"""The plain reference against Python integers, hashlib's transcript
against the port's, and the reference's proofs against the port's CPU
path at nv=4 (dim 4), B=2, through both batched entry points."""

import random

import numpy as np
import pytest
import torch

from portbench.reference import prover as RP
from portbench.reference import transcript as RT
from portbench.reference.field import Field, digits_int, int_digits

BLS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BN254 = 0x30644E72E131A029B85045B68181585D2833E84879B97091_43E1F593F0000001


def _col(values):
    return torch.tensor([int_digits(v) for v in values], dtype=torch.int64).T.contiguous()


def _ints(t):
    return [digits_int(t[:, i]) for i in range(t.shape[1])]


@pytest.mark.parametrize("p", [BLS, BN254], ids=["bls12_381", "bn254"])
def test_field_against_python_ints(p):
    F = Field(p, "cpu")
    rnd = random.Random(p % 1000)
    a = [p - 1, 0, 1] + [rnd.randrange(p) for _ in range(500)]
    b = [p - 1, p - 1, 0] + [rnd.randrange(p) for _ in range(500)]
    A, B = _col(a), _col(b)
    assert _ints(F.add(A, B)) == [(x + y) % p for x, y in zip(a, b)]
    assert _ints(F.sub(A, B)) == [(x - y) % p for x, y in zip(a, b)]
    assert _ints(F.mul(A, B)) == [x * y * F.r_inv % p for x, y in zip(a, b)]
    wide = [rnd.randrange(1 << 271) for _ in range(200)] + [(1 << 272) - 1]
    W = torch.tensor([[(w >> (16 * i)) & 0xFFFF for i in range(17)] for w in wide],
                     dtype=torch.int64).T.contiguous()
    assert _ints(F.reduce_wide(W)) == [w % p for w in wide]


def test_lazy_field_is_wrong_somewhere():
    F, G = Field(BLS, "cpu"), Field(BLS, "cpu", lazy=True)
    rnd = random.Random(3)
    A = _col([rnd.randrange(BLS) for _ in range(200)])
    s, t = F.add(A, A), G.add(A, A)
    assert _ints(F.mul(s, s)) != _ints(G.mul(t, t))


def test_transcript_matches_the_port():
    import sumcheck_tpu_torch as T

    ours, port = RT.Transcript(), T.Blake2b512Rng.setup()
    for n in (0, 8, 64, 100, 129):
        data = bytes(range(n % 256)) * (1 + n // 256)
        ours.feed(data)
        port.feed(data)
        assert ours.field_element(BLS) == T.Fr.rand(port).v
        assert ours.draw(n) == port.fill_bytes(n)


def _tables(rng, nv, count):
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2
        out.append(d)
    return out


def _i64(arrays, axis):
    return torch.stack([torch.from_numpy(a.astype(np.int64)) for a in arrays], axis)


def test_ml_reference_equals_the_port_cpu_path():
    import sumcheck_tpu_torch as T
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    rng = np.random.default_rng(4)
    nv, batch = 4, 2
    tables = [_tables(rng, nv, 6) for _ in range(batch)]
    coeffs = [[int(c) for c in rng.integers(2, 1 << 62, size=2)] for _ in range(batch)]
    labels = [bytes([b]) * 32 for b in range(batch)]
    polys, rngs = [], []
    for b in range(batch):
        mles = [T.DenseMLE(nv, t) for t in tables[b]]
        poly = T.ListOfProductsOfPolynomials(nv)
        poly.add_product(mles[:3], T.Fr(coeffs[b][0]))
        poly.add_product(mles[3:], T.Fr(coeffs[b][1]))
        polys.append(poly)
        r = T.Blake2b512Rng.setup()
        r.feed(labels[b])
        rngs.append(r)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, polys, device="cpu")
    tabs = torch.stack([_i64(t, 1) for t in tables], 2)
    ref = RP.ml_prove(Field(BLS, "cpu"), tabs, [(0, 1, 2), (3, 4, 5)], coeffs, labels)
    for b in range(batch):
        assert serialize_proof(proofs[b]) == RT.proof_bytes(ref["messages"][b])
        assert [r.v for r in challenges[b]] == ref["challenges"][b]
        assert T.Fr.rand(rngs[b]).v == ref["next"][b]


def test_gkr_reference_equals_the_port_cpu_path():
    import sumcheck_tpu_torch as T
    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck

    rng = np.random.default_rng(5)
    dim, batch, nnz = 4, 2, 24
    f1s, f2s, f3s, gs = [], [], [], []
    for _ in range(batch):
        idx = rng.choice(1 << (3 * dim), size=nnz, replace=False).astype(np.int64)
        vals = np.ascontiguousarray(_tables(rng, 5, 1)[0][:, :nnz])
        f1s.append(T.SparseMLE(3 * dim, idx, vals))
        f2s.append(T.DenseMLE(dim, _tables(rng, dim, 1)[0]))
        f3s.append(T.DenseMLE(dim, _tables(rng, dim, 1)[0]))
        gs.append([int(v) for v in rng.integers(0, 1 << 62, size=dim)])
    labels = [bytes([7 + b]) * 8 for b in range(batch)]
    rngs = []
    for label in labels:
        r = T.Blake2b512Rng.setup()
        r.feed(label)
        rngs.append(r)
    proofs = BatchedGKRRoundSumcheck.prove(rngs, f1s, f2s, f3s,
                                           [[T.Fr(v) for v in g] for g in gs], device="cpu")
    idx = torch.stack([torch.from_numpy(f.indices) for f in f1s])
    ref = RP.gkr_prove(Field(BLS, "cpu"), idx, _i64([f.values for f in f1s], 1),
                       _i64([f.evals for f in f2s], 1), _i64([f.evals for f in f3s], 1), gs,
                       labels)
    for b in range(batch):
        want = RT.proof_bytes(ref["phase1"][b]) + RT.proof_bytes(ref["phase2"][b])
        assert proofs[b].serialize_uncompressed() == want
        assert T.Fr.rand(rngs[b]).v == ref["next"][b]
