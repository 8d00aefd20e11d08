"""The CUDA kernels on the card: the round kernels of both chains and the
transcript step, each against its plain PyTorch version, and proves through
both chains on `device="cuda"` against `device="cpu"`.

Marked `cuda`; every test skips without a CUDA device. This file imports
no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance 0: exact field arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sumcheck_tpu_torch as T
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.fields.fr import P
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.protocol.device_prover import lift_transcript
from sumcheck_tpu_torch.transcript.blake2b_rng import _DRAW_MASK
from sumcheck_tpu_torch.utils.config import get_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(seed: int, nv: int, count: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def _pair(seed, slots, nv, device):
    t = np.stack(_tables(seed, nv, slots)).astype(np.int32)
    half = 1 << (nv - 1)
    lo = torch.from_numpy(np.ascontiguousarray(t[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(t[:, :, half:])).to(device)
    return lo, hi


@pytest.mark.parametrize("extent", [1, 2, 3, 127, 128, 129, 1 << 10])
@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
def test_kernel_matches_plain(cuda, fold, extent):
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _pair(extent, 6, 12, cuda)
    if fold and 2 * extent > lo.shape[2]:
        extent //= 2
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(cuda)
    lo_p, hi_p = lo.clone(), hi.clone()
    if fold:
        got = RC.round_fold(lo, hi, r, products, 3, extent)
        want = RC.round_fold_ref(lo_p, hi_p, r, products, 3, extent)
    else:
        got = RC.round_nofold(lo, hi, products, 3, extent)
        want = RC.round_nofold_ref(lo_p, hi_p, products, 3, extent)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


@pytest.mark.parametrize("slots", [1, 9, 16])
def test_kernel_slot_counts(cuda, slots):
    """From one slot up to the kernel's maximum (dynamic shared memory
    beyond 48 KB per block)."""
    products = (tuple(range(slots))[:4],) if slots >= 4 else ((0,) * 2,)
    degree = len(products[0])
    lo, hi = _pair(slots, slots, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(5)[:, 0].astype(np.int32)).to(cuda)
    lo_p, hi_p = lo.clone(), hi.clone()
    got = RC.round_fold(lo, hi, r, products, degree, 200)
    want = RC.round_fold_ref(lo_p, hi_p, r, products, degree, 200)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


def test_prove_on_cuda_equals_cpu(cuda):
    nv = 12
    tables = _tables(7, nv, 5)
    poly = polynomial_from_numpy(nv, tables, [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    before = (RC.round_nofold.launches, RC.round_fold.launches)
    proof = T.MLSumcheck.prove(poly, device=cuda)
    after = (RC.round_nofold.launches, RC.round_fold.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, nv - 1)
    assert serialize_proof(proof) == serialize_proof(T.MLSumcheck.prove(poly, device="cpu"))
    sub = T.MLSumcheck.verify(poly.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert poly.evaluate(sub.point) == sub.expected_evaluation


def _coeffs(products, device):
    vals = [L.mont_scalar(1000003 * (p + 1))[:, 0] for p in range(len(products))]
    return torch.from_numpy(np.stack(vals).astype(np.int32)).to(device)


@pytest.mark.parametrize("extent", [1, 2, 3, 127, 128, 129, 1 << 10])
@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
def test_step_kernel_matches_plain(cuda, fold, coeffs, extent):
    """The per-size kernels at every extent: a fold reads a pair of width
    2 * extent and writes fresh tables of width extent."""
    products = ((0, 1, 2), (3, 4, 5))
    width = 2 * extent if fold else extent
    rng = np.random.default_rng(extent)
    d = rng.integers(0, 1 << 16, size=(2, 6, 16, width), dtype=np.uint32)
    d[:, :, 15] >>= 2
    lo = torch.from_numpy(d[0].astype(np.int32)).to(cuda)
    hi = torch.from_numpy(d[1].astype(np.int32)).to(cuda)
    c = _coeffs(products, cuda) if coeffs else None
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(cuda)
    lo0, hi0 = lo.clone(), hi.clone()
    if fold:
        (glo, ghi), got = RC.round_step_fold(lo, hi, r, products, 3, c)
        (wlo, whi), want = RC.round_step_fold_ref(lo, hi, r, products, 3, c)
        torch.cuda.synchronize()
        assert glo.shape == (6, 16, extent)
        assert torch.equal(glo, wlo) and torch.equal(ghi, whi)
    else:
        got = RC.round_step_nofold(lo, hi, products, 3, c)
        want = RC.round_step_nofold_ref(lo, hi, products, 3, c)
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lo, lo0) and torch.equal(hi, hi0)  # inputs untouched


def test_transcript_kernel_matches_plain(cuda):
    """60 rounds of the transcript kernel against the plain version on the
    card, from the same state and sums; the schedule rejects draws."""
    rounds, degree = 60, 3
    gen = np.random.default_rng(5)
    sums = torch.from_numpy(
        gen.integers(0, 1 << 40, size=(rounds, degree + 1, 16), dtype=np.int64)).to(cuda)
    host = T.Blake2b512Rng.setup()
    host.feed_bytes(b"\x07" * 24)
    state_k = lift_transcript(host, cuda)
    state_p = state_k.clone()
    outs = []
    for _ in range(2):
        outs.append((torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=cuda),
                     torch.empty((rounds, 16), dtype=torch.int32, device=cuda)))
    before = TC.transcript_step.launches
    for j in range(rounds):
        TC.transcript_step(state_k, sums[j], *outs[0], j)
        TC.transcript_step_ref(state_p, sums[j], *outs[1], j)
    torch.cuda.synchronize()
    assert TC.transcript_step.launches - before == rounds
    assert torch.equal(state_k, state_p)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    # the same schedule on the host rejects at least one draw
    msgs = outs[1][0].cpu().numpy().astype(np.int64)
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(b"\x07" * 24)
    rejected = 0
    for j in range(rounds):
        vals = [T.Fr(sum(int(msgs[j, i, t]) << (16 * i) for i in range(16)))
                for t in range(degree + 1)]
        rng.feed(T.protocol.ProverMsg(vals))
        while True:
            draw = int.from_bytes(rng.next_u64s_bytes(4), "little") & _DRAW_MASK
            if draw < P:
                break
            rejected += 1
        rs = outs[0][1][j].cpu().numpy().astype(np.int64)
        assert sum(int(rs[i]) << (16 * i) for i in range(16)) == draw
    assert rejected >= 1


@pytest.mark.parametrize("impl", ["generic", "persize"])
def test_chained_prove_on_cuda_equals_cpu(cuda, impl, monkeypatch):
    """Both chains with the transcript on the card: launch counts per
    prove, and proof bytes and final transcript state equal to the CPU's."""
    monkeypatch.setattr(get_config(), "chain_impl", impl)
    nv = 11
    tables = _tables(8, nv, 5)
    poly = polynomial_from_numpy(nv, tables, [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    counters = ((RC.round_step_nofold, RC.round_step_fold) if impl == "persize"
                else (RC.round_nofold, RC.round_fold))
    before = [f.launches for f in counters] + [TC.transcript_step.launches]
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, poly, device=cuda)
    after = [f.launches for f in counters] + [TC.transcript_step.launches]
    assert [a - b for a, b in zip(after, before)] == [1, nv - 1, nv]
    rng_cpu = T.Blake2b512Rng.setup()
    proof_cpu, state_cpu = T.MLSumcheck.prove_as_subprotocol(rng_cpu, poly, device="cpu")
    assert serialize_proof(proof) == serialize_proof(proof_cpu)
    assert rng.state_tuple() == rng_cpu.state_tuple()
    sub = T.MLSumcheck.verify(poly.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert state.randomness == sub.point
    assert poly.evaluate(sub.point) == sub.expected_evaluation


def test_mma_tile(cuda):
    """One `mma.sync` m16n8k32 u8 x u8 -> s32 tile of `csrc/round_mxu.cu`,
    fragment layouts as the kernel uses them, against an int64 product."""
    gen = np.random.default_rng(11)
    a = gen.integers(0, 256, size=(16, 32), dtype=np.uint8)
    b = gen.integers(0, 256, size=(8, 32), dtype=np.uint8)  # B's columns
    c = gen.integers(-(1 << 20), 1 << 20, size=(16, 8), dtype=np.int32)
    got = RC._mma_tile(*(torch.from_numpy(x).to(cuda) for x in (a, b, c)))
    want = a.astype(np.int64) @ b.astype(np.int64).T + c
    assert np.array_equal(got.cpu().numpy().astype(np.int64), want)


def _strict(gen, n):
    d = gen.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    d[15] >>= 2  # < 2^254 < p
    return d


@pytest.mark.parametrize("r_int", [None, 0, 1, P - 1], ids=["random", "0", "1", "p-1"])
@pytest.mark.parametrize("extent", [1, 3, 129, (1 << 9) + 5, 1 << 10])
def test_fold_mxu_kernel_matches_plain_and_cios(cuda, extent, r_int):
    """`round_fold_mxu` against its plain version and against `round_fold`
    on the card: the folded pair and the block sums, array-equal; lanes
    past the extent untouched. The first lanes of slot 0 fold 0 towards
    edge values (0, 1, 2, p-1, p-2, 2^255 mod p), so the banded multiply
    meets them as operands, by edge challenges too."""
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _pair(extent + 1, 6, 12, cuda)
    edges = L.from_ints([0, 1, 2, P - 1, P - 2, (1 << 255) % P], mont=False)
    n = min(extent, edges.shape[1])
    lo[0, :, :n] = 0
    hi[0, :, :n] = torch.from_numpy(edges[:, :n].astype(np.int32)).to(cuda)
    r_digits = (L.mont_scalar(987654321) if r_int is None else L.from_ints([r_int], mont=False))
    r = torch.from_numpy(r_digits[:, 0].astype(np.int32)).to(cuda)
    runs = []
    for fn in (RC.round_fold_mxu, RC.round_fold_mxu_ref, RC.round_fold):
        l, h = lo.clone(), hi.clone()
        runs.append((fn(l, h, r, products, 3, extent), l, h))
    torch.cuda.synchronize()
    for sums, l, h in runs[1:]:
        assert torch.equal(runs[0][0], sums)
        assert torch.equal(runs[0][1], l) and torch.equal(runs[0][2], h)
    assert torch.equal(runs[0][1][:, :, extent:], lo[:, :, extent:])


@pytest.mark.parametrize("slots", [1, 2, 16])
def test_fold_mxu_kernel_slot_counts(cuda, slots):
    """From one slot to the maximum, whose ladder and exchange tiles take
    more than 48 KB of dynamic shared memory; the GKR shape is two slots."""
    products = ((0, 1),) if slots == 2 else (((0, 0),) if slots == 1 else (tuple(range(4)),))
    degree = len(products[0])
    lo, hi = _pair(slots + 40, slots, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(77)[:, 0].astype(np.int32)).to(cuda)
    l1, h1, l2, h2 = lo.clone(), hi.clone(), lo.clone(), hi.clone()
    got = RC.round_fold_mxu(l1, h1, r, products, degree, 200)
    want = RC.round_fold(l2, h2, r, products, degree, 200)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(l1, l2) and torch.equal(h1, h2)


def test_mont_mul_scalar_mxu_on_the_card(cuda):
    """`ops/mxu_mul.py`'s float32 matmuls are exact on the card: equal to
    the CIOS multiply at 2^17 lanes."""
    from sumcheck_tpu_torch.fields import limbs_torch as LT
    from sumcheck_tpu_torch.ops import mxu_mul

    gen = np.random.default_rng(3)
    a = torch.from_numpy(_strict(gen, 1 << 17).astype(np.int64)).to(cuda)
    c = torch.from_numpy(L.mont_scalar(int(gen.integers(1, 1 << 62)))[:, 0].astype(np.int64)).to(cuda)
    assert torch.equal(mxu_mul.mont_mul_scalar_mxu(a, c), LT.mont_mul(a, c[:, None]))


def test_prove_in_mxu_mode_on_cuda(cuda, monkeypatch):
    """The generic chain in the MXU fold mode: nv - 1 `round_fold_mxu`
    launches, no `round_fold`, and the default mode's bytes."""
    nv = 11
    poly = polynomial_from_numpy(nv, _tables(9, nv, 5),
                                 [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    want = serialize_proof(T.MLSumcheck.prove(poly, device=cuda))
    monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
    monkeypatch.setattr(get_config(), "ab", True)
    before = (RC.round_fold_mxu.launches, RC.round_fold.launches)
    proof = T.MLSumcheck.prove(poly, device=cuda)
    after = (RC.round_fold_mxu.launches, RC.round_fold.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (nv - 1, 0)
    assert serialize_proof(proof) == want


def _gkr_mode(mode, monkeypatch):
    """Chain and fold mode; "mxu" is the generic chain in the MXU fold mode
    with the banded-product threshold at 1 lane, so the eq tables and the
    phase-2 scaling take the banded product on the card too."""
    from sumcheck_tpu_torch.ops import gkr_init as GI

    cfg = get_config()
    monkeypatch.setattr(cfg, "chain_impl", "persize" if mode == "persize" else "generic")
    if mode == "mxu":
        monkeypatch.setattr(cfg, "mxu_fold", "kernel")
        monkeypatch.setattr(cfg, "ab", True)
        monkeypatch.setattr(GI, "MXU_MIN_LANES", 1)
    if mode == "persize":
        return (RC.round_step_nofold, RC.round_step_fold)
    return (RC.round_nofold, RC.round_fold_mxu if mode == "mxu" else RC.round_fold)


@pytest.mark.parametrize("mode", ["generic", "persize", "mxu"])
def test_gkr_golden_on_cuda(cuda, mode, monkeypatch):
    """`tests/fixtures/gkr_dim5.json` byte for byte through `device="cuda"`."""
    import hashlib
    import json
    from pathlib import Path

    _gkr_mode(mode, monkeypatch)
    fx = json.loads((Path(__file__).parent / "fixtures" / "gkr_dim5.json").read_text())
    dim = fx["dim"]

    def table(tag):
        return [int.from_bytes(hashlib.blake2b(f"sumcheck-golden/gkr{dim}/{tag}/{i}".encode(),
                                               digest_size=32).digest(), "little") % P
                for i in range(1 << dim)]

    f1 = T.SparseMLE.from_pairs(3 * dim, [(int(k), T.Fr(int(v, 16)))
                                          for k, v in fx["f1_nonzeros"].items()])
    f2, f3 = T.DenseMLE.from_evaluations(dim, table("f2")), T.DenseMLE.from_evaluations(dim, table("f3"))
    g = [T.Fr(int(x, 16)) for x in fx["g"]]
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, g, device=cuda)
    hexes = lambda msgs: [[format(e.v, "064x") for e in m.evaluations] for m in msgs]  # noqa: E731
    assert hexes(proof.phase1_sumcheck_msgs) == fx["phase1_msgs"]
    assert hexes(proof.phase2_sumcheck_msgs) == fx["phase2_msgs"]
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof,
                                    T.Fr(int(fx["claimed_sum"], 16)))
    assert sub.expected_evaluation.v == int(fx["expected_evaluation"], 16)
    assert sub.verify_subclaim(f1, f2, f3, g)


@pytest.mark.parametrize("mode", ["generic", "persize", "mxu"])
def test_gkr_prove_on_cuda_equals_cpu(cuda, mode, monkeypatch):
    """A dim-9 GKR prove with colliding f1 entries: 2 round-0 launches,
    2 (dim - 1) folds and 2 dim transcript steps per prove, and proof bytes
    and the final transcript state equal to the CPU's."""
    import random

    counters = _gkr_mode(mode, monkeypatch) + (TC.transcript_step,)
    dim = 9
    rnd = random.Random(dim)
    f1 = T.SparseMLE.rand_with_config(3 * dim, 3 << dim, rnd)
    f2, f3 = T.DenseMLE.rand(dim, rnd), T.DenseMLE.rand(dim, rnd)
    g = [T.Fr(rnd.randrange(P)) for _ in range(dim)]
    before = [f.launches for f in counters]
    rng = T.Blake2b512Rng.setup()
    proof = T.GKRRoundSumcheck.prove(rng, f1, f2, f3, g, device=cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2 * (dim - 1), 2 * dim]
    rng_cpu = T.Blake2b512Rng.setup()
    want = T.GKRRoundSumcheck.prove(rng_cpu, f1, f2, f3, g, device="cpu")
    assert proof.serialize_uncompressed() == want.serialize_uncompressed()
    assert rng.state_tuple() == rng_cpu.state_tuple()
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
    assert sub.verify_subclaim(f1, f2, f3, g)
