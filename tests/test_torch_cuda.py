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
