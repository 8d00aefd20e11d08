"""The CUDA kernels on the card: the round kernels of both chains and the
transcript step, each against its plain PyTorch version, the sums rows the
round kernels add into, and proves through both chains on `device="cuda"`
against `device="cpu"`.

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
from sumcheck_tpu_torch.fields.fr import FIELD_NAME, P, SHAVE_BITS
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.protocol.device_prover import lift_transcript
from sumcheck_tpu_torch.transcript.blake2b_rng import _DRAW_MASK
from sumcheck_tpu_torch.utils.config import get_config

pytestmark = pytest.mark.cuda

# random tables keep their top 16-bit digit below 2^(16 - TOP_SHIFT), so
# every value below 2^(256 - TOP_SHIFT) < p: 2^254 under BLS12-381 Fr, 2^253
# under BN254 Fr
TOP_SHIFT = 1 + SHAVE_BITS


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
        d[15] >>= TOP_SHIFT  # < p
        out.append(d)
    return out


def _packed(d: np.ndarray, axis: int = 0) -> torch.Tensor:
    """Digit tables, 16 along `axis` -> their int32 limbs, 8 along `axis`."""
    return torch.from_numpy(L.pack_limbs(d, axis=axis))


def _pair(seed, slots, nv, device):
    """A random (slots, 8, 2^(nv-1)) limb pair."""
    t = L.pack_limbs(np.stack(_tables(seed, nv, slots)), axis=1)
    half = 1 << (nv - 1)
    lo = torch.from_numpy(np.ascontiguousarray(t[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(t[:, :, half:])).to(device)
    return lo, hi


@pytest.mark.parametrize("extent", [1, 2, 3, 127, 128, 129, (1 << 9) + 5, 1 << 10])
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


@pytest.mark.parametrize("width", [6, 10, 36])
def test_fold_kernel_unaligned_rows(cuda, width):
    """Pair widths that are not a multiple of 4 lanes, and one that is, at
    extents whose upper half starts off a 16-byte boundary."""
    products = ((0, 1, 2), (3, 4, 5))
    rng = np.random.default_rng(width)
    d = rng.integers(0, 1 << 16, size=(2, 6, 16, width), dtype=np.uint32)
    d[:, :, 15] >>= TOP_SHIFT
    lo = _packed(d[0], 1).to(cuda)
    hi = _packed(d[1], 1).to(cuda)
    r = torch.from_numpy(L.mont_scalar(31337)[:, 0].astype(np.int32)).to(cuda)
    for extent in sorted({1, width // 2 - 1, width // 2} - {0}):
        l1, h1, l2, h2 = lo.clone(), hi.clone(), lo.clone(), hi.clone()
        got = RC.round_fold(l1, h1, r, products, 3, extent)
        want = RC.round_fold_ref(l2, h2, r, products, 3, extent)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(l1, l2) and torch.equal(h1, h2)


@pytest.mark.parametrize("kernel", ["nofold", "fold", "step_nofold", "step_fold", "fold_mxu"])
def test_kernels_add_into_the_sums_row(cuda, kernel):
    """Every round kernel adds its blocks' sums into the row it is given,
    with 64-bit atomics: into row j of a zeroed (rounds, d+1, 16) buffer it
    writes exactly the plain version's sums and leaves the other rows at 0;
    a second launch into the same row doubles it. Equal to the sum over
    128-lane blocks of the plain per-block sums (the former second pass)."""
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _pair(21, 6, 12, cuda)
    r = torch.from_numpy(L.mont_scalar(4242)[:, 0].astype(np.int32)).to(cuda)
    extent = 1000
    fold = kernel in ("fold", "fold_mxu")

    def run(out, l, h):
        if kernel == "nofold":
            return RC.round_nofold(l, h, products, 3, extent, out)
        if kernel == "fold":
            return RC.round_fold(l, h, r, products, 3, extent, out)
        if kernel == "fold_mxu":
            return RC.round_fold_mxu(l, h, r, products, 3, extent, out)
        if kernel == "step_nofold":
            return RC.round_step_nofold(l, h, products, 3, None, out)
        return RC.round_step_fold(l, h, r, products, 3, None, out)[1]

    rows = torch.zeros((4, 4, 16), dtype=torch.int64, device=cuda)
    got = run(rows[2], lo.clone(), hi.clone())
    assert got.data_ptr() == rows[2].data_ptr()
    l, h = lo.clone(), hi.clone()
    if kernel.startswith("step"):
        want = (RC.round_step_nofold_ref(l, h, products, 3) if kernel == "step_nofold"
                else RC.round_step_fold_ref(l, h, r, products, 3)[1])
    elif fold:
        want = RC.round_fold_ref(l, h, r, products, 3, extent)
    else:
        want = RC.round_nofold_ref(l, h, products, 3, extent)
    torch.cuda.synchronize()
    assert torch.equal(rows[2], want)
    assert not rows[[0, 1, 3]].any()
    run(rows[2], lo.clone(), hi.clone())
    torch.cuda.synchronize()
    assert torch.equal(rows[2], 2 * want)
    if kernel == "nofold":  # the blocks' partial sums, summed on the host
        blocks = [RC.round_nofold_ref(lo[:, :, k:].contiguous(), hi[:, :, k:].contiguous(),
                                      products, 3, min(128, extent - k))
                  for k in range(0, extent, 128)]
        assert torch.equal(torch.stack(blocks).sum(0), want)


def _limbs(values) -> torch.Tensor:
    """Python ints -> (n, 8) int32 tensor of 32-bit limbs."""
    rows = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in values]
    return torch.from_numpy(np.array(rows, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("impl", sorted(RC.MULTIPLIES))
@pytest.mark.parametrize("reps", [1, 5])
def test_mont_mul_edge_operands(cuda, reps, impl):
    """`csrc/field.cuh`'s Montgomery multiplies (`mont_mul`, the even/odd
    accumulators, and `mont_mul_cios`) against Python integers, at edge
    operands (0, 1, 2, p-1, p-2, R mod p, R^2 mod p, 2^255 mod p) in every
    pairing and at random ones; `reps` chains the product into itself."""
    from sumcheck_tpu_torch.fields.fr import R2

    edges = [0, 1, 2, P - 1, P - 2, (1 << 256) % P, R2 % P, (1 << 255) % P]
    gen = np.random.default_rng(17)
    rand = [int.from_bytes(gen.bytes(32), "little") % P for _ in range(64)]
    pairs = [(x, y) for x in edges + rand[:8] for y in edges + rand[:8]]
    pairs += list(zip(rand, rand[::-1]))
    a, b = (_limbs([pr[k] for pr in pairs]).to(cuda) for k in (0, 1))
    got = RC._mont_mul_probe(a, b, reps, impl)
    r_inv = pow(1 << 256, -1, P)
    want = []
    for x, y in pairs:
        for _ in range(reps):
            x = x * y * r_inv % P
        want.append(x)
    assert torch.equal(got.cpu(), _limbs(want))


def _edge_pair(seed, slots, nv, device):
    """A random pair whose slot 0 starts with edge values (0, 1, p-1,
    2^255 mod p) in both halves."""
    lo, hi = _pair(seed, slots, nv, device)
    edges = _packed(L.from_ints([0, 1, P - 1, (1 << 255) % P], mont=False)).to(device)
    lo[0, :, :4] = edges
    hi[0, :, :4] = edges.flip(1)
    return lo, hi


def _round0(cuda, lo, hi, products, degree, extent, coeffs):
    """Round 0 on the card and by its plain version: `round_nofold` over the
    extent, or with coefficients `round_step_nofold` over a pair of that
    width. Returns (kernel sums, plain sums); the inputs stay untouched."""
    lo0, hi0 = lo.clone(), hi.clone()
    if coeffs:
        lo, hi = lo[:, :, :extent].contiguous(), hi[:, :, :extent].contiguous()
        c = _coeffs(products, cuda)
        got = RC.round_step_nofold(lo, hi, products, degree, c)
        want = RC.round_step_nofold_ref(lo, hi, products, degree, c)
    else:
        got = RC.round_nofold(lo, hi, products, degree, extent)
        want = RC.round_nofold_ref(lo, hi, products, degree, extent)
        torch.cuda.synchronize()
        assert torch.equal(lo, lo0) and torch.equal(hi, hi0)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
@pytest.mark.parametrize("degree", range(1, 9))
def test_nofold_kernel_every_degree(cuda, degree, coeffs):
    """Round 0 at every degree 1-8 (the register body up to degree 4, the
    ladder body above it), with products of fewer factors than the degree,
    as many and more, 9 slots, a ragged extent, edge values, with and
    without coefficients."""
    rng = np.random.default_rng(degree)
    factors = min(8, max(1, degree + (degree % 3) - 1))
    products = tuple(tuple(int(s) for s in rng.integers(0, 9, factors)) for _ in range(3))
    lo, hi = _edge_pair(degree + 50, 9, 10, cuda)
    got, want = _round0(cuda, lo, hi, products, degree, 300, coeffs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
@pytest.mark.parametrize("factors", range(1, 9))
def test_nofold_kernel_factor_counts(cuda, factors, coeffs):
    """Products of 1 to 8 factors at their own degree, as a prove plans
    them: every extension of the register body by differences, and the
    ladder body from degree 5; extents 1 and 129."""
    slots = max(factors, 2)
    products = (tuple(range(factors)), tuple(reversed(range(factors))),
                tuple([slots - 1] * factors))
    lo, hi = _edge_pair(factors + 70, slots, 9, cuda)
    for extent in (1, 129):
        got, want = _round0(cuda, lo, hi, products, factors, extent, coeffs)
        assert torch.equal(got, want)


@pytest.mark.parametrize("slots", [1, 9, 16])
def test_nofold_kernel_slot_counts(cuda, slots):
    """Round 0 from one slot up to the maximum, at degrees 2-4 (the
    register body) and 8 (the ladder body, whose ladder passes 48 KB of
    shared memory at 16 slots), with 16 products."""
    rng = np.random.default_rng(slots)
    lo, hi = _edge_pair(slots + 90, slots, 10, cuda)
    for degree in (2, 3, 4, 8):
        products = tuple(tuple(int(s) for s in rng.integers(0, slots, degree))
                         for _ in range(16))
        got, want = _round0(cuda, lo, hi, products, degree, 333, False)
        assert torch.equal(got, want)


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
    d[:, :, 15] >>= TOP_SHIFT
    lo = _packed(d[0], 1).to(cuda)
    hi = _packed(d[1], 1).to(cuda)
    c = _coeffs(products, cuda) if coeffs else None
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(cuda)
    lo0, hi0 = lo.clone(), hi.clone()
    if fold:
        (glo, ghi), got = RC.round_step_fold(lo, hi, r, products, 3, c)
        (wlo, whi), want = RC.round_step_fold_ref(lo, hi, r, products, 3, c)
        torch.cuda.synchronize()
        assert glo.shape == (6, 8, extent)
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


def _host_rounds(prefix: bytes, sums: np.ndarray, degree: int, max_rounds: int = 200):
    """The host schedule of transcript steps from a transcript fed `prefix`:
    rounds up to and including the first that rejects a draw. Returns (the
    rounds' canonical values, their challenges, the final host rng)."""
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(prefix)
    values, draws = [], []
    for j in range(max_rounds):
        wide = RC.finish_sums(torch.from_numpy(sums[j]))
        vals = [sum(int(wide[i, t]) << (16 * i) for i in range(wide.shape[0])) % P
                * pow(2, -256, P) % P for t in range(degree + 1)]
        rng.feed(T.protocol.ProverMsg([T.Fr(v) for v in vals]))
        rejected = False
        while True:
            draw = int.from_bytes(rng.next_u64s_bytes(4), "little") & _DRAW_MASK
            if draw < P:
                break
            rejected = True
        values.append(vals)
        draws.append(draw)
        if rejected:
            return values, draws, rng
    raise AssertionError("no draw rejected")


@pytest.mark.parametrize("degree", range(1, 9))
def test_transcript_kernel_every_degree_and_pending_fill(cuda, degree):
    """The transcript kernel at every degree 1..8, from every pending-block
    fill (blen 0, 8, ..., 128 bytes), each over rounds up to the first that
    rejects a draw: messages, challenges and final state equal to the host
    rng's, and the first round equal to the plain version's."""
    from sumcheck_tpu_torch.protocol.device_prover import restore_transcript

    for blen in range(0, 129, 8):
        prefix = bytes(range(128 + blen)) if blen else b""
        gen = np.random.default_rng(1000 * degree + blen)
        sums = gen.integers(0, 1 << 40, size=(200, degree + 1, 16), dtype=np.int64)
        values, draws, host = _host_rounds(prefix, sums, degree)
        rounds = len(values)
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        state = lift_transcript(rng, cuda)
        assert int(state[25, 0]) == blen
        msgs = torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=cuda)
        rs = torch.empty((rounds, 16), dtype=torch.int32, device=cuda)
        state_p = state.cpu()
        msgs_p, rs_p = torch.empty_like(msgs[:1]).cpu(), torch.empty_like(rs[:1]).cpu()
        sums_d = torch.from_numpy(sums[:rounds]).to(cuda)
        for j in range(rounds):
            TC.transcript_step(state, sums_d[j], msgs, rs, j)
        TC.transcript_step_ref(state_p, torch.from_numpy(sums[0]), msgs_p, rs_p, 0)
        torch.cuda.synchronize()
        assert torch.equal(msgs[0].cpu(), msgs_p[0]) and torch.equal(rs[0].cpu(), rs_p[0])
        m = msgs.cpu().numpy().astype(np.int64)
        r = rs.cpu().numpy().astype(np.int64)
        for j in range(rounds):
            assert [sum(int(m[j, i, t]) << (16 * i) for i in range(16))
                    for t in range(degree + 1)] == values[j], (blen, j)
            assert sum(int(r[j, i]) << (16 * i) for i in range(16)) == draws[j], (blen, j)
        probe = T.Blake2b512Rng.setup()
        restore_transcript(probe, state.cpu())
        assert probe.state_tuple() == host.state_tuple(), blen


def test_compress_probe_matches_host_core(cuda):
    """The transcript kernel's compression on its four hash lanes against
    the host's Blake2b core, over a chain that sets the last flag on every
    eighth block."""
    from sumcheck_tpu_torch.transcript.blake2b_core import compress

    iters = 24
    blk = b"".join((0x0123456789ABCDEF * (i + 1) % (1 << 64)).to_bytes(8, "little")
                   for i in range(16))
    h = list(range(1, 9))
    for k in range(iters):
        h = compress(h, blk, 128 * k, k % 8 == 7)
    out = torch.zeros(9, dtype=torch.int64, device=cuda)
    TC._compress_probe(out, iters)
    assert [int(x) % (1 << 64) for x in out.cpu().tolist()[:8]] == h
    assert int(out[8]) > 0


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
    d[15] >>= TOP_SHIFT  # < p
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
    hi[0, :, :n] = _packed(edges[:, :n]).to(cuda)
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


@pytest.mark.parametrize("slots", [1, 2, 9, 16])
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


@pytest.mark.parametrize("degree", range(1, 9))
def test_fold_mxu_kernel_every_degree(cuda, degree):
    """`round_fold_mxu` at every degree 1-8 with up to 8 factors over 9
    slots, edge values among the operands, at a ragged extent: the folded
    pair and the sums equal the plain version's and `round_fold`'s."""
    rng = np.random.default_rng(degree + 20)
    factors = min(8, max(1, degree + (degree % 3) - 1))
    products = tuple(tuple(int(s) for s in rng.integers(0, 9, factors)) for _ in range(2))
    lo, hi = _edge_pair(degree + 30, 9, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(1 + degree)[:, 0].astype(np.int32)).to(cuda)
    runs = []
    for fn in (RC.round_fold_mxu, RC.round_fold_mxu_ref, RC.round_fold):
        l, h = lo.clone(), hi.clone()
        runs.append((fn(l, h, r, products, degree, 211), l, h))
    torch.cuda.synchronize()
    for sums, l, h in runs[1:]:
        assert torch.equal(runs[0][0], sums)
        assert torch.equal(runs[0][1], l) and torch.equal(runs[0][2], h)


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


# the phase-init kernels a GKR prove launches on each path: (weight_reduce,
# finish_sums, pair_slots); every chain and fold mode runs one fused launch
# a phase, the per-size chain too
GKR_INIT_LAUNCHES = {"generic": (2, 0, 0), "persize": (2, 0, 0), "mxu": (2, 0, 0)}


def _init_counters():
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    return (GK.weight_reduce, GK.finish_sums, GK.pair_slots)


def _gkr_mode(mode, monkeypatch):
    """Chain and fold mode; "mxu" is the generic chain in the MXU fold mode
    (`round_fold_mxu`), with the banded-product threshold at 1 lane, which
    only the inits' plain versions read: the path runs the init kernels."""
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
    """`tests/fixtures/gkr_dim5.json` byte for byte through `device="cuda"`;
    under BN254 Fr, the GKR vectors of `bn254_torch.json`."""
    import hashlib
    import json
    from pathlib import Path

    _gkr_mode(mode, monkeypatch)
    fixtures = Path(__file__).parent / "fixtures"
    if FIELD_NAME == "bn254_fr":
        fx = json.loads((fixtures / "bn254_torch.json").read_text())["gkr"]
    else:
        fx = json.loads((fixtures / "gkr_dim5.json").read_text())
    dim = fx["dim"]

    def table(tag):
        return [int.from_bytes(hashlib.blake2b(f"sumcheck-golden/gkr{dim}/{tag}/{i}".encode(),
                                               digest_size=32).digest(), "little") % P
                for i in range(1 << dim)]

    f1 = T.SparseMLE.from_pairs(3 * dim, [(int(k), T.Fr(int(v, 16)))
                                          for k, v in fx["f1_nonzeros"].items()])
    f2, f3 = T.DenseMLE.from_evaluations(dim, table("f2")), T.DenseMLE.from_evaluations(dim, table("f3"))
    g = [T.Fr(int(x, 16)) for x in fx["g"]]
    before = [f.launches for f in _init_counters()]
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, g, device=cuda)
    assert tuple(f.launches - b for f, b in zip(_init_counters(), before)) == \
        GKR_INIT_LAUNCHES[mode]
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
    2 (dim - 1) folds and 2 dim transcript steps per prove, the phase-init
    kernels' launches of the path (`GKR_INIT_LAUNCHES`: 2 on every chain
    and fold mode), and proof bytes and the final
    transcript state equal to the CPU's."""
    import random

    counters = _gkr_mode(mode, monkeypatch) + (TC.transcript_step,) + _init_counters()
    dim = 9
    rnd = random.Random(dim)
    f1 = T.SparseMLE.rand_with_config(3 * dim, 3 << dim, rnd)
    f2, f3 = T.DenseMLE.rand(dim, rnd), T.DenseMLE.rand(dim, rnd)
    g = [T.Fr(rnd.randrange(P)) for _ in range(dim)]
    before = [f.launches for f in counters]
    rng = T.Blake2b512Rng.setup()
    proof = T.GKRRoundSumcheck.prove(rng, f1, f2, f3, g, device=cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [2, 2 * (dim - 1), 2 * dim, *GKR_INIT_LAUNCHES[mode]]
    rng_cpu = T.Blake2b512Rng.setup()
    want = T.GKRRoundSumcheck.prove(rng_cpu, f1, f2, f3, g, device="cpu")
    assert proof.serialize_uncompressed() == want.serialize_uncompressed()
    assert rng.state_tuple() == rng_cpu.state_tuple()
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
    assert sub.verify_subclaim(f1, f2, f3, g)


# ---------------------------------------------------------------------------
# the GKR phase-init kernels (`ops/gkr_init_cuda.py`, `csrc/gkr_init.cu`)
# ---------------------------------------------------------------------------


def _gkr_split(dim, nnz, seed, device, skew=0):
    """An f1 over 3 dim variables with `nnz` random entries (and, with
    `skew`, that many more in x segment 5), split for `device`; f2, f3, g's
    and u's rows."""
    import random

    from sumcheck_tpu_torch.ops import gkr_init as GI

    gen = np.random.default_rng(seed)
    mask = (1 << dim) - 1
    idx = gen.integers(0, 1 << (3 * dim), nnz)
    if skew:
        gy = gen.choice(1 << (2 * dim), skew, replace=False)
        idx = np.concatenate([idx, (gy & mask) | (5 << dim) | ((gy >> dim) << (2 * dim))])
    idx = np.unique(idx)
    rnd = random.Random(seed)
    f1 = T.SparseMLE(3 * dim, idx, L.from_ints([rnd.randrange(P) for _ in idx]))
    if dim <= 18:
        f2, f3 = T.DenseMLE.rand(dim, rnd), T.DenseMLE.rand(dim, rnd)
    else:  # numpy's draws: millions of Python ones would take minutes
        f2, f3 = (T.DenseMLE(dim, t) for t in L.random_tables(gen, dim, 2))
    g, u = ([T.Fr(rnd.randrange(P)) for _ in range(dim)] for _ in range(2))
    split = GI._split_f1_device(f1, dim, device)
    return split, f2.to_device(device), f3.to_device(device), \
        GI.upload(GI._point_rows(g), device), GI.upload(GI._point_rows(u), device)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a split or a plan
        return type(x)(*(_to_cpu(t) for t in x))
    return tuple(_to_cpu(t) for t in x) if isinstance(x, (tuple, list)) else x


@pytest.mark.parametrize("dim,skew", [(9, 0), (14, 0), (18, 0), (9, (1 << 16) + 1)],
                         ids=["dim9", "dim14", "dim18", "skewed"])
def test_gkr_init_kernels_match_plain(cuda, dim, skew):
    """Each GKR phase-init kernel against its plain version on the same
    inputs, with colliding entries (3 a segment on average; one a segment
    at dim 18, the main shape) or one segment of 2^16 + 1 entries (cut into
    chunks across blocks): the fused weight reduce (its blocks building
    eq's half tables from challenge rows with a row stride) in phase 1's
    form (the f3 gather
    and the carry) and phase 2's (over the carry), each into a table, into
    one instance's slice of a batched pair with the pair's other slot from
    the same launch (f2 copied; f3 times the final fold of phase 1's pair)
    and without it, and as a rank's raw sums, then `finish_sums` of them;
    the pair slots (copies, a scale by a
    digit row, by the final fold of a strided one-lane pair, from a dealt
    view, into one instance's slice of a batched pair) and the final fold
    alone; each wrapper counted once a launch, and the long segments'
    scratch left zero."""
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
    from sumcheck_tpu_torch.parallel.mesh import deal

    nnz = (3 << dim) if dim < 18 else 1 << dim
    split, f2, f3, g_r, u_r = _gkr_split(dim, nnz, dim, cuda, skew)
    cpu = _to_cpu((split, f2, f3, g_r, u_r))
    csplit, cf2, cf3, cg, cu = cpu
    assert (split.plan_x.long > 0) == bool(skew)
    counts = [f.launches for f in _init_counters()]
    wide = torch.stack([torch.zeros_like(g_r), g_r], dim=1)[:, 1]  # row stride 32 words
    n, half = 1 << dim, 1 << (dim - 1)
    carry = None
    for phase in (1, 2):
        if phase == 1:
            s, c = split, csplit
            args = (s.gbits, s.vals, wide, dim, s.last_x, s.plan_x)
            cargs = (c.gbits, c.vals, cg, dim, c.last_x, c.plan_x)
            kw = {"f3": f3, "y": s.y_rev, "to_y": s.to_y}
            ckw = {"f3": cf3, "y": c.y_rev, "to_y": c.to_y}
            slot, cslot = (f2, None), (cf2, None)
        else:
            args = (split.x_y, carry, u_r, dim, split.last_y, split.plan_y)
            cargs = (csplit.x_y, carry.cpu(), cu, dim, csplit.last_y, csplit.plan_y)
            kw = ckw = {}
            slot = (f3, (lo[1, :, :, :1], hi[1, :, :, :1], u_r[dim - 1], 1))
            cslot = (cf3, (clo[:, :, :1], chi[:, :, :1], cu[dim - 1], 1))
        table = torch.empty((8, n), dtype=torch.int32, device=cuda)
        got = GK.weight_reduce(*args, table, **kw)
        want = torch.empty((8, n), dtype=torch.int32)
        cgot = GK.weight_reduce_ref(*cargs, want, **ckw)
        assert torch.equal(table.cpu(), want)
        assert (got is None) == (phase == 2)
        if phase == 1:
            assert got.shape == (len(split.gbits), 8) and torch.equal(got.cpu(), cgot)
            carry = got
        bare = torch.zeros((2, 8, half), dtype=torch.int32, device=cuda), \
            torch.zeros((2, 8, half), dtype=torch.int32, device=cuda)
        GK.weight_reduce(*args, bare, **kw)
        assert torch.equal(torch.cat([bare[0][0], bare[1][0]], dim=1).cpu(), want)
        assert not bare[0][1].any() and not bare[1][1].any()
        lo = torch.zeros((3, 2, 8, half), dtype=torch.int32, device=cuda)
        hi = torch.zeros_like(lo)
        GK.weight_reduce(*args, (lo[1], hi[1]), slot=slot, **kw)
        clo, chi = (torch.empty((2, 8, half), dtype=torch.int32) for _ in range(2))
        GK.weight_reduce_ref(*cargs, (clo, chi), slot=cslot, **ckw)
        assert torch.equal(torch.cat([lo[1, 0], hi[1, 0]], dim=1).cpu(), want)
        assert torch.equal(lo[1].cpu(), clo) and torch.equal(hi[1].cpu(), chi)
        assert not lo[[0, 2]].any() and not hi[[0, 2]].any()
        with pytest.raises(ValueError, match="overlaps"):
            GK.weight_reduce(*args, (lo[1], hi[1]),
                             slot=(f3, (lo[1, :, :, :1], hi[1, :, :, :1], u_r[dim - 1], 1)),
                             **kw)
        sums = torch.empty((8, n), dtype=torch.int64, device=cuda)
        GK.weight_reduce(*args, sums, **kw)
        csums = torch.empty((8, n), dtype=torch.int64)
        GK.weight_reduce_ref(*cargs, csums, **ckw)
        assert torch.equal(sums.cpu(), csums)
        twice = torch.empty_like(table)
        GK.finish_sums(sums, twice)
        assert torch.equal(twice, table)
    if skew:
        scratch, arrived = GK._scratch(cuda, 1)
        assert not scratch.any() and not arrived.any()
    # the pair slots
    r_last = u_r[dim - 1]
    lo1 = torch.empty((2, 8, half), dtype=torch.int32, device=cuda)
    hi1 = torch.empty_like(lo1)
    GK.pair_slots(lo1, hi1, ((0, table, None), (1, f2, r_last)))
    clo1, chi1 = torch.empty((2, 8, half), dtype=torch.int32), torch.empty((2, 8, half),
                                                                          dtype=torch.int32)
    GK.pair_slots_ref(clo1, chi1, ((0, want, None), (1, cf2, cu[dim - 1])))
    assert torch.equal(lo1.cpu(), clo1) and torch.equal(hi1.cpu(), chi1)
    fold = (lo1[:, :, :1], hi1[:, :, :1], r_last, 1)
    cfold = (clo1[:, :, :1], chi1[:, :, :1], cu[dim - 1], 1)
    blo = torch.zeros((3, 2, 8, half), dtype=torch.int32, device=cuda)
    bhi = torch.zeros_like(blo)
    GK.pair_slots(blo[2], bhi[2], ((1, f3, "fold"),), fold=fold)
    clo2, chi2 = torch.zeros((2, 8, half), dtype=torch.int32), torch.zeros((2, 8, half),
                                                                          dtype=torch.int32)
    GK.pair_slots_ref(clo2, chi2, ((1, cf3, "fold"),), fold=cfold)
    assert torch.equal(blo[2].cpu(), clo2) and torch.equal(bhi[2].cpu(), chi2)
    assert not blo[:2].any() and not bhi[:2].any()
    f2u = torch.empty(16, dtype=torch.int32, device=cuda)
    GK.pair_slots(None, None, (), fold=fold, fold_out=f2u)
    cf2u = torch.empty(16, dtype=torch.int32)
    GK.pair_slots_ref(None, None, (), fold=cfold, fold_out=cf2u)
    assert torch.equal(f2u.cpu(), cf2u)
    dlo = torch.empty((2, 8, half // 2), dtype=torch.int32, device=cuda)
    dhi = torch.empty_like(dlo)
    GK.pair_slots(dlo, dhi, ((0, deal(table, 1, 2), None), (1, deal(f3, 1, 2), f2u)))
    cdlo, cdhi = torch.empty((2, 8, half // 2), dtype=torch.int32), \
        torch.empty((2, 8, half // 2), dtype=torch.int32)
    GK.pair_slots_ref(cdlo, cdhi, ((0, deal(want, 1, 2), None), (1, deal(cf3, 1, 2), cf2u)))
    assert torch.equal(dlo.cpu(), cdlo) and torch.equal(dhi.cpu(), cdhi)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(_init_counters(), counts)] == [8, 2, 4]


@pytest.mark.parametrize("dim,skew", [(9, 0), (14, 0), (9, (1 << 16) + 1), (21, 0)],
                         ids=["dim9", "dim14", "skewed", "dim21"])
def test_gkr_phase_inits_on_cuda_equal_plain(cuda, dim, skew):
    """Both phases on the kernels (`phase1_pair`, `phase2_pair`: one launch
    each; the per-size `phase1`, `prep1`, `final_fold`, `phase2_digits`,
    `prep2`) equal the torch-op plain versions on the card and, up to dim
    14, the kernels' plain versions on the CPU, with `out=` into a batched
    slice. Dim 21, on 2^16 entries, is the largest build in the blocks'
    shared memory (2^11 + 2^10 lanes) and the largest dim whose 3 dim
    index bits fit f1's int64 indices."""
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    nnz = 3 << dim if dim <= 14 else 1 << 16
    split, f2, f3, g_r, u_r = _gkr_split(dim, nnz, dim + 1, cuda, skew)
    on_cpu = dim <= 14
    if on_cpu:
        csplit, cf2, cf3, cg, cu = _to_cpu((split, f2, f3, g_r, u_r))
    half = 1 << (dim - 1)
    blo = torch.zeros((2, 2, 8, half), dtype=torch.int32, device=cuda)
    bhi = torch.zeros_like(blo)
    counts = [f.launches for f in _init_counters()]
    lo, hi, w = GI.phase1_pair(split, g_r, f3, f2, dim, out=(blo[1], bhi[1]))
    args = (split, w, u_r, f3, dim)
    lo2, hi2 = GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], u_r[dim - 1], *args)
    assert GK.in_block(dim)
    assert [f.launches - c for f, c in zip(_init_counters(), counts)] == [2, 0, 0]
    rlo, rhi, rw = GI.phase1_pair_ref(split, g_r, f3, f2, dim)
    for a, b in ((lo, rlo), (hi, rhi), (w, rw)):
        assert torch.equal(a, b)
    assert not blo[0].any() and not bhi[0].any()
    rlo2, rhi2 = GI.phase2_pair_ref(lo[:, :, :1], hi[:, :, :1], u_r[dim - 1], *args)
    assert torch.equal(lo2, rlo2) and torch.equal(hi2, rhi2)
    if on_cpu:
        clo, chi, cw = GI.phase1_pair(csplit, cg, cf3, cf2, dim)
        for a, c in ((lo, clo), (hi, chi), (w, cw)):
            assert torch.equal(a.cpu(), c)
        clo2, chi2 = GI.phase2_pair(clo[:, :, :1], chi[:, :, :1], cu[dim - 1], csplit, cw, cu,
                                    cf3, dim)
        assert torch.equal(lo2.cpu(), clo2) and torch.equal(hi2.cpu(), chi2)
    hg, w1 = GI.phase1(split, g_r, f3, dim)
    assert all(torch.equal(a, b) for a, b in zip((hg, w1), GI.phase1_ref(split, g_r, f3, dim)))
    assert all(torch.equal(a, b) for a, b in zip(GI.prep1(hg, f2), GI.prep1_ref(hg, f2)))
    f2u = GI.final_fold(lo[:, :, :1], hi[:, :, :1], u_r[dim - 1], 1)
    assert torch.equal(f2u, GI.final_fold_ref(lo[:, :, :1], hi[:, :, :1], u_r[dim - 1], 1))
    f1gu = GI.phase2_digits(split, w, u_r, dim)
    assert torch.equal(f1gu, GI.phase2_digits_ref(split, w, u_r, dim))
    assert all(torch.equal(a, b) for a, b in zip(GI.prep2(f1gu, f3, f2u),
                                                  GI.prep2_ref(f1gu, f3, f2u)))


@pytest.mark.parametrize("size", [2, 4], ids=lambda s: f"S{s}")
def test_dealt_finish_on_cuda_equals_plain(cuda, size):
    """A sharded rank's finish on a dim-14 instance: the weight reduce's
    raw sums rank-major, (S, 8, 2^14 / S) (`ranks` = S), equal to its
    plain version's, then for every rank s `finish_sums` over its block
    [s] of them (what its reduce-scatter hands it), in both slot forms
    (phase 1: its dealt f2 copied into slot 1; phase 2: its dealt f3 times
    the final fold of a one-lane pair), equal to its plain version on the
    CPU, lanes outside the pair untouched; and the rank's pair from the
    phase functions a sharded prover calls (`phase1_pair`, `phase2_pair`
    with `reduce_fn`, given the rank's (S, 8, run) raw sums and returning
    its summed block, and `shard`) equal to `mesh.deal` of the single
    device's pairs; one finish launch a call, no `pair_slots`."""
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
    from sumcheck_tpu_torch.parallel.mesh import deal

    dim = 14
    split, f2, f3, g_r, u_r = _gkr_split(dim, 3 << dim, dim + 2, cuda)
    csplit, _cf2, cf3, cg, cu = _to_cpu((split, f2, f3, g_r, u_r))
    n, half, run = 1 << dim, 1 << (dim - 1), (1 << dim) // size
    sums1, sums2 = (torch.empty((size, 8, run), dtype=torch.int64, device=cuda)
                    for _ in range(2))
    carry = GK.weight_reduce(split.gbits, split.vals, g_r, dim, split.last_x, split.plan_x, sums1,
                             f3, split.y_rev, split.to_y, ranks=size)
    GK.weight_reduce(split.x_y, carry, u_r, dim, split.last_y, split.plan_y, sums2, ranks=size)
    want1, want2 = (torch.empty((size, 8, run), dtype=torch.int64) for _ in range(2))
    GK.weight_reduce_ref(csplit.gbits, csplit.vals, cg, dim, csplit.last_x, csplit.plan_x, want1,
                         cf3, csplit.y_rev, csplit.to_y, ranks=size)
    GK.weight_reduce_ref(csplit.x_y, carry.cpu(), cu, dim, csplit.last_y, csplit.plan_y, want2,
                         ranks=size)
    assert torch.equal(sums1.cpu(), want1) and torch.equal(sums2.cpu(), want2)
    lo1, hi1, w = GI.phase1_pair(split, g_r, f3, f2, dim)
    lo2, hi2 = GI.phase2_pair(lo1[:, :, :1], hi1[:, :, :1], u_r[dim - 1], split, w, u_r, f3, dim)
    fold = (lo1[:, :, :1], hi1[:, :, :1], u_r[dim - 1], 1)
    cfold = _to_cpu(fold[:3]) + (1,)
    counts = [f.launches for f in _init_counters()]
    for s in range(size):
        f2_s, f3_s = deal(f2, s, size).contiguous(), deal(f3, s, size).contiguous()
        for sums, slot in ((sums1, (f2_s, None)), (sums2, (f3_s, fold))):
            lo = torch.full((3, 2, 8, half // size), 7, dtype=torch.int32, device=cuda)
            hi = torch.full_like(lo, 7)
            GK.finish_sums(sums[s], (lo[1], hi[1]), slot=slot)
            clo, chi = (torch.empty((2, 8, half // size), dtype=torch.int32) for _ in range(2))
            GK.finish_sums_ref(sums.cpu()[s], (clo, chi),
                               slot=(slot[0].cpu(), None if slot[1] is None else cfold))
            assert torch.equal(lo[1].cpu(), clo) and torch.equal(hi[1].cpu(), chi)
            assert (lo[[0, 2]] == 7).all() and (hi[[0, 2]] == 7).all()

        def reduce_scattered(total, s=s):
            """Rank s's reduce-scatter of the whole f1's raw sums (one rank's
            partial is the whole sum here): its block, a fresh tensor."""
            def fn(part):
                assert part.shape == (size, 8, run) and part.device == total.device
                return total[s].clone()
            return fn

        for got, whole in ((GI.phase1_pair(split, g_r, f3, f2_s, dim,
                                           reduce_fn=reduce_scattered(sums1),
                                           shard=(s, size))[:2], (lo1, hi1)),
                           (GI.phase2_pair(*fold[:3], split, w, u_r, f3_s, dim,
                                           reduce_fn=reduce_scattered(sums2), shard=(s, size)),
                            (lo2, hi2))):
            for u in range(2):
                want = deal(torch.cat([whole[0][u], whole[1][u]], dim=1), s, size)
                assert torch.equal(torch.cat([got[0][u], got[1][u]], dim=1), want)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(_init_counters(), counts)] == \
        [2 * size, 4 * size, 0]


def test_segment_reduce_long_segment_on_cuda(cuda):
    """One segment of 2^20 + 3 entries (2,049 chunks across blocks) between
    short and empty ones, and one of exactly a tile + 1, through the fused
    kernel in phase 2's form: strict and raw sums equal to the plain
    version, three launches in a row (the last chunk to arrive zeroes the
    scratch for the next), and the scratch zero after."""
    import random

    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    gen = np.random.default_rng(20)
    lengths = np.array([0, 2, (1 << 20) + 3, 0, 70, 1, GK.TILE + 1] + [1] * 250)
    nnz, nseg = int(lengths.sum()), len(lengths)
    last_np = np.cumsum(lengths) - 1
    last = torch.from_numpy(last_np.astype(np.int32))
    plan = GK.upload_plan(last_np, nnz, "cpu")
    assert plan.long == 2
    rows = gen.integers(-(1 << 31), 1 << 31, (nnz, 8), dtype=np.int64).astype(np.int32)
    rows[:, 7] &= (1 << 28) - 1  # below p
    vals = torch.from_numpy(rows)
    idx = torch.from_numpy(gen.integers(0, 1 << 10, nnz).astype(np.int32))
    rnd = random.Random(20)
    r = torch.from_numpy(GI._point_rows([T.Fr(rnd.randrange(P)) for _ in range(10)]))
    args = (idx.to(cuda), vals.to(cuda), r.to(cuda), 10, last.to(cuda),
            GK.Plan(plan.items.to(cuda), plan.long))
    want = torch.empty((8, nseg), dtype=torch.int32)
    GK.weight_reduce_ref(idx, vals, r, 10, last, plan, want)
    wsums = torch.empty((8, nseg), dtype=torch.int64)
    GK.weight_reduce_ref(idx, vals, r, 10, last, plan, wsums)
    for _ in range(3):
        out = torch.empty((8, nseg), dtype=torch.int32, device=cuda)
        GK.weight_reduce(*args, out)
        sums = torch.empty((8, nseg), dtype=torch.int64, device=cuda)
        GK.weight_reduce(*args, sums)
        assert torch.equal(out.cpu(), want) and torch.equal(sums.cpu(), wsums)
    scratch, arrived = GK._scratch(cuda, 2)
    assert not scratch.any() and not arrived.any()


# ---------------------------------------------------------------------------
# the batched provers' kernels: the instance axis and the pair init
# ---------------------------------------------------------------------------


def _batched_pair(seed, batch, slots, nv, device):
    pairs = [_pair(seed + b, slots, nv, device) for b in range(batch)]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _challenges(batch, seed, device):
    gen = np.random.default_rng(seed)
    r = np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)) % P)[:, 0] for _ in range(batch)])
    return torch.from_numpy(r.astype(np.int32)).to(device)


def _batch_coeffs(batch, products, seed, device):
    gen = np.random.default_rng(seed)
    c = np.stack([np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)))[:, 0]
                            for _ in products]) for _ in range(batch)])
    return torch.from_numpy(c.astype(np.int32)).to(device)


# every extent of an nv=8 prove's rounds, then ragged ones
BATCH_EXTENTS = [128 >> j for j in range(8)] + [3, 37, 100]


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("mode", ["nofold", "nofold_coeffs", "fold", "step_fold",
                                  "step_fold_coeffs"])
def test_batched_round_kernels_match_plain(cuda, mode, batch):
    """Each batched round kernel against its plain version (the single plain
    version per instance) at every extent of an nv=8 prove and at ragged
    ones, instance b with its own challenge and coefficients: sums rows and
    tables array-equal, lanes past the extent untouched, and every instance
    equal to its own single-kernel launch."""
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _batched_pair(batch * 10, batch, 6, 9, cuda)  # H = 256
    r = _challenges(batch, batch, cuda)
    coeffs = _batch_coeffs(batch, products, batch + 1, cuda) if mode.endswith("coeffs") else None
    for extent in BATCH_EXTENTS:
        if mode.startswith("step_fold"):
            w = 2 * extent
            l, h = lo[..., :w].contiguous(), hi[..., :w].contiguous()
            (gl, gh), got = RC.round_step_fold_batched(l, h, r, products, 3, coeffs)
            (wl, wh), want = RC.round_step_fold_batched_ref(l.cpu(), h.cpu(), r.cpu(), products,
                                                            3, None if coeffs is None
                                                            else coeffs.cpu())
            torch.cuda.synchronize()
            assert torch.equal(gl.cpu(), wl) and torch.equal(gh.cpu(), wh), extent
            assert torch.equal(got.cpu(), want), extent
            for b in range(batch):
                (sl, sh), single = RC.round_step_fold(l[b].contiguous(), h[b].contiguous(), r[b],
                                                      products, 3,
                                                      None if coeffs is None else coeffs[b])
                assert torch.equal(single, got[b]) and torch.equal(sl, gl[b]), (extent, b)
            continue
        fold = mode == "fold"
        l1, h1 = lo.clone(), hi.clone()
        l2, h2 = lo.cpu(), hi.cpu()
        if fold:
            got = RC.round_fold_batched(l1, h1, r, products, 3, extent)
            want = RC.round_fold_batched_ref(l2, h2, r.cpu(), products, 3, extent)
        else:
            got = RC.round_nofold_batched(l1, h1, products, 3, extent, coeffs=coeffs)
            want = RC.round_nofold_batched_ref(l2, h2, products, 3, extent,
                                               coeffs=None if coeffs is None else coeffs.cpu())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), extent
        assert torch.equal(l1.cpu(), l2) and torch.equal(h1.cpu(), h2), extent
        if fold:
            assert torch.equal(l1[..., extent:], lo[..., extent:]), extent
        for b in range(batch):
            ls, hs = lo[b].clone(), hi[b].clone()
            if fold:
                single = RC.round_fold(ls, hs, r[b], products, 3, extent)
            elif coeffs is None:
                single = RC.round_nofold(ls, hs, products, 3, extent)
            else:
                single = RC.round_step_nofold(ls[..., :extent].contiguous(),
                                              hs[..., :extent].contiguous(), products, 3,
                                              coeffs[b])
            assert torch.equal(single, got[b]), (extent, b)


@pytest.mark.parametrize("degree", [1, 3, 5])
def test_batched_round_kernels_other_degrees(cuda, degree):
    """The register body (degree <= 4) and the ladder body (above) of round
    0 and the fold, batched, with coefficients, against the plain versions."""
    products = ((0, 1), (2, 1)) if degree <= 2 else (tuple(range(degree)),
                                                     tuple(range(degree - 1, -1, -1)))
    slots = max(max(p) for p in products) + 1
    lo, hi = _batched_pair(degree, 3, slots, 8, cuda)
    r = _challenges(3, degree, cuda)
    coeffs = _batch_coeffs(3, products, degree, cuda)
    got = RC.round_nofold_batched(lo, hi, products, degree, 77, coeffs=coeffs)
    want = RC.round_nofold_batched_ref(lo.cpu(), hi.cpu(), products, degree, 77,
                                       coeffs=coeffs.cpu())
    assert torch.equal(got.cpu(), want)
    (gl, _gh), got = RC.round_step_fold_batched(lo, hi, r, products, degree, coeffs)
    (wl, _wh), want = RC.round_step_fold_batched_ref(lo.cpu(), hi.cpu(), r.cpu(), products,
                                                     degree, coeffs.cpu())
    assert torch.equal(got.cpu(), want) and torch.equal(gl.cpu(), wl)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_transcript_matches_plain(cuda, batch):
    """The batched transcript step against the plain step per transcript,
    over 30 rounds from unequal pending-byte counts (each block reads its
    own): messages, challenges and final states array-equal, and each
    instance equal to the single kernel's run."""
    degree = 3
    gen = np.random.default_rng(batch)
    rngs = []
    for b in range(batch):
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(bytes(range(8 * ((5 * b) % 17))))
        rngs.append(rng)
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcripts

    state = lift_transcripts(rngs, cuda)
    state_p, state_s = state.cpu(), state.clone()
    rounds = 30
    sums = torch.from_numpy(gen.integers(0, 1 << 40, size=(rounds, batch, degree + 1, 16),
                                         dtype=np.int64)).to(cuda)
    msgs = torch.empty((rounds, batch, 16, degree + 1), dtype=torch.int32, device=cuda)
    rs = torch.empty((rounds, batch, 16), dtype=torch.int32, device=cuda)
    msgs_p, rs_p = torch.empty_like(msgs).cpu(), torch.empty_like(rs).cpu()
    for j in range(rounds):
        TC.transcript_step_batched(state, sums[j], msgs, rs, j)
        TC.transcript_step_batched_ref(state_p, sums[j].cpu(), msgs_p, rs_p, j)
    torch.cuda.synchronize()
    assert torch.equal(state.cpu(), state_p)
    assert torch.equal(msgs.cpu(), msgs_p) and torch.equal(rs.cpu(), rs_p)
    for b in range(batch):
        st = state_s[b].clone()
        m = torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=cuda)
        rr = torch.empty((rounds, 16), dtype=torch.int32, device=cuda)
        for j in range(rounds):
            TC.transcript_step(st, sums[j, b].contiguous(), m, rr, j)
        assert torch.equal(st, state[b])
        assert torch.equal(m, msgs[:, b]) and torch.equal(rr, rs[:, b])


@pytest.mark.parametrize("case", ["inplace", "copy", "ones", "unit", "batched_slice",
                                  "zero_copy", "sixteen_slots", "nv1", "nv2", "unaligned"])
def test_pair_init_matches_plain(cuda, case):
    """The pair-init kernel against its plain version: an in-place scaling,
    an appended scaled copy, a ones slot, a unit coefficient, writes into
    one instance's slice of a batched pair, fault F3's copy slot (a scaled
    copy by 0), the 16-slot maximum, half widths of 1 and 2 lanes (the
    one-lane body, as the launch takes it below 4 lanes), and halves not
    16-byte aligned at the four-lane body's shape (the one-lane body too);
    the source tables stay as they were."""
    from sumcheck_tpu_torch.ops import init_cuda as IC

    nv = {"nv1": 1, "nv2": 2}.get(case, 9)
    tables = [_packed(t).to(cuda) for t in _tables(40, nv, 4)]
    before = [t.clone() for t in tables]
    specs = {
        "inplace": ((0, 12345), (1, None), (2, 7), (3, None)),
        "copy": ((0, None), (1, None), (2, None), (3, None), (0, P - 2), (1, 99)),
        "ones": ((0, None), (1, 5), (2, None), (3, None), (None, 1)),
        "unit": ((0, 1), (1, None), (2, 1), (3, 3)),
        "batched_slice": ((0, 11), (1, None), (2, None), (3, 13), (None, 1)),
        "zero_copy": ((0, None), (1, None), (2, None), (3, None), (0, 0)),
        "sixteen_slots": tuple((u % 4, None if u % 3 else u + 1) for u in range(15))
        + ((None, 1),),
    }.get(case, ((0, 3), (1, None), (2, None), (3, None), (1, 5), (None, 1)))
    half = 1 << (nv - 1)
    if case == "batched_slice":
        lo = torch.zeros((3, len(specs), 8, half), dtype=torch.int32, device=cuda)
        hi = torch.zeros_like(lo)
        IC.pair_init(lo[1], hi[1], tables, specs)
        assert not lo[0].any() and not lo[2].any() and not hi[0].any() and not hi[2].any()
        got = (lo[1], hi[1])
    elif case == "unaligned":  # one word past a 16-byte boundary
        words = len(specs) * 8 * half
        buf = torch.empty((2, words + 1), dtype=torch.int32, device=cuda)
        got = tuple(b[1:].view(len(specs), 8, half) for b in buf)
        assert got[0].data_ptr() % 16 and got[1].data_ptr() % 16
        IC.pair_init(got[0], got[1], tables, specs)
    else:
        lo = torch.empty((len(specs), 8, half), dtype=torch.int32, device=cuda)
        got = (lo, torch.empty_like(lo))
        IC.pair_init(got[0], got[1], tables, specs)
    lo_p = torch.empty((len(specs), 8, half), dtype=torch.int32)
    want = (lo_p, torch.empty_like(lo_p))
    IC.pair_init_ref(want[0], want[1], [t.cpu() for t in tables], specs)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert all(torch.equal(a, b) for a, b in zip(tables, before))
    if case == "zero_copy":
        assert not got[0][4].any() and not got[1][4].any()


def test_pair_init_occupancy(cuda):
    """Both pair-init bodies fit several blocks on a multiprocessor."""
    from sumcheck_tpu_torch.ops import init_cuda as IC

    assert IC.blocks_per_sm(True) >= 4 and IC.blocks_per_sm(False) >= 4


# ---------------------------------------------------------------------------
# the fold body: every degree, both sides of kMaxRegisterDegree, the staged
# variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", range(1, 9))
def test_fold_kernels_every_degree(cuda, degree):
    """The in-place fold (`round_fold`) and the out-of-place fold with
    coefficients (`round_step_fold`) at every degree 1-8, the register body
    up to 4 and the ladder body above it, ragged plans of up to 8 factors
    over 9 slots, edge values among the operands, at a ragged extent:
    folded tables and sums equal the plain versions'."""
    rng = np.random.default_rng(degree + 60)
    factors = min(8, max(1, degree - int(rng.integers(0, 2))))
    products = tuple(tuple(int(s) for s in rng.integers(0, 9, factors)) for _ in range(3))
    lo, hi = _edge_pair(degree + 61, 9, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(3 + degree)[:, 0].astype(np.int32)).to(cuda)
    l1, h1, l2, h2 = lo.clone(), hi.clone(), lo.clone(), hi.clone()
    got = RC.round_fold(l1, h1, r, products, degree, 211)
    want = RC.round_fold_ref(l2, h2, r, products, degree, 211)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(l1, l2) and torch.equal(h1, h2)
    c = _coeffs(products, cuda)
    (gl, gh), got = RC.round_step_fold(lo, hi, r, products, degree, c)
    (wl, wh), want = RC.round_step_fold_ref(lo, hi, r, products, degree, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(gl, wl) and torch.equal(gh, wh)


@pytest.mark.parametrize("slots", [1, 6, 16])
@pytest.mark.parametrize("degree", range(1, 5))
def test_fold_staged_variant_matches_plain(cuda, degree, slots):
    """The fold body's yardstick (`ops/fold_staged.py`: the stripes staged
    in shared memory by the block's 16-byte cp.async copies) equals the
    plain version and `round_fold`, at every register degree, from one slot
    to the maximum, at the full extent, a partial last block and one chunk
    of 4 lanes; it refuses extents not a multiple of 4."""
    from sumcheck_tpu_torch.ops import fold_staged as FS

    rng = np.random.default_rng(10 * degree + slots)
    products = tuple(tuple(int(s) for s in rng.integers(0, slots, degree)) for _ in range(2))
    lo, hi = _pair(slots + 80, slots, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(11 * degree)[:, 0].astype(np.int32)).to(cuda)
    for extent in (256, 132, 4):
        runs = []
        for fn in (FS.round_fold_staged, RC.round_fold_ref, RC.round_fold):
            l, h = lo.clone(), hi.clone()
            runs.append((fn(l, h, r, products, degree, extent), l, h))
        torch.cuda.synchronize()
        for sums, l, h in runs[1:]:
            assert torch.equal(runs[0][0], sums), extent
            assert torch.equal(runs[0][1], l) and torch.equal(runs[0][2], h), extent
    with pytest.raises(RuntimeError):  # the variant has no ladder body
        FS.round_fold_staged(lo, hi, r, ((0,) * 5,), 5, 8)
    with pytest.raises(ValueError):
        FS.round_fold_staged(lo, hi, r, products, degree, 129)


def test_fold_occupancy(cuda):
    """`round_fold`'s body at the 2x3 prove's 6 slots holds at least as
    many blocks a multiprocessor as the staged yardstick, whose stage takes
    32 KB of shared memory more a block; a degree past the register bodies
    has none to report."""
    from sumcheck_tpu_torch.ops import fold_staged as FS

    inplace = RC.blocks_per_sm(3, 6)
    assert inplace >= 2 and inplace >= FS.blocks_per_sm(3, 6) >= 1
    assert RC.blocks_per_sm(4, 16) >= 1
    with pytest.raises(ValueError):
        RC.blocks_per_sm(5, 6)


def _batch_polys(seed, batch, nv, coeff_sets=None):
    gen = np.random.default_rng(seed)
    polys = []
    for b in range(batch):
        tabs = _tables(seed * 10 + b, nv, 5)
        cs = coeff_sets[b] if coeff_sets else [int(gen.integers(1, 1 << 62)) for _ in range(3)]
        polys.append(polynomial_from_numpy(nv, tabs, [(cs[0], [0, 1, 2]), (cs[1], [0, 3]),
                                                      (cs[2], [4, 0, 4, 1])]))
    return polys


class _OtherRng:
    def __init__(self):
        self._rng = T.Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def next_u64(self):
        return self._rng.next_u64()


@pytest.mark.parametrize("path", ["generic", "persize", "host", "diverging"])
def test_batched_ml_on_cuda_equals_per_instance(cuda, path, monkeypatch):
    """`BatchedMLSumcheck` on the card against per-instance card proves, on
    both chains (two launches a round for all instances, plus one pair init
    each), the host loop (another transcript) and diverging fold plans
    (coefficient 1 in one instance only): proof bytes, challenges and the
    final transcripts."""
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ops import init_cuda as IC

    monkeypatch.setattr(get_config(), "chain_impl", "persize" if path == "persize" else "generic")
    nv, batch = 9, 3
    coeff_sets = [[5, 1, 9], [1, 5, 9], [7, 7, 7]] if path == "diverging" else None
    polys = _batch_polys(nv, batch, nv, coeff_sets)
    make = _OtherRng if path == "host" else T.Blake2b512Rng.setup
    alone = []
    for p in polys:
        rng = make()
        proof, state = T.MLSumcheck.prove_as_subprotocol(rng, p, device=cuda)
        alone.append((serialize_proof(proof), state.randomness, rng))
    fold = RC.round_step_fold_batched if path in ("persize", "host", "diverging") \
        else RC.round_fold_batched
    counters = (RC.round_nofold_batched, fold, TC.transcript_step_batched, IC.pair_init)
    before = [f.launches for f in counters]
    rngs = [make() for _ in polys]
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, polys, device=cuda)
    want = [1, nv - 1, nv, batch] if path in ("generic", "persize") else [1, nv - 1, 0, batch]
    assert [f.launches - b for f, b in zip(counters, before)] == want
    for (blob, randomness, rng_a), pf, ch, rng in zip(alone, proofs, challenges, rngs):
        assert serialize_proof(pf) == blob and ch == randomness
        if path != "host":
            assert rng.state_tuple() == rng_a.state_tuple()
        assert T.Fr.rand(rng) == T.Fr.rand(rng_a)


def test_batched_gkr_on_cuda_equals_per_instance(cuda):
    """`BatchedGKRRoundSumcheck` on the card against per-instance card
    proves at dim 7: proof bytes and the next draw of every transcript;
    2 dim batched transcript steps for all instances."""
    import random

    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck

    dim, batch = 7, 3
    rnd = random.Random(dim)
    insts = [(T.SparseMLE.rand_with_config(3 * dim, 1 << dim, rnd), T.DenseMLE.rand(dim, rnd),
              T.DenseMLE.rand(dim, rnd), [T.Fr(rnd.randrange(P)) for _ in range(dim)])
             for _ in range(batch)]
    alone_rngs = [T.Blake2b512Rng.setup() for _ in insts]
    alone = [T.GKRRoundSumcheck.prove(r, *i, device=cuda).serialize_uncompressed()
             for r, i in zip(alone_rngs, insts)]
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    before = TC.transcript_step_batched.launches
    batched = (GK.weight_reduce_batched, GK.finish_sums, GK.pair_slots, GK.weight_reduce)
    inits = [f.launches for f in batched]
    rngs = [T.Blake2b512Rng.setup() for _ in insts]
    proofs = BatchedGKRRoundSumcheck.prove(rngs, *(list(t) for t in zip(*insts)), device=cuda)
    assert TC.transcript_step_batched.launches - before == 2 * dim
    # every instance's phase inits into its slice of the batched pair: one
    # launch a phase for all of them (the weight reduce's instance axis), no
    # single launch
    assert [f.launches - b for f, b in zip(batched, inits)] == [2, 0, 0, 0]
    assert [p.serialize_uncompressed() for p in proofs] == alone
    assert [T.Fr.rand(r) for r in rngs] == [T.Fr.rand(r) for r in alone_rngs]


@pytest.mark.parametrize("skew", [0, (1 << 16) + 1], ids=["plans", "skewed"])
def test_batched_weight_reduce_matches_singles_and_plain(cuda, skew):
    """The weight reduce's instance axis: one launch a phase for 3
    instances at dim 9 whose tile plans differ (their entries' counts and
    segments differ; with `skew`, instance 1 also holds one segment of 2^16
    + 1 entries cut across blocks, on its own scratch rows), equal to 3
    single launches and to the plain version: phase 1's pairs and carries,
    phase 2's pairs over each instance's column of (dim, 3, 16) challenge
    rows and the final fold of its own phase-1 pair; the scratch left
    zero."""
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    dim, batch = 9, 3
    inputs = [_gkr_split(dim, (2 + b) << dim, 50 + b, cuda, skew if b == 1 else 0)
              for b in range(batch)]
    splits, f2s, f3s, g_rs, _u = zip(*inputs)
    assert len({len(s.plan_x.items) for s in splits}) == batch
    u = torch.stack([x[4] for x in inputs], dim=1)  # (dim, B, 16)
    shape = (batch, 2, 8, 1 << (dim - 1))
    pairs = {k: [torch.zeros(shape, dtype=torch.int32, device=cuda) for _ in range(4)]
             for k in ("batched", "singles", "plain")}
    counts = [GK.weight_reduce_batched.launches, GK.weight_reduce.launches]
    carries = {"batched": GI.phase1_pairs(splits, g_rs, f3s, f2s, dim, *pairs["batched"][:2])}
    lo, hi = pairs["singles"][:2]
    carries["singles"] = [GI.phase1_pair(s, g, f3, f2, dim, out=(lo[b], hi[b]))[2]
                          for b, (s, f2, f3, g) in enumerate(zip(splits, f2s, f3s, g_rs))]
    lo, hi = pairs["plain"][:2]
    carries["plain"] = GK.weight_reduce_batched_ref([
        GK.Instance(s.gbits, s.vals, g, s.last_x, s.plan_x, (lo[b], hi[b]), f3=f3, y=s.y_rev,
                    to_y=s.to_y, slot=(f2, None))
        for b, (s, f2, f3, g) in enumerate(zip(splits, f2s, f3s, g_rs))], dim)
    lo1, hi1 = pairs["batched"][:2]
    fold = (lo1[:, :, :, :1], hi1[:, :, :, :1])
    GI.phase2_pairs(*fold, u[dim - 1], splits, carries["batched"], u, f3s, dim,
                    *pairs["batched"][2:])
    lo, hi = pairs["singles"][2:]
    for b, (s, f3) in enumerate(zip(splits, f3s)):
        GI.phase2_pair(fold[0][b], fold[1][b], u[dim - 1, b], s, carries["batched"][b], u[:, b],
                       f3, dim, out=(lo[b], hi[b]))
    lo, hi = pairs["plain"][2:]
    GK.weight_reduce_batched_ref([
        GK.Instance(s.x_y, carries["batched"][b], u[:, b], s.last_y, s.plan_y, (lo[b], hi[b]),
                    slot=(f3, (fold[0][b], fold[1][b], u[dim - 1, b], 1)))
        for b, (s, f3) in enumerate(zip(splits, f3s))], dim)
    torch.cuda.synchronize()
    assert [GK.weight_reduce_batched.launches - counts[0],
            GK.weight_reduce.launches - counts[1]] == [2, 2 * batch]
    for kind in ("singles", "plain"):
        assert all(torch.equal(a, b) for a, b in zip(pairs["batched"], pairs[kind])), kind
        assert all(torch.equal(a, b) for a, b in zip(carries["batched"], carries[kind])), kind
    assert all(p.any() for p in pairs["batched"])
    scratch, arrived = GK._scratch(cuda, 1)
    assert not scratch.any() and not arrived.any()


@pytest.mark.parametrize("batch", [1, 8, 9, 254, 255, 300])
def test_batched_weight_reduce_every_route(cuda, batch):
    """The batched weight reduce at every launch route that B picks: the
    parameter capacities 8 and BATCH_CAP (254) at and past each edge, and
    past BATCH_CAP the few launches of `batch_launches` (255, 300). The
    B instances at dim 6 cycle over five f1s whose tile plans differ, one
    with a segment of 1,100 entries cut across blocks (each repeat on its
    own scratch rows). Both phases equal the plain version and B single
    launches, pairs and carries; one launch a phase where one launch's
    parameters hold the batch, else one a `batch_launches` run; the
    scratch left zero."""
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    dim, kinds = 6, 5
    bases = [_gkr_split(dim, (2 + b) << dim, 60 + b, cuda, 1100 if b == 1 else 0)
             for b in range(kinds)]
    assert bases[1][0].plan_x.long == 1 and len({len(x[0].plan_x.items) for x in bases}) > 1
    inputs = [bases[b % kinds] for b in range(batch)]
    splits, f2s, f3s, g_rs, _u = zip(*inputs)
    u = torch.stack([x[4] for x in inputs], dim=1)  # (dim, B, 16)
    shape = (batch, 2, 8, 1 << (dim - 1))
    pairs = {k: [torch.zeros(shape, dtype=torch.int32, device=cuda) for _ in range(4)]
             for k in ("batched", "singles")}
    before = GK.weight_reduce_batched.launches
    carries = {"batched": GI.phase1_pairs(splits, g_rs, f3s, f2s, dim, *pairs["batched"][:2])}
    lo, hi = pairs["singles"][:2]
    carries["singles"] = [GI.phase1_pair(s, g, f3, f2, dim, out=(lo[b], hi[b]))[2]
                          for b, (s, f2, f3, g) in enumerate(zip(splits, f2s, f3s, g_rs))]
    lo1, hi1 = pairs["batched"][:2]
    fold = (lo1[:, :, :, :1], hi1[:, :, :, :1])
    GI.phase2_pairs(*fold, u[dim - 1], splits, carries["batched"], u, f3s, dim,
                    *pairs["batched"][2:])
    lo, hi = pairs["singles"][2:]
    for b, (s, f3) in enumerate(zip(splits, f3s)):
        GI.phase2_pair(fold[0][b], fold[1][b], u[dim - 1, b], s, carries["batched"][b], u[:, b],
                       f3, dim, out=(lo[b], hi[b]))
    torch.cuda.synchronize()
    runs = len(GK.batch_launches(batch))
    assert GK.weight_reduce_batched.launches - before == 2 * runs
    assert (runs == 1) == (batch <= GK.BATCH_CAP)
    assert all(torch.equal(a, b) for a, b in zip(pairs["batched"], pairs["singles"]))
    assert all(torch.equal(a, b) for a, b in zip(carries["batched"], carries["singles"]))
    # the plain version, once a kind of instance
    for b in range(min(batch, kinds)):
        s, f2, f3, g, _ur = bases[b]
        plo, phi = (torch.zeros((2, 8, 1 << (dim - 1)), dtype=torch.int32, device=cuda)
                    for _ in range(2))
        [w] = GK.weight_reduce_batched_ref([GK.Instance(
            s.gbits, s.vals, g, s.last_x, s.plan_x, (plo, phi), f3=f3, y=s.y_rev, to_y=s.to_y,
            slot=(f2, None))], dim)
        qlo, qhi = (torch.zeros_like(plo) for _ in range(2))
        GK.weight_reduce_batched_ref([GK.Instance(
            s.x_y, w, u[:, b], s.last_y, s.plan_y, (qlo, qhi),
            slot=(f3, (plo[:, :, :1], phi[:, :, :1], u[dim - 1, b], 1)))], dim)
        for c in range(b, batch, kinds):
            assert torch.equal(carries["batched"][c], w), c
            got = [t[c] for t in pairs["batched"]]
            assert all(torch.equal(x, y) for x, y in zip(got, (plo, phi, qlo, qhi))), c
    scratch, arrived = GK._scratch(cuda, 1)
    assert not scratch.any() and not arrived.any()


# --- the multi-device provers on the card: S = 2 ranks


def _sharded_instances():
    """The ML (nv=10), batch (4 x nv=10) and GKR (dim 6) instances of the
    sharded card tests, rebuilt the same in every process."""
    import random

    nv = 10
    poly = polynomial_from_numpy(nv, _tables(21, nv, 5),
                                 [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    rnd = random.Random(6)
    gkr = (T.SparseMLE.rand_with_config(18, 40, rnd), T.DenseMLE.rand(6, rnd),
           T.DenseMLE.rand(6, rnd), [T.Fr(rnd.randrange(P)) for _ in range(6)])
    return poly, _batch_polys(22, 4, nv), gkr


def _sharded_rank(rank, size, init_file, backend, out_file):
    """One rank of `test_sharded_on_cuda_equals_single_card`: proves the
    three instances in a `backend` group and writes what it got."""
    import json

    import torch.distributed as dist

    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.parallel import ChainedShardedProver, ShardedGKRProver, comm

    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        poly, polys, gkr = _sharded_instances()
        ml = ChainedShardedProver.auto(size, device="cuda")
        for cls in (ChainedShardedProver, ShardedGKRProver):
            with pytest.raises(T.SumcheckError, match="ranks"):
                cls.auto(2 * size, device="cuda")
        if backend == "nccl":
            torch.cuda.set_device(ml.device)
        launches = (RC.round_nofold.launches, RC.round_fold.launches)
        rng = T.Blake2b512Rng.setup()
        proof, _state = ml.prove_as_subprotocol(rng, poly)
        launches = [f.launches - b for f, b in zip((RC.round_nofold, RC.round_fold), launches)]
        grng = T.Blake2b512Rng.setup()
        gproof = ShardedGKRProver.auto(size, device="cuda").prove(grng, *gkr)
        proofs = BatchedMLSumcheck.prove(polys, device="cuda", group=ml.group)
        torch.cuda.synchronize()
        with open(out_file.format(rank), "w") as f:
            json.dump({"device": str(ml.device), "launches": launches,
                       "collectives": comm.all_reduce_sum_.calls,
                       "reduce_scatters": comm.reduce_scatter_sum_.calls,
                       "ml": [serialize_proof(proof).hex(), repr(rng.state_tuple())],
                       "gkr": [gproof.serialize_uncompressed().hex(), repr(grng.state_tuple())],
                       "batch": [serialize_proof(p).hex() for p in proofs]}, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_on_cuda_equals_single_card(cuda, backend, tmp_path):
    """Two ranks (gloo: both on card 0; NCCL: one card each, so it skips
    with fewer than two cards) prove the sharded ML nv=10, GKR dim 6 and
    batch 4 x nv=10 on the card, the provers made by `.auto(2)` (`.auto(4)`
    raises): proof bytes and final transcripts equal
    to the single-card proves, on both ranks; each rank ran round 0 once
    and nv - 1 folds (the sharded ones and the tail), and the GKR inits
    exchanged their raw sums by one reduce-scatter a phase."""
    import json

    import torch.multiprocessing as mp

    from sumcheck_tpu_torch.batch import BatchedMLSumcheck

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL takes one card a rank: {torch.cuda.device_count()} card(s) here")
    poly, polys, gkr = _sharded_instances()
    rng, grng = T.Blake2b512Rng.setup(), T.Blake2b512Rng.setup()
    want = {"ml": [serialize_proof(T.MLSumcheck.prove_as_subprotocol(rng, poly,
                                                                     device=cuda)[0]).hex(),
                   repr(rng.state_tuple())],
            "gkr": [T.GKRRoundSumcheck.prove(grng, *gkr, device=cuda).serialize_uncompressed()
                    .hex(), repr(grng.state_tuple())],
            "batch": [serialize_proof(p).hex() for p in BatchedMLSumcheck.prove(polys, device=cuda)]}
    out_file = str(tmp_path / "rank{}.json")
    mp.spawn(_sharded_rank, args=(2, str(tmp_path / "init"), backend, out_file), nprocs=2)
    for rank in range(2):
        with open(out_file.format(rank)) as f:
            got = json.load(f)
        assert got["device"] == ("cuda:0" if backend == "gloo" else f"cuda:{rank}")
        assert got["launches"] == [1, poly.num_variables - 1]
        # all-reduces, ML: 9 sharded rounds and the gather; GKR: per phase
        # 5 sharded rounds and the gather; the batch: one gather. GKR's
        # inits: one reduce-scatter a phase
        assert got["collectives"] == 10 + 2 * 6 + 1
        assert got["reduce_scatters"] == 2
        assert {k: got[k] for k in want} == want


def _reduce_scatter_rank(rank, size, init_file, backend, out_file):
    """One rank of `test_reduce_scatter_on_cuda`: `comm.reduce_scatter_sum_`
    of its (S, 8, 3000) int64 blocks on its card, written out."""
    import json

    import torch.distributed as dist

    from sumcheck_tpu_torch.parallel import comm

    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        blocks = _rs_blocks(rank, size)
        t = torch.from_numpy(blocks).to(device)
        out = comm.reduce_scatter_sum_(t, dist.group.WORLD)
        again = comm.reduce_scatter_sum_(t, dist.group.WORLD)
        torch.cuda.synchronize()
        with open(out_file.format(rank), "w") as f:
            json.dump({"device": str(out.device), "input_device": str(t.device),
                       "input_kept": bool(np.array_equal(t.cpu().numpy(), blocks)),
                       "again": bool(torch.equal(out, again)),
                       "sums": out.cpu().numpy().tolist(),
                       "counts": [comm.reduce_scatter_sum_.calls, comm.reduce_scatter_sum_.bytes,
                                  comm.reduce_scatter_sum_.received]}, f)
    finally:
        dist.destroy_process_group()


def _rs_blocks(rank: int, size: int) -> np.ndarray:
    return np.random.default_rng(70 + rank).integers(-(1 << 40), 1 << 40, size=(size, 8, 3000),
                                                     dtype=np.int64)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_reduce_scatter_on_cuda(cuda, backend, tmp_path):
    """`comm.reduce_scatter_sum_` over CUDA tensors at S = 2, one call on
    the card's tensor itself: gloo (both ranks on card 0; gloo takes the
    tensor through the host) and NCCL (one card a rank, so it skips with
    fewer than two cards). Each rank gets the exact sum of every rank's
    block [rank] on its own card, twice alike, its input unchanged, the
    calls and bytes counted."""
    import json

    import torch.multiprocessing as mp

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL takes one card a rank: {torch.cuda.device_count()} card(s) here")
    out_file = str(tmp_path / "rank{}.json")
    mp.spawn(_reduce_scatter_rank, args=(2, str(tmp_path / "init"), backend, out_file),
             nprocs=2)
    for rank in range(2):
        with open(out_file.format(rank)) as f:
            got = json.load(f)
        assert got["device"] == got["input_device"] == ("cuda:0" if backend == "gloo"
                                                        else f"cuda:{rank}")
        assert got["input_kept"] and got["again"]
        want = sum(_rs_blocks(r, 2)[rank] for r in range(2))
        np.testing.assert_array_equal(np.array(got["sums"], dtype=np.int64), want)
        assert got["counts"] == [2, 2 * 8 * 2 * 8 * 3000, 2 * 8 * 8 * 3000]


# ---------------------------------------------------------------------------
# the round-by-round prover: the interactive tier, the GKR host-transcript
# branch, the GKR init wrappers, ShardedProver and the rooflines
# ---------------------------------------------------------------------------


class _ForeignRng:
    """A transcript other than `Blake2b512Rng`, with the same bytes."""

    def __init__(self, prefix=b""):
        self.inner = T.Blake2b512Rng.setup()
        self.inner.feed_bytes(prefix)

    def feed(self, msg):
        self.inner.feed(msg)

    def next_u64(self):
        return self.inner.next_u64()


def _interactive(poly, device):
    """Every round of the interactive tier over a host transcript; returns
    (messages, the final tables)."""
    st = T.IPForMLSumcheck.prover_init(poly, device=device)
    rng, v, msgs = T.Blake2b512Rng.setup(), None, []
    for _ in range(poly.num_variables):
        msgs.append(T.IPForMLSumcheck.prove_round(st, v).serialize_uncompressed())
        rng.feed_bytes(msgs[-1])
        v = T.IPForMLSumcheck.sample_round(rng)
    return msgs, st.flattened_ml_extensions


def test_interactive_tier_on_cuda_equals_cpu(cuda, monkeypatch):
    """`prover_init(device=cuda)` launches the pair init, round 0 the
    no-fold kernel and every later round the fold kernel, with one
    `finish_sums` a round; messages and final tables equal the CPU's."""
    from sumcheck_tpu_torch.ops import init_cuda as IC

    nv = 12
    poly = polynomial_from_numpy(nv, _tables(31, nv, 5),
                                 [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    syncs = []
    real = RC.finish_sums
    monkeypatch.setattr(RC, "finish_sums", lambda s: syncs.append(s.device) or real(s))
    counters = (IC.pair_init, RC.round_nofold, RC.round_fold)
    before = [f.launches for f in counters]
    msgs, tables = _interactive(poly, cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, nv - 1]
    assert syncs == [cuda] * nv
    want_msgs, want_tables = _interactive(poly, "cpu")
    assert msgs == want_msgs
    assert all(np.array_equal(a, b) for a, b in zip(tables, want_tables))


@pytest.mark.parametrize("transcript", ["unaligned", "foreign"])
def test_gkr_host_transcript_on_cuda_equals_cpu(cuda, transcript):
    """The GKR prove over a transcript the chain cannot lift runs the round
    kernels on the card (2 round-0 launches and 2 (dim - 1) folds, no
    transcript step), byte-equal to the CPU's, the transcript too."""
    import random

    dim = 8
    rnd = random.Random(dim)
    inst = (T.SparseMLE.rand_with_config(3 * dim, 3 << dim, rnd), T.DenseMLE.rand(dim, rnd),
            T.DenseMLE.rand(dim, rnd), [T.Fr(rnd.randrange(P)) for _ in range(dim)])

    def rng():
        if transcript == "foreign":
            return _ForeignRng()
        r = T.Blake2b512Rng.setup()
        r.feed_bytes(b"abc")
        return r

    counters = (RC.round_nofold, RC.round_fold, TC.transcript_step)
    before = [f.launches for f in counters]
    a = rng()
    proof = T.GKRRoundSumcheck.prove(a, *inst, device=cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2 * (dim - 1), 0]
    b = rng()
    want = T.GKRRoundSumcheck.prove(b, *inst, device="cpu")
    assert proof.serialize_uncompressed() == want.serialize_uncompressed()
    assert getattr(a, "inner", a).state_tuple() == getattr(b, "inner", b).state_tuple()


def test_phase_init_wrappers_on_cuda_equal_cpu(cuda):
    import random

    from sumcheck_tpu_torch.ops import gkr_init as GI

    dim = 7
    rnd = random.Random(dim)
    f1 = T.SparseMLE.rand_with_config(3 * dim, 3 << dim, rnd)
    f3 = T.DenseMLE.rand(dim, rnd)
    g, u = ([T.Fr(rnd.randrange(P)) for _ in range(dim)] for _ in range(2))
    h, carry = GI.phase1_init_device(f1.indices, f1.values, f3.evals, g, dim, device=cuda)
    assert carry[1].device == cuda
    h_cpu, carry_cpu = GI.phase1_init_device(f1.indices, f1.values, f3.evals, g, dim,
                                             device="cpu")
    assert np.array_equal(h, h_cpu)
    assert np.array_equal(GI.phase2_init_device(carry, u, dim),
                          GI.phase2_init_device(carry_cpu, u, dim))


def _sharded_prover_rank(rank, size, init_file, out_file):
    """One rank of `test_sharded_prover_on_cuda_equals_single_card`."""
    import json

    import torch.distributed as dist

    from sumcheck_tpu_torch.parallel import ShardedProver, comm

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        poly = _sharded_instances()[0]
        prover = ShardedProver(device="cuda")
        launches = [RC.round_nofold.launches, RC.round_fold.launches]
        out = {}
        for transcript in ("aligned", "foreign"):
            rng = _ForeignRng() if transcript == "foreign" else T.Blake2b512Rng.setup()
            proof, _state = prover.prove_as_subprotocol(rng, poly)
            out[transcript] = [serialize_proof(proof).hex(),
                               repr(getattr(rng, "inner", rng).state_tuple())]
        out["launches"] = [RC.round_nofold.launches - launches[0],
                           RC.round_fold.launches - launches[1]]
        out["collectives"] = comm.all_reduce_sum_.calls
        out["device"] = str(prover.device)
        with open(out_file.format(rank), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_sharded_prover_on_cuda_equals_single_card(cuda, tmp_path):
    """`ShardedProver` with two gloo ranks on card 0, over a `Blake2b512Rng`
    and a transcript of another class: proofs and final transcripts equal
    to the single card's, on both ranks; per prove round 0 once and nv - 1
    folds, nv - 1 all-reduces and one gather a rank."""
    import json

    import torch.multiprocessing as mp

    poly = _sharded_instances()[0]
    rng = T.Blake2b512Rng.setup()
    proof, _ = T.MLSumcheck.prove_as_subprotocol(rng, poly, device=cuda)
    want = [serialize_proof(proof).hex(), repr(rng.state_tuple())]
    out_file = str(tmp_path / "rank{}.json")
    mp.spawn(_sharded_prover_rank, args=(2, str(tmp_path / "init"), out_file), nprocs=2)
    nv = poly.num_variables
    for rank in range(2):
        with open(out_file.format(rank)) as f:
            got = json.load(f)
        assert got["device"] == "cuda:0"
        assert got["aligned"] == got["foreign"] == want
        assert got["launches"] == [2, 2 * (nv - 1)]
        assert got["collectives"] == 2 * nv


def test_measure_roofline_on_cuda(cuda, tmp_path, monkeypatch):
    """Both rates measured on the card, finite and positive, with its name
    and power limit; kept in the build directory and read back."""
    import math

    from sumcheck_tpu_torch.ops import cuda_build
    from sumcheck_tpu_torch.utils import sol

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    roof = sol.measure_roofline(cuda)
    for key in ("mont_muls_per_s", "hbm_bytes_per_s"):
        assert math.isfinite(roof[key]) and roof[key] > 0
    assert torch.cuda.get_device_name(cuda) in roof["card"]
    assert (tmp_path / "sol_roofline.json").exists()
    assert sol.measure_roofline(cuda) == roof
    share = sol.sol_seconds(sol.count_prove_ops(10, 6, 2, 3, 3), roof)
    assert share["sol_s"] > 0


# ---------------------------------------------------------------------------
# the entry point, the multi-rank dry run and the microbench
# ---------------------------------------------------------------------------


def test_entry_on_cuda_equals_cpu(cuda):
    """`entry()`'s round on the card, one `round_fold` launch, equals
    `entry(device="cpu")`'s: folded tables and sums."""
    from sumcheck_tpu_torch import entry as E

    fn, args = E.entry(cuda)
    before = RC.round_fold.launches
    folded, sums = fn(*args)
    assert RC.round_fold.launches - before == 1
    assert folded.device == cuda
    cpu_fn, cpu_args = E.entry("cpu")
    want_folded, want_sums = cpu_fn(*cpu_args)
    assert torch.equal(folded.cpu(), want_folded)
    assert np.array_equal(sums, want_sums)


def test_dryrun_multichip_on_cuda(cuda):
    """`dryrun_multichip(2)` on the card: every rank checked its three cases
    against its single-card proves (a mismatch raises), on a card, through
    the round and transcript kernels; the proofs equal the CPU dry run's."""
    from sumcheck_tpu_torch import entry as E

    res = E.dryrun_multichip(2)
    assert res["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    for rank in res["ranks"]:
        assert rank["device"].startswith("cuda")
        launches = rank["launches"]  # each sharded prove's own
        assert launches["sp"]["round_fold"] and not launches["sp"]["transcript_step"]
        assert launches["chained"]["round_fold"] and launches["chained"]["transcript_step"]
        assert launches["gkr"]["round_fold"] and launches["gkr"]["transcript_step"]
        assert launches["batch"]["round_fold_batched"]
        assert launches["batch"]["transcript_step_batched"]
    cpu = E.dryrun_multichip(2, device="cpu")
    assert all(res[k] == cpu[k] for k in ("ml", "gkr", "batch"))


def test_microbench_on_cuda(cuda, tmp_path):
    """The microbench at nv=12 on the card, in a process of its own as a
    user runs it (`python -m sumcheck_tpu_torch.microbench 12`; in a
    process that has spawned ranks on the card the profiler drops device
    records): every probe checked and every stage measured, with launches,
    busy time and bound, and device time wherever the sleep held the stream
    (not for the syncing full prove)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from sumcheck_tpu_torch import microbench as MB

    out = tmp_path / "microbench.json"
    subprocess.run([sys.executable, "-m", "sumcheck_tpu_torch.microbench", "12", "--reps", "1",
                    "--out", str(out)], cwd=Path(__file__).resolve().parent.parent, check=True,
                   timeout=600)
    res = json.loads(out.read_text())
    assert tuple(res["probes"]) == MB.PROBES and tuple(res["stages"]) == MB.STAGES
    assert torch.cuda.get_device_name(cuda) in res["card"]
    for name, m in {**res["probes"], **res["stages"]}.items():
        assert m["host_ms"] > 0 and m["busy_ms"] is not None and m["bound_ms"] is not None, name
        if name == "full_prove":
            assert m["device_ms"] is None and m["held"] is None
        else:
            assert (m["device_ms"] is None) == (m["held"] is False), name
    for name in ("rtt", "compress", "challenge", "mont_nnz_eo"):
        assert res["probes"][name]["launches"] == 1, name
        assert res["probes"][name]["device_ms"] > 0, name
    assert res["probes"]["compress"]["clocks"] > 0
    stages = [res["stages"][name]["launches"] for name in MB.STAGES]
    assert stages[0] > 0 and stages == sorted(stages)  # cumulative prefixes


# ---------------------------------------------------------------------------
# fault F4 on the card: the wide route of every kernel
# ---------------------------------------------------------------------------


def _f4_poly(name: str, nv: int, seed: int = 0):
    """F4's structure `name` (`tests/f4_cases.py`; "chunk" its
    `chunk_structure`, past the wide route's first chunk) over random tables
    at `nv`."""
    from f4_cases import chunk_structure, f4_structure

    _nv, products, count = chunk_structure() if name == "chunk" else f4_structure(name)
    return polynomial_from_numpy(nv, _tables(seed, nv, count), products)


def _ones_slot(lo, hi, products) -> None:
    """Slot `products.ones` of a (U, 8, H) or (B, U, 8, H) pair set to the
    Montgomery one in every lane, as the pair init leaves it: what a
    `Products` that names it claims."""
    if getattr(products, "ones", None) is None:
        return
    one = _packed(L.from_ints([(1 << 256) % P], mont=False)).to(lo.device)  # (8, 1)
    lo[..., products.ones, :, :] = one
    hi[..., products.ones, :, :] = one


def _wide_plan(name: str):
    """The fold plan's (slots, products, degree) of an F4 structure: each
    past the by-value plan's maxima."""
    from sumcheck_tpu_torch.protocol.device_prover import _fold_plan

    poly = _f4_poly(name, 1)
    products, _scale, slots, _ones = _fold_plan(poly)
    assert RC.route(slots, products, poly.max_multiplicands) == "wide"
    return slots, products, poly.max_multiplicands


@pytest.mark.parametrize("name", ["a", "b", "c", "wide", "chunk"])
@pytest.mark.parametrize("mode", ["nofold", "nofold_coeffs", "fold", "step_fold",
                                  "step_fold_coeffs", "fold_mxu", "batched_nofold",
                                  "batched_fold", "batched_step_fold"])
def test_wide_round_kernels_match_plain(cuda, mode, name):
    """Every round kernel on the wide route (F4's structures: 17 and 61
    slots, 17 and 41 products, degrees 9 and 20; and degree 17 in two
    chunks) against its plain version at ragged extents: sums and tables
    array-equal. A ragged structure runs twice: with its `Products` over a
    pair whose ones slot holds the one (the padding skipped), and as plain
    tuples over random values there (every factor multiplied)."""
    slots, products_, degree = _wide_plan(name)
    claims = [products_, tuple(products_)] if products_.ones is not None else [products_]
    batch = 3 if mode.startswith("batched") else None
    for extent, products in ((e, c) for e in (1, 100, 128) for c in claims):
        seed = 7 * extent + len(mode)
        if batch:
            lo, hi = _batched_pair(seed, batch, slots, 9, cuda)
            r = _challenges(batch, seed, cuda)
        else:
            lo, hi = _edge_pair(seed, slots, 9, cuda)
            r = torch.from_numpy(L.mont_scalar(seed)[:, 0].astype(np.int32)).to(cuda)
        _ones_slot(lo, hi, products)
        coeffs = _coeffs(products, cuda) if mode.endswith("coeffs") else None
        l1, h1, l2, h2 = lo.clone(), hi.clone(), lo.cpu(), hi.cpu()
        if mode in ("step_fold", "step_fold_coeffs", "batched_step_fold"):
            w = 2 * extent
            l1, h1 = l1[..., :w].contiguous(), h1[..., :w].contiguous()
            l2, h2 = l2[..., :w].contiguous(), h2[..., :w].contiguous()
            if batch:
                (l1, h1), got = RC.round_step_fold_batched(l1, h1, r, products, degree)
                (l2, h2), want = RC.round_step_fold_batched_ref(l2, h2, r.cpu(), products,
                                                                degree)
            else:
                c2 = None if coeffs is None else coeffs.cpu()
                (l1, h1), got = RC.round_step_fold(l1, h1, r, products, degree, coeffs)
                (l2, h2), want = RC.round_step_fold_ref(l2, h2, r.cpu(), products, degree, c2)
        elif mode == "nofold_coeffs":
            l1, h1 = l1[..., :extent].contiguous(), h1[..., :extent].contiguous()
            l2, h2 = l2[..., :extent].contiguous(), h2[..., :extent].contiguous()
            got = RC.round_step_nofold(l1, h1, products, degree, coeffs)
            want = RC.round_step_nofold_ref(l2, h2, products, degree, coeffs.cpu())
        elif mode == "nofold":
            got = RC.round_nofold(l1, h1, products, degree, extent)
            want = RC.round_nofold_ref(l2, h2, products, degree, extent)
        elif mode == "batched_nofold":
            got = RC.round_nofold_batched(l1, h1, products, degree, extent)
            want = RC.round_nofold_batched_ref(l2, h2, products, degree, extent)
        elif mode == "batched_fold":
            got = RC.round_fold_batched(l1, h1, r, products, degree, extent)
            want = RC.round_fold_batched_ref(l2, h2, r.cpu(), products, degree, extent)
        else:
            fn = RC.round_fold_mxu if mode == "fold_mxu" else RC.round_fold
            got = fn(l1, h1, r, products, degree, extent)
            want = RC.round_fold_ref(l2, h2, r.cpu(), products, degree, extent)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), extent
        assert torch.equal(l1.cpu(), l2) and torch.equal(h1.cpu(), h2), extent


@pytest.mark.parametrize("degree", [2, 3, 4, 6, 7, 8, 10, 11, 12, 16, 24])
def test_wide_chunk_boundary_degrees_match_plain(cuda, degree):
    """The wide route at d + 1 = T - 1, T, T + 1 and 2T + 1 for its chunks
    T = 4, 8, 12: a product of d tables and one of d // 2 beside 17 single
    tables (so past the plan's 16 products) with coefficients, the pair
    built by `init_pair` (scaled copies, the ones slot); round 0 with and
    without coefficients, the three folds, the MXU fold and the batched
    fold, each against its plain version, array-equal."""
    from sumcheck_tpu_torch.protocol.device_prover import init_pair

    rows = [list(range(degree)), list(range(max(1, degree // 2)))] + \
        [[degree + i] for i in range(17)]
    nv = 8
    poly = polynomial_from_numpy(nv, _tables(degree, nv, degree + 17),
                                 [(3 + 7 * i, ix) for i, ix in enumerate(rows)])
    lo, hi, products, d = init_pair(poly, cuda)
    assert d == degree and RC.route(lo.shape[0], products, d) == "wide"
    extent = lo.shape[2] // 2 - 3
    r = torch.from_numpy(L.mont_scalar(degree + 5)[:, 0].astype(np.int32)).to(cuda)
    c = _coeffs(products, cuda)
    cases = {
        "nofold": (lambda a, b: RC.round_nofold(a, b, products, d, extent),
                   lambda a, b: RC.round_nofold_ref(a, b, products, d, extent)),
        "nofold_coeffs": (lambda a, b: RC.round_step_nofold(a, b, products, d, c),
                          lambda a, b: RC.round_step_nofold_ref(a, b, products, d, c.cpu())),
        "fold": (lambda a, b: RC.round_fold(a, b, r, products, d, extent),
                 lambda a, b: RC.round_fold_ref(a, b, r.cpu(), products, d, extent)),
        "fold_mxu": (lambda a, b: RC.round_fold_mxu(a, b, r, products, d, extent),
                     lambda a, b: RC.round_fold_ref(a, b, r.cpu(), products, d, extent)),
        "step_fold": (lambda a, b: RC.round_step_fold(a, b, r, products, d, c),
                      lambda a, b: RC.round_step_fold_ref(a, b, r.cpu(), products, d, c.cpu())),
        "batched_fold": (
            lambda a, b: RC.round_fold_batched(a, b, r.expand(2, -1).contiguous(), products,
                                               d, extent),
            lambda a, b: RC.round_fold_batched_ref(a, b, r.cpu().expand(2, -1).contiguous(),
                                                   products, d, extent)),
    }
    for mode, (kernel, plain) in cases.items():
        a, b = (lo, hi) if mode != "batched_fold" else (torch.stack([lo, lo.flip(2)]),
                                                        torch.stack([hi, hi.flip(2)]))
        a1, b1, a2, b2 = a.clone(), b.clone(), a.cpu(), b.cpu()
        got, want = kernel(a1, b1), plain(a2, b2)
        torch.cuda.synchronize()
        if mode == "step_fold":
            (a1, b1), got = got
            (a2, b2), want = want
        assert torch.equal(got.cpu(), want), mode
        assert torch.equal(a1.cpu(), a2) and torch.equal(b1.cpu(), b2), mode


def test_wide_route_is_chosen_by_shape(cuda):
    """Today's maxima take the by-value plan, one past any of them the wide
    route; the main path's 2 x 3 at degree 3 is on the plan route."""
    assert RC.route(6, ((0, 1, 2), (3, 4, 5)), 3) == "plan"
    assert RC.route(RC.MAX_SLOTS, ((0,),) * RC.MAX_PRODUCTS, RC.MAX_DEGREE) == "plan"
    assert RC.route(RC.MAX_SLOTS + 1, ((0,),), 1) == "wide"
    assert RC.route(2, ((0,),) * (RC.MAX_PRODUCTS + 1), 1) == "wide"
    assert RC.route(9, (tuple(range(9)),), 9) == "wide"


@pytest.mark.parametrize("degree", [9, 20, 33])
def test_wide_transcript_matches_host(cuda, degree):
    """The transcript step past degree 8 (its byte stream in dynamic shared
    memory, the elements in turns of 32 threads) from pending fills of 0,
    64 and 128 bytes, over rounds up to the first that rejects a draw:
    messages, challenges and final state equal to the host rng's, the
    first round equal to the plain version's; and the batched step equal to
    the plain one."""
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcripts, restore_transcript

    for blen in (0, 64, 128):
        prefix = bytes(range(128 + blen)) if blen else b""
        gen = np.random.default_rng(1000 * degree + blen)
        sums = gen.integers(0, 1 << 40, size=(200, degree + 1, 16), dtype=np.int64)
        values, draws, host = _host_rounds(prefix, sums, degree)
        rounds = len(values)
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        state = lift_transcript(rng, cuda)
        msgs = torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=cuda)
        rs = torch.empty((rounds, 16), dtype=torch.int32, device=cuda)
        state_p = state.cpu()
        msgs_p, rs_p = torch.empty_like(msgs[:1]).cpu(), torch.empty_like(rs[:1]).cpu()
        sums_d = torch.from_numpy(sums[:rounds]).to(cuda)
        for j in range(rounds):
            TC.transcript_step(state, sums_d[j], msgs, rs, j)
        TC.transcript_step_ref(state_p, torch.from_numpy(sums[0]), msgs_p, rs_p, 0)
        torch.cuda.synchronize()
        assert torch.equal(msgs[0].cpu(), msgs_p[0]) and torch.equal(rs[0].cpu(), rs_p[0])
        m = msgs.cpu().numpy().astype(np.int64)
        r = rs.cpu().numpy().astype(np.int64)
        for j in range(rounds):
            assert [sum(int(m[j, i, t]) << (16 * i) for i in range(16))
                    for t in range(degree + 1)] == values[j], (blen, j)
            assert sum(int(r[j, i]) << (16 * i) for i in range(16)) == draws[j], (blen, j)
        probe = T.Blake2b512Rng.setup()
        restore_transcript(probe, state.cpu())
        assert probe.state_tuple() == host.state_tuple(), blen
    rngs = []
    for b in range(3):
        rngs.append(T.Blake2b512Rng.setup())
        rngs[-1].feed_bytes(bytes(range(8 * (5 * b))))
    state = lift_transcripts(rngs, cuda)
    state_p = state.cpu()
    gen = np.random.default_rng(degree)
    sums = torch.from_numpy(gen.integers(0, 1 << 40, size=(6, 3, degree + 1, 16),
                                         dtype=np.int64)).to(cuda)
    msgs = torch.empty((6, 3, 16, degree + 1), dtype=torch.int32, device=cuda)
    rs = torch.empty((6, 3, 16), dtype=torch.int32, device=cuda)
    msgs_p, rs_p = torch.empty_like(msgs).cpu(), torch.empty_like(rs).cpu()
    for j in range(6):
        TC.transcript_step_batched(state, sums[j], msgs, rs, j)
        TC.transcript_step_batched_ref(state_p, sums[j].cpu(), msgs_p, rs_p, j)
    torch.cuda.synchronize()
    assert torch.equal(state.cpu(), state_p)
    assert torch.equal(msgs.cpu(), msgs_p) and torch.equal(rs.cpu(), rs_p)


def test_transcript_ceiling_is_measured_and_raised(cuda):
    """The step's one ceiling, the degree whose byte stream fills a block's
    opt-in shared memory, lies far past degree 32; one past it raises
    `SumcheckError` naming it, before any launch."""
    top = TC.max_degree(cuda.index)
    assert top > 1000
    before = TC.transcript_step.launches
    state = lift_transcript(T.Blake2b512Rng.setup(), cuda)
    sums = torch.zeros((top + 2, 16), dtype=torch.int64, device=cuda)
    msgs = torch.empty((1, 16, top + 2), dtype=torch.int32, device=cuda)
    rs = torch.empty((1, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(T.SumcheckError, match="ceiling"):
        TC.transcript_step(state, sums, msgs, rs, 0)
    assert TC.transcript_step.launches == before


@pytest.mark.parametrize("slots", [17, 40, 300])
def test_wide_pair_init_matches_plain(cuda, slots):
    """The pair init past 16 slots (its plan staged in device memory):
    copies, scalings, a scaled copy by 0 and a ones slot, at a four-lane
    width and at a one-lane one, against its plain version; the source
    tables stay as they were."""
    from sumcheck_tpu_torch.ops import init_cuda as IC

    for nv in (9, 2):
        tables = [_packed(t).to(cuda) for t in _tables(slots + nv, nv, 5)]
        before = [t.clone() for t in tables]
        specs = tuple((u % 5, None if u % 3 else u + 1) for u in range(slots - 2)) \
            + ((1, 0), (None, 1))
        half = 1 << (nv - 1)
        lo = torch.empty((slots, 8, half), dtype=torch.int32, device=cuda)
        hi = torch.empty_like(lo)
        IC.pair_init(lo, hi, tables, specs)
        lo_p = torch.empty((slots, 8, half), dtype=torch.int32)
        hi_p = torch.empty_like(lo_p)
        IC.pair_init_ref(lo_p, hi_p, [t.cpu() for t in tables], specs)
        torch.cuda.synchronize()
        assert torch.equal(lo.cpu(), lo_p) and torch.equal(hi.cpu(), hi_p), nv
        assert all(torch.equal(a, b) for a, b in zip(tables, before))


@pytest.mark.parametrize("name", ["a", "b", "c", "wide"])
@pytest.mark.parametrize("chain", ["generic", "persize", "mxu"])
def test_f4_prove_on_cuda_equals_cpu(cuda, chain, name, monkeypatch):
    """F4's structures proved on the card on every chain: proof bytes and
    final transcript equal to the CPU's, the proof verifies, and the
    launches are the chain's (no host fallback)."""
    monkeypatch.setattr(get_config(), "chain_impl", "persize" if chain == "persize" else "generic")
    if chain == "mxu":
        monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
        monkeypatch.setattr(get_config(), "ab", True)
    nv = 8
    poly = _f4_poly(name, nv, seed=3)
    counters = {"generic": (RC.round_nofold, RC.round_fold),
                "persize": (RC.round_step_nofold, RC.round_step_fold),
                "mxu": (RC.round_nofold, RC.round_fold_mxu)}[chain] + (TC.transcript_step,)
    before = [f.launches for f in counters]
    rng = T.Blake2b512Rng.setup()
    proof, _state = T.MLSumcheck.prove_as_subprotocol(rng, poly, device=cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, nv - 1, nv]
    rng_cpu = T.Blake2b512Rng.setup()
    proof_cpu, _ = T.MLSumcheck.prove_as_subprotocol(rng_cpu, poly, device="cpu")
    assert serialize_proof(proof) == serialize_proof(proof_cpu)
    assert rng.state_tuple() == rng_cpu.state_tuple()
    sub = T.MLSumcheck.verify(poly.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert poly.evaluate(sub.point) == sub.expected_evaluation


def test_f4_batch_and_interactive_on_cuda_equal_cpu(cuda):
    """F4 (a) as a batch of 3 on the card (two launches a round, one pair
    init each) and on the interactive tier (each round's message and the
    final tables), equal to the CPU's."""
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ops import init_cuda as IC

    nv = 8
    polys = [_f4_poly("a", nv, seed=s) for s in range(3)]
    counters = (RC.round_nofold_batched, RC.round_fold_batched, IC.pair_init)
    before = [f.launches for f in counters]
    got = BatchedMLSumcheck.prove(polys, device=cuda)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, nv - 1, 3]
    want = BatchedMLSumcheck.prove(polys, device="cpu")
    assert [serialize_proof(p) for p in got] == [serialize_proof(p) for p in want]
    msgs, tables = _interactive(polys[0], cuda)
    want_msgs, want_tables = _interactive(polys[0], "cpu")
    assert msgs == want_msgs
    assert all(np.array_equal(a, b) for a, b in zip(tables, want_tables))


# ---------------------------------------------------------------------------
# fault F3 on the card
# ---------------------------------------------------------------------------


def test_zero_coefficient_state_on_cuda_equals_cpu(cuda):
    """F3: 0 x [t0, t1, t2] + c x [t3, t4, t5] at nv=12. The pair-init
    kernel writes the zero product's copy slot (table 0 scaled by 0) and
    leaves the tables; every round's message and `flattened_ml_extensions`
    equal the CPU state's; the proof equals the chained card prove's."""
    nv = 12
    tables = _tables(41, nv, 6)
    poly = polynomial_from_numpy(nv, tables, [(0, [0, 1, 2]), (7, [3, 4, 5])])
    card = T.IPForMLSumcheck.prover_init(poly, device=cuda)
    plain = T.IPForMLSumcheck.prover_init(poly, device="cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.stacked, plain.stacked))
    assert card.stacked[0].shape[0] == 7 and not card.stacked[0][6].any()
    rngs = [T.Blake2b512Rng.setup() for _ in range(2)]
    for rng in rngs:
        rng.feed(poly.info())
    msgs, vs = [], [None, None]
    for _ in range(nv):
        ms = [T.IPForMLSumcheck.prove_round(st, v) for st, v in zip((card, plain), vs)]
        assert ms[0] == ms[1]
        assert all(np.array_equal(a, b) for a, b in zip(card.flattened_ml_extensions,
                                                        plain.flattened_ml_extensions))
        msgs.append(ms[0])
        for rng, m in zip(rngs, ms):
            rng.feed(m)
        vs = [T.IPForMLSumcheck.sample_round(rng) for rng in rngs]
    assert serialize_proof(msgs) == serialize_proof(T.MLSumcheck.prove(poly, device=cuda))


# ---------------------------------------------------------------------------
# every test above under the second prime
# ---------------------------------------------------------------------------

CUDA_TESTS = sorted(n for n in list(globals()) if n.startswith("test_"))


@pytest.fixture(scope="module")
def bn254_outcomes(tmp_path_factory):
    """This file's cuda tests in one child pytest under
    SUMCHECK_TPU_FIELD=bn254_fr: every kernel launched with BN254's p,
    -p^-1 mod 2^32 and shave, against its plain version under the same
    field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_field import child_outcomes

    return child_outcomes(__file__, tmp_path_factory.mktemp("bn254"), "not under_bn254",
                          "-m", "cuda")


@pytest.mark.parametrize("name", CUDA_TESTS)
def test_cuda_under_bn254(cuda, bn254_outcomes, name):
    """Every case of test `name` passed (or skipped as it does under the
    default field: NCCL with one card) in the child under BN254 Fr."""
    from test_torch_field import outcomes_of

    cases = outcomes_of(bn254_outcomes, name)
    assert cases and "passed" in cases.values(), cases
    assert all(v == "passed" or (v.startswith("skipped") and "card" in v)
               for v in cases.values()), cases
