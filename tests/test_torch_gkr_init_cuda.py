"""The GKR phase inits' kernels (`sumcheck_tpu_torch/ops/gkr_init_cuda.py`,
`csrc/gkr_init.cu`) through their plain versions on the CPU, and the
phase functions of `ops/gkr_init.py` built on them, against the JAX
package's phase-init functions (`sumcheck_tpu/ops/gkr_init.py`) on the
same inputs, made with numpy and `random` from a seed.

The JAX functions run eagerly (`jax.disable_jit`: a jit compile of the pair
bodies takes longer on the CPU), at dim 4 with three entries a segment on
average, and the eq half tables at k = 4 and 9. A skewed f1, one segment of
2^16 + 1 entries, is held to Python integers (the naive sums). The file
reruns itself under BN254 Fr in a child pytest (`test_*_under_bn254`);
there the JAX package's `reduce_wide` leaves a segment sum past 3p
unreduced (ROADMAP section 3), so segment sums compare mod p, with the
port's values strict. Tolerance 0 everywhere.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.fields import limbs_jnp as LJ
from sumcheck_tpu.ops import gkr_init as JGI
from sumcheck_tpu_torch.convert import gkr_instance_from_numpy
from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.fields.fr import P, R, R_INV
from sumcheck_tpu_torch.ops import gkr_init as GI
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
from sumcheck_tpu_torch.utils.config import get_config

CPU = torch.device("cpu")
DIM = 4


def _raw(digits) -> list[int]:
    """(16, n) digits -> the integers they hold (Montgomery form), unreduced."""
    d = np.asarray(digits).astype(np.uint64)
    return [sum(int(d[i, j]) << (16 * i) for i in range(16)) for j in range(d.shape[1])]


def _ints(digits) -> list[int]:
    """(16, n) Montgomery digits -> their integers mod p."""
    return [v % P for v in _raw(digits)]


def _limb_ints(limbs) -> list[int]:
    """(8, n) int32 limbs -> their integers, each asserted strict (< p)."""
    out = _raw(L.unpack_limbs(limbs.numpy()))
    assert all(v < P for v in out)
    return out


def _same(port_limbs, jax_digits) -> None:
    """The port's strict limbs equal the JAX package's digits mod p."""
    assert _limb_ints(port_limbs) == _ints(jax_digits)


def _rows(points: list[int]) -> torch.Tensor:
    return torch.from_numpy(GI._point_rows([T.Fr(v) for v in points]))


def _eager(fn, *args):
    with jax.disable_jit():
        return fn(*args)


def _digits(gen, n: int) -> np.ndarray:
    """(16, n) digits of values below p, seeded from `gen`."""
    rnd = random.Random(int(gen.integers(1 << 30)))
    return L.from_ints([rnd.randrange(P) for _ in range(n)])


# ---------------------------------------------------------------------------
# the eq half tables and the weight fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [4, 9])
def test_weight_fold_matches_jax(k):
    """eq_halves + weight_fold = the JAX package's `_weight_fold` (one eq
    table of 2^k lanes, one gather), and the f3 gather's product equals
    the JAX multiply of the same lanes."""
    gen = np.random.default_rng(k)
    nnz = 3 << k
    idx = gen.integers(0, 1 << k, nnz)
    vals = _digits(gen, nnz)
    f3 = _digits(gen, 1 << k)
    y = gen.integers(0, 1 << k, nnz)
    pts = [random.Random(k).randrange(P) for _ in range(k)]
    r_pts, omr_pts = GI._points_arrays([T.Fr(v) for v in pts])
    want = _eager(JGI._weight_fold, jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals),
                  jnp.asarray(r_pts), jnp.asarray(omr_pts), k)
    eq = GK.eq_halves(_rows(pts), k)
    assert eq.shape == (8, (1 << (k - k // 2)) + (1 << (k // 2))) and eq.dtype == torch.int32
    w, wv = GK.weight_fold(torch.from_numpy(idx.astype(np.int32)),
                           torch.from_numpy(L.pack_limbs(vals)), eq, k,
                           torch.from_numpy(y.astype(np.int32)), torch.from_numpy(L.pack_limbs(f3)))
    np.testing.assert_array_equal(L.unpack_limbs(w.numpy()), np.asarray(want))
    wv_want = _eager(LJ.mont_mul, want, jnp.asarray(f3[:, y]))
    np.testing.assert_array_equal(L.unpack_limbs(wv.numpy()), np.asarray(wv_want))
    w2, none = GK.weight_fold(torch.from_numpy(idx.astype(np.int32)),
                              torch.from_numpy(L.pack_limbs(vals)), eq, k)
    assert none is None and torch.equal(w2, w)


def test_eq_halves_factor_the_eq_table():
    """The half tables hold eq over the low kl and the high k - kl
    variables (Python integers), for k = 1 (an empty high half) to 9, from
    challenge rows with a row stride (one column of the batched chain's
    (k, B, 16) rows); lane j of eq is eq_lo[j & m] * eq_hi[j >> kl]."""
    for k in range(1, 10):
        pts = [random.Random(100 + k).randrange(P) for _ in range(k)]
        rows = torch.stack([torch.zeros_like(_rows(pts)), _rows(pts)], dim=1)[:, 1]
        assert rows.stride(0) == 2 * 16
        kl = k - k // 2
        halves = [x * R_INV % P for x in _limb_ints(GK.eq_halves(rows, k))]

        def eq(vars_, j):
            out = 1
            for i, r in enumerate(vars_):
                out = out * (r if (j >> i) & 1 else 1 - r) % P
            return out

        lo, hi = halves[: 1 << kl], halves[1 << kl:]
        assert lo == [eq(pts[:kl], j) for j in range(1 << kl)]
        assert hi == [eq(pts[kl:], j) for j in range(1 << (k - kl))]
        assert [lo[j & ((1 << kl) - 1)] * hi[j >> kl] % P for j in range(1 << k)] == \
            [eq(pts, j) for j in range(1 << k)]


# ---------------------------------------------------------------------------
# the phases against the JAX package's phase functions and pair bodies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    """One dim-4 instance with colliding entries in both packages, phase
    1's challenges g and phase 2's u, and every JAX phase function's output
    on them (eagerly)."""
    rnd = random.Random(41)
    f1 = J.SparseMLE.rand_with_config(3 * DIM, 3 << DIM, rnd)
    f2, f3 = J.DenseMLE.rand(DIM, rnd), J.DenseMLE.rand(DIM, rnd)
    g = [J.Fr(rnd.randrange(P)) for _ in range(DIM)]
    u = [rnd.randrange(P) for _ in range(DIM)]
    t1, t2, t3, tg = gkr_instance_from_numpy(DIM, f1.indices, f1.values, f2.evals, f3.evals,
                                             [x.v for x in g])
    jsp = JGI._split_f1_device(f1, DIM)
    nx, ny = JGI._seg_narrow(f1)
    gr, gomr = (jnp.asarray(a) for a in JGI._points_arrays(g))
    u_dig = np.stack([L.mont_scalar(v)[:, 0] for v in u])
    f3b, f2b = f3.device_bitrev(), f2.device_bitrev()
    with jax.disable_jit():
        hg, w = JGI._compiled_phase1(len(f1.indices), DIM, "off", not nx)(
            jsp[0], jsp[4], jsp[5], jsp[2], jsp[3], gr, gomr, f3b)
        jlo, jhi, jw = JGI._phase1_pair_body(DIM, not nx)(
            jsp[0], jsp[4], jsp[5], jsp[2], jsp[3], gr, gomr, f3b, f2b)
        p1 = JGI._compiled_prep1(DIM)(hg, f2b)
        f2u = JGI._compiled_final_fold(1)(jlo[:, :, :1], jhi[:, :, :1], jnp.asarray(u_dig[-1]))
        f1gu = JGI._compiled_phase2_digits(len(f1.indices), DIM, "off", not ny)(
            jsp[1], jsp[6], jsp[7], w, jnp.asarray(u_dig))
        p2 = JGI._compiled_prep2(DIM)(f1gu, f3b, f2u)
        jlo2, jhi2 = JGI._phase2_pair_body(DIM, not ny)(
            jlo[:, :, :1], jhi[:, :, :1], jnp.asarray(u_dig[-1]), jsp[1], jsp[6], jsp[7], jw,
            jnp.asarray(u_dig), f3b)
    jax_out = {"hg": hg, "w": w, "pair1": (jlo, jhi, jw), "prep1": p1, "f2u": f2u, "f1gu": f1gu,
               "prep2": p2, "pair2": (jlo2, jhi2)}
    split = GI._split_f1_device(t1, DIM, CPU)
    port = {"split": split, "g": GI.upload(GI._point_rows(tg), CPU),
            "u": torch.from_numpy(u_dig.astype(np.int32)), "f2": t2.to_device(CPU),
            "f3": t3.to_device(CPU)}
    return jax_out, port


def _pair_digits(lo, hi) -> list[np.ndarray]:
    """A (2, 8, H) limb pair -> each slot's (16, 2H) digits."""
    return [L.unpack_limbs(torch.cat([lo[u], hi[u]], dim=1).numpy()) for u in range(2)]


def _jax_pair(lo, hi) -> list[np.ndarray]:
    return [np.concatenate([np.asarray(lo)[u], np.asarray(hi)[u]], axis=1) for u in range(2)]


def _phase1(case):
    _j, p = case
    gbits, _x, y_rev, vals, last_x, *_ = p["split"]
    return GI.phase1(gbits, last_x, y_rev, vals, p["g"], p["f3"], DIM)


def test_phase1_matches_jax(case):
    j, _p = case
    hg, w = _phase1(case)
    assert hg.shape == (8, 1 << DIM) and w.dtype == torch.int32
    _same(hg, j["hg"])
    np.testing.assert_array_equal(L.unpack_limbs(w.numpy()), np.asarray(j["w"]))


def test_prep1_matches_jax(case):
    j, p = case
    hg, _w = _phase1(case)
    lo, hi = GI.prep1(hg, p["f2"])
    assert lo.shape == (2, 8, 1 << (DIM - 1)) and lo.is_contiguous()
    got, want = _pair_digits(lo, hi), _jax_pair(*j["prep1"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_phase1_pair_matches_jax_body(case):
    """`phase1_pair` unpacked against `_phase1_pair_body`, fresh and written
    into one instance's slice of a batched pair (`out=`)."""
    j, p = case
    gbits, _x, y_rev, vals, last_x, *_ = p["split"]
    args = (gbits, last_x, y_rev, vals, p["g"], p["f3"], p["f2"], DIM)
    lo, hi, w = GI.phase1_pair(*args)
    jlo, jhi, jw = j["pair1"]
    got, want = _pair_digits(lo, hi), _jax_pair(jlo, jhi)
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(L.unpack_limbs(w.numpy()), np.asarray(jw))
    blo = torch.full((3, 2, 8, 1 << (DIM - 1)), 7, dtype=torch.int32)
    bhi = torch.full_like(blo, 7)
    GI.phase1_pair(*args, out=(blo[1], bhi[1]))
    assert torch.equal(blo[1], lo) and torch.equal(bhi[1], hi)
    assert (blo[[0, 2]] == 7).all() and (bhi[[0, 2]] == 7).all()


def test_final_fold_matches_jax(case):
    j, p = case
    lo, hi, _w = GI.phase1_pair(*_pair1_args(p))
    got = GI.final_fold(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1)
    assert got.dtype == torch.int32 and got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j["f2u"]))


def _pair1_args(p):
    gbits, _x, y_rev, vals, last_x, *_ = p["split"]
    return gbits, last_x, y_rev, vals, p["g"], p["f3"], p["f2"], DIM


def test_phase2_digits_matches_jax(case):
    j, p = case
    _lo, _hi, w = GI.phase1_pair(*_pair1_args(p))
    _g, x, _y, _v, _lx, perm_y, last_y = p["split"]
    f1gu = GI.phase2_digits(x, perm_y, last_y, w, p["u"], DIM)
    assert f1gu.shape == (8, 1 << DIM) and f1gu.dtype == torch.int32
    _same(f1gu, j["f1gu"])


def test_prep2_matches_jax(case):
    """`prep2` against `_compiled_prep2` on the same f1(g, u, .) and f2(u):
    slot 1 = f3 * f2(u)."""
    j, p = case
    f1gu = torch.from_numpy(L.pack_limbs(L.from_ints(_ints(j["f1gu"]), mont=False)))
    lo, hi = GI.prep2(f1gu, p["f3"], torch.from_numpy(np.asarray(j["f2u"]).astype(np.int32)))
    got, want = _pair_digits(lo, hi), _jax_pair(*j["prep2"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_phase2_pair_matches_jax_body(case):
    """`phase2_pair` unpacked against `_phase2_pair_body`, from phase 1's
    one-lane pair (a strided view of the pair), fresh and into `out=`."""
    j, p = case
    lo, hi, w = GI.phase1_pair(*_pair1_args(p))
    _g, x, _y, _v, _lx, perm_y, last_y = p["split"]
    args = (lo[:, :, :1], hi[:, :, :1], p["u"][-1], x, perm_y, last_y, w, p["u"], p["f3"], DIM)
    lo2, hi2 = GI.phase2_pair(*args)
    got, want = _pair_digits(lo2, hi2), _jax_pair(*j["pair2"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    blo = torch.zeros((2, 2, 8, 1 << (DIM - 1)), dtype=torch.int32)
    bhi = torch.zeros_like(blo)
    GI.phase2_pair(*args, out=(blo[1], bhi[1]))
    assert torch.equal(blo[1], lo2) and torch.equal(bhi[1], hi2) and not blo[0].any()


@pytest.mark.parametrize("fold", ["generic", "mxu"])
def test_whole_phase_refs_equal_the_kernels_plain_versions(case, fold, monkeypatch):
    """The torch-op bodies kept as the plain versions of the whole phases
    (`*_ref`; in the MXU fold mode with the banded products at every width,
    their A/B) give the same pairs, weights and tables as the kernels'
    plain versions, bit for bit."""
    if fold == "mxu":
        cfg = get_config()
        monkeypatch.setattr(cfg, "mxu_fold", "kernel")
        monkeypatch.setattr(cfg, "ab", True)
        monkeypatch.setattr(GI, "MXU_MIN_LANES", 1)
    _j, p = case
    args = _pair1_args(p)
    lo, hi, w = GI.phase1_pair(*args)
    rlo, rhi, rw = GI.phase1_pair_ref(*args)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi) and torch.equal(w, rw)
    gbits, x, y_rev, vals, last_x, perm_y, last_y = p["split"]
    hg, w1 = GI.phase1(gbits, last_x, y_rev, vals, p["g"], p["f3"], DIM)
    assert [torch.equal(a, b) for a, b in zip(
        (hg, w1), GI.phase1_ref(gbits, last_x, y_rev, vals, p["g"], p["f3"], DIM))] == \
        [True, True]
    assert all(torch.equal(a, b) for a, b in zip(GI.prep1(hg, p["f2"]),
                                                  GI.prep1_ref(hg, p["f2"])))
    f2u = GI.final_fold(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1)
    assert torch.equal(f2u, GI.final_fold_ref(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1))
    f1gu = GI.phase2_digits(x, perm_y, last_y, w, p["u"], DIM)
    assert torch.equal(f1gu, GI.phase2_digits_ref(x, perm_y, last_y, w, p["u"], DIM))
    assert all(torch.equal(a, b) for a, b in zip(GI.prep2(f1gu, p["f3"], f2u),
                                                  GI.prep2_ref(f1gu, p["f3"], f2u)))
    pair_args = (lo[:, :, :1], hi[:, :, :1], p["u"][-1], x, perm_y, last_y, w, p["u"], p["f3"],
                 DIM)
    assert all(torch.equal(a, b) for a, b in zip(GI.phase2_pair(*pair_args),
                                                  GI.phase2_pair_ref(*pair_args)))


# ---------------------------------------------------------------------------
# the segment reduce: a rank's raw sums, and a skewed f1
# ---------------------------------------------------------------------------


def test_segment_reduce_partials_add_to_the_whole():
    """`segment_reduce` with a `reduce_fn`: the raw (8, nseg) int64 limb
    sums of two halves of the entries, added (as the ranks' all-reduce
    adds them), finish to the whole's strict sums; the sums are exact
    integers (each below 2^56)."""
    gen = np.random.default_rng(5)
    nnz, nseg = 400, 64
    seg = np.sort(gen.integers(0, nseg, nnz))
    seg[seg == 3] = 4  # an empty segment
    vals = torch.from_numpy(L.pack_limbs(_digits(gen, nnz)))
    last = torch.from_numpy((np.searchsorted(seg, np.arange(nseg), side="right") - 1)
                            .astype(np.int32))
    whole = torch.empty((8, nseg), dtype=torch.int32)
    GK.segment_reduce(vals, None, last, whole)
    cut = nnz // 2
    parts = []
    for lo, hi in ((0, cut), (cut, nnz)):
        part_last = torch.from_numpy((np.searchsorted(seg[lo:hi], np.arange(nseg), side="right")
                                      - 1).astype(np.int32))
        parts.append(GK.limb_sums_ref(vals[:, lo:hi].contiguous(), None, part_last))
    assert all(p.dtype == torch.int64 and p.shape == (8, nseg) for p in parts)

    def add_other(sums):
        sums += parts[1]

    got = torch.empty_like(whole)
    half_last = torch.from_numpy((np.searchsorted(seg[:cut], np.arange(nseg), side="right") - 1)
                                 .astype(np.int32))
    GK.segment_reduce(vals[:, :cut].contiguous(), None, half_last, got, add_other)
    assert torch.equal(got, whole)
    ints = _raw(L.unpack_limbs(vals.numpy()))
    assert _limb_ints(whole) == [sum(ints[i] for i in range(nnz) if seg[i] == s) % P
                                 for s in range(nseg)]


def skewed_f1(dim: int, seed: int):
    """A GKR f1 over 3 dim variables whose x segment 5 holds 2^16 + 1
    entries (distinct (g, y) parts) among 2^dim random ones: (indices,
    (16, nnz) digits)."""
    gen = np.random.default_rng(seed)
    mask = (1 << dim) - 1
    gy = gen.choice(1 << (2 * dim), (1 << 16) + 1, replace=False)
    long = (gy & mask) | (5 << dim) | ((gy >> dim) << (2 * dim))
    rest = gen.integers(0, 1 << (3 * dim), 1 << dim)
    idx = np.unique(np.concatenate([long, rest]))
    return idx, _digits(gen, len(idx))


def test_skewed_segment_matches_naive():
    """A segment of 2^16 + 1 entries (past the JAX package's narrow width
    and the kernels' one-thread length): h_g and f1(g, u, .) from the phase
    functions equal Python-integer sums over f1's entries."""
    dim = 9
    idx, vals = skewed_f1(dim, 9)
    rnd = random.Random(9)
    g = [rnd.randrange(P) for _ in range(dim)]
    u = [rnd.randrange(P) for _ in range(dim)]
    f3_vals = [rnd.randrange(P) for _ in range(1 << dim)]
    f1 = GI._HostF1(idx, vals)
    last_x = GI._split_f1_device(f1, dim, CPU)[4].numpy()
    assert np.diff(np.concatenate([[-1], last_x])).max() > 1 << 16  # one x segment's length
    f3 = T.DenseMLE.from_evaluations(dim, f3_vals)
    h, carry = GI.phase1_init_device(idx, vals, f3.evals, [T.Fr(v) for v in g], dim,
                                     device="cpu")
    f1gu = GI.phase2_init_device(carry, [T.Fr(v) for v in u], dim)
    mask = (1 << dim) - 1
    v_int = L.to_ints(vals)  # canonical

    def eq(pts, bits):
        out = 1
        for i, r in enumerate(pts):
            out = out * (r if (bits >> i) & 1 else 1 - r) % P
        return out

    hw, fw = [0] * (1 << dim), [0] * (1 << dim)
    for i, v in zip(idx.tolist(), v_int):
        wg = v * eq(g, i & mask) % P
        hw[(i >> dim) & mask] += wg * f3_vals[i >> (2 * dim)]
        fw[i >> (2 * dim)] += wg * eq(u, (i >> dim) & mask)
    assert _ints(h) == [x * R % P for x in hw] and max(_raw(h)) < P
    assert _ints(f1gu) == [x * R % P for x in fw] and max(_raw(f1gu)) < P


# ---------------------------------------------------------------------------
# every test above under the second prime
# ---------------------------------------------------------------------------

INIT_TESTS = sorted(n for n in list(globals()) if n.startswith("test_"))


@pytest.fixture(scope="module")
def bn254_outcomes(tmp_path_factory):
    from test_torch_field import child_outcomes

    return child_outcomes(__file__, tmp_path_factory.mktemp("bn254"), "not under_bn254")


@pytest.mark.parametrize("name", INIT_TESTS)
def test_gkr_init_under_bn254(bn254_outcomes, name):
    """Every case of test `name` passed in the child under BN254 Fr."""
    from test_torch_field import outcomes_of

    cases = outcomes_of(bn254_outcomes, name)
    assert cases and set(cases.values()) == {"passed"}, cases
