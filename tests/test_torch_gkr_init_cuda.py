"""The GKR phase inits' kernels (`sumcheck_tpu_torch/ops/gkr_init_cuda.py`,
`csrc/gkr_init.cu`) through their plain versions on the CPU, and the
phase functions of `ops/gkr_init.py` built on them, against the JAX
package's phase-init functions (`sumcheck_tpu/ops/gkr_init.py`) on the
same inputs, made with numpy and `random` from a seed.

The JAX functions run eagerly (`jax.disable_jit`: a jit compile of the pair
bodies takes longer on the CPU), at dim 4 and 9 with three entries a segment
on average, and the eq half tables and the fused weight reduce at k = 4 and
9. Phase 1's weights `w` (the carry) are entry-major (nnz, 8) in y order:
row to_y[j] holds the JAX package's column j, and the tests compare them
under that permutation and transpose. The tile plans with long segments
(2^16 + 1 entries, a tile + 1) are walked and held to the naive sums, and a
skewed f1, one segment of 2^16 + 1 entries, to Python integers. The file
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
from sumcheck_tpu_torch.parallel.mesh import deal
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


def _carry_columns(carry: torch.Tensor, to_y: torch.Tensor) -> np.ndarray:
    """The carry, (nnz, 8) limbs in y order -> (16, nnz) digits in x order
    (column j from row to_y[j]), the JAX package's layout of `w`."""
    return L.unpack_limbs(carry.numpy(), axis=1)[to_y.numpy()].T


def _entry_rows(digits) -> torch.Tensor:
    """(16, n) digits -> the (n, 8) int32 entry-major limb rows."""
    return torch.from_numpy(L.pack_limbs(np.asarray(digits).T, axis=1))


# ---------------------------------------------------------------------------
# the eq half tables and the fused weight reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [4, 9])
def test_weight_fold_matches_jax(k):
    """eq's half tables + the weight fold = the JAX package's `_weight_fold` (one
    eq table of 2^k lanes, one gather); `weight_reduce` (which builds the
    half tables from the same challenge rows) in phase 1's form
    (the f3 gather, the carry through a permutation) gives the carry equal
    to it and segment sums equal to `_segment_reduce_sorted` of its product
    with f3, strict, as raw limb sums too, and in phase 2's form (no
    gather) the sums of the weights alone."""
    gen = np.random.default_rng(k)
    nnz = 3 << k
    idx = gen.integers(0, 1 << k, nnz)
    vals = _digits(gen, nnz)
    f3 = _digits(gen, 1 << k)
    y = gen.integers(0, 1 << k, nnz)
    to_y = gen.permutation(nnz)
    seg = np.sort(gen.integers(0, 1 << k, nnz))
    last = np.searchsorted(seg, np.arange(1 << k), side="right") - 1
    pts = [random.Random(k).randrange(P) for _ in range(k)]
    r_pts, omr_pts = GI._points_arrays([T.Fr(v) for v in pts])
    want = _eager(JGI._weight_fold, jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals),
                  jnp.asarray(r_pts), jnp.asarray(omr_pts), k)
    wv_want = _eager(LJ.mont_mul, want, jnp.asarray(f3[:, y]))
    rows = _rows(pts)
    eq = GK.eq_halves_ref(rows, k)
    assert eq.shape == (8, (1 << (k - k // 2)) + (1 << (k // 2))) and eq.dtype == torch.int32
    w_ref, _ = GK.weight_fold_ref(torch.from_numpy(idx.astype(np.int32)),
                                  torch.from_numpy(L.pack_limbs(vals)), eq, k)
    np.testing.assert_array_equal(L.unpack_limbs(w_ref.numpy()), np.asarray(want))
    t_idx, t_last = (torch.from_numpy(a.astype(np.int32)) for a in (idx, last))
    plan = GK.upload_plan(last, nnz, CPU)
    gather = {"f3": torch.from_numpy(L.pack_limbs(f3)), "y": torch.from_numpy(y.astype(np.int32)),
              "to_y": torch.from_numpy(to_y.astype(np.int32))}
    hg = torch.empty((8, 1 << k), dtype=torch.int32)
    carry = GK.weight_reduce(t_idx, _entry_rows(vals), rows, k, t_last, plan, hg, **gather)
    np.testing.assert_array_equal(_carry_columns(carry, gather["to_y"]), np.asarray(want))
    last_j = jnp.asarray(last.astype(np.int32))
    _same(hg, _eager(JGI._segment_reduce_sorted, wv_want, None, last_j))
    sums = torch.empty((8, 1 << k), dtype=torch.int64)
    assert GK.weight_reduce(t_idx, _entry_rows(vals), rows, k, t_last, plan, sums, **gather) \
        is not None
    assert torch.equal(GK.finish_ref(sums), hg)
    h2 = torch.empty((8, 1 << k), dtype=torch.int32)
    assert GK.weight_reduce(t_idx, _entry_rows(vals), rows, k, t_last, plan, h2) is None
    _same(h2, _eager(JGI._segment_reduce_sorted, want, None, last_j))


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
        halves = [x * R_INV % P for x in _limb_ints(GK.eq_halves_ref(rows, k))]

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


def _case(dim: int, seed: int, bodies_only: bool = False, skew: int = 0):
    """One dim-`dim` instance with colliding entries in both packages, phase
    1's challenges g and phase 2's u, and every JAX phase function's output
    on them (eagerly), or only the two pair bodies'. With `skew`, f1 has
    that many more entries in x segment 5 (distinct (g, y) parts): past a
    tile, the segment is cut into chunks across the kernel's blocks."""
    rnd = random.Random(seed)
    f1 = J.SparseMLE.rand_with_config(3 * dim, 3 << dim, rnd)
    if skew:
        gen = np.random.default_rng(seed)
        mask = (1 << dim) - 1
        gy = gen.choice(1 << (2 * dim), skew, replace=False)
        idx = np.unique(np.concatenate([f1.indices,
                                        (gy & mask) | (5 << dim) | ((gy >> dim) << (2 * dim))]))
        f1 = J.SparseMLE(3 * dim, idx, _digits(gen, len(idx)))
    f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
    g = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
    u = [rnd.randrange(P) for _ in range(dim)]
    t1, t2, t3, tg = gkr_instance_from_numpy(dim, f1.indices, f1.values, f2.evals, f3.evals,
                                             [x.v for x in g])
    jsp = JGI._split_f1_device(f1, dim)
    nx, ny = JGI._seg_narrow(f1)
    gr, gomr = (jnp.asarray(a) for a in JGI._points_arrays(g))
    u_dig = np.stack([L.mont_scalar(v)[:, 0] for v in u])
    f3b, f2b = f3.device_bitrev(), f2.device_bitrev()
    with jax.disable_jit():
        jlo, jhi, jw = JGI._phase1_pair_body(dim, not nx)(
            jsp[0], jsp[4], jsp[5], jsp[2], jsp[3], gr, gomr, f3b, f2b)
        jlo2, jhi2 = JGI._phase2_pair_body(dim, not ny)(
            jlo[:, :, :1], jhi[:, :, :1], jnp.asarray(u_dig[-1]), jsp[1], jsp[6], jsp[7], jw,
            jnp.asarray(u_dig), f3b)
        jax_out = {"pair1": (jlo, jhi, jw), "pair2": (jlo2, jhi2)}
        if not bodies_only:
            hg, w = JGI._compiled_phase1(len(f1.indices), dim, "off", not nx)(
                jsp[0], jsp[4], jsp[5], jsp[2], jsp[3], gr, gomr, f3b)
            f2u = JGI._compiled_final_fold(1)(jlo[:, :, :1], jhi[:, :, :1],
                                              jnp.asarray(u_dig[-1]))
            f1gu = JGI._compiled_phase2_digits(len(f1.indices), dim, "off", not ny)(
                jsp[1], jsp[6], jsp[7], w, jnp.asarray(u_dig))
            jax_out.update(hg=hg, w=w, prep1=JGI._compiled_prep1(dim)(hg, f2b), f2u=f2u,
                           f1gu=f1gu, prep2=JGI._compiled_prep2(dim)(f1gu, f3b, f2u))
    split = GI._split_f1_device(t1, dim, CPU)
    port = {"dim": dim, "f1": t1, "split": split, "g": GI.upload(GI._point_rows(tg), CPU),
            "u": torch.from_numpy(u_dig.astype(np.int32)), "f2": t2.to_device(CPU),
            "f3": t3.to_device(CPU)}
    return jax_out, port


@pytest.fixture(scope="module")
def case():
    return _case(DIM, 41)


@pytest.fixture(scope="module")
def case9():
    return _case(9, 42)


def _pair_digits(lo, hi) -> list[np.ndarray]:
    """A (2, 8, H) limb pair -> each slot's (16, 2H) digits."""
    return [L.unpack_limbs(torch.cat([lo[u], hi[u]], dim=1).numpy()) for u in range(2)]


def _jax_pair(lo, hi) -> list[np.ndarray]:
    return [np.concatenate([np.asarray(lo)[u], np.asarray(hi)[u]], axis=1) for u in range(2)]


def _phase1(case):
    _j, p = case
    return GI.phase1(p["split"], p["g"], p["f3"], p["dim"])


def _pair1_args(p):
    return p["split"], p["g"], p["f3"], p["f2"], p["dim"]


def check_phase1(case):
    j, p = case
    hg, w = _phase1(case)
    assert hg.shape == (8, 1 << p["dim"]) and w.dtype == torch.int32
    _same(hg, j["hg"])
    assert w.shape == (3 << p["dim"], 8) and w.is_contiguous()
    np.testing.assert_array_equal(_carry_columns(w, p["split"].to_y), np.asarray(j["w"]))


def check_prep1(case):
    j, p = case
    hg, _w = _phase1(case)
    lo, hi = GI.prep1(hg, p["f2"])
    assert lo.shape == (2, 8, 1 << (p["dim"] - 1)) and lo.is_contiguous()
    got, want = _pair_digits(lo, hi), _jax_pair(*j["prep1"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])


def check_phase1_pair(case):
    j, p = case
    args = _pair1_args(p)
    lo, hi, w = GI.phase1_pair(*args)
    jlo, jhi, jw = j["pair1"]
    got, want = _pair_digits(lo, hi), _jax_pair(jlo, jhi)
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_carry_columns(w, p["split"].to_y), np.asarray(jw))
    blo = torch.full((3,) + tuple(lo.shape), 7, dtype=torch.int32)
    bhi = torch.full_like(blo, 7)
    GI.phase1_pair(*args, out=(blo[1], bhi[1]))
    assert torch.equal(blo[1], lo) and torch.equal(bhi[1], hi)
    assert (blo[[0, 2]] == 7).all() and (bhi[[0, 2]] == 7).all()


def check_final_fold(case):
    j, p = case
    lo, hi, _w = GI.phase1_pair(*_pair1_args(p))
    got = GI.final_fold(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1)
    assert got.dtype == torch.int32 and got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j["f2u"]))


def check_phase2_digits(case):
    j, p = case
    _lo, _hi, w = GI.phase1_pair(*_pair1_args(p))
    f1gu = GI.phase2_digits(p["split"], w, p["u"], p["dim"])
    assert f1gu.shape == (8, 1 << p["dim"]) and f1gu.dtype == torch.int32
    _same(f1gu, j["f1gu"])


def check_prep2(case):
    j, p = case
    f1gu = torch.from_numpy(L.pack_limbs(L.from_ints(_ints(j["f1gu"]), mont=False)))
    lo, hi = GI.prep2(f1gu, p["f3"], torch.from_numpy(np.asarray(j["f2u"]).astype(np.int32)))
    got, want = _pair_digits(lo, hi), _jax_pair(*j["prep2"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])


def check_phase2_pair(case):
    j, p = case
    lo, hi, w = GI.phase1_pair(*_pair1_args(p))
    args = (lo[:, :, :1], hi[:, :, :1], p["u"][-1], p["split"], w, p["u"], p["f3"], p["dim"])
    lo2, hi2 = GI.phase2_pair(*args)
    got, want = _pair_digits(lo2, hi2), _jax_pair(*j["pair2"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    blo = torch.zeros((2,) + tuple(lo2.shape), dtype=torch.int32)
    bhi = torch.zeros_like(blo)
    GI.phase2_pair(*args, out=(blo[1], bhi[1]))
    assert torch.equal(blo[1], lo2) and torch.equal(bhi[1], hi2) and not blo[0].any()


def test_phase1_matches_jax(case):
    """`phase1` against `_compiled_phase1`: h_g, and the carry under its
    permutation and transpose."""
    check_phase1(case)


def test_prep1_matches_jax(case):
    check_prep1(case)


def test_phase1_pair_matches_jax_body(case):
    """`phase1_pair` unpacked against `_phase1_pair_body`, fresh and written
    into one instance's slice of a batched pair (`out=`)."""
    check_phase1_pair(case)


def test_final_fold_matches_jax(case):
    check_final_fold(case)


def test_phase2_digits_matches_jax(case):
    check_phase2_digits(case)


def test_prep2_matches_jax(case):
    """`prep2` against `_compiled_prep2` on the same f1(g, u, .) and f2(u):
    slot 1 = f3 * f2(u)."""
    check_prep2(case)


def test_phase2_pair_matches_jax_body(case):
    """`phase2_pair` unpacked against `_phase2_pair_body`, from phase 1's
    one-lane pair (a strided view of the pair), fresh and into `out=`."""
    check_phase2_pair(case)


@pytest.mark.parametrize("check", [check_phase1, check_phase1_pair, check_phase2_digits,
                                   check_phase2_pair], ids=lambda f: f.__name__[6:])
def test_phases_match_jax_at_dim9(case9, check):
    """The phase functions on the fused kernel's plain version against
    `_compiled_phase1`, `_phase1_pair_body`, `_compiled_phase2_digits` and
    `_phase2_pair_body` at dim 9 (eq over k = 9 variables, 1,536 entries)."""
    check(case9)


@pytest.mark.parametrize("fold", ["generic", "mxu"])
def test_whole_phase_refs_equal_the_kernels_plain_versions(case, fold, monkeypatch):
    """The torch-op bodies kept as the plain versions of the whole phases
    (`*_ref`; in the MXU fold mode with the banded products at every width,
    their A/B) give the same pairs, carries and tables as the kernels'
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
    split = p["split"]
    hg, w1 = GI.phase1(split, p["g"], p["f3"], DIM)
    assert [torch.equal(a, b) for a, b in zip(
        (hg, w1), GI.phase1_ref(split, p["g"], p["f3"], DIM))] == [True, True]
    assert all(torch.equal(a, b) for a, b in zip(GI.prep1(hg, p["f2"]),
                                                  GI.prep1_ref(hg, p["f2"])))
    f2u = GI.final_fold(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1)
    assert torch.equal(f2u, GI.final_fold_ref(lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1))
    f1gu = GI.phase2_digits(split, w, p["u"], DIM)
    assert torch.equal(f1gu, GI.phase2_digits_ref(split, w, p["u"], DIM))
    assert all(torch.equal(a, b) for a, b in zip(GI.prep2(f1gu, p["f3"], f2u),
                                                  GI.prep2_ref(f1gu, p["f3"], f2u)))
    pair_args = (lo[:, :, :1], hi[:, :, :1], p["u"][-1], split, w, p["u"], p["f3"], DIM)
    assert all(torch.equal(a, b) for a, b in zip(GI.phase2_pair(*pair_args),
                                                  GI.phase2_pair_ref(*pair_args)))


# ---------------------------------------------------------------------------
# a sharded rank's dealt finish
# ---------------------------------------------------------------------------


def _dealt_jax(pair, s: int, size: int) -> list[np.ndarray]:
    """Rank s's deal (`mesh.deal`) of each slot of a JAX (2, 16, H) pair:
    (16, 2H / S) digits, its local lo lanes then its hi lanes."""
    return [deal(table, s, size) for table in _jax_pair(*pair)]


def _rank_raw_sums(p, size: int, ranks: int):
    """The S ranks' chunks of f1 (`_split_f1_device(..., shard=)`), each
    rank's carry, and both phases' raw limb sums (rank-major over `ranks`)
    added over the ranks as the all-reduce adds them: (splits, carries,
    phase 1 sums, phase 2 sums)."""
    dim = p["dim"]
    splits = [GI._split_f1_device(p["f1"], dim, CPU, (s, size)) for s in range(size)]
    sums1, sums2, carries = 0, 0, []
    for sp in splits:
        raw = torch.empty((8, 1 << dim), dtype=torch.int64)
        carries.append(GK.weight_reduce(sp.gbits, sp.vals, p["g"], dim, sp.last_x, sp.plan_x, raw,
                                        p["f3"], sp.y_rev, sp.to_y, ranks=ranks))
        sums1 = sums1 + raw
        GK.weight_reduce(sp.x_y, carries[-1], p["u"], dim, sp.last_y, sp.plan_y, raw, ranks=ranks)
        sums2 = sums2 + raw
    return splits, carries, sums1, sums2


def _same_dealt(lo, hi, want) -> None:
    """A rank's (2, 8, H / S) pair against the dealt JAX slots: slot 0 mod p
    and strict, slot 1 digit for digit."""
    got = _pair_digits(lo, hi)
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("size", [1, 2, 4], ids=lambda s: f"S{s}")
@pytest.mark.parametrize("which", ["dim4", "dim9"])
def test_dealt_finish_matches_deal_of_jax_prep(which, size, case, case9):
    """A sharded rank's finish over the raw sums of S ranks' chunks of f1,
    added as the all-reduce adds them: the weight reduce writes them
    rank-major (`ranks` = S; the natural sums with the columns of rank s's
    dealt segments moved into one run, `rank_major`), and `finish_sums`
    (its plain version `finish_sums_ref` on the CPU) over rank s's run,
    with its dealt f2 (phase 1) or f3 and the final fold of phase 1's
    one-lane pair (phase 2) for the pair's slot 1, gives a pair equal to
    `mesh.deal` of the JAX package's `_compiled_prep1` output (h_g, f2) and
    `_compiled_prep2`'s (f1(g, u, .), f3 times f2(u)); and so does the
    rank's pair from the phase functions a sharded prover calls
    (`phase1_pair`, `phase2_pair` with `reduce_fn` and `shard`), whose
    carry is the rank's own."""
    j, p = case if which == "dim4" else case9
    dim, f2, f3, u = p["dim"], p["f2"], p["f3"], p["u"]
    half, run = 1 << (dim - 1), (1 << dim) // size
    splits, carries, sums1, sums2 = _rank_raw_sums(p, size, size)
    natural = _rank_raw_sums(p, size, 1)
    assert torch.equal(sums1, GK.rank_major(natural[2], size))
    assert torch.equal(sums2, GK.rank_major(natural[3], size))
    lo1, hi1, _w = GI.phase1_pair(*_pair1_args(p))
    fold = (lo1[:, :, :1], hi1[:, :, :1], u[-1], 1)
    for s in range(size):
        want1, want2 = _dealt_jax(j["prep1"], s, size), _dealt_jax(j["prep2"], s, size)
        mine = slice(s * run, (s + 1) * run)
        f2_s, f3_s = deal(f2, s, size).contiguous(), deal(f3, s, size).contiguous()
        lo, hi = (torch.full((2, 8, half // size), 7, dtype=torch.int32) for _ in range(2))
        GK.finish_sums_ref(sums1[:, mine], (lo, hi), slot=(f2_s, None))
        _same_dealt(lo, hi, want1)
        GK.finish_sums(sums1[:, mine], (lo, hi), slot=(f2_s, None))
        _same_dealt(lo, hi, want1)
        GK.finish_sums_ref(sums2[:, mine], (lo, hi), slot=(f3_s, fold))
        _same_dealt(lo, hi, want2)

        def all_reduced(total):
            return lambda part: part.copy_(total)

        rlo, rhi, rw = GI.phase1_pair(splits[s], p["g"], f3, f2_s, dim,
                                      reduce_fn=all_reduced(sums1), shard=(s, size))
        assert rlo.shape == (2, 8, half // size) and torch.equal(rw, carries[s])
        _same_dealt(rlo, rhi, want1)
        rlo2, rhi2 = GI.phase2_pair(*fold[:3], splits[s], rw, u, f3_s, dim,
                                    reduce_fn=all_reduced(sums2), shard=(s, size))
        _same_dealt(rlo2, rhi2, want2)


def test_dealt_finish_refuses_a_bad_run_or_an_overlapping_pair(case):
    """Refused before any work: rank-major raw sums over a rank count that
    does not divide the segments, or into a strict destination; a finish
    whose run of sums is not the pair's width, or whose rows are not
    contiguous; and a final fold read from the pair the finish writes."""
    _j, p = case
    dim, split = p["dim"], p["split"]
    n = 1 << dim
    args = (split.gbits, split.vals, p["g"], dim, split.last_x, split.plan_x)
    gather = {"f3": p["f3"], "y": split.y_rev, "to_y": split.to_y}
    for out, ranks in ((torch.zeros((8, n), dtype=torch.int64), 3),
                       (torch.zeros((8, n), dtype=torch.int32), 2)):
        with pytest.raises(ValueError, match="rank-major"):
            GK.weight_reduce(*args, out, ranks=ranks, **gather)
    sums = torch.zeros((8, n), dtype=torch.int64)
    lo, hi = (torch.zeros((2, 8, n // 4), dtype=torch.int32) for _ in range(2))
    with pytest.raises(ValueError, match="pair halves"):
        GK.finish_sums(sums[:, : n // 4], (lo, hi))
    with pytest.raises(ValueError, match="contiguous rows"):
        GK.finish_sums(sums[:, ::2], (lo, hi))
    with pytest.raises(ValueError, match="overlaps"):
        GK.finish_sums(sums[:, n // 2:], (lo, hi), slot=(
            deal(p["f3"], 1, 2).contiguous(), (lo[:, :, :1], hi[:, :, :1], p["u"][-1], 1)))
    assert not lo.any() and not hi.any()


@pytest.fixture(scope="module")
def case5():
    return _case(5, 43, bodies_only=True)


@pytest.mark.parametrize("which", ["dim5", "dim9"])
def test_fused_phase_inits_match_jax_bodies(which, case5, case9):
    """The fused weight reduce's plain version (`weight_reduce_ref`: the
    half tables, the weight fold, the segment sum and the pair's other slot
    in one call, as the kernel's one launch a phase) against the JAX
    package's `_phase1_pair_body` and `_phase2_pair_body`, at dim 5 and at
    dim 9 with colliding entries (three a segment on average): phase 1 the
    pair with f2 copied into slot 1 and the carry, phase 2 the pair with f3
    times the final fold of phase 1's one-lane pair; and `weight_reduce`
    on the CPU is that plain version."""
    j, p = case5 if which == "dim5" else case9
    dim, split, g, u, f2, f3 = (p[k] for k in ("dim", "split", "g", "u", "f2", "f3"))
    half = 1 << (dim - 1)

    def pair():
        return tuple(torch.full((2, 8, half), 7, dtype=torch.int32) for _ in range(2))

    lo, hi = pair()
    w = GK.weight_reduce_ref(split.gbits, split.vals, g, dim, split.last_x, split.plan_x,
                             (lo, hi), f3, split.y_rev, split.to_y, slot=(f2, None))
    jlo, jhi, jw = j["pair1"]
    got, want = _pair_digits(lo, hi), _jax_pair(jlo, jhi)
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_carry_columns(w, split.to_y), np.asarray(jw))
    lo2, hi2 = pair()
    fold = (lo[:, :, :1], hi[:, :, :1], u[-1], 1)
    assert GK.weight_reduce_ref(split.x_y, w, u, dim, split.last_y, split.plan_y, (lo2, hi2),
                                slot=(f3, fold)) is None
    got, want = _pair_digits(lo2, hi2), _jax_pair(*j["pair2"])
    assert _ints(got[0]) == _ints(want[0])
    np.testing.assert_array_equal(got[1], want[1])
    again = pair()
    GK.weight_reduce(split.x_y, w, u, dim, split.last_y, split.plan_y, again, slot=(f3, fold))
    assert torch.equal(again[0], lo2) and torch.equal(again[1], hi2)


def test_batched_phase_pairs_match_jax_bodies(case5):
    """The batched prover's phase inits (`phase1_pairs`, `phase2_pairs`:
    one weight-reduce launch a phase for B instances on the card, its plain
    version `weight_reduce_batched_ref` here) over two dim-5 instances of
    different f1s, then over three, one of them with an x segment of 600
    more entries (past a tile: chunks across blocks, scratch rows of its
    own), each instance into its slice of one (B, 2, 8, 16) pair, phase 2
    over each instance's column of (dim, B, 16) challenge rows and the
    final fold of its own phase-1 pair: each instance's pairs and carry
    equal the JAX package's `_phase1_pair_body` and `_phase2_pair_body` on
    it (the vmapped `_bgkr_phase1` / `_bgkr_phase2` of
    `sumcheck_tpu/batch.py:565-580`)."""
    two = [case5, _case(5, 44, bodies_only=True)]
    skewed = _case(5, 45, bodies_only=True, skew=600)
    assert skewed[1]["split"].plan_x.long == 1
    for cases in (two, two + [skewed]):
        _batched_phase_pairs_match(cases)


def _batched_phase_pairs_match(cases) -> None:
    dim, batch = 5, len(cases)
    ports = [p for _j, p in cases]
    shape = (batch, 2, 8, 1 << (dim - 1))
    lo, hi, lo2, hi2 = (torch.full(shape, 7, dtype=torch.int32) for _ in range(4))
    ws = GI.phase1_pairs([p["split"] for p in ports], [p["g"] for p in ports],
                         [p["f3"] for p in ports], [p["f2"] for p in ports], dim, lo, hi)
    u = torch.stack([p["u"] for p in ports], dim=1)  # (dim, B, 16)
    GI.phase2_pairs(lo[:, :, :, :1], hi[:, :, :, :1], u[dim - 1], [p["split"] for p in ports],
                    ws, u, [p["f3"] for p in ports], dim, lo2, hi2)
    for b, (j, p) in enumerate(cases):
        jlo, jhi, jw = j["pair1"]
        for (glo, ghi), (wlo, whi) in (((lo[b], hi[b]), (jlo, jhi)),
                                       ((lo2[b], hi2[b]), j["pair2"])):
            got, want = _pair_digits(glo, ghi), _jax_pair(wlo, whi)
            assert _ints(got[0]) == _ints(want[0]), b
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(_carry_columns(ws[b], p["split"].to_y), np.asarray(jw))


def test_fused_slot_refuses_an_overlapping_pair(case):
    """The fused launch's other slot: a destination pair that overlaps the
    one-lane pair its final fold reads (the same pair, or a view sharing
    its lanes) is refused before any work, as are a slot without a pair to
    write (a table or raw sums) and a one-slot pair; a fold read from a
    disjoint strided view is taken."""
    _j, p = case
    dim, split, u, f3 = p["dim"], p["split"], p["u"], p["f3"]
    half = 1 << (dim - 1)
    lo1, hi1, w = GI.phase1_pair(*_pair1_args(p))
    args = (split.x_y, w, u, dim, split.last_y, split.plan_y)
    big = torch.zeros((3, 2, 8, half), dtype=torch.int32)
    bhi = torch.zeros_like(big)
    for fold_pair in ((big[1, :, :, :1], bhi[1, :, :, :1]), (big[1], bhi[1]),
                      (big[1, :, :, half - 1:], bhi[1, :, :, half - 1:])):
        with pytest.raises(ValueError, match="overlaps"):
            GK.weight_reduce(*args, (big[1], bhi[1]), slot=(f3, (*fold_pair, u[-1], 1)))
    assert not big.any() and not bhi.any()
    fold = (lo1[:, :, :1], hi1[:, :, :1], u[-1], 1)
    for out in (torch.empty((8, 1 << dim), dtype=torch.int32),
                torch.empty((8, 1 << dim), dtype=torch.int64)):
        with pytest.raises(ValueError, match="pair"):
            GK.weight_reduce(*args, out, slot=(f3, fold))
    one = torch.empty((1, 8, half), dtype=torch.int32), torch.empty((1, 8, half), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot 1"):
        GK.weight_reduce(*args, one, slot=(f3, fold))
    GK.weight_reduce(*args, (big[2], bhi[2]), slot=(f3, (big[0, :, :, :1], bhi[0, :, :, :1],
                                                         u[-1], 1)))
    want = GI.phase2_pair(big[0, :, :, :1], bhi[0, :, :, :1], u[-1], split, w, u, f3, dim)
    assert torch.equal(big[2], want[0]) and torch.equal(bhi[2], want[1])


@pytest.mark.parametrize("k", [20, 21, 22, 24])
def test_weight_reduce_refuses_k_past_the_blocks_shared_memory(k, monkeypatch):
    """Up to k = 21 (2^11 + 2^10 half-table lanes, `in_block`, as far as
    f1's int64 indices reach) the wrapper launches once on a card (its
    launch stubbed here) and counts it; from k = 22 it raises, on a card
    and on the CPU alike, and launches nothing."""
    rows = _rows([random.Random(k).randrange(P) for _ in range(k)])
    nnz, nseg = 64, 16
    last = np.arange(nseg) * (nnz // nseg) + nnz // nseg - 1
    args = (torch.zeros(nnz, dtype=torch.int32), torch.zeros((nnz, 8), dtype=torch.int32), rows,
            k, torch.from_numpy(last.astype(np.int32)), GK.upload_plan(last, nnz, CPU),
            torch.empty((8, nseg), dtype=torch.int32))
    assert GK.in_block(k) == (k <= 21)
    if k > 21:
        with pytest.raises(ValueError, match="up to k = 21"):
            GK.weight_reduce(*args)
    seen = []
    monkeypatch.setattr(GK, "_on_card", lambda t: True)
    monkeypatch.setattr(GK, "_launch_reduce", lambda *a: seen.append(a[3]))
    before = GK.weight_reduce.launches
    try:
        if k <= 21:
            GK.weight_reduce(*args)
        else:
            with pytest.raises(ValueError, match="up to k = 21"):
                GK.weight_reduce(*args)
        assert GK.weight_reduce.launches == before + (k <= 21)
    finally:
        GK.weight_reduce.launches = before
    assert seen == ([k] if k <= 21 else [])


# ---------------------------------------------------------------------------
# the segment sums: a rank's raw sums, the tile plans, and a skewed f1
# ---------------------------------------------------------------------------


def _segments(lengths) -> np.ndarray:
    """Each segment's last sorted position, for segments of these lengths."""
    return np.cumsum(lengths) - 1


def test_segment_reduce_partials_add_to_the_whole():
    """The fused kernel's raw-sums mode (a rank's partial) at S = 2 and 4:
    the entries cut into S contiguous chunks, each chunk's raw (8, nseg)
    int64 limb sums (an empty segment among them) added as the ranks'
    all-reduce adds them equal the whole's, and `finish_sums` of the total
    equals the whole's strict sums, which are the Python-integer sums of
    the weights; the sums are exact integers (each below 2^56)."""
    gen = np.random.default_rng(5)
    nnz, nseg, k = 400, 64, 6
    seg = np.sort(gen.integers(0, nseg, nnz))
    seg[seg == 3] = 4  # an empty segment
    vals = _entry_rows(_digits(gen, nnz))
    idx = torch.from_numpy(gen.integers(0, 1 << k, nnz).astype(np.int32))
    rows = _rows([random.Random(5).randrange(P) for _ in range(k)])
    eq = GK.eq_halves_ref(rows, k)

    def raw(lo, hi):
        last = np.searchsorted(seg[lo:hi], np.arange(nseg), side="right") - 1
        sums = torch.empty((8, nseg), dtype=torch.int64)
        GK.weight_reduce(idx[lo:hi], vals[lo:hi].contiguous(), rows, k,
                         torch.from_numpy(last.astype(np.int32)),
                         GK.upload_plan(last, hi - lo, CPU), sums)
        return sums

    whole_sums = raw(0, nnz)
    whole = torch.empty((8, nseg), dtype=torch.int32)
    last = np.searchsorted(seg, np.arange(nseg), side="right") - 1
    GK.weight_reduce(idx, vals, rows, k, torch.from_numpy(last.astype(np.int32)),
                     GK.upload_plan(last, nnz, CPU), whole)
    for size in (2, 4):
        cuts = [nnz * r // size for r in range(size + 1)]
        parts = [raw(lo, hi) for lo, hi in zip(cuts, cuts[1:])]
        assert all(p.dtype == torch.int64 and p.shape == (8, nseg) for p in parts)
        total = sum(parts)
        assert torch.equal(total, whole_sums) and int(total.max()) < 1 << 56
        got = torch.empty_like(whole)
        GK.finish_sums(total, got)
        assert torch.equal(got, whole)
    halves = [x for x in _limb_ints(eq)]
    kl = k - k // 2
    w = [_raw(L.unpack_limbs(vals.numpy(), axis=1).T)[i] * halves[int(j) & ((1 << kl) - 1)]
         * halves[(1 << kl) + (int(j) >> kl)] * R_INV * R_INV % P for i, j in enumerate(idx)]
    assert _limb_ints(whole) == [sum(w[i] for i in range(nnz) if seg[i] == s) % P
                                 for s in range(nseg)]


def walk_plan(items: np.ndarray, last: np.ndarray, products: np.ndarray, tile: int):
    """The fused kernel's schedule over a plan, on (nnz, 8) int64 product
    limbs: each tile's segments summed out of its entries (which must be
    exactly the segments' entries, at most `tile` of each), each chunk's
    entries (at most `tile`) added into its scratch row, and the row
    emitted when its segment's last chunk arrives (chunks counted against
    the segment's length). Returns the (8, nseg) sums and each segment's
    emit count."""
    nseg = len(last)
    begin = np.concatenate([[0], last[:-1] + 1])
    sums = np.zeros((8, nseg), np.int64)
    emitted = np.zeros(nseg, np.int64)
    scratch, arrived = {}, {}
    for s0, count, e0, e1 in items.tolist():
        assert 0 < e1 - e0 <= tile or (count > 0 and e1 == e0)
        if count > 0:
            assert count <= tile and begin[s0] == e0 and last[s0 + count - 1] + 1 == e1
            for s in range(s0, s0 + count):
                sums[:, s] = products[begin[s]:last[s] + 1].sum(axis=0)
                emitted[s] += 1
            continue
        row = -1 - count
        assert begin[s0] <= e0 and e1 <= last[s0] + 1
        scratch[row] = scratch.get(row, 0) + products[e0:e1].sum(axis=0)
        arrived[row] = arrived.get(row, 0) + 1
        if arrived[row] == -(-(last[s0] + 1 - begin[s0]) // tile):
            sums[:, s0] = scratch.pop(row)
            arrived.pop(row)
            emitted[s0] += 1
    assert not scratch and not arrived  # every row finished, and so left zero
    return sums, emitted


def test_tile_plan_long_segments_match_naive():
    """`tile_plan` over segments of 2^16 + 1 entries, exactly a tile + 1,
    exactly a tile, runs of empty and one-entry segments: walked as the
    kernel walks it (`walk_plan`), every segment emitted once with the
    naive sums of its entries, the long ones cut into ceil(n / tile)
    chunks with their own scratch rows; the fused kernel's plain version
    and the phase functions give the same strict sums."""
    tile = GK.TILE
    gen = np.random.default_rng(16)
    lengths = np.concatenate([[0, 3, (1 << 16) + 1, 0, 1], [1] * 600, [tile + 1, tile, 0],
                              gen.poisson(1.0, 3000), [tile + 1], [0] * 700])
    last = _segments(lengths)
    nnz = int(lengths.sum())
    items, long = GK.tile_plan(last, nnz)
    assert long == 3 and items.dtype == np.int32 and items.shape[1] == 4
    assert (items[:, 1] < 0).sum() == -(-((1 << 16) + 1) // tile) + 2 + 2
    products = gen.integers(0, 1 << 32, (nnz, 8), dtype=np.int64)
    sums, emitted = walk_plan(items, last, products, tile)
    assert (emitted == 1).all()
    naive = np.stack([products[b:e].sum(axis=0) for b, e in
                      zip(np.concatenate([[0], last[:-1] + 1]), last + 1)], axis=1)
    np.testing.assert_array_equal(sums, naive)
    k = 5
    vals = _entry_rows(_digits(gen, nnz))
    idx = torch.from_numpy(gen.integers(0, 1 << k, nnz).astype(np.int32))
    rows = _rows([random.Random(6).randrange(P) for _ in range(k)])
    eq = GK.eq_halves_ref(rows, k)
    plan = GK.Plan(torch.from_numpy(items), long)
    got = torch.empty((8, len(lengths)), dtype=torch.int64)
    GK.weight_reduce(idx, vals, rows, k, torch.from_numpy(last.astype(np.int32)), plan, got)
    w, _ = GK.weight_fold_ref(idx, vals.T.contiguous(), eq, k)
    walked, _ = walk_plan(items, last, w.T.long().numpy() & 0xFFFFFFFF, tile)
    np.testing.assert_array_equal(got.numpy(), walked)


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
    split = GI._split_f1_device(f1, dim, CPU)
    last_x = split.last_x.numpy()
    assert split.plan_x.long == 1 and split.plan_y.long == 0
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
