"""The port's interactive tier, GKR device-init wrappers and speed-of-light
counts on the CPU (`device="cpu"`: the round kernels' plain versions)
against the JAX package, tolerance 0:

- `IPForMLSumcheck.prover_init` / `prove_round` / `sample_round` message by
  message against the JAX package's (its host engine at these sizes) on the
  `shared_ragged` and `2x3` structures of `tests/test_torch_prover.py`, the
  folded tables after every round (`ProverState.flattened_ml_extensions`,
  coefficients divided back out) equal to the JAX state's, and the round
  bookkeeping's errors;
- `ops/gkr_init.phase1_init_device` / `phase2_init_device` against the JAX
  package's (`tests/test_gkr_device_init.py::test_phase_inits_match_host`),
  and the no-sync `phase1_init_device_arrays` against them;
- the reference's GKR phase helpers (`initialize_phase_one` / `_two`,
  `start_phase1_sumcheck` / `start_phase2_sumcheck` on the device asked
  for);
- `utils/sol.py`'s multiply and byte counts against the JAX package's.

`tests/test_torch_field.py` runs the interactive tier and the init wrappers
under BN254 Fr.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.fields.fr import P
from sumcheck_tpu.ops import gkr_init as JGI
from sumcheck_tpu.utils import sol as JSOL
from sumcheck_tpu_torch.fields.limbs_np import unpack_limbs
from sumcheck_tpu_torch.ops import gkr_init as GI
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.protocol.prover import bitrev_perm, to_bitrev
from sumcheck_tpu_torch.utils import sol as SOL
from test_torch_prover import both


def _rounds(jp, tp, seed: int):
    """Both tiers driven in step over the same transcript bytes; yields
    after each round (JAX state, port state, JAX message, port message)."""
    jst = J.IPForMLSumcheck.prover_init(jp)
    st = T.IPForMLSumcheck.prover_init(tp, device="cpu")
    jrng, rng = J.Blake2b512Rng.setup(), T.Blake2b512Rng.setup()
    jrng.feed_bytes(seed.to_bytes(4, "little"))
    rng.feed_bytes(seed.to_bytes(4, "little"))
    jv = v = None
    for _ in range(tp.num_variables):
        jm = J.IPForMLSumcheck.prove_round(jst, jv)
        m = T.IPForMLSumcheck.prove_round(st, v)
        yield jst, st, jm, m
        jrng.feed(jm)
        rng.feed(m)
        jv = J.IPForMLSumcheck.sample_round(jrng)
        v = T.IPForMLSumcheck.sample_round(rng)
        assert v.randomness.v == jv.randomness.v
    jst.randomness.append(jv.randomness)
    st.randomness.append(v.randomness)
    assert [r.v for r in st.randomness] == [r.v for r in jst.randomness]


@pytest.mark.parametrize("shape", ["shared_ragged", "2x3"])
def test_interactive_tier_matches_jax_round_by_round(shape):
    """Every message, challenge and folded table equal to the JAX
    package's, round by round, through the plain round versions."""
    jp, tp = both(shape, seed=11)
    rounds = 0
    for jst, st, jm, m in _rounds(jp, tp, seed=11):
        assert m.serialize_uncompressed() == jm.serialize_uncompressed()
        tables = st.flattened_ml_extensions
        want = [np.asarray(t) for t in jst.flattened_ml_extensions]
        assert len(tables) == len(want) == len(jp.flattened_ml_extensions)
        for got, ref in zip(tables, want):
            np.testing.assert_array_equal(got, ref)
        rounds += 1
    assert rounds == tp.num_variables
    assert st.round == jst.round == tp.num_variables
    assert tables[0].shape == (16, 2)


def test_interactive_tier_runs_the_round_kernels(monkeypatch):
    """Round 0 reaches `round_nofold` over all 2^(nv-1) pair lanes, round j
    `round_fold` over 2^(nv-1) >> j, each on the pair's device, and each
    round's sums come to the host once, in `finish_sums`."""
    calls = []
    for name in ("round_nofold", "round_fold", "finish_sums"):
        real = getattr(RC, name)
        monkeypatch.setattr(RC, name, lambda *a, _n=name, _f=real: calls.append(
            (_n, a[0].device.type, a[-1] if _n != "finish_sums" else None)) or _f(*a))
    _, tp = both("2x3", seed=12)
    st = T.IPForMLSumcheck.prover_init(tp, device="cpu")
    rng = T.Blake2b512Rng.setup()
    v = None
    for _ in range(tp.num_variables):
        rng.feed(T.IPForMLSumcheck.prove_round(st, v))
        v = T.IPForMLSumcheck.sample_round(rng)
    nv, half = tp.num_variables, 1 << (tp.num_variables - 1)
    want = []
    for j in range(nv):
        want += [("round_fold" if j else "round_nofold", "cpu", half >> j),
                 ("finish_sums", "cpu", None)]
    assert calls == want


def test_round_bookkeeping_errors_unchanged():
    from sumcheck_tpu_torch.protocol.verifier import VerifierMsg

    _, tp = both("single_var", seed=13)
    st = T.IPForMLSumcheck.prover_init(tp, device="cpu")
    with pytest.raises(T.SumcheckError, match="first round should be prover first"):
        T.IPForMLSumcheck.prove_round(st, VerifierMsg(T.Fr(3)))
    T.IPForMLSumcheck.prove_round(st, None)
    with pytest.raises(T.SumcheckError, match="verifier message is empty"):
        T.IPForMLSumcheck.prove_round(st, None)
    with pytest.raises(T.SumcheckError, match="Prover is not active"):
        T.IPForMLSumcheck.prove_round(st, VerifierMsg(T.Fr(3)))
    poly = T.ListOfProductsOfPolynomials(0)
    poly.add_product([T.DenseMLE.zero(0)], T.Fr(1))
    with pytest.raises(T.SumcheckError, match="constant"):
        T.IPForMLSumcheck.prover_init(poly, device="cpu")


def zero_coefficient_polys(nv: int):
    """Fault F3's inputs, (JAX polynomial, port polynomial): tables from
    `random.Random(5)` by the JAX package's `DenseMLE.rand`, carried across
    as digits. nv=3: one product [a, b] with coefficient 0 (the recorded
    case); larger nv: `chip_smoke.py`'s F3 polynomial, 0 x [t0, t1, t2] +
    c x [t3, t4, t5] with c drawn from the same `Random`."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    rnd = random.Random(5)
    count = 2 if nv == 3 else 6
    mles = [J.DenseMLE.rand(nv, rnd) for _ in range(count)]
    products = [(0, [0, 1])] if nv == 3 else [(0, [0, 1, 2]), (rnd.randrange(P), [3, 4, 5])]
    jp = J.ListOfProductsOfPolynomials(nv)
    for c, ix in products:
        jp.add_product([mles[i] for i in ix], J.Fr(c))
    return jp, polynomial_from_numpy(nv, [m.evals for m in mles], products)


def zero_coefficient_rounds(nv: int) -> tuple[list, list]:
    """The interactive tier over F3's polynomial in both packages: after
    every round, (message bytes, folded tables), the port's and the JAX
    package's. `tests/test_torch_field.py` runs it under BN254."""
    jp, tp = zero_coefficient_polys(nv)
    got, want = [], []
    for jst, st, jm, m in _rounds(jp, tp, seed=nv):
        got.append((m.serialize_uncompressed(), [t.tolist() for t in st.flattened_ml_extensions]))
        want.append((jm.serialize_uncompressed(),
                     [np.asarray(t).tolist() for t in jst.flattened_ml_extensions]))
    return got, want


def test_zero_coefficient_table_refuses_to_read():
    """Fault F3, nv=3: a product whose coefficient is 0 takes a scaled copy
    slot, so its tables survive unscaled and `flattened_ml_extensions`
    returns them, equal to the JAX package's after every round (both
    tables, no raise), with equal messages."""
    got, want = zero_coefficient_rounds(3)
    assert len(got) == 3
    assert all(len(tables) == 2 for _m, tables in got)
    assert got == want


@pytest.mark.parametrize("nv", [3, 10])
def test_zero_coefficient_tables_match_jax(nv):
    """F3 at nv=3 and 10 (a zero and a nonzero product): the fold plan
    keeps the old slots for the nonzero coefficient and adds one copy slot
    for the zero one, the pair holds the source tables untouched and the
    copy zeroed, and every round's message and tables equal the JAX
    package's."""
    from sumcheck_tpu_torch.protocol import device_prover as TD

    jp, tp = zero_coefficient_polys(nv)
    tables = len(tp.flattened_ml_extensions)
    products, scale_plan, slots, ones = TD._fold_plan(tp)
    assert [dst for dst, src, c in scale_plan if c == 0] == [tables]
    assert slots == tables + 1 and not ones and products[0][0] == tables
    st = T.IPForMLSumcheck.prover_init(tp, device="cpu")
    lo, hi = st.stacked
    assert not lo[tables].any() and not hi[tables].any()
    for i, m in enumerate(tp.flattened_ml_extensions):
        if all(i != src for dst, src, c in scale_plan if dst == src):
            both = unpack_limbs(torch.cat([lo[i], hi[i]], dim=1).numpy())
            np.testing.assert_array_equal(both, to_bitrev(m.evals, nv))
    got, want = zero_coefficient_rounds(nv)
    assert len(got) == nv and got == want



def _slot_limit_polys(tables: int, nv: int = 3):
    """(JAX polynomial, port polynomial) of `tables` tables from
    `random.Random(tables)`, each used by one product (products of three
    for 15 tables, of two otherwise), the first product's coefficient 0 and
    the others' random."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    rnd = random.Random(tables)
    mles = [J.DenseMLE.rand(nv, rnd) for _ in range(tables)]
    width = 3 if tables % 3 == 0 else 2
    products = [(0 if i == 0 else rnd.randrange(2, P), list(range(i, i + width)))
                for i in range(0, tables - width + 1, width)]
    jp = J.ListOfProductsOfPolynomials(nv)
    for c, ix in products:
        jp.add_product([mles[i] for i in ix], J.Fr(c))
    return jp, polynomial_from_numpy(nv, [m.evals for m in mles], products)


@pytest.mark.parametrize("tables", [15, 16])
def test_zero_coefficient_at_the_slot_limit(tables):
    """F3 at the kernels' 16 slots (`init_cuda.MAX_SLOTS`). 15 tables: the
    zero product's copy slot makes 16, and every round's message and tables
    equal the JAX package's. 16 tables: a copy would make 17, so the plan
    scales the table by 0 in place, as the JAX plan does; every message
    still equals the JAX package's, and only `flattened_ml_extensions`
    refuses the wiped table."""
    from sumcheck_tpu_torch.ops import init_cuda
    from sumcheck_tpu_torch.protocol import device_prover as TD

    jp, tp = _slot_limit_polys(tables)
    _products, scale_plan, slots, ones = TD._fold_plan(tp)
    assert slots == init_cuda.MAX_SLOTS == 16 and not ones
    assert scale_plan[0] == ((15, 0, 0) if tables == 15 else (0, 0, 0))
    rounds = 0
    for jst, st, jm, m in _rounds(jp, tp, seed=tables):
        assert m.serialize_uncompressed() == jm.serialize_uncompressed()
        want = [np.asarray(t).tolist() for t in jst.flattened_ml_extensions]
        if tables == 15:
            assert [t.tolist() for t in st.flattened_ml_extensions] == want
        else:
            with pytest.raises(T.SumcheckError, match="coefficient 0 in place"):
                st.flattened_ml_extensions
        rounds += 1
    assert rounds == tp.num_variables


def test_plan_past_the_slot_limit_raises_before_any_launch(monkeypatch):
    """18 tables need 18 slots even in place: `prover_init` and the prove
    raise `SumcheckError` from the plan, before the pair-init wrapper is
    called."""
    from sumcheck_tpu_torch.ops import init_cuda

    calls = []
    monkeypatch.setattr(init_cuda, "pair_init", lambda *a, **k: calls.append(1))
    _jp, tp = _slot_limit_polys(18)
    with pytest.raises(T.SumcheckError, match="18 table slots"):
        T.IPForMLSumcheck.prover_init(tp, device="cpu")
    with pytest.raises(T.SumcheckError, match="18 table slots"):
        T.MLSumcheck.prove(tp, device="cpu")
    assert calls == []

def _gkr_case(dim: int, seed: int):
    rnd = random.Random(seed)
    f1 = J.SparseMLE.rand_with_config(3 * dim, 3 * (1 << dim), rnd)  # colliding entries
    f3 = J.DenseMLE.rand(dim, rnd)
    g = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
    u = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
    return f1, f3, g, u


def test_phase_init_wrappers_match_jax():
    """h_g and f1(g, u, .) as NumPy tables in natural lane order, equal to
    the JAX package's device-init wrappers, and the no-sync variant's
    bit-reversed device tensor equal to them."""
    dim = 3
    f1, f3, g, u = _gkr_case(dim, 15)
    jh, jcarry = JGI.phase1_init_device(f1.indices, f1.values, f3.evals, g, dim)
    tg, tu = [T.Fr(x.v) for x in g], [T.Fr(x.v) for x in u]
    h, carry = GI.phase1_init_device(f1.indices, f1.values, f3.evals, tg, dim, device="cpu")
    assert h.dtype == np.uint32 and h.shape == (16, 1 << dim)
    np.testing.assert_array_equal(h, np.asarray(jh))
    assert carry[3].device.type == "cpu"
    np.testing.assert_array_equal(GI.phase2_init_device(carry, tu, dim),
                                  np.asarray(JGI.phase2_init_device(jcarry, u, dim)))
    tf1 = T.SparseMLE(3 * dim, f1.indices, f1.values)
    hg, _carry = GI.phase1_init_device_arrays(tf1, T.DenseMLE(dim, f3.evals), tg, dim, "cpu")
    np.testing.assert_array_equal(hg.numpy()[:, bitrev_perm(dim)].astype(np.uint32), h)


def test_phase_init_wrappers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    f1, f3, g, _u = _gkr_case(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GI.phase1_init_device(f1.indices, f1.values, f3.evals, [T.Fr(x.v) for x in g], 2)


def test_reference_phase_helpers_match_jax():
    """The reference's phase helpers: the host inits `initialize_phase_one`
    / `initialize_phase_two` equal the JAX package's, and
    `start_phase1_sumcheck` / `start_phase2_sumcheck` build the interactive
    tier's state on the device asked for, first message the JAX package's."""
    from sumcheck_tpu import gkr_round_sumcheck as JG
    from sumcheck_tpu_torch import gkr_round_sumcheck as G

    dim = 3
    f1, f3, g, u = _gkr_case(dim, 17)
    tf1, tf3 = T.SparseMLE(3 * dim, f1.indices, f1.values), T.DenseMLE(dim, f3.evals)
    h_g, f1_g = G.initialize_phase_one(tf1, tf3, [T.Fr(x.v) for x in g])
    jh_g, jf1_g = JG.initialize_phase_one(f1, f3, g)
    np.testing.assert_array_equal(h_g.evals, jh_g.evals)
    f1_gu = G.initialize_phase_two(f1_g, [T.Fr(x.v) for x in u])
    jf1_gu = JG.initialize_phase_two(jf1_g, u)
    np.testing.assert_array_equal(f1_gu.evals, jf1_gu.evals)
    c = J.Fr(random.Random(18).randrange(P))
    for st, jst in ((G.start_phase1_sumcheck(h_g, tf3, device="cpu"),
                     JG.start_phase1_sumcheck(jh_g, f3)),
                    (G.start_phase2_sumcheck(f1_gu, tf3, T.Fr(c.v), device="cpu"),
                     JG.start_phase2_sumcheck(jf1_gu, f3, c))):
        assert st.stacked[0].device.type == "cpu"
        got = T.IPForMLSumcheck.prove_round(st, None).serialize_uncompressed()
        assert got == J.IPForMLSumcheck.prove_round(jst, None).serialize_uncompressed()


@pytest.mark.parametrize("nv,slots,products,max_len,degree",
                         [(20, 6, 2, 3, 3), (10, 8, 3, 4, 4), (1, 2, 1, 2, 2)])
def test_sol_counts_match_jax(nv, slots, products, max_len, degree):
    got = SOL.count_prove_ops(nv, slots, products, max_len, degree)
    want = JSOL.count_prove_ops(nv, slots, products, max_len, degree)
    assert (got["mont_muls"], got["hbm_bytes"]) == (want["mont_muls"], want["hbm_bytes"])
    assert got["u32_muls"] == got["mont_muls"] * SOL.MULS_PER_MONT == got["mont_muls"] * 264


@pytest.mark.parametrize("dim,nnz", [(18, 1 << 18), (5, 3 << 5)])
def test_sol_gkr_counts_match_jax(dim, nnz):
    got, want = SOL.count_gkr_prove_ops(dim, nnz), JSOL.count_gkr_prove_ops(dim, nnz)
    assert (got["mont_muls"], got["hbm_bytes"]) == (want["mont_muls"], want["hbm_bytes"])


def test_sol_seconds_takes_the_binding_roofline():
    counts = {"mont_muls": 10, "hbm_bytes": 400}
    sol = SOL.sol_seconds(counts, {"mont_muls_per_s": 5.0, "hbm_bytes_per_s": 100.0})
    assert sol == {"mont_bound_s": 2.0, "hbm_bound_s": 4.0, "sol_s": 4.0, "bound": "hbm"}
    assert SOL.sol_seconds(counts, {"mont_muls_per_s": 1.0, "hbm_bytes_per_s": 100.0})["bound"] \
        == "mont"


def test_measure_roofline_is_the_cards(monkeypatch, tmp_path):
    """The rooflines are measured on a card: the CPU is refused, and no
    cache file appears at the repository root."""
    from sumcheck_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    with pytest.raises(ValueError, match="card"):
        SOL.measure_roofline("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SOL.measure_roofline()
    assert SOL._cache_path().parent == tmp_path
