"""The port's prover (`sumcheck_tpu_torch`, `device="cpu"`, i.e. the round
kernels' plain versions) against the JAX package.

- `_fold_plan` and `init_pair` equal the JAX ones (the port's (U, 8, H)
  limb pair unpacked to the JAX (U, 16, H) digits);
- full `MLSumcheck.prove_as_subprotocol` equals the JAX package's host
  engine (whose bit-identity to its on-device `prove_generic` the JAX suite
  pins): proof bytes, challenges, and the transcript after the prove;
- the two ML golden fixtures prove byte-exactly;
- the interactive tier and the verifier behave as the JAX package's.

Both packages get the same tables, made with `numpy.random.default_rng`
and carried across by `convert.polynomial_from_numpy`. Tolerance 0.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.protocol import device_prover as JD
from sumcheck_tpu.utils.config import get_config
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.fields import limbs_np as TL
from sumcheck_tpu_torch.fields.limbs_np import unpack_limbs
from sumcheck_tpu_torch.ml_sumcheck import deserialize_proof, serialize_proof
from sumcheck_tpu_torch.protocol import device_prover as TD

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")

# (nv, [(coeff, [table indices])], number of tables)
SHAPES = {
    "2x3": (8, [(0x1234567, [0, 1, 2]), (0x7654321, [3, 4, 5])], 6),
    "shared_ragged": (6, [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])], 5),
    "single_var": (1, [(3, [0, 1])], 2),
}


def _tables(seed: int, nv: int, count: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def jax_poly(nv, tables, products):
    mles = [J.DenseMLE(nv, t.copy()) for t in tables]
    poly = J.ListOfProductsOfPolynomials(nv)
    for c, idx in products:
        poly.add_product([mles[i] for i in idx], J.Fr(c))
    return poly


def both(shape: str, seed: int = 0):
    nv, products, count = SHAPES[shape]
    tables = _tables(seed, nv, count)
    return jax_poly(nv, tables, products), polynomial_from_numpy(nv, tables, products)


def jax_host_prove(poly):
    """The JAX package's host-engine Fiat-Shamir prove (the
    `tests/test_generic_prover.py` pattern)."""
    cfg = get_config()
    saved = cfg.engine
    cfg.engine = "host"
    try:
        rng = J.Blake2b512Rng.setup()
        proof, state = J.MLSumcheck.prove_as_subprotocol(rng, poly)
    finally:
        cfg.engine = saved
    return proof, state, rng


def test_convert_keeps_table_identity():
    jp, tp = both("shared_ragged")
    assert len(tp.flattened_ml_extensions) == len(jp.flattened_ml_extensions)
    assert [ix for _, ix in tp.products] == [ix for _, ix in jp.products]
    assert [c.v for c, _ in tp.products] == [c.v for c, _ in jp.products]
    for a, b in zip(tp.flattened_ml_extensions, jp.flattened_ml_extensions):
        np.testing.assert_array_equal(a.evals, b.evals)
    assert tp.info().serialize_uncompressed() == jp.info().serialize_uncompressed()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fold_plan_matches(shape):
    jp, tp = both(shape)
    assert TD._fold_plan(tp) == JD._fold_plan(jp)


@pytest.mark.parametrize("shape", ["2x3", "shared_ragged"])
def test_init_pair_matches(shape):
    jp, tp = both(shape)
    jlo, jhi, jprod, jdeg, _ = JD.init_pair(jp)
    lo, hi, prod, deg = TD.init_pair(tp, "cpu")
    assert (prod, deg) == (jprod, jdeg)
    assert lo.dtype == torch.int32 and lo.is_contiguous() and hi.is_contiguous()
    assert lo.shape == (len(jlo), 8, jlo.shape[2])  # the JAX pair's digits as limbs
    np.testing.assert_array_equal(unpack_limbs(lo.numpy(), axis=1), np.asarray(jlo))
    np.testing.assert_array_equal(unpack_limbs(hi.numpy(), axis=1), np.asarray(jhi))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prove_matches_jax_host_engine(shape):
    jp, tp = both(shape, seed=3)
    jproof, jstate, jrng = jax_host_prove(jp)
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    assert state.round == tp.num_variables
    # the transcript continues identically after the prove
    assert rng.fill_bytes(40) == jrng.fill_bytes(40)


@pytest.mark.parametrize("chain", ["generic", "persize"])
def test_unaligned_pending_bytes_prove_on_the_host_loop(chain, monkeypatch):
    """A `Blake2b512Rng` pre-fed 3 bytes holds a pending byte count that is
    not a multiple of 8, which the device transcript cannot hold: the prove
    takes the host-transcript loop (it raised `ValueError` in the lift
    before), on either chain, byte-equal to the JAX package's prove of the
    same pre-fed transcript, and the transcript ends in the same state."""
    from sumcheck_tpu_torch.utils.config import get_config as t_get_config

    monkeypatch.setattr(t_get_config(), "chain_impl", chain)
    products = [(0x1234567, [0, 1, 2]), (0x7654321, [3, 4, 5])]
    tables = _tables(7, 5, 6)
    jp, tp = jax_poly(5, tables, products), polynomial_from_numpy(5, tables, products)
    cfg = get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        jrng = J.Blake2b512Rng.setup()
        jrng.feed_bytes(b"abc")
        jproof, jstate = J.MLSumcheck.prove_as_subprotocol(jrng, jp)
    finally:
        cfg.engine = saved
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(b"abc")
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    assert rng.state_tuple() == jrng.state_tuple()


def test_one_shot_prove_verifies_and_subclaim_holds():
    jp, tp = both("2x3", seed=4)
    proof = T.MLSumcheck.prove(tp, device=torch.device("cpu"))
    assert serialize_proof(proof) == j_serialize(J.MLSumcheck.prove(jp))
    s = T.MLSumcheck.extract_sum(proof)
    sub = T.MLSumcheck.verify(tp.info(), s, proof)
    jsub = J.MLSumcheck.verify(jp.info(), J.Fr(s.v), J.ml_sumcheck.deserialize_proof(
        serialize_proof(proof)))
    assert [x.v for x in sub.point] == [x.v for x in jsub.point]
    assert sub.expected_evaluation.v == jsub.expected_evaluation.v
    assert tp.evaluate(sub.point) == sub.expected_evaluation


def test_interactive_tier_matches():
    jp, tp = both("shared_ragged", seed=5)
    jst = J.IPForMLSumcheck.prover_init(jp)
    st = T.IPForMLSumcheck.prover_init(tp, device="cpu")
    jrng, rng = J.Blake2b512Rng.setup(), T.Blake2b512Rng.setup()
    jv = v = None
    for _ in range(tp.num_variables):
        jm = J.IPForMLSumcheck.prove_round(jst, jv)
        m = T.IPForMLSumcheck.prove_round(st, v)
        assert m.serialize_uncompressed() == jm.serialize_uncompressed()
        jrng.feed(jm)
        rng.feed(m)
        jv = J.IPForMLSumcheck.sample_round(jrng)
        v = T.IPForMLSumcheck.sample_round(rng)
        assert v.randomness.v == jv.randomness.v


def test_tampered_proof_is_rejected():
    _, tp = both("2x3", seed=6)
    proof = T.MLSumcheck.prove(tp, device="cpu")
    s = T.MLSumcheck.extract_sum(proof)
    with pytest.raises(T.Reject):
        T.MLSumcheck.verify(tp.info(), s + T.Fr.one(), proof)
    bad = deserialize_proof(serialize_proof(proof))
    bad[2].evaluations[1] = bad[2].evaluations[1] + T.Fr.one()
    with pytest.raises(T.Reject):
        T.MLSumcheck.verify(tp.info(), s, bad)
    with pytest.raises(T.SerializationError):
        deserialize_proof(serialize_proof(proof) + b"\0")


def test_constant_polynomial_is_refused():
    poly = T.ListOfProductsOfPolynomials(0)
    poly.add_product([T.DenseMLE.zero(0)], T.Fr(1))
    with pytest.raises(T.SumcheckError):
        T.MLSumcheck.prove(poly, device="cpu")


def _golden_poly(fx):
    from test_golden import gen_table

    nv = fx["nv"]
    prefix = "nv14" if nv == 14 else "nv6"
    shared = {}
    poly = T.ListOfProductsOfPolynomials(nv)
    for prod in fx["products"]:
        mles = []
        for tag in prod["tables"]:
            if tag not in shared:
                shared[tag] = T.DenseMLE.from_evaluations(nv, gen_table(f"{prefix}/{tag}", nv))
            mles.append(shared[tag])
        poly.add_product(mles, T.Fr(int(prod["coeff"], 16)))
    return poly


@pytest.mark.parametrize("fixture", ["ml_nv6_rich.json", "ml_nv14_config1.json"])
def test_ml_golden_fixture_on_cpu(fixture):
    with open(os.path.join(FIXDIR, fixture)) as f:
        fx = json.load(f)
    poly = _golden_poly(fx)
    assert poly.info().serialize_uncompressed().hex() == fx["info_bytes"]
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, poly, device="cpu")
    assert serialize_proof(proof).hex() == fx["proof_bytes"]
    assert [format(r.v, "064x") for r in state.randomness] == fx["challenges"]
    assert T.MLSumcheck.extract_sum(proof).v == int(fx["asserted_sum"], 16)
    sub = T.MLSumcheck.verify(poly.info(), T.Fr(int(fx["asserted_sum"], 16)), proof)
    assert [format(r.v, "064x") for r in sub.point] == fx["challenges"]
    assert sub.expected_evaluation.v == int(fx["final_evaluation"], 16)
    assert poly.evaluate(sub.point) == sub.expected_evaluation


def test_convert_rejects_wrong_table_shapes():
    good = _tables(0, 3, 1)[0]
    with pytest.raises(ValueError):
        polynomial_from_numpy(4, [good], [(1, [0])])
    with pytest.raises(ValueError):
        polynomial_from_numpy(3, [good[:8]], [(1, [0])])


@pytest.mark.parametrize("source", ["init_pair", "init_pairs", "sharded", "to_device",
                                    "gkr_phase1", "gkr_phase2", "entry"])
def test_every_pair_is_packed_limbs(source):
    """Every table pair and cached table the port builds holds 8 x 32-bit
    limbs a value: (..., 8, H) int32, contiguous: the ML pair, the batched
    pair, a rank's sharded pair, `DenseMLE.to_device`'s cache, the GKR
    phase pairs and `entry()`'s pair."""
    from sumcheck_tpu_torch import entry as E
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from test_torch_gkr import instances

    _jp, tp = both("2x3", seed=5)
    half = 1 << (tp.num_variables - 1)
    if source == "init_pair":
        pairs, lead = TD.init_pair(tp, "cpu")[:2], (6,)
    elif source == "init_pairs":
        pairs, lead = TD.init_pairs([tp, tp], "cpu")[:2], (2, 6)
    elif source == "sharded":
        pairs, lead, half = TD.init_pair(tp, "cpu", (1, 4))[:2], (6,), half // 4
    elif source == "to_device":
        pairs, lead, half = [m.to_device("cpu") for m in tp.flattened_ml_extensions], (), 2 * half
    elif source == "entry":
        pairs, lead, half = E.entry(device="cpu")[1][:2], (6,), 128
    else:
        dim = 4
        _j, (t1, t2, t3, tg) = instances(dim, seed=dim, nnz=3 << dim)
        gbits, x, y_rev, vals, last_x, perm_y, last_y = GI._split_f1_device(t1, dim, "cpu")
        g_r, g_omr = (GI.upload(a, torch.device("cpu")) for a in GI._points_arrays(tg))
        lo, hi, w = GI.phase1_pair(gbits, last_x, y_rev, vals, g_r, g_omr, t3.to_device("cpu"),
                                   t2.to_device("cpu"), dim)
        pairs, lead, half = (lo, hi), (2,), 1 << (dim - 1)
        if source == "gkr_phase2":
            u = torch.from_numpy(np.stack([TL.mont_scalar(7 + i)[:, 0] for i in range(dim)])
                                 .astype(np.int32))
            pairs = GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], u[-1], x, perm_y, last_y, w, u,
                                   t3.to_device("cpu"), dim)
    for t in pairs:
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert tuple(t.shape) == lead + (8, half), (source, tuple(t.shape))
