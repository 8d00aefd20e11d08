"""Per-instance fields in the port (`fields/generic.py`, `portable.py`, the
`field=` promotion and dispatch) against the JAX package's, in process,
under the default field (BLS12-381 Fr):

- proofs over a per-instance `Field` (BN254 Fr and the 61-bit Mersenne
  prime) are byte-equal to the JAX package's portable engine, for ML and
  GKR, and verify alike; a `device=` is accepted and ignored there;
- two fields in one process, bad primes rejected (the
  `tests/test_field_api.py` patterns);
- the portable engine over the default field equals the port's chain;
- a BN254 per-instance proof equals the BN254 process-default proof of
  `tests/fixtures/bn254_torch.json` (made by the JAX package under
  `SUMCHECK_TPU_FIELD=bn254_fr`).

Tolerance 0: exact field arithmetic.
"""

from __future__ import annotations

import json
import os
import random

import pytest

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu import portable as JP
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu_torch import portable as TP
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bn254_torch.json")
PRIMES = {"bn254": 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
          "p61": (1 << 61) - 1}


def _ml(pkg, field, seed: int, nv: int = 5):
    """Two products over three shared tables of `field`, from
    `random.Random(seed)`, in package `pkg`."""
    rnd = random.Random(seed)
    mles = [pkg.PortableDenseMLE.rand(field, nv, rnd) for _ in range(3)]
    poly = pkg.ListOfProductsOfPolynomials(nv, field=field)
    poly.add_product(mles[:2], field.el(7))
    poly.add_product([mles[1], mles[2], mles[0]], field.el(rnd.randrange(field.P)))
    return poly


def _gkr(pkg, field, seed: int, dim: int = 3):
    rnd = random.Random(seed)
    f1 = pkg.PortableSparseMLE.rand_with_config(field, 3 * dim, 1 << dim, rnd)
    f2 = pkg.PortableDenseMLE.rand(field, dim, rnd)
    f3 = pkg.PortableDenseMLE.rand(field, dim, rnd)
    return f1, f2, f3, [field.el(rnd.randrange(field.P)) for _ in range(dim)]


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_portable_ml_equals_jax(prime):
    tf, jf = T.Field(PRIMES[prime], prime), J.Field(PRIMES[prime], prime)
    assert not tf.is_default
    tpoly, jpoly = _ml(T, tf, 1), _ml(J, jf, 1)
    assert isinstance(tpoly, TP.PortableListOfProducts)
    rng, jrng = T.Blake2b512Rng.setup(), J.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tpoly, device="cuda")  # ignored
    jproof, jstate = J.MLSumcheck.prove_as_subprotocol(jrng, jpoly)
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    assert rng.state_tuple() == jrng.state_tuple()
    s = T.MLSumcheck.extract_sum(proof)
    assert isinstance(s, T.FieldEl) and s.f is tf
    sub = T.MLSumcheck.verify(tpoly.info(), s, proof)
    jsub = J.MLSumcheck.verify(jpoly.info(), jf.el(s.v), jproof)
    assert [x.v for x in sub.point] == [x.v for x in jsub.point]
    assert sub.expected_evaluation.v == jsub.expected_evaluation.v
    assert tpoly.evaluate(sub.point) == sub.expected_evaluation
    with pytest.raises(T.Reject):
        T.MLSumcheck.verify(tpoly.info(), s + tf.one(), proof)


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_portable_gkr_equals_jax(prime):
    tf, jf = T.Field(PRIMES[prime], prime), J.Field(PRIMES[prime], prime)
    t_inst, j_inst = _gkr(T, tf, 2), _gkr(J, jf, 2)
    rng, jrng = T.Blake2b512Rng.setup(), J.Blake2b512Rng.setup()
    proof = T.GKRRoundSumcheck.prove(rng, *t_inst, device="cuda")  # ignored
    jproof = J.GKRRoundSumcheck.prove(jrng, *j_inst)
    assert proof.serialize_uncompressed() == jproof.serialize_uncompressed()
    assert rng.state_tuple() == jrng.state_tuple()
    s = proof.extract_sum()
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), 3, proof, s)
    jsub = J.GKRRoundSumcheck.verify(J.Blake2b512Rng.setup(), 3, jproof, jf.el(s.v))
    assert [x.v for x in sub.u + sub.v] == [x.v for x in jsub.u + jsub.v]
    assert sub.expected_evaluation.v == jsub.expected_evaluation.v
    f1, f2, f3, g = t_inst
    guv = list(g) + list(sub.u) + list(sub.v)
    assert f1.evaluate(guv) * f2.evaluate(sub.u) * f3.evaluate(sub.v) == sub.expected_evaluation


def test_two_fields_one_process():
    """Default-field and BN254 proves interleaved, no reimports (the
    `tests/test_field_api.py` pattern): the default field on the port's
    chain (`device="cpu"`), BN254 on the portable engine."""
    rnd = random.Random(3)
    seen = set()
    for field in (T.default_field(), T.get_field("bn254_fr"), T.default_field()):
        nv = 5
        poly = T.ListOfProductsOfPolynomials(nv, field=field)
        if field.is_default:
            assert type(poly) is T.ListOfProductsOfPolynomials
            mles = [T.DenseMLE.rand(nv, rnd) for _ in range(3)]
        else:
            mles = [T.PortableDenseMLE.rand(field, nv, rnd) for _ in range(3)]
        poly.add_product(mles[:2], field.el(7))
        poly.add_product([mles[1], mles[2]], field.el(rnd.randrange(field.P)))
        proof = T.MLSumcheck.prove(poly, device="cpu")
        s = T.MLSumcheck.extract_sum(proof)
        sub = T.MLSumcheck.verify(poly.info(), s, proof)
        assert poly.evaluate(sub.point) == sub.expected_evaluation
        with pytest.raises(T.Reject):
            T.MLSumcheck.verify(poly.info(), s + field.one(), proof)
        seen.add(field.name)
    assert seen == {"bls12_381_fr", "bn254_fr"}


def test_registry_and_default_field():
    d = T.default_field()
    assert d.is_default and d.name == "bls12_381_fr" and d.P == T.fields.fr.P
    assert T.get_field("bls12_381_fr") is d and T.get_field(d.P) is not d
    assert T.get_field(d.P).is_default
    assert isinstance(d.el(5), T.Fr) and d.el(5) == T.Fr(5)
    bn = T.get_field("bn254_fr")
    assert bn.P == PRIMES["bn254"] and bn.SHAVE_BITS == 2 and not bn.is_default
    x = bn.el(PRIMES["bn254"] + 3)
    assert isinstance(x, T.FieldEl) and x.v == 3 and (x * x.inverse()).v == 1
    with pytest.raises(TypeError):
        x + T.Fr(1)
    with pytest.raises(KeyError):
        T.get_field("goldilocks")
    for name in ("Field", "FieldEl", "default_field", "get_field", "PortableDenseMLE",
                 "PortableSparseMLE"):
        assert name in T.__all__ and hasattr(T, name)


def test_field_constructor_rejects_bad_primes():
    for bad in (1 << 256, (1 << 255) + 5, 1 << 60, 4, 10, 1, 0):
        with pytest.raises(ValueError, match="Field support envelope"):
            T.Field(bad)
    assert T.Field((1 << 61) - 1).MODULUS_BITS == 61


def test_portable_engine_over_the_default_field_equals_the_chain():
    """The portable engine over the DEFAULT field against the port's chain
    (`device="cpu"`): the same proof bytes."""
    field = T.default_field()
    rnd = random.Random(4)
    nv = 5
    values = [[T.Fr(rnd.randrange(field.P)) for _ in range(1 << nv)] for _ in range(3)]
    fast = T.ListOfProductsOfPolynomials(nv)
    port = TP.PortableListOfProducts(nv, field)
    fast_m = [T.DenseMLE.from_evaluations(nv, v) for v in values]
    port_m = [T.PortableDenseMLE.from_evaluations(field, nv, v) for v in values]
    coeffs = [T.Fr(7), T.Fr(rnd.randrange(field.P))]
    fast.add_product(fast_m[:2], coeffs[0])
    fast.add_product([fast_m[1], fast_m[2], fast_m[0]], coeffs[1])
    port.add_product(port_m[:2], coeffs[0])
    port.add_product([port_m[1], port_m[2], port_m[0]], coeffs[1])
    proof = T.MLSumcheck.prove(fast, device="cpu")
    port_proof, _state = TP.prove_as_subprotocol(T.Blake2b512Rng.setup(), port)
    assert serialize_proof(proof) == serialize_proof(port_proof)


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def test_bn254_per_instance_ml_equals_the_process_default_fixture():
    """The fixture's ML proof was made with BN254 as the process field;
    here BN254 is a per-instance field over the BLS12-381 process."""
    fx = _fixture()["ml"]
    bn = T.get_field("bn254_fr")
    nv = fx["nv"]
    shared, poly = {}, T.ListOfProductsOfPolynomials(nv, field=bn)
    from test_torch_field import golden_table

    for prod in fx["products"]:
        mles = []
        for tag in prod["tables"]:
            if tag not in shared:
                shared[tag] = T.PortableDenseMLE.from_evaluations(
                    bn, nv, golden_table(f"nv6/{tag}", nv, bn.P))
            mles.append(shared[tag])
        poly.add_product(mles, bn.el(int(prod["coeff"], 16)))
    assert poly.info().serialize_uncompressed().hex() == fx["info_bytes"]
    proof, state = T.MLSumcheck.prove_as_subprotocol(T.Blake2b512Rng.setup(), poly)
    assert serialize_proof(proof).hex() == fx["proof_bytes"]
    assert [format(r.v, "064x") for r in state.randomness] == fx["challenges"]
    sub = T.MLSumcheck.verify(poly.info(), bn.el(int(fx["asserted_sum"], 16)), proof)
    assert sub.expected_evaluation.v == int(fx["final_evaluation"], 16)


def test_bn254_per_instance_gkr_and_draws_equal_the_fixture():
    fx = _fixture()
    gx = fx["gkr"]
    bn = T.get_field("bn254_fr")
    dim = gx["dim"]
    from test_torch_field import golden_table

    f1 = T.PortableSparseMLE(bn, 3 * dim, {int(k): bn.el(int(v, 16))
                                            for k, v in gx["f1_nonzeros"].items()})
    f2 = T.PortableDenseMLE.from_evaluations(bn, dim, golden_table(f"gkr{dim}/f2", dim, bn.P))
    f3 = T.PortableDenseMLE.from_evaluations(bn, dim, golden_table(f"gkr{dim}/f3", dim, bn.P))
    g = [bn.el(int(x, 16)) for x in gx["g"]]
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, g)
    hexes = [[format(e.v, "064x") for e in m.evaluations] for m in proof.phase1_sumcheck_msgs]
    assert hexes == gx["phase1_msgs"]
    hexes = [[format(e.v, "064x") for e in m.evaluations] for m in proof.phase2_sumcheck_msgs]
    assert hexes == gx["phase2_msgs"]
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
    assert [format(x.v, "064x") for x in sub.u] == gx["u"]
    assert [format(x.v, "064x") for x in sub.v] == gx["v"]
    assert sub.expected_evaluation.v == int(gx["expected_evaluation"], 16)
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(bytes.fromhex(fx["fr_rand"]["seed_feed"]))
    assert [format(bn.rand(rng).v, "064x") for _ in fx["fr_rand"]["draws_canonical"]] \
        == fx["fr_rand"]["draws_canonical"]
