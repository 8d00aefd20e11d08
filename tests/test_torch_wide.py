"""Fault F4 on the CPU: every product structure the JAX package proves, the
port proves, byte-equal to the JAX package's host engine (tolerance 0).

The kernels carry a by-value plan up to 16 slots, 16 products, 8 factors
and degree 8; past any of these a structure takes the wide route
(`round_cuda.route`, the pair init's and the transcript step's wide
bodies). On the CPU the wrappers run the plain versions, which take any
structure; these tests hold the whole paths to the JAX package:

- F4's structures, (a) 17 products of one table at nv=4, (b) one product
  of 9 tables at nv=3, (c) 17 pairs of 7 tables with coefficients 2..18 at
  nv=3, 18 tables in pairs with a zero coefficient, and a product of 20
  tables beside 40 single-table products with random coefficients, on the
  generic chain, the per-size chain and the MXU fold mode: proof bytes,
  challenges and the transcript after the prove;
- the interactive tier, each round's message and
  `flattened_ml_extensions` against the JAX package's state;
- a batch of (a);
- a structure whose products straddle the wide route's chunk boundary at
  t = 12 (`f4_cases.chunk_structure`: a product of 17 tables and one of 9
  beside single-table products, random coefficients) on the three chains,
  the interactive tier and a batch;
- a `hypothesis` fuzz over structures of up to 24 tables, 1-20 products
  and degree up to 12 at nv <= 4.

The sharded provers' cases run in `tests/test_torch_parallel.py`'s S = 2
spawn, the BN254 ones in `tests/test_torch_field.py`, and the kernels'
wide bodies on the card in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.fields.fr import P
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.protocol import device_prover as JD
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.protocol import device_prover as TD
from sumcheck_tpu_torch.utils.config import get_config
from f4_cases import NAMES, chunk_structure, f4_structure
from test_torch_interactive import _rounds
from test_torch_prover import _tables, jax_host_prove, jax_poly


def f4_polys(name: str, seed: int = 0):
    """(JAX polynomial, port polynomial) of an F4 structure."""
    nv, products, count = f4_structure(name)
    tables = _tables(seed, nv, count)
    return jax_poly(nv, tables, products), polynomial_from_numpy(nv, tables, products)


F4 = list(NAMES)


def test_f4_structures_take_the_wide_route():
    """Each F4 structure is past the by-value plan's maxima (the wide
    route), and its fold plan is the JAX package's, but for the zero
    coefficient's copy slot."""
    for name in F4:
        jp, tp = f4_polys(name)
        products, scale, slots, ones = TD._fold_plan(tp)
        assert RC.route(slots, products, tp.max_multiplicands) == "wide", name
        if name == "tables18":
            jproducts, jscale, jslots, _ = JD._fold_plan(jp)
            assert jscale[0] == (0, 0, 0) and scale[0] == (18, 0, 0)
            assert slots == jslots + 1 == 19 and products[0][0] == 18
        else:
            assert (products, scale, slots, ones) == JD._fold_plan(jp), name


@pytest.mark.parametrize("name", F4)
@pytest.mark.parametrize("chain", ["generic", "persize", "mxu"])
def test_f4_prove_matches_jax(chain, name, monkeypatch):
    """The prove on `device="cpu"` (the kernels' plain versions) on each
    chain: proof bytes, the state's randomness and the transcript after it
    equal to the JAX package's host engine."""
    cfg = get_config()
    monkeypatch.setattr(cfg, "chain_impl", "persize" if chain == "persize" else "generic")
    if chain == "mxu":
        monkeypatch.setattr(cfg, "mxu_fold", "kernel")
        monkeypatch.setattr(cfg, "ab", True)
    jp, tp = f4_polys(name, seed=3)
    jproof, jstate, jrng = jax_host_prove(jp)
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    assert rng.fill_bytes(40) == jrng.fill_bytes(40)


@pytest.mark.parametrize("name", F4)
def test_f4_interactive_matches_jax_round_by_round(name):
    """The interactive tier: each round's message and the tables after it
    (`flattened_ml_extensions`, the zero coefficient's table included)
    equal the JAX package's state."""
    jp, tp = f4_polys(name, seed=5)
    rounds = 0
    for jst, st, jm, m in _rounds(jp, tp, seed=len(name)):
        assert m.serialize_uncompressed() == jm.serialize_uncompressed()
        assert [t.tolist() for t in st.flattened_ml_extensions] == \
            [np.asarray(t).tolist() for t in jst.flattened_ml_extensions]
        rounds += 1
    assert rounds == tp.num_variables


def test_f4_batch_matches_jax():
    """A batch of three (a) instances (`BatchedMLSumcheck`, the batched
    chain) against each instance's JAX prove: proofs, challenges and the
    transcripts after them."""
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck

    pairs = [f4_polys("a", seed=s) for s in range(3)]
    rngs = [T.Blake2b512Rng.setup() for _ in pairs]
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
        rngs, [tp for _jp, tp in pairs], device="cpu")
    for (jp, _tp), proof, ch, rng in zip(pairs, proofs, challenges, rngs):
        jproof, jstate, jrng = jax_host_prove(jp)
        assert serialize_proof(proof) == j_serialize(jproof)
        assert [r.v for r in ch] == [r.v for r in jstate.randomness]
        assert rng.fill_bytes(16) == jrng.fill_bytes(16)


def chunk_polys(seed: int = 0):
    """(JAX polynomial, port polynomial) of `chunk_structure`."""
    nv, products, count = chunk_structure()
    tables = _tables(seed, nv, count)
    return jax_poly(nv, tables, products), polynomial_from_numpy(nv, tables, products)


@pytest.mark.parametrize("chain", ["generic", "persize", "mxu"])
def test_chunk_boundary_prove_matches_jax(chain, monkeypatch):
    """Products across the wide route's chunk boundary (degree 17: two
    chunks of the kernels' 12 points), on each chain: proof bytes,
    challenges and the transcript after it equal to the JAX package's host
    engine; the structure takes the wide route with padding."""
    cfg = get_config()
    monkeypatch.setattr(cfg, "chain_impl", "persize" if chain == "persize" else "generic")
    if chain == "mxu":
        monkeypatch.setattr(cfg, "mxu_fold", "kernel")
        monkeypatch.setattr(cfg, "ab", True)
    jp, tp = chunk_polys(seed=11)
    products, _scale, slots, ones = TD._fold_plan(tp)
    assert ones and products.ones == slots - 1
    assert RC.route(slots, products, tp.max_multiplicands) == "wide"
    assert RC.wide_points(tp.max_multiplicands) < tp.max_multiplicands + 1
    jproof, jstate, jrng = jax_host_prove(jp)
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    assert rng.fill_bytes(40) == jrng.fill_bytes(40)


def test_chunk_boundary_interactive_and_batch_match_jax():
    """The same structure on the interactive tier (each round's message and
    `flattened_ml_extensions` against the JAX package's state) and as a
    batch of two instances (`BatchedMLSumcheck`) against each instance's
    JAX prove."""
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck

    jp, tp = chunk_polys(seed=12)
    rounds = 0
    for jst, st, jm, m in _rounds(jp, tp, seed=17):
        assert m.serialize_uncompressed() == jm.serialize_uncompressed()
        assert [t.tolist() for t in st.flattened_ml_extensions] == \
            [np.asarray(t).tolist() for t in jst.flattened_ml_extensions]
        rounds += 1
    assert rounds == tp.num_variables
    pairs = [chunk_polys(seed=s) for s in (13, 14)]
    rngs = [T.Blake2b512Rng.setup() for _ in pairs]
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
        rngs, [tp for _jp, tp in pairs], device="cpu")
    for (jp, _tp), proof, ch, rng in zip(pairs, proofs, challenges, rngs):
        jproof, jstate, jrng = jax_host_prove(jp)
        assert serialize_proof(proof) == j_serialize(jproof)
        assert [r.v for r in ch] == [r.v for r in jstate.randomness]
        assert rng.fill_bytes(16) == jrng.fill_bytes(16)


@st.composite
def structures(draw):
    """nv <= 4; 1-24 tables; 1-20 products of 1-12 tables each (repeats
    allowed), coefficients 0, 1 or random."""
    nv = draw(st.integers(1, 4))
    count = draw(st.integers(1, 24))
    degree = draw(st.integers(1, 12))
    products = []
    for _ in range(draw(st.integers(1, 20))):
        factors = draw(st.integers(1, degree))
        ix = draw(st.lists(st.integers(0, count - 1), min_size=factors, max_size=factors))
        coeff = draw(st.sampled_from([0, 1, None]))
        if coeff is None:
            coeff = draw(st.integers(2, P - 1))
        products.append((coeff, ix))
    return nv, products, count, draw(st.integers(0, 1 << 16))


@settings(max_examples=12, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(structures())
def test_structure_fuzz_matches_jax(case):
    """Any structure, within the sizes above, proves on the generic chain
    with the JAX package's bytes and transcript."""
    nv, products, count, seed = case
    tables = _tables(seed, nv, count)
    used = sorted({s for _c, ix in products for s in ix})  # the polynomial's own tables
    remap = {s: i for i, s in enumerate(used)}
    products = [(c, [remap[s] for s in ix]) for c, ix in products]
    tables = [tables[s] for s in used]
    jp, tp = jax_poly(nv, tables, products), polynomial_from_numpy(nv, tables, products)
    jproof, _jstate, jrng = jax_host_prove(jp)
    rng = T.Blake2b512Rng.setup()
    proof, _state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert rng.fill_bytes(16) == jrng.fill_bytes(16)
