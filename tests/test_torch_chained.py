"""The port's chained provers on CPU (`device="cpu"`: the kernels' plain
versions) against the JAX package: `MLSumcheck.prove_as_subprotocol` with
`chain_impl="persize"` (`protocol/device_prover.prove_chained`) and with
`"generic"` (`protocol/generic_prover.prove_generic`), both with the
transcript on the device, and the host-transcript loop that any other
transcript takes.

Compared with the JAX host-engine proof of the same polynomial (carried
across by `convert.polynomial_from_numpy`): proof bytes, challenges, the
caller's transcript state after the prove (`state_tuple()`), and the
subclaim point. JAX's own `prove_chained` compiles per size, so it is
compared only in a `slow` test. Tolerance 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import weakref

import pytest

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.utils.config import get_config as j_get_config
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.protocol import device_prover as TD
from sumcheck_tpu_torch.protocol import generic_prover as TG
from sumcheck_tpu_torch.utils.config import get_config
from test_torch_prover import FIXDIR, SHAPES, _golden_poly, both, jax_host_prove

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ["generic", "persize"]


@pytest.fixture
def chain(request, monkeypatch):
    monkeypatch.setattr(get_config(), "chain_impl", request.param)
    return request.param


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("chain", IMPLS, indirect=True)
def test_prove_matches_jax_host_engine(chain, shape):
    jp, tp = both(shape, seed=3)
    jproof, jstate, jrng = jax_host_prove(jp)
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
    # the caller's transcript ends in the identical state (composition)
    assert rng.state_tuple() == jrng.state_tuple()
    assert state.round == tp.num_variables
    sub = T.MLSumcheck.verify(tp.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert state.randomness == sub.point
    assert tp.evaluate(sub.point) == sub.expected_evaluation


@pytest.mark.parametrize("chain", IMPLS, indirect=True)
def test_composition_after_pending_bytes(chain):
    """A transcript that holds pending bytes before the prove (a full block
    and a part), and that goes on after it: every byte the caller draws
    afterwards equals the JAX host path's."""
    jp, tp = both("shared_ragged", seed=7)
    prefix = bytes(range(200))
    jrng = J.Blake2b512Rng.setup()
    jrng.feed_bytes(prefix)
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        jproof, _ = J.MLSumcheck.prove_as_subprotocol(jrng, jp)
    finally:
        cfg.engine = saved
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(prefix)
    proof, _ = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert rng.state_tuple() == jrng.state_tuple()
    assert rng.fill_bytes(100) == jrng.fill_bytes(100)


@pytest.mark.parametrize("chain", IMPLS, indirect=True)
def test_ml_golden_fixture_through_chain(chain):
    with open(os.path.join(FIXDIR, "ml_nv6_rich.json")) as f:
        fx = json.load(f)
    poly = _golden_poly(fx)
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, poly, device="cpu")
    assert serialize_proof(proof).hex() == fx["proof_bytes"]
    assert [format(r.v, "064x") for r in state.randomness] == fx["challenges"]
    sub = T.MLSumcheck.verify(poly.info(), T.Fr(int(fx["asserted_sum"], 16)), proof)
    assert sub.expected_evaluation.v == int(fx["final_evaluation"], 16)


@pytest.mark.parametrize("value", ["", "generic", "persize", "other"])
def test_chain_impl_env_is_parsed_as_in_jax(value):
    """`SUMCHECK_TPU_CHAIN_IMPL` gives both packages the same setting, read
    at import; unset means "generic"."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SUMCHECK_TPU_CHAIN_IMPL", None)
    if value:
        env["SUMCHECK_TPU_CHAIN_IMPL"] = value
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            from sumcheck_tpu_torch.utils.config import get_config
            from sumcheck_tpu.utils.config import get_config as j
            print(repr((get_config().chain_impl, j().chain_impl)))
        """)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    want = value or "generic"
    assert proc.stdout.strip() == repr((want, want))


class _OtherRng:
    """A transcript other than `Blake2b512Rng`, with the same bytes: what a
    caller's own `FeedableRNG` looks like to `prove_as_subprotocol`."""

    def __init__(self):
        self._rng = T.Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def next_u64(self):
        return self._rng.next_u64()


@pytest.mark.parametrize("impl", ["generic", "persize", "other"])
def test_dispatch(impl, monkeypatch):
    """A `Blake2b512Rng` goes to the generic chain for "generic" and to the
    per-size chain for any other value; any other transcript takes the host
    loop, whatever the setting, and the bytes are the same."""
    monkeypatch.setattr(get_config(), "chain_impl", impl)
    ran = []
    for mod, name in ((TG, "prove_generic"), (TD, "prove_chained"),
                      (TG, "prove_host_transcript")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, _f=real, **k: ran.append(_n) or _f(*a, **k))
    _, tp = both("2x3", seed=1)
    proof, _ = T.MLSumcheck.prove_as_subprotocol(T.Blake2b512Rng.setup(), tp, device="cpu")
    assert ran == ["prove_generic" if impl == "generic" else "prove_chained"]

    ran.clear()
    monkeypatch.setattr(TC, "transcript_step_ref",
                        lambda *a: pytest.fail("the host loop ran a device transcript step"))
    other = _OtherRng()
    host_proof, _ = T.MLSumcheck.prove_as_subprotocol(other, tp, device="cpu")
    assert ran == ["prove_host_transcript"]
    assert serialize_proof(host_proof) == serialize_proof(proof)


def test_persize_chain_releases_folded_pairs():
    """`chain_rounds` keeps no reference to a pair it has folded away."""
    _, tp = both("2x3", seed=2)
    lo, hi, products, degree = TD.init_pair(tp, "cpu")
    first = weakref.ref(lo)
    pair = [lo, hi]
    del lo, hi
    state = TD.lift_transcript(T.Blake2b512Rng.setup(), TD.resolve_device("cpu"))
    msgs, rs, state, (lo, hi) = TD.chain_rounds(pair, state, products, degree, 3)
    assert pair == [] and first() is None
    assert lo.shape[2] == (1 << (tp.num_variables - 1)) >> 2
    assert msgs.shape == (3, 16, degree + 1) and rs.shape == (3, 16)


@pytest.mark.slow
@pytest.mark.parametrize("chain", IMPLS, indirect=True)
def test_prove_matches_jax_prove_chained(chain):
    """Against the JAX package's own per-size chain (jit per size)."""
    jp, tp = both("shared_ragged", seed=4)
    cfg = j_get_config()
    saved = (cfg.chained, cfg.device_threshold, cfg.chain_impl)
    try:
        cfg.chained, cfg.device_threshold, cfg.chain_impl = "on", 1, "persize"
        jrng = J.Blake2b512Rng.setup()
        jproof, jstate = J.MLSumcheck.prove_as_subprotocol(jrng, jp)
    finally:
        cfg.chained, cfg.device_threshold, cfg.chain_impl = saved
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert rng.state_tuple() == jrng.state_tuple()
    assert [r.v for r in state.randomness] == [r.v for r in jstate.randomness]
