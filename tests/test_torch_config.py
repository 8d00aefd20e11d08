"""The JAX package's engine variables and a foreign transcript, on the CPU
against the JAX package, tolerance 0:

- `sumcheck_tpu_torch/utils/config.py` refuses, naming the variable, every
  value of ``SUMCHECK_TPU_CHAINED``, ``SUMCHECK_TPU_DEVICE_THRESHOLD`` and
  ``SUMCHECK_TPU_ENGINE`` that the port does not honour, at import; the
  values it takes change no byte of a proof;
- a transcript of another class that draws through `next_u64s` (the JAX
  package's `fr_rand` branch for it): ML and GKR proofs equal to the JAX
  package's over its counterpart, and a counter shows the draws took
  `next_u64s`.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys

import pytest

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.utils.config import get_config as j_get_config
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.utils.config import check_engine_variables
from sumcheck_tpu_torch.utils.errors import SumcheckError
from test_torch_gkr import instances as gkr_instances
from test_torch_prover import both, jax_host_prove

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GKR_DIM = 4

REFUSED = [("SUMCHECK_TPU_CHAINED", "off"), ("SUMCHECK_TPU_CHAINED", "sometimes"),
           ("SUMCHECK_TPU_DEVICE_THRESHOLD", "64"), ("SUMCHECK_TPU_DEVICE_THRESHOLD", "-1"),
           ("SUMCHECK_TPU_DEVICE_THRESHOLD", "lots"), ("SUMCHECK_TPU_ENGINE", "host"),
           ("SUMCHECK_TPU_ENGINE", "tpu")]
TAKEN = {"defaults": {},
         "chain": {"SUMCHECK_TPU_CHAINED": "on", "SUMCHECK_TPU_DEVICE_THRESHOLD": "0",
                   "SUMCHECK_TPU_ENGINE": "device"},
         "auto": {"SUMCHECK_TPU_CHAINED": "auto", "SUMCHECK_TPU_ENGINE": "auto"},
         "empty": {"SUMCHECK_TPU_CHAINED": "", "SUMCHECK_TPU_DEVICE_THRESHOLD": "",
                   "SUMCHECK_TPU_ENGINE": ""}}


@pytest.mark.parametrize("variable,value", REFUSED)
def test_refused_values_name_the_variable(variable, value):
    """``CHAINED=off``, any threshold but 0, ``ENGINE=host`` (the JAX
    package's host engine and host loop, which the port does not have) and
    values neither package knows raise `SumcheckError` naming the
    variable and its value."""
    with pytest.raises(SumcheckError, match=f"{variable}={value!r}"):
        check_engine_variables({variable: value})


@pytest.mark.parametrize("setting", sorted(TAKEN))
def test_taken_values_pass(setting):
    """The values that mean what the port does (chain on the prover's
    device), and unset or empty ones, pass."""
    check_engine_variables(TAKEN[setting])


def _child(env: dict) -> subprocess.CompletedProcess:
    """The port alone in a child process under `env`: an ML prove on the
    CPU, its proof bytes printed in hex."""
    script = ("import random, sumcheck_tpu_torch as T\n"
              "from sumcheck_tpu_torch.ml_sumcheck import serialize_proof\n"
              "p = T.ListOfProductsOfPolynomials(3)\n"
              "rnd = random.Random(2)\n"
              "p.add_product([T.DenseMLE.rand(3, rnd) for _ in range(2)], T.Fr(5))\n"
              "print(serialize_proof(T.MLSumcheck.prove(p, device='cpu')).hex())\n")
    env = dict({k: v for k, v in os.environ.items() if not k.startswith("SUMCHECK_TPU_")}, **env)
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)


def test_variables_are_checked_at_import():
    """Importing the port checks the variables: ``SUMCHECK_TPU_CHAINED=off``
    stops the import with the variable's name; the taken values prove the
    same bytes as the defaults, and as the JAX package."""
    refused = _child({"SUMCHECK_TPU_CHAINED": "off"})
    assert refused.returncode != 0 and refused.stdout == ""
    assert "SumcheckError: SUMCHECK_TPU_CHAINED='off'" in refused.stderr
    runs = [_child(TAKEN[s]) for s in ("defaults", "chain")]
    assert all(r.returncode == 0 for r in runs), [r.stderr[-2000:] for r in runs]
    jp = J.ListOfProductsOfPolynomials(3)
    rnd = random.Random(2)
    jp.add_product([J.DenseMLE.rand(3, rnd) for _ in range(2)], J.Fr(5))
    want = j_serialize(jax_host_prove(jp)[0]).hex()
    assert [r.stdout.strip() for r in runs] == [want, want]


class _U64sRng:
    """A transcript of another class with `feed`, `next_u64` and
    `next_u64s` only, over a `rng`; counts the calls of each draw."""

    def __init__(self, rng):
        self.rng = rng
        self.calls = {"next_u64": 0, "next_u64s": 0}

    def feed(self, msg):
        self.rng.feed(msg)

    def next_u64(self):
        self.calls["next_u64"] += 1
        return self.rng.next_u64()

    def next_u64s(self, k):
        self.calls["next_u64s"] += 1
        return self.rng.next_u64s(k)


@pytest.mark.parametrize("kind", ["ml", "gkr"])
def test_foreign_transcript_draws_through_next_u64s(kind):
    """`fr_rand` takes a foreign transcript's `next_u64s(4)` before its
    `next_u64` (the JAX package's branch order): every draw goes through
    `next_u64s`, and the ML and GKR proofs and final transcripts equal the
    JAX package's over the same kind of transcript."""
    rng, jrng = _U64sRng(T.Blake2b512Rng.setup()), _U64sRng(J.Blake2b512Rng.setup())
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        if kind == "ml":
            jp, tp = both("2x3", seed=6)
            jproof, _ = J.MLSumcheck.prove_as_subprotocol(jrng, jp)
            proof, _ = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
            got, want, rounds = serialize_proof(proof), j_serialize(jproof), tp.num_variables
        else:
            ref, port = gkr_instances(GKR_DIM, seed=7)
            jproof = J.GKRRoundSumcheck.prove(jrng, *ref)
            proof = T.GKRRoundSumcheck.prove(rng, *port, device="cpu")
            got, want = proof.serialize_uncompressed(), jproof.serialize_uncompressed()
            rounds = 2 * GKR_DIM
    finally:
        cfg.engine = saved
    assert got == want
    assert rng.rng.state_tuple() == jrng.rng.state_tuple()
    assert rng.calls["next_u64"] == 0 and rng.calls["next_u64s"] >= rounds
    assert rng.calls == jrng.calls
