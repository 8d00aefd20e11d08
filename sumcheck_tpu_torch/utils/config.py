"""Run-time configuration: the one knob of `sumcheck_tpu/utils/config.py`
that the port reads.

- ``SUMCHECK_TPU_CHAIN_IMPL``: which chained prover `MLSumcheck` runs for a
  `Blake2b512Rng` transcript. ``generic`` (the default) runs the generic
  chain (`protocol/generic_prover.py`, one table pair folded in place over
  run-time extents); any other value runs the per-size chain
  (`protocol/device_prover.py`, fresh half-width tables every round), as in
  the JAX package. Read once, when this module is imported; set
  `get_config().chain_impl` to change it afterwards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class Config:
    chain_impl: str = os.environ.get("SUMCHECK_TPU_CHAIN_IMPL", "generic")


_config = Config()


def get_config() -> Config:
    return _config
