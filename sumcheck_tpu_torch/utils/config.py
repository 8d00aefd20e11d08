"""Run-time configuration: the knobs of `sumcheck_tpu/utils/config.py` that
the port reads. Each is read once, when this module is imported; set the
field on `get_config()` to change it afterwards.

- ``SUMCHECK_TPU_CHAIN_IMPL``: which chained prover `MLSumcheck` and
  `GKRRoundSumcheck` run for a `Blake2b512Rng` transcript. ``generic`` (the
  default) runs the generic chain (`protocol/generic_prover.py`, one table
  pair folded in place over run-time extents); any other value runs the
  per-size chain (`protocol/device_prover.py`, fresh half-width tables every
  round), as in the JAX package.
- ``SUMCHECK_TPU_MXU_FOLD``: the fold-by-challenge multiply as banded
  8-bit-digit matrix products (`ops/mxu_mul.py`), bit-identical to the CIOS
  multiply. ``off`` | ``on`` / ``xla`` | ``kernel`` | ``auto`` (= off).
  The JAX package's ``xla`` mode runs the products in its XLA-fused chain
  body and ``kernel`` inside its Pallas chain kernel; the port has no
  XLA-fused body, since every chain body is a kernel, so every non-off mode
  selects the same thing here: the generic chain's fold rounds launch the
  tensor-core fold kernel (`round_cuda.round_fold_mxu`, `csrc/round_mxu.cu`),
  and the GKR init's shared-scalar multiplies (eq-table doublings, the
  `f2(u)` scaling) run as banded products. The per-size chain has no MXU
  branch, as in the JAX package.
- ``SUMCHECK_TPU_AB``: unlocks the non-off MXU modes, which the JAX package
  quarantines as measured A/B bodies; without it they raise, with the JAX
  package's error text.

Refused: the JAX package's engine variables, checked once at import
(`check_engine_variables`); a value the port does not honour raises
`SumcheckError` naming the variable. A prove in the port takes the chain
on the prover's device for a transcript it can lift, else the
round-by-round loop on the same device, with the same proof bytes. So
``SUMCHECK_TPU_CHAINED`` may be ``auto`` or ``on``, ``SUMCHECK_TPU_ENGINE``
``auto`` or ``device`` (the JAX package's ``device`` chains every table,
as the port does), and ``SUMCHECK_TPU_DEVICE_THRESHOLD`` only 0; unset or
empty is the first of each. ``CHAINED=off``, a threshold and
``ENGINE=host`` sent proves to the JAX package's NumPy host engine or host
loop to save XLA compiles on small tables; the port has no host round
engine and compiles nothing per table, and nothing falls back to the CPU.

Read elsewhere: ``SUMCHECK_TPU_FIELD`` (`fields/fr.py`, at import; an
unknown name raises) and ``SUMCHECK_TPU_NATIVE`` (`native/__init__.py`, at
every call). Not read, because each tunes the JAX package's TPU blocks,
padding or XLA compiles and has no counterpart in a hand-written kernel:
``SUMCHECK_TPU_PALLAS`` and ``SUMCHECK_TPU_PALLAS_BLOCK`` (Pallas bodies or
XLA-fused ones, and their block), ``SUMCHECK_TPU_GENERIC_BLOCK``,
``SUMCHECK_TPU_BATCH_BLOCK`` and ``SUMCHECK_TPU_TAIL_BLOCK`` (the chains'
lane blocks), ``SUMCHECK_TPU_GENERIC_PAD`` (padding to one compiled
program family), ``SUMCHECK_TPU_KRON_EQ`` (the eq tables' gather form),
``SUMCHECK_TPU_BIG_PAIR_BYTES`` (the incremental pair init for a 16 GB
chip) and ``SUMCHECK_TPU_CIOS`` (the unroll of the traced multiply).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import SumcheckError


@dataclass
class Config:
    chain_impl: str = os.environ.get("SUMCHECK_TPU_CHAIN_IMPL", "generic")
    mxu_fold: str = os.environ.get("SUMCHECK_TPU_MXU_FOLD", "auto")
    ab: bool = os.environ.get("SUMCHECK_TPU_AB", "0") not in ("", "0", "off")

    def mxu_mode(self) -> str:
        """"off", "xla" or "kernel", resolved and checked as in the JAX
        package (`sumcheck_tpu/utils/config.py:71-87`)."""
        if self.mxu_fold in ("on", "xla", "kernel") and not self.ab:
            raise ValueError(
                f"SUMCHECK_TPU_MXU_FOLD={self.mxu_fold!r} is a quarantined "
                "A/B body (measured slower than the default on the v5e, "
                "MXU_AB.json); set SUMCHECK_TPU_AB=1 to enable it anyway"
            )
        if self.mxu_fold in ("on", "xla"):
            return "xla"
        if self.mxu_fold == "kernel":
            return "kernel"
        if self.mxu_fold not in ("off", "auto"):
            raise ValueError(
                f"SUMCHECK_TPU_MXU_FOLD={self.mxu_fold!r}: "
                "expected off|on|xla|kernel|auto"
            )
        return "off"

    def use_mxu_fold(self) -> bool:
        """Shared-scalar multiplies as banded products (the fold kernel, the
        eq tables, the phase-2 scaling)."""
        return self.mxu_mode() != "off"


def check_engine_variables(environ=os.environ) -> None:
    """Raise `SumcheckError`, naming the variable, for a value of the JAX
    package's engine variables that the port does not honour (see above)."""
    allowed = {"SUMCHECK_TPU_CHAINED": ("auto", "on"), "SUMCHECK_TPU_ENGINE": ("auto", "device"),
               "SUMCHECK_TPU_DEVICE_THRESHOLD": ("0",)}
    for name, values in allowed.items():
        value = environ.get(name) or values[0]
        if value.strip() not in values:
            raise SumcheckError(
                f"{name}={value!r}: the port takes only {' or '.join(values)}; it has no host "
                f"round engine, and a transcript the chain cannot lift already takes the "
                f"round-by-round loop on the prover's device")


check_engine_variables()
_config = Config()


def get_config() -> Config:
    return _config
