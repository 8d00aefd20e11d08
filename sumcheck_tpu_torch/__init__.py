"""sumcheck_tpu_torch — the PyTorch and CUDA port of `sumcheck_tpu`.

`MLSumcheck` (sums of products of multilinear polynomials over the boolean
hypercube, Libra linear-time prover) and `GKRRoundSumcheck` (the Libra
two-phase GKR round function) over the BLS12-381 scalar field (or the
prime ``SUMCHECK_TPU_FIELD`` names, e.g. `bn254_fr`) with the bit-exact
arkworks-compatible Blake2b-512 Fiat-Shamir transcript, hashed in a C core
(`native/`). Other fields per instance (`Field`, `get_field`,
`ListOfProductsOfPolynomials(nv, field=...)`) prove on the portable host
engine (`portable.py`). The prover's
rounds run through hand-written CUDA kernels for Hopper (`ops/round_cuda.py`,
`csrc/round.cu`, `csrc/round_mxu.cu`; the transcript in `csrc/transcript.cu`)
on `device="cuda"`, and through their plain PyTorch versions on
`device="cpu"`. Proofs are byte-identical to the JAX package's.

The batched provers (`BatchedMLSumcheck`, `BatchedGKRRoundSumcheck`) are in
`sumcheck_tpu_torch.batch`, not exported here, as in the JAX package.

This package imports torch and numpy, never JAX and never `sumcheck_tpu`.
Importing it checks the JAX package's engine variables (`utils/config.py`).
"""

from .data_structures import ListOfProductsOfPolynomials, PolynomialInfo
from .fields.fr import Fr
from .fields.generic import Field, FieldEl, default_field, get_field
from .gkr_round_sumcheck import GKRProof, GKRRoundSumcheck, GKRRoundSumcheckSubClaim
from .ml_sumcheck import MLSumcheck
from .mle import DenseMLE, SparseMLE
from .portable import PortableDenseMLE, PortableSparseMLE
from .protocol import IPForMLSumcheck
from .transcript.blake2b_rng import Blake2b512Rng
from .utils import config  # noqa: F401  (refuses the engine variables it does not honour)
from .utils.errors import (
    IOError_,
    OtherError,
    Reject,
    RNGError,
    SerializationError,
    SumcheckError,
)

__version__ = "0.1.0"

__all__ = [
    "Blake2b512Rng",
    "DenseMLE",
    "Field",
    "FieldEl",
    "Fr",
    "PortableDenseMLE",
    "PortableSparseMLE",
    "default_field",
    "get_field",
    "GKRProof",
    "GKRRoundSumcheck",
    "GKRRoundSumcheckSubClaim",
    "IPForMLSumcheck",
    "IOError_",
    "ListOfProductsOfPolynomials",
    "MLSumcheck",
    "OtherError",
    "PolynomialInfo",
    "Reject",
    "RNGError",
    "SerializationError",
    "SparseMLE",
    "SumcheckError",
    "__version__",
]
