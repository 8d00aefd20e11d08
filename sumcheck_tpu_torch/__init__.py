"""sumcheck_tpu_torch — the PyTorch and CUDA port of `sumcheck_tpu`.

`MLSumcheck` (sums of products of multilinear polynomials over the boolean
hypercube, Libra linear-time prover) and `GKRRoundSumcheck` (the Libra
two-phase GKR round function) over the BLS12-381 scalar field with the
bit-exact arkworks-compatible Blake2b-512 Fiat-Shamir transcript. The prover's
rounds run through hand-written CUDA kernels for Hopper (`ops/round_cuda.py`,
`csrc/round.cu`, `csrc/round_mxu.cu`; the transcript in `csrc/transcript.cu`)
on `device="cuda"`, and through their plain PyTorch versions on
`device="cpu"`. Proofs are byte-identical to the JAX package's.

This package imports torch and numpy, never JAX and never `sumcheck_tpu`.
"""

from .data_structures import ListOfProductsOfPolynomials, PolynomialInfo
from .fields.fr import Fr
from .gkr_round_sumcheck import GKRProof, GKRRoundSumcheck, GKRRoundSumcheckSubClaim
from .ml_sumcheck import MLSumcheck
from .mle import DenseMLE, SparseMLE
from .protocol import IPForMLSumcheck
from .transcript.blake2b_rng import Blake2b512Rng
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
    "Fr",
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
