"""Interactive protocol core for MLSumcheck (reference L4,
`src/ml_sumcheck/protocol/`): the round-level prover/verifier state machines.

The reference namespaces these under the zero-sized `IPForMLSumcheck<F>`
(`protocol/mod.rs:10-13`); the same surface is a class of static methods so
all three API tiers survive: raw interactive rounds, Fiat-Shamir
as-subprotocol, and one-shot Fiat-Shamir (SURVEY.md §3.5).
"""

from ..data_structures import ListOfProductsOfPolynomials, PolynomialInfo
from .prover import ProverMsg, ProverState, prove_round, prover_init
from .verifier import (
    SubClaim,
    VerifierMsg,
    VerifierState,
    check_and_generate_subclaim,
    interpolate_uni_poly,
    sample_round,
    verifier_init,
    verify_round,
)


class IPForMLSumcheck:
    """Interactive proof for multilinear sumcheck (reference
    `IPForMLSumcheck`, `src/ml_sumcheck/protocol/mod.rs:10-13`)."""

    prover_init = staticmethod(prover_init)
    prove_round = staticmethod(prove_round)
    verifier_init = staticmethod(verifier_init)
    verify_round = staticmethod(verify_round)
    check_and_generate_subclaim = staticmethod(check_and_generate_subclaim)
    sample_round = staticmethod(sample_round)


__all__ = [
    "IPForMLSumcheck",
    "ListOfProductsOfPolynomials",
    "PolynomialInfo",
    "ProverMsg",
    "ProverState",
    "SubClaim",
    "VerifierMsg",
    "VerifierState",
    "interpolate_uni_poly",
]
