"""Non-interactive MLSumcheck via Fiat-Shamir (reference L5/C11,
`src/ml_sumcheck/mod.rs:18-101`).

Transcript schedule (must match the reference byte-for-byte):
`feed(polynomial.info())`, then per round `prove_round -> feed(prover_msg) ->
sample challenge`; the final challenge is appended to the prover's randomness
(`mod.rs:65-67`) so `prover_state.randomness` equals the verifier's subclaim
point. A proof is the list of round messages (`type Proof<F> =
Vec<ProverMsg<F>>`, `mod.rs:22`).

Port of `sumcheck_tpu/ml_sumcheck.py`. The prover's device is explicit:
`device="cuda"` runs the rounds through the CUDA kernels, `device="cpu"`
through their plain PyTorch versions. For a `Blake2b512Rng` transcript the
rounds and the transcript run chained on the device, with one sync per
prove: the generic chain (`protocol/generic_prover.py`) by default, the
per-size chain (`protocol/device_prover.py`) when
`SUMCHECK_TPU_CHAIN_IMPL` is anything else (`utils/config.py`). Any other
transcript runs on the host between the rounds, as the JAX package's host
loop does.
"""

from __future__ import annotations

from .data_structures import ListOfProductsOfPolynomials, PolynomialInfo
from .fields.fr import MODULUS_BYTES, Fr
from .protocol import IPForMLSumcheck
from .protocol.prover import ProverMsg, ProverState
from .protocol.verifier import SubClaim
from .transcript.blake2b_rng import Blake2b512Rng
from .transcript.serialize import serialize_u64
from .utils.errors import SerializationError

Proof = list  # Proof = list[ProverMsg]


def serialize_proof(proof: list[ProverMsg]) -> bytes:
    """arkworks-compatible `Vec<ProverMsg>` encoding: u64 LE length prefix,
    then each message (itself a length-prefixed `Vec<Fr>`)."""
    return serialize_u64(len(proof)) + b"".join(
        m.serialize_uncompressed() for m in proof
    )


def _deserialize_proof_prefix(data: bytes) -> tuple[list[ProverMsg], int]:
    """Parse one `Vec<ProverMsg>` from the head of `data`; returns
    (proof, bytes consumed)."""
    off = 0

    def u64():
        nonlocal off
        if off + 8 > len(data):
            raise SerializationError("truncated length prefix")
        v = int.from_bytes(data[off : off + 8], "little")
        off += 8
        return v

    n = u64()
    proof = []
    for _ in range(n):
        k = u64()
        if off + k * MODULUS_BYTES > len(data):
            raise SerializationError("truncated proof encoding")
        evals = []
        for _ in range(k):
            evals.append(Fr.deserialize_uncompressed(data[off : off + MODULUS_BYTES]))
            off += MODULUS_BYTES
        proof.append(ProverMsg(evals))
    return proof, off


def deserialize_proof(data: bytes) -> list[ProverMsg]:
    """Inverse of `serialize_proof`."""
    proof, off = _deserialize_proof_prefix(data)
    if off != len(data):
        raise SerializationError("trailing bytes in proof encoding")
    return proof


class MLSumcheck:
    """Sumcheck for sums of products of multilinear polynomials."""

    @staticmethod
    def extract_sum(proof: list[ProverMsg]) -> Fr:
        """The claimed sum is P_1(0) + P_1(1) (reference `mod.rs:26-28`)."""
        return proof[0].evaluations[0] + proof[0].evaluations[1]

    @staticmethod
    def prove(polynomial: ListOfProductsOfPolynomials, *, device) -> list[ProverMsg]:
        """One-shot Fiat-Shamir prove with a fresh transcript
        (reference `mod.rs:42-45`) on `device` (a `torch.device` or its
        name)."""
        fs_rng = Blake2b512Rng.setup()
        proof, _state = MLSumcheck.prove_as_subprotocol(fs_rng, polynomial, device=device)
        return proof

    @staticmethod
    def prove_as_subprotocol(
        fs_rng, polynomial: ListOfProductsOfPolynomials, *, device
    ) -> tuple[list[ProverMsg], ProverState]:
        """Prove over a caller-supplied transcript; returns the prover state
        too, for composition into larger protocols (reference `mod.rs:50-70`).
        The rounds run on `device`; the proof bytes and the transcript's
        final state are the same whichever chain runs."""
        from .protocol.device_prover import prove_chained
        from .protocol.generic_prover import prove_generic, prove_host_transcript
        from .utils.config import get_config

        fs_rng.feed(polynomial.info())
        if not isinstance(fs_rng, Blake2b512Rng):
            return prove_host_transcript(fs_rng, polynomial, device)
        if get_config().chain_impl == "generic":
            return prove_generic(fs_rng, polynomial, device)
        return prove_chained(fs_rng, polynomial, device)

    @staticmethod
    def verify(
        polynomial_info: PolynomialInfo, claimed_sum: Fr, proof: list[ProverMsg]
    ) -> SubClaim:
        """One-shot Fiat-Shamir verify (reference `mod.rs:73-80`).
        Raises `Reject` if the proof is inconsistent with the claim."""
        fs_rng = Blake2b512Rng.setup()
        return MLSumcheck.verify_as_subprotocol(fs_rng, polynomial_info, claimed_sum, proof)

    @staticmethod
    def verify_as_subprotocol(
        fs_rng, polynomial_info: PolynomialInfo, claimed_sum: Fr, proof: list[ProverMsg]
    ) -> SubClaim:
        """Verify over a caller-supplied transcript (reference `mod.rs:84-100`)."""
        fs_rng.feed(polynomial_info)
        verifier_state = IPForMLSumcheck.verifier_init(polynomial_info)
        for i in range(polynomial_info.num_variables):
            if i >= len(proof):
                raise IndexError("proof is incomplete")
            prover_msg = proof[i]
            fs_rng.feed(prover_msg)
            IPForMLSumcheck.verify_round(prover_msg, verifier_state, fs_rng)
        return IPForMLSumcheck.check_and_generate_subclaim(verifier_state, claimed_sum)
