"""MLSumcheck round verifier — host-side, O(nv*d) field ops
(reference C9/C10, `src/ml_sumcheck/protocol/verifier.rs`).

Mirrors the reference's *lazy* design: `verify_round` only samples the
challenge and stores the received evaluations (`verifier.rs:54-83`); all
soundness checks happen in `check_and_generate_subclaim`
(`verifier.rs:90-121`): per round, the evaluation count must be d+1, then
`P_i(0) + P_i(1) == expected`, then `expected = P_i(r_i)` by interpolation.

`interpolate_uni_poly` evaluates the unique degree-<=d polynomial through
`(0, p[0])..(d, p[d])` at `r` (`verifier.rs:139-251`). The reference has three
integer-width branches for the factorial ratios (i64/i128/BigInt) purely as a
CPU optimization; the field *results* are branch-independent, so we keep one
field-arithmetic path (plus the same early return at integer points).

Copied from `sumcheck_tpu/protocol/verifier.py`: the Python round loop only.
The C verifier core comes with the C transcript core in a later slice.
"""

from __future__ import annotations

from ..data_structures import PolynomialInfo
from ..fields.fr import Fr, P
from ..transcript.serialize import serialize_fr
from ..utils.errors import Reject, SumcheckError
from .prover import ProverMsg


class VerifierMsg:
    """Challenge sampled by the verifier (reference `VerifierMsg`)."""

    __slots__ = ("randomness",)

    def __init__(self, randomness: Fr):
        self.randomness = randomness

    def serialize_uncompressed(self) -> bytes:
        return serialize_fr(self.randomness)

    def __repr__(self) -> str:
        return f"VerifierMsg({self.randomness})"


class VerifierState:
    __slots__ = (
        "round",
        "nv",
        "max_multiplicands",
        "finished",
        "polynomials_received",
        "randomness",
    )

    def __init__(self, round: int, nv: int, max_multiplicands: int):
        self.round = round
        self.nv = nv
        self.max_multiplicands = max_multiplicands
        self.finished = False
        self.polynomials_received: list[list[Fr]] = []
        self.randomness: list[Fr] = []


class SubClaim:
    """Output of a convinced verifier: the claimed polynomial evaluates to
    `expected_evaluation` at `point` (reference `SubClaim`,
    `verifier.rs:29-34`). The caller must still check this against the
    polynomial itself."""

    __slots__ = ("point", "expected_evaluation")

    def __init__(self, point: list[Fr], expected_evaluation: Fr):
        self.point = point
        self.expected_evaluation = expected_evaluation


def verifier_init(index_info: PolynomialInfo) -> VerifierState:
    return VerifierState(1, index_info.num_variables, index_info.max_multiplicands)


def verify_round(prover_msg: ProverMsg, verifier_state: VerifierState, rng) -> VerifierMsg:
    """Sample challenge, store evaluations, defer all checks
    (reference `verify_round`, `verifier.rs:54-83`)."""
    if verifier_state.finished:
        raise SumcheckError("Incorrect verifier state: Verifier is already finished.")
    msg = sample_round(rng)
    verifier_state.randomness.append(msg.randomness)
    verifier_state.polynomials_received.append(list(prover_msg.evaluations))
    if verifier_state.round == verifier_state.nv:
        verifier_state.finished = True
    else:
        verifier_state.round += 1
    return msg


def check_and_generate_subclaim(verifier_state: VerifierState, asserted_sum: Fr) -> SubClaim:
    """All deferred soundness checks (reference `verifier.rs:90-121`).
    Raises `Reject` on inconsistency — the only soundness rejection site.

    The per-round interpolations run INVERSION-FREE: the Lagrange numerators
    `prod_{j!=i} (r - j)` come from prefix/suffix products and the node
    denominators `1/(i! (n-1-i)! (-1)^(n-1-i))` are per-degree constants
    (cached) — no runtime `pow`/inversion at all. Results are identical to
    the reference's running-ratio recurrence (`verifier.rs:191-248`); the
    unique interpolant doesn't care how it's evaluated."""
    if not verifier_state.finished:
        raise SumcheckError("Verifier has not finished.")
    if len(verifier_state.polynomials_received) != verifier_state.nv:
        raise SumcheckError("insufficient rounds")
    expected = asserted_sum
    want = verifier_state.max_multiplicands + 1
    for i in range(verifier_state.nv):
        evaluations = verifier_state.polynomials_received[i]
        # checks stay in the reference's per-round order (`verifier.rs:104-113`)
        if len(evaluations) != want:
            raise SumcheckError("incorrect number of evaluations")
        if (evaluations[0].v + evaluations[1].v - expected.v) % P:
            raise Reject("Prover message is not consistent with the claim.")
        expected = Fr(
            _interp_eval_int(
                [e.v for e in evaluations], verifier_state.randomness[i].v
            )
        )
    return SubClaim(list(verifier_state.randomness), expected)


def _interp_eval_int(p_vals: list[int], eval_at: int) -> int:
    """Evaluate the unique degree-<n interpolant through `(j, p_vals[j])`
    at `eval_at` — raw ints, zero inversions (see the caller's docstring)."""
    n = len(p_vals)
    if eval_at < n:  # challenge hit an integer node (reference early return)
        return p_vals[eval_at]
    facs = [(eval_at - j) % P for j in range(n)]
    suf = [1] * n  # suffix products of facs
    for i in range(n - 2, -1, -1):
        suf[i] = suf[i + 1] * facs[i + 1] % P
    consts = _lagrange_consts(n)
    acc = 0
    pre = 1  # running prefix product of facs
    for i in range(n):
        acc = (acc + p_vals[i] * consts[i] % P * pre * suf[i]) % P
        pre = pre * facs[i] % P
    return acc


def sample_round(rng) -> VerifierMsg:
    """Draw a uniform field challenge from the transcript RNG
    (reference `sample_round`, `verifier.rs:128-132`)."""
    return VerifierMsg(Fr.rand(rng))


def interpolate_uni_poly(p_i: list[Fr], eval_at: Fr) -> Fr:
    """Evaluate at `eval_at` the unique polynomial of degree < len(p_i) whose
    value at x = j is p_i[j] (reference `verifier.rs:139-251`), in the
    inversion-free Lagrange form of `check_and_generate_subclaim`."""
    return Fr(_interp_eval_int([e.v for e in p_i], eval_at.v))


def _lagrange_consts(n: int, _cache: dict = {}) -> list[int]:
    out = _cache.get(n)
    if out is None:
        fact = [1]
        for i in range(1, n):
            fact.append(fact[-1] * i % P)
        out = [
            pow(fact[i] * fact[n - 1 - i] * (P - 1) ** ((n - 1 - i) & 1), -1, P)
            for i in range(n)
        ]
        _cache[n] = out
    return out
