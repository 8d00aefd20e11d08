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

Copied from `sumcheck_tpu/protocol/verifier.py`, with its C core
(`native/fastrng.c`) in `native_verify_phase`: a whole verification pass
(feed, sample, checks) in one C call, which the ML and GKR verifies take
whenever their rng hashes in the C core. Any other rng, and
``SUMCHECK_TPU_NATIVE=off``, run the Python loop below, with the same
results and rejections.
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


# the C core's largest interpolation (`fastrng.c`, INTERP_MAX)
_INTERP_MAX = 36

_native_state: dict = {}  # the C core's constants, made at its first use


def _native_ctx():
    """(lib, field constant arrays, cached Montgomery Lagrange constants)
    for `native_verify_phase`, or None when the C core is off. The
    library builds at the first use; a failed build raises."""
    import ctypes

    from ..fields.fr import R, R2
    from ..native import lib

    L = lib()
    if L is None:
        return None
    st = _native_state.get("ctx")
    if st is not None:
        return st

    def limbs4(x: int):
        return (ctypes.c_uint64 * 4).from_buffer_copy(x.to_bytes(32, "little"))

    consts_cache: dict = {}

    def consts_mont(n: int):
        cm = consts_cache.get(n)
        if cm is None:
            cm = (ctypes.c_uint64 * (4 * n)).from_buffer_copy(
                b"".join((c * R % P).to_bytes(32, "little") for c in _lagrange_consts(n))
            )
            consts_cache[n] = cm
        return cm

    st = {
        "lib": L,
        "limbs4": limbs4,
        "consts_mont": consts_mont,
        "p": limbs4(P),
        "r2": limbs4(R2),
        "ninv0": ctypes.c_uint64((-pow(P, -1, 1 << 64)) % (1 << 64)),
        "out": ctypes.create_string_buffer(32),
        "ctypes": ctypes,
    }
    _native_state["ctx"] = st
    return st


def native_verify_phase(rng, msgs, d1: int, asserted_v: int):
    """One WHOLE verification pass — per-round transcript feed + challenge
    sample + deferred checks — in a single C call (`fr_verify_rounds`).

    Fuses what `verify_round` x nv + `check_and_generate_subclaim` compute
    (reference `verifier.rs:54-121`), byte- and result-identical: the C loop
    absorbs exactly the bytes `feed(prover_msg)` would, draws exactly the
    ark-ff challenge stream, and runs the same check order. Returns
    (point_ints, final_expected_int) on success, None when the pass does
    not apply (the rng does not hash in the C core, uneven evaluation
    counts, a degree out of the C range) — the caller then runs the Python
    loop, whose observable behavior is identical. Raises `Reject` on a
    failed consistency check, after the transcript has advanced through
    every round, as the lazy verifier does."""
    from ..fields.fr import SHAVE_BITS
    from ..transcript.blake2b_rng import _NativeCore

    core = getattr(rng, "_h", None)
    if not isinstance(core, _NativeCore):
        return None
    st = _native_ctx()
    if st is None or d1 > _INTERP_MAX or d1 < 2:
        return None
    if any(len(m.evaluations) != d1 for m in msgs):
        return None
    ct = st["ctypes"]
    blob = b"".join(m.serialize_uncompressed() for m in msgs)
    nv = len(msgs)
    rands = ct.create_string_buffer(32 * max(nv, 1))
    out = st["out"]
    rc = st["lib"].fr_verify_rounds(
        core._ctx, blob, nv, d1, st["limbs4"](asserted_v), st["consts_mont"](d1), st["p"],
        ct.c_uint64((1 << (64 - SHAVE_BITS)) - 1), st["ninv0"], st["r2"], rands, out,
    )
    if rc <= -1000:
        raise ValueError(f"fr_verify_rounds rejected d + 1 = {d1}")
    if rc < 0:
        raise Reject("Prover message is not consistent with the claim.")
    point = [int.from_bytes(rands.raw[32 * i: 32 * i + 32], "little") for i in range(nv)]
    return point, int.from_bytes(out.raw, "little")


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
