"""GKR Round Sumcheck (Libra two-phase, [XZZPS19] §3.3) — reference L6,
`src/gkr_round_sumcheck/mod.rs` and `data_structures.rs`; the port of
`sumcheck_tpu/gkr_round_sumcheck.py`.

Proves `sum_{x,y} f1(g, x, y) * f2(x) * f3(y)` for sparse `f1` over 3*dim
variables and dense `f2`, `f3` over dim variables, reusing the MLSumcheck
round engine as a subroutine:

- phase 1: build `h_g(x) = sum_y f1(g, x, y) * f3(y)` (reference
  `mod.rs:22-42`), then run a dim-round degree-2 sumcheck on `h_g * f2`
  -> randomness `u`;
- phase 2: fix `f1_g` at `u`, densify, and sumcheck `f1(g,u,.) * (f2(u)*f3)`
  -> randomness `v`.

For a `Blake2b512Rng` transcript the whole prove runs chained on the
prover's device (`device="cuda"`: the CUDA round, transcript and phase-init
kernels; `device="cpu"`: their plain versions): the phase-1
init, both phases' rounds on the generic chain (or the per-size chain,
`SUMCHECK_TPU_CHAIN_IMPL`), the phase-2 init from phase 1's challenges on
the device, and one fetch at the end, the prove's only host sync. Any
other transcript, and a `Blake2b512Rng` holding a pending byte count that
is not a multiple of 8, runs the same inits and round kernels on the same
device with the transcript on the host between the rounds, one sync a
round (`_prove_host_transcript`). Tables
over a field other than the process default (`PortableDenseMLE`,
`PortableSparseMLE`) prove and verify on the portable host engine
(`portable.py`), whatever `device` says.

Transcript parity note: the reference feeds ONLY prover messages — `g`, the
dimensions, and the claimed sum are NOT absorbed (`mod.rs:114,128`; no domain
separation). The port does the same, for bit-exactness.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .data_structures import ListOfProductsOfPolynomials, PolynomialInfo
from .fields import limbs_np as L
from .fields.fr import Fr
from .mle import DenseMLE, SparseMLE, _segment_sum_mod_p
from .protocol import IPForMLSumcheck
from .protocol.prover import ProverMsg, ProverState
from .utils.errors import SumcheckError


def initialize_phase_one(
    f1: SparseMLE, f3: DenseMLE, g: Sequence[Fr]
) -> tuple[DenseMLE, SparseMLE]:
    """Build the Libra helper table `h_g(x) = sum_y f1(g,x,y) * f3(y)` on the
    host and return it with `f1` fixed at `g` (reference `mod.rs:22-42`)."""
    dim = f3.num_vars
    assert f1.num_vars == dim * 3
    assert len(g) == dim
    f1_g = f1.fix_variables(list(g))  # sparse over 2*dim vars (x then y)
    a_hg = L.zeros(1 << dim)
    if f1_g.num_nonzero:
        idx = f1_g.indices
        x = (idx & ((1 << dim) - 1)).astype(np.int64)
        y = (idx >> dim).astype(np.int64)
        vals = L.mont_mul(f1_g.values, f3.evals[:, y])
        uniq, inverse = np.unique(x, return_inverse=True)
        a_hg[:, uniq] = _segment_sum_mod_p(vals, inverse, len(uniq))
    return DenseMLE(dim, a_hg), f1_g


def start_phase1_sumcheck(h_g: DenseMLE, f2: DenseMLE, *, device="cuda") -> ProverState:
    """Wrap `h_g * f2` as a 1-product polynomial and init the round prover
    on `device` (reference `mod.rs:45-54`)."""
    dim = h_g.num_vars
    assert f2.num_vars == dim
    poly = ListOfProductsOfPolynomials(dim)
    poly.add_product([h_g, f2], Fr.one())
    return IPForMLSumcheck.prover_init(poly, device=device)


def initialize_phase_two(f1_g: SparseMLE, u: Sequence[Fr]) -> DenseMLE:
    """`f1` fixed at `g || u`, densified (reference `mod.rs:57-63`)."""
    assert len(u) * 2 == f1_g.num_vars
    return f1_g.fix_variables(list(u)).to_dense()


def start_phase2_sumcheck(f1_gu: DenseMLE, f3: DenseMLE, f2_u: Fr, *,
                          device="cuda") -> ProverState:
    """Prove `sum_y f1(g,u,y) * f2(u) * f3(y)` as `f1_gu * (f2_u * f3)`
    on `device` (reference `mod.rs:66-82`)."""
    f3_f2u = DenseMLE.zero().scaled_add(f2_u, f3)
    dim = f1_gu.num_vars
    assert f3.num_vars == dim
    poly = ListOfProductsOfPolynomials(dim)
    poly.add_product([f1_gu, f3_f2u], Fr.one())
    return IPForMLSumcheck.prover_init(poly, device=device)


def _upload(f1: SparseMLE, f2: DenseMLE, f3: DenseMLE, g: Sequence[Fr], dim: int,
            device: torch.device, shard=None) -> tuple:
    """Everything a chained prove reads, on `device`: f1's split (cached on
    f1), f2 and f3 in bit-reversed order
    (cached on the MLEs), g's coordinates as (dim, 16) int32 digit rows,
    and the plain inits' constants. With `shard` = (s, S), f1's split is
    rank s's chunk (`_split_f1_device`)."""
    from .ops import gkr_init as GI

    split = GI._split_f1_device(f1, dim, device, shard)
    f2_d, f3_d = f2.to_device(device), f3.to_device(device)
    GI.prepare(device)
    return split, f2_d, f3_d, GI.upload(GI._point_rows(list(g)), device)


def _enqueue(inputs: tuple, state, dim: int, round_fns=None, step_fns=None,
             transcript_fn=None):
    """The phase-1 init, phase 1's rounds, the phase-2 init from phase 1's
    final pair and challenges, and phase 2's rounds, all enqueued on the
    inputs' device with no host sync (`sumcheck_tpu` `:108-178`). Returns
    both phases' (msgs (2 dim, 16, 3), rs (2 dim, 16)) and the transcript
    state. `round_fns` (generic chain), `step_fns` (per-size chain) and
    `transcript_fn` replace the kernels' functions, a test hook by which a
    check on the card runs the plain versions there."""
    from .ops import gkr_init as GI
    from .protocol import device_prover, generic_prover
    from .utils.config import get_config

    split, f2_d, f3_d, g_r = inputs
    products = ((0, 1),)  # unit coefficient: nothing to fold into the tables

    # each phase init is one launch on either chain; phase 2's folds f2 at u
    # (the phase-1 final pair's slot 1 by rs1[dim-1], u's last) in its blocks
    if get_config().chain_impl == "generic":
        # both phases fold one pair each in place over run-time extents
        lo1, hi1, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
        msgs1, rs1, state = generic_prover.chain_rounds_generic(
            lo1, hi1, state, products, 2, dim, round_fns, transcript_fn)
        # the chain left the 1-lane final pair in lane 0
        lo2, hi2 = GI.phase2_pair(lo1[:, :, :1], hi1[:, :, :1], rs1[dim - 1], split, w, rs1,
                                  f3_d, dim)
        msgs2, rs2, state = generic_prover.chain_rounds_generic(
            lo2, hi2, state, products, 2, dim, round_fns, transcript_fn)
    else:
        # each fold writes fresh half-width tables; `chain_rounds` empties the
        # list it is given, so no name here keeps a folded-away pair alive
        *pair1, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
        msgs1, rs1, state, final1 = device_prover.chain_rounds(
            pair1, state, products, 2, dim, step_fns, transcript_fn)
        # the chain left every table folded dim-1 times: the 1-lane final pair
        pair2 = list(GI.phase2_pair(*final1, rs1[dim - 1], split, w, rs1, f3_d, dim))
        msgs2, rs2, state, _ = device_prover.chain_rounds(
            pair2, state, products, 2, dim, step_fns, transcript_fn)
    return torch.cat([msgs1, msgs2]), torch.cat([rs1, rs2]), state


def _prove_chained(rng, f1: SparseMLE, f2: DenseMLE, f3: DenseMLE,
                   g: Sequence[Fr], dim: int, device: torch.device, round_fns=None,
                   step_fns=None, transcript_fn=None) -> "GKRProof":
    """The whole GKR prove chained on `device` (`sumcheck_tpu` `:86-192`):
    the uploads and the transcript lift first, then both phases enqueued
    without a host sync (`_enqueue`, which takes the hooks), then one fetch
    of both phases' messages, challenges and the transcript state."""
    from .protocol import device_prover

    inputs = _upload(f1, f2, f3, g, dim, device)
    state = device_prover.lift_transcript(rng, device)
    msgs, rs, state = _enqueue(inputs, state, dim, round_fns, step_fns, transcript_fn)
    # ONE synchronization for both phases and the final transcript state
    msgs_h, _rs_h, state_h = device_prover.fetch_chain_outputs(msgs, rs, state)
    device_prover.restore_transcript(rng, state_h)
    return GKRProof(device_prover.msgs_from_host(msgs_h[:dim], 2),
                    device_prover.msgs_from_host(msgs_h[dim:], 2))


def _prove_host_transcript(rng, f1: SparseMLE, f2: DenseMLE, f3: DenseMLE,
                           g: Sequence[Fr], dim: int, device: torch.device,
                           round_fns=None) -> "GKRProof":
    """The GKR prove over a transcript the device chain cannot lift (any
    rng other than a `Blake2b512Rng`, or one whose pending byte count is
    not a multiple of 8), on `device` (`sumcheck_tpu` `:285-327`): the
    chained prove's inits and round kernels, with the transcript on the
    host between the rounds, each phase the interactive tier's rounds over
    its pair (`generic_prover.host_rounds`, one sync a round). Phase 1's
    challenges go back up once, as digits, for the phase-2 init.
    `round_fns` replaces (round_nofold, round_fold), a test hook."""
    from .ops import gkr_init as GI
    from .protocol.generic_prover import host_rounds

    split, f2_d, f3_d, g_r = _upload(f1, f2, f3, g, dim, device)
    lo1, hi1, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
    phase1_msgs, u = host_rounds(rng, _pair_state(lo1, hi1, dim, round_fns), dim)
    u_digits = GI.upload(GI._point_rows(u), device)
    # the rounds left phase 1's 1-lane final pair in lane 0; u[dim-1] folds it
    lo2, hi2 = GI.phase2_pair(lo1[:, :, :1], hi1[:, :, :1], u_digits[dim - 1], split, w,
                              u_digits, f3_d, dim)
    phase2_msgs, _v = host_rounds(rng, _pair_state(lo2, hi2, dim, round_fns), dim)
    return GKRProof(phase1_msgs, phase2_msgs)


def _pair_state(lo, hi, dim: int, round_fns) -> ProverState:
    """The interactive tier's state over one phase's pair: one unit product
    of its two slots, `h_g * f2` or `f1_gu * (f2(u) * f3)`."""
    state = ProverState([], [(Fr.one(), [0, 1])], (lo, hi), dim, 2, ((0, 1),), 2)
    state.round_fns = round_fns
    return state


class GKRProof:
    """Proof for a GKR round function (reference `data_structures.rs:9-19`)."""

    __slots__ = ("phase1_sumcheck_msgs", "phase2_sumcheck_msgs")

    def __init__(self, phase1_sumcheck_msgs: list[ProverMsg], phase2_sumcheck_msgs: list[ProverMsg]):
        self.phase1_sumcheck_msgs = phase1_sumcheck_msgs
        self.phase2_sumcheck_msgs = phase2_sumcheck_msgs

    def extract_sum(self) -> Fr:
        return (
            self.phase1_sumcheck_msgs[0].evaluations[0]
            + self.phase1_sumcheck_msgs[0].evaluations[1]
        )

    def serialize_uncompressed(self) -> bytes:
        """Byte encoding the reference lacks (`data_structures.rs:9-13` has
        no CanonicalSerialize derive): the two phases as the encoding that
        derive WOULD produce — two length-prefixed `Vec<ProverMsg>`."""
        from .ml_sumcheck import serialize_proof

        return serialize_proof(self.phase1_sumcheck_msgs) + serialize_proof(
            self.phase2_sumcheck_msgs
        )

    @staticmethod
    def deserialize_uncompressed(data: bytes) -> "GKRProof":
        from .ml_sumcheck import _deserialize_proof_prefix
        from .utils.errors import SerializationError

        p1, off1 = _deserialize_proof_prefix(data)
        p2, off2 = _deserialize_proof_prefix(data[off1:])
        if off1 + off2 != len(data):
            raise SerializationError("trailing bytes in GKRProof encoding")
        if len(p1) != len(p2):
            raise SerializationError("GKR phases have unequal round counts")
        if not p1:
            raise SerializationError("GKRProof encoding has zero rounds")
        return GKRProof(p1, p2)


class GKRRoundSumcheckSubClaim:
    """Subclaim from a convinced GKR verifier
    (reference `data_structures.rs:22-57`)."""

    __slots__ = ("u", "v", "expected_evaluation")

    def __init__(self, u: list[Fr], v: list[Fr], expected_evaluation: Fr):
        self.u = u
        self.v = v
        self.expected_evaluation = expected_evaluation

    def verify_subclaim(
        self, f1: SparseMLE, f2: DenseMLE, f3: DenseMLE, g: Sequence[Fr]
    ) -> bool:
        dim = len(self.u)
        assert len(self.v) == dim
        assert f1.num_vars == 3 * dim and f2.num_vars == dim and f3.num_vars == dim
        assert len(g) == dim
        guv = list(g) + list(self.u) + list(self.v)
        actual = f1.evaluate(guv) * f2.evaluate(self.u) * f3.evaluate(self.v)
        return actual == self.expected_evaluation


class GKRRoundSumcheck:
    """Sumcheck argument for a GKR round function (reference `mod.rs:85-192`)."""

    @staticmethod
    def prove(
        rng, f1: SparseMLE, f2: DenseMLE, f3: DenseMLE, g: Sequence[Fr], *,
        device="cuda"
    ) -> GKRProof:
        """Caller supplies the transcript RNG (unlike `MLSumcheck.prove`);
        the prover's device is a `torch.device` or its name, the card unless
        the caller asks for the CPU."""
        from .portable import PortableDenseMLE, gkr_prove
        from .protocol.device_prover import liftable, resolve_device

        if isinstance(f2, PortableDenseMLE):  # per-instance generic field
            return gkr_prove(rng, f1, f2, f3, g)
        assert f1.num_vars == 3 * f2.num_vars
        assert f1.num_vars == 3 * f3.num_vars
        dim = f2.num_vars
        g = list(g)
        device = resolve_device(device)
        if dim == 0:
            raise SumcheckError("Attempt to prove a constant.")
        if liftable(rng):
            return _prove_chained(rng, f1, f2, f3, g, dim, device)
        return _prove_host_transcript(rng, f1, f2, f3, g, dim, device)

    @staticmethod
    def verify(
        rng, f2_num_vars: int, proof: GKRProof, claimed_sum: Fr
    ) -> GKRRoundSumcheckSubClaim:
        """Two chained degree-2 verification passes; phase 2's claimed sum is
        phase 1's expected evaluation (reference `mod.rs:147-192`).
        Raises `Reject` on inconsistency."""
        from .protocol.verifier import native_verify_phase

        f = getattr(claimed_sum, "f", None)  # FieldEl -> its generic field
        if f is not None and not f.is_default:
            from .portable import gkr_verify

            return gkr_verify(rng, f, f2_num_vars, proof, claimed_sum)
        dim = f2_num_vars

        def run_phase(msgs, asserted: Fr):
            """One dim-round degree-2 verification pass over `rng`: the
            whole loop in one call of the C core where it applies, else the
            per-round loop, with the same bytes, results and rejections."""
            if len(msgs) >= dim > 0:
                fast = native_verify_phase(rng, msgs[:dim], 3, asserted.v)
                if fast is not None:
                    point, final = fast
                    return [Fr(x) for x in point], Fr(final)
            vs = IPForMLSumcheck.verifier_init(
                PolynomialInfo(max_multiplicands=2, num_variables=dim)
            )
            for i in range(dim):
                pm = msgs[i]
                rng.feed(pm)
                IPForMLSumcheck.verify_round(pm, vs, rng)
            sub = IPForMLSumcheck.check_and_generate_subclaim(vs, asserted)
            return sub.point, sub.expected_evaluation

        u, expected1 = run_phase(proof.phase1_sumcheck_msgs, claimed_sum)
        v, expected2 = run_phase(proof.phase2_sumcheck_msgs, expected1)
        return GKRRoundSumcheckSubClaim(u=u, v=v, expected_evaluation=expected2)
