"""The generic chained prover over the round kernels.

Port of `sumcheck_tpu/protocol/generic_prover.py` `prove_generic`
(`:652-710`) with its round chain (`chain_rounds_generic`, `:516-593`) as one
Python loop over rounds with run-time extents. The table pair is allocated
once (`device_prover.init_pair`); round j works on the first
`A = 2^(nv-1) >> j` lanes of it:

- round 0 launches the no-fold kernel over all `2^(nv-1)` pairs;
- round j >= 1 launches the fold kernel over exactly `A` lanes; the kernel
  grid covers that extent, so nothing needs the JAX lane mask.

In the MXU fold mode (`SUMCHECK_TPU_MXU_FOLD`, `utils/config.py`) the fold
rounds launch `round_cuda.round_fold_mxu` in place of `round_fold`, as the
JAX chain's `mxu_kernel` branch (`:216-264`) swaps in
`_kernel_chain_fold_mxu`; round 0 is the same either way.

The transcript runs on the device (`transcript_cuda.transcript_step`, the
round step's `feed_fr_vec_dyn` / `fr_rand_dyn` tail at `:276-296`): the host
lifts its `Blake2b512Rng` state once, enqueues every round with no sync,
and fetches the proof, the challenges and the final transcript state in
one copy (`device_prover.finish_chain`). A round is two launches: the round
kernel adds its sums into the round's row of one zeroed buffer
(`device_prover.sum_rows`), and the transcript step reads that row.

`chain_rounds_generic_batched` runs the same chain over B instances at once
for `batch.py`, two launches a round for all of them.

`prove_host_transcript` is the loop for any other transcript, the
interactive tier's rounds (`protocol/prover.py`) under `host_rounds`: each
round copies its exact sums to the host (one sync), reduces them mod p,
feeds the `ProverMsg` and samples the challenge on `fs_rng`, which the next
round uploads for its fold, the schedule of the host loop at
`sumcheck_tpu/ml_sumcheck.py:122-131`. Proofs are byte-identical either way.

Left out, because they serve XLA compile counts or TPU enqueue memory: the
masked fixed-shape programs and their padding, the compile prewarming, the
per-stage syncs for huge pairs and the incremental pair init.
"""

from __future__ import annotations

import torch

from ..fields.fr import NUM_DIGITS
from ..ops import round_cuda, transcript_cuda
from ..utils.config import get_config
from ..utils.errors import SumcheckError
from ..utils.tracing import span
from .device_prover import (
    _batched_buffers,
    finish_chain,
    init_pair,
    lift_transcript,
    prover_state,
    resolve_device,
    sum_rows,
)
from .prover import prove_round, prover_init
from .verifier import sample_round


def chain_rounds_generic(lo, hi, state, products, degree: int, num_rounds: int,
                         round_fns=None, transcript_fn=None, reduce_fn=None, r0=None):
    """Enqueue `num_rounds` rounds with no host sync: per round one round
    kernel over the active extent (folding `lo`, `hi` in place), adding its
    sums into row j of a zeroed `sum_rows` buffer, and one transcript step
    reading that row. `state` is the packed transcript (advanced in place).
    Returns (msgs (k, 16, d+1), rs (k, 16), state) on the pair's device.
    The fold rounds launch `round_fold_mxu` in the MXU fold mode.

    The multi-device provers (`parallel/chained.py`) give `reduce_fn`,
    called on each round's sums row between the kernel and the transcript
    step (the exact sum over the ranks, in place), and `r0`, a challenge
    to fold by first: every round then folds, round 0 by `r0` over half the
    pair. `round_fns` and `transcript_fn` are test hooks."""
    mxu = get_config().use_mxu_fold()
    nofold, fold = round_fns or (
        round_cuda.round_nofold, round_cuda.round_fold_mxu if mxu else round_cuda.round_fold)
    transcript = transcript_fn or transcript_cuda.transcript_step
    device = lo.device
    half = lo.shape[2] if r0 is None else lo.shape[2] // 2
    with span("chain"):
        msgs = torch.empty((num_rounds, NUM_DIGITS, degree + 1), dtype=torch.int32,
                           device=device)
        rs = torch.empty((num_rounds, NUM_DIGITS), dtype=torch.int32, device=device)
        rows = sum_rows(num_rounds, degree, device)
        for j in range(num_rounds):
            extent = half >> j
            if j == 0 and r0 is None:
                sums = nofold(lo, hi, products, degree, extent, rows[j])
            else:
                sums = fold(lo, hi, rs[j - 1] if j else r0, products, degree, extent, rows[j])
            if reduce_fn is not None:
                reduce_fn(sums)
            transcript(state, sums, msgs, rs, j)
    return msgs, rs, state


def chain_rounds_generic_batched(lo, hi, state, products, degree: int, num_rounds: int,
                                 round_fns=None, transcript_fn=None):
    """`chain_rounds_generic` over B instances at once, the counterpart of
    the JAX package's vmapped step and chain (`_bstep_generic`,
    `_bchain_generic`, `_prove_batched_generic`, `sumcheck_tpu/batch.py:
    60-84, 157-257`): `lo`, `hi` are (B, U, 8, H) tables folded in place,
    `state` the (B, 26, 2) transcripts. Per round one batched round kernel
    (`round_nofold_batched`, then `round_fold_batched`, instance b folded by
    its own challenge rs[j-1, b]) adding into row j of a zeroed (k, B, d+1,
    16) buffer, and one batched transcript step reading it: two launches a
    round for all B instances, no host sync. The fold is `round_fold_batched`
    in every MXU mode, as the JAX batch never takes the MXU kernel. Returns
    (msgs (k, B, 16, d+1), rs (k, B, 16), state). `round_fns` and
    `transcript_fn` are test hooks."""
    nofold, fold = round_fns or (round_cuda.round_nofold_batched, round_cuda.round_fold_batched)
    transcript = transcript_fn or transcript_cuda.transcript_step_batched
    half = lo.shape[3]
    with span("chain"):
        msgs, rs, rows = _batched_buffers(num_rounds, lo.shape[0], degree, lo.device)
        for j in range(num_rounds):
            extent = half >> j
            if j == 0:
                sums = nofold(lo, hi, products, degree, extent, rows[j])
            else:
                sums = fold(lo, hi, rs[j - 1], products, degree, extent, rows[j])
            transcript(state, sums, msgs, rs, j)
    return msgs, rs, state


def prove_generic(fs_rng, polynomial, device, round_fns=None, transcript_fn=None):
    """Full Fiat-Shamir prove with the round kernels and the transcript on
    `device`; returns (prover_msgs, ProverState) like the host path.
    `fs_rng` is a `Blake2b512Rng` that has been fed the polynomial info; its
    state is lifted, advanced on the device, and written back.

    `device="cuda"` launches the CUDA kernels and raises without a card;
    `device="cpu"` runs their plain versions. `round_fns` (no-fold, fold)
    and `transcript_fn` replace the kernels' functions, a test hook by
    which a check on the card runs the plain versions there."""
    device = resolve_device(device)
    nv = polynomial.num_variables
    if nv == 0:
        raise SumcheckError("Attempt to prove a constant.")

    lo, hi, products, degree = init_pair(polynomial, device)
    state = lift_transcript(fs_rng, device)
    msgs, rs, state = chain_rounds_generic(
        lo, hi, state, products, degree, nv, round_fns, transcript_fn
    )
    prover_msgs, randomness = finish_chain(fs_rng, msgs, rs, state, degree)
    return prover_msgs, prover_state(polynomial, lo, hi, randomness)


def prove_host_transcript(fs_rng, polynomial, device):
    """Full Fiat-Shamir prove with the round kernels on `device` and the
    transcript `fs_rng` on the host (any rng with `feed` and the draws
    `Fr.rand` uses): the interactive tier's rounds (`prover.prove_round`,
    one sync each) under `host_rounds`. Arguments as `prove_generic`."""
    state = prover_init(polynomial, device=device)
    msgs, point = host_rounds(fs_rng, state, polynomial.num_variables)
    state.randomness.append(point[-1])
    return msgs, state


def host_rounds(fs_rng, state, num_rounds: int):
    """`num_rounds` rounds of the interactive tier over the host transcript
    `fs_rng`: prove a round, feed its message, draw the challenge, as
    `sumcheck_tpu/ml_sumcheck.py:122-131` does. Returns (messages, every
    challenge drawn); the last one is not yet given to the prover."""
    msgs, point = [], []
    v_msg = None
    for _ in range(num_rounds):
        msg = prove_round(state, v_msg)
        fs_rng.feed(msg)
        msgs.append(msg)
        v_msg = sample_round(fs_rng)
        point.append(v_msg.randomness)
    return msgs, point
