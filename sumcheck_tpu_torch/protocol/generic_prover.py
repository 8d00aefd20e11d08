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
one copy (`device_prover.finish_chain`).

`prove_host_transcript` is the loop for any other transcript: each round
copies its exact sums to the host (one sync), reduces them mod p, feeds the
`ProverMsg` and samples the challenge on `fs_rng`, then uploads the
challenge for the next fold, the schedule of the host loop at
`sumcheck_tpu/ml_sumcheck.py:122-131`. Proofs are byte-identical either way.

Left out, because they serve XLA compile counts or TPU enqueue memory: the
masked fixed-shape programs and their padding, the compile prewarming, the
per-stage syncs for huge pairs and the incremental pair init.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs_np as L
from ..fields.fr import NUM_DIGITS, Fr, P, R_INV
from ..fields.limbs_torch import wide_to_int
from ..ops import round_cuda, transcript_cuda
from ..utils.config import get_config
from ..utils.errors import SumcheckError
from .device_prover import (
    finish_chain,
    init_pair,
    lift_transcript,
    prover_state,
    resolve_device,
)
from .prover import ProverMsg


def chain_rounds_generic(lo, hi, state, products, degree: int, num_rounds: int,
                         round_fns=None, transcript_fn=None):
    """Enqueue `num_rounds` rounds with no host sync: per round one round
    kernel over the active extent (folding `lo`, `hi` in place) and one
    transcript step. `state` is the packed transcript (advanced in place).
    Returns (msgs (k, 16, d+1), rs (k, 16), state) on the pair's device.
    The fold rounds launch `round_fold_mxu` in the MXU fold mode.
    `round_fns` and `transcript_fn` are test hooks."""
    mxu = get_config().use_mxu_fold()
    nofold, fold = round_fns or (
        round_cuda.round_nofold, round_cuda.round_fold_mxu if mxu else round_cuda.round_fold)
    transcript = transcript_fn or transcript_cuda.transcript_step
    device = lo.device
    half = lo.shape[2]
    msgs = torch.empty((num_rounds, NUM_DIGITS, degree + 1), dtype=torch.int32, device=device)
    rs = torch.empty((num_rounds, NUM_DIGITS), dtype=torch.int32, device=device)
    for j in range(num_rounds):
        extent = half >> j
        if j == 0:
            sums = nofold(lo, hi, products, degree, extent)
        else:
            sums = fold(lo, hi, rs[j - 1], products, degree, extent)
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
    return prover_msgs, prover_state(polynomial, lo, hi, randomness, degree)


def prove_host_transcript(fs_rng, polynomial, device, round_fns=None):
    """Full Fiat-Shamir prove with the round kernels on `device` and the
    transcript `fs_rng` on the host (any rng with `feed` and the draws
    `Fr.rand` uses), one sync per round. Arguments as `prove_generic`."""
    device = resolve_device(device)
    nofold, fold = round_fns or (round_cuda.round_nofold, round_cuda.round_fold)
    nv = polynomial.num_variables
    if nv == 0:
        raise SumcheckError("Attempt to prove a constant.")

    lo, hi, products, degree = init_pair(polynomial, device)
    half = lo.shape[2]
    msgs, randomness = [], []
    r_dev = None
    for j in range(nv):
        extent = half >> j
        if j == 0:
            sums = nofold(lo, hi, products, degree, extent)
        else:
            sums = fold(lo, hi, r_dev, products, degree, extent)
        wide = round_cuda.finish_sums(sums)  # the round's one sync
        msg = ProverMsg(
            [Fr(wide_to_int(wide[:, t]) % P * R_INV % P) for t in range(degree + 1)]
        )
        fs_rng.feed(msg)
        msgs.append(msg)
        r = Fr.rand(fs_rng)
        randomness.append(r)
        if j + 1 < nv:
            r_host = L.mont_scalar(r.v)[:, 0].astype(np.int32)
            r_dev = torch.from_numpy(r_host).to(device)
    return msgs, prover_state(polynomial, lo, hi, randomness, degree)
