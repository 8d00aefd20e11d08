"""The Fiat-Shamir prover over the round kernels.

Port of `sumcheck_tpu/protocol/generic_prover.py` `prove_generic`
(`:652-710`) with its round chain (`chain_rounds_generic`, `:516-593`) as one
Python loop over rounds with run-time extents. The table pair is allocated
once (`device_prover.init_pair`); round j works on the first
`A = 2^(nv-1) >> j` lanes of it:

- round 0 launches the no-fold kernel over all `2^(nv-1)` pairs;
- round j >= 1 launches the fold kernel over exactly `A` lanes; the kernel
  grid covers that extent, so nothing needs the JAX lane mask.

The transcript runs on the host: each round copies its exact sums to the
host (one sync), reduces them mod p to canonical form, feeds the `ProverMsg`
and samples the challenge on `fs_rng`, then uploads the challenge's
Montgomery digits for the next fold — the schedule of the host loop at
`sumcheck_tpu/ml_sumcheck.py:122-131`, so proofs are byte-identical to the
JAX package's. The on-device transcript (one sync per prove) is later work.

Left out, because they serve XLA compile counts or TPU enqueue memory: the
masked fixed-shape programs and their padding, the compile prewarming, the
per-stage syncs for huge pairs, the incremental pair init and the per-size
chain.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs_np as L
from ..fields.fr import Fr, P, R_INV
from ..fields.limbs_torch import wide_to_int
from ..ops import round_cuda
from ..utils.errors import SumcheckError
from .device_prover import init_pair
from .prover import ProverMsg, ProverState


def prove_generic(fs_rng, polynomial, device, round_fns=None):
    """Full Fiat-Shamir prove with the round kernels on `device`; returns
    (prover_msgs, ProverState) like the host path. `fs_rng` has been fed
    the polynomial info already.

    `device="cuda"` launches the CUDA kernels and raises without a card;
    `device="cpu"` runs their plain versions. `round_fns` replaces the
    (no-fold, fold) round functions — a test hook, by which a check on the
    card runs the plain versions there to compare proofs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device is cuda, but no CUDA device is available")
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

    state = ProverState(
        randomness=randomness,
        list_of_products=[(c, list(ix)) for c, ix in polynomial.products],
        stacked=(lo, hi),
        num_vars=nv,
        max_multiplicands=degree,
    )
    state.round = nv
    return msgs, state
