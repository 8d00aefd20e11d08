"""The per-size chained prover, the round kernels' table pair, and the
plumbing of the on-device transcript.

Port of `sumcheck_tpu/protocol/device_prover.py`:

- `_fold_plan` (`:141-177`) and `init_pair` (`:298-334`, with the scaling of
  `_stacker` as torch ops on the pair's device): the table pair both chains
  start from;
- `_kernel_step` (`:40-115`), `chain_rounds` (`:337-371`) and
  `prove_chained` (`:460-491`): the per-size chain
  (`SUMCHECK_TPU_CHAIN_IMPL=persize`). Each round launches one round kernel
  (`round_cuda.round_step_nofold` in round 0, `round_step_fold` after it,
  which folds into fresh half-width tables) and one transcript step
  (`transcript_cuda.transcript_step`), output feeding input, with no host
  sync; the kernels cover every extent down to one lane, so there is no
  small-table branch;
- `lift_transcript`, `fetch_chain_outputs` (`_packer`), `col_int`,
  `msgs_from_host` and `restore_transcript` (`:374-457`), shared with the
  generic chain (`generic_prover.py`): one upload of the host transcript
  before the chain, one device-to-host copy after it.

Left out, because they work around the TPU: `_init_pair_incremental`,
`_slot_writer`, `_ones_writer` and `_BIG_PAIR_BYTES` (`:206-295`, for the
TPU's enqueue-time allocation and a 16 GB chip; an 80 GB H100 holds the
nv=24 pair several times over), the jit donation logic (`:111-115`; here
the folded-away pair is released once no reference holds it), and the
`_dev_pair` cache (`:313-316`), which nothing writes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs_np as L
from ..fields import limbs_torch as LT
from ..fields.fr import NUM_DIGITS, Fr, P, R_INV
from ..ops import round_cuda, transcript_cuda
from ..transcript.device import DevTranscript
from ..utils.errors import SumcheckError


def _fold_plan(polynomial):
    """Decide how to fold each product's coefficient into a table slot.

    Returns (products, scale_plan, num_slots, need_ones):
    - products: padded index tuples with coefficients absorbed;
    - scale_plan: list of (dst_slot, src_slot, coeff_int) — dst == src means
      scale in place (slot referenced nowhere else); dst >= num_tables
      appends a scaled copy (slot shared between products);
    - coefficient 1 folds for free (no scale op).
    """
    num_tables = len(polynomial.flattened_ml_extensions)
    usage = [0] * num_tables
    prods = [list(ix) for _, ix in polynomial.products]
    for ix in prods:
        for s in ix:
            usage[s] += 1
    scale_plan = []
    next_slot = num_tables
    for (coeff, _), ix in zip(polynomial.products, prods):
        if coeff.v == 1:
            continue
        t0 = ix[0]
        if usage[t0] == 1:
            scale_plan.append((t0, t0, coeff.v))
        else:
            scale_plan.append((next_slot, t0, coeff.v))
            usage[t0] -= 1
            ix[0] = next_slot
            next_slot += 1
    max_len = max(len(ix) for ix in prods)
    need_ones = any(len(ix) < max_len for ix in prods)
    ones_slot = next_slot
    products = tuple(
        tuple(ix + [ones_slot] * (max_len - len(ix))) for ix in prods
    )
    num_slots = next_slot + (1 if need_ones else 0)
    return products, tuple(scale_plan), num_slots, need_ones


def init_pair(polynomial, device):
    """Build the (lo, hi) table pair the round kernels consume on `device`:
    unique tables (device-cached, bit-reversed — `DenseMLE.to_device`),
    product coefficients pre-multiplied into one exclusive slot each, a
    constant-one slot only if some product needs ragged padding.

    Returns (lo, hi, products, degree): lo and hi are fresh (U, 16, 2^nv/2)
    int32 tensors that the rounds fold in place."""
    n = 1 << polynomial.num_variables
    products, scale_plan, num_slots, need_ones = _fold_plan(polynomial)
    tabs = [m.to_device(device) for m in polynomial.flattened_ml_extensions]
    for dst, src, coeff in scale_plan:
        col = LT.from_numpy(L.mont_scalar(coeff), tabs[src].device)
        scaled = LT.mont_mul(tabs[src], col).to(torch.int32)
        if dst == src:
            tabs[src] = scaled
        else:
            tabs.append(scaled)
    if need_ones:
        one = torch.from_numpy(L.mont_scalar(1).astype("int32"))
        tabs.append(one.to(tabs[0].device).expand(NUM_DIGITS, n))
    # slot axis leading: (U, 16, n/2) halves, filled slot by slot
    lo = torch.empty((num_slots, NUM_DIGITS, n // 2), dtype=torch.int32, device=tabs[0].device)
    hi = torch.empty_like(lo)
    for u, t in enumerate(tabs):
        lo[u] = t[:, : n // 2]
        hi[u] = t[:, n // 2 :]
    return lo, hi, products, polynomial.max_multiplicands


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device` with its index, as a tensor's `.device`
    names it (so device-keyed caches agree); "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device is cuda, but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _kernel_step(lo, hi, r, products, degree: int, do_fold: bool, step_fns=None):
    """The per-round table work: [fold by r] -> evaluate at t=0..d ->
    lane-reduce. Returns (pair, sums): the fresh half-width (lo, hi) after a
    fold, None for round 0, and the (d+1, 16) int64 per-digit sums.
    Coefficients do not appear: `init_pair` folds them into the tables.
    `step_fns` replaces (round_step_nofold, round_step_fold), a test hook."""
    nofold, fold = step_fns or (round_cuda.round_step_nofold, round_cuda.round_step_fold)
    if do_fold:
        return fold(lo, hi, r, products, degree)
    return None, nofold(lo, hi, products, degree)


def chain_rounds(pair: list, state, products, degree: int, num_rounds: int,
                 step_fns=None, transcript_fn=None):
    """Enqueue `num_rounds` rounds with no host sync: per round one round
    kernel and one transcript step, output feeding input. `pair` is the
    list [lo, hi]; this function empties it, so that no reference outside
    keeps a folded-away pair alive, and each pair is released once the
    next round's launch is enqueued. `state` is the packed transcript
    (advanced in place). Returns (msgs (k, 16, d+1), rs (k, 16), state,
    (lo, hi)), all on the pair's device; rs holds each round's challenge in
    Montgomery digits. `step_fns` and `transcript_fn` are test hooks."""
    transcript = transcript_fn or transcript_cuda.transcript_step
    lo, hi = pair
    pair.clear()
    device = lo.device
    msgs = torch.empty((num_rounds, NUM_DIGITS, degree + 1), dtype=torch.int32, device=device)
    rs = torch.empty((num_rounds, NUM_DIGITS), dtype=torch.int32, device=device)
    r = None
    for i in range(num_rounds):
        new_pair, sums = _kernel_step(lo, hi, r, products, degree, i > 0, step_fns)
        if new_pair is not None:
            lo, hi = new_pair
        transcript(state, sums, msgs, rs, i)
        r = rs[i]
    return msgs, rs, state, (lo, hi)


def fetch_chain_outputs(msgs, rs, state):
    """One device-to-host copy of everything a chain produced; returns
    (msgs (k, 16, d+1), rs (k, 16), state (26, 2)) as CPU int32 tensors."""
    flat = torch.cat([msgs.reshape(-1), rs.reshape(-1), state.reshape(-1)]).cpu()
    o1 = msgs.numel()
    o2 = o1 + rs.numel()
    return (flat[:o1].reshape(msgs.shape), flat[o1:o2].reshape(rs.shape),
            flat[o2:].reshape(state.shape))


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`; on a card from pinned memory, without a
    host wait, so that a prove's uploads do not sync."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def lift_transcript(fs_rng, device) -> torch.Tensor:
    """The packed device transcript of a host `Blake2b512Rng`, one upload."""
    return upload(DevTranscript.lift(fs_rng.state_tuple()).to_state(), device)


def col_int(d) -> int:
    """(16,) strict digit column (host) -> Python int."""
    v = 0
    for k in range(NUM_DIGITS):
        v |= int(d[k]) << (16 * k)
    return v


def msgs_from_host(msgs_h, degree: int):
    """Fetched canonical digit mats [(16, d+1)] -> list[ProverMsg]."""
    from .prover import ProverMsg

    msgs_h = np.asarray(msgs_h)
    return [
        ProverMsg([Fr(col_int(m[:, t])) for t in range(degree + 1)])
        for m in msgs_h
    ]


def restore_transcript(fs_rng, state_h) -> None:
    """Write the fetched device transcript state back into the host rng."""
    fs_rng.set_state(*DevTranscript.from_state(state_h).lower())


def finish_chain(fs_rng, msgs, rs, state, degree: int):
    """After a chain: the one fetch, then the proof messages, the challenges
    as `Fr`, and the host transcript set to the device's final state."""
    msgs_h, rs_h, state_h = fetch_chain_outputs(msgs, rs, state)
    prover_msgs = msgs_from_host(msgs_h, degree)
    randomness = [Fr(col_int(rd) * R_INV % P) for rd in rs_h.numpy()]
    restore_transcript(fs_rng, state_h)
    return prover_msgs, randomness


def prover_state(polynomial, lo, hi, randomness, degree: int):
    """The `ProverState` after all rounds of a chained prove."""
    from .prover import ProverState

    state = ProverState(
        randomness=randomness,
        list_of_products=[(c, list(ix)) for c, ix in polynomial.products],
        stacked=(lo, hi),
        num_vars=polynomial.num_variables,
        max_multiplicands=degree,
    )
    state.round = polynomial.num_variables
    return state


def prove_chained(fs_rng, polynomial, device, step_fns=None, transcript_fn=None):
    """Full Fiat-Shamir prove through the per-size chain with the transcript
    on `device`; returns (prover_msgs, ProverState) like the host path.
    `fs_rng` is a `Blake2b512Rng` that has been fed the polynomial info; its
    state is lifted, advanced on the device, and written back.

    `device="cuda"` launches the CUDA kernels and raises without a card;
    `device="cpu"` runs their plain versions. `step_fns` and
    `transcript_fn` replace the round and transcript functions, a test hook
    by which a check on the card runs the plain versions there."""
    device = resolve_device(device)
    nv = polynomial.num_variables
    if nv == 0:
        raise SumcheckError("Attempt to prove a constant.")

    lo, hi, products, degree = init_pair(polynomial, device)
    pair = [lo, hi]
    del lo, hi
    state = lift_transcript(fs_rng, device)
    msgs, rs, state, (lo, hi) = chain_rounds(
        pair, state, products, degree, nv, step_fns, transcript_fn
    )
    prover_msgs, randomness = finish_chain(fs_rng, msgs, rs, state, degree)
    return prover_msgs, prover_state(polynomial, lo, hi, randomness, degree)
