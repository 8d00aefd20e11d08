"""The per-size chained prover, the round kernels' table pair, and the
plumbing of the on-device transcript.

Port of `sumcheck_tpu/protocol/device_prover.py`:

- `_fold_plan` (`:141-177`) and `init_pair` (`:298-334`, `_stacker` as one
  `ops/init_cuda.pair_init` kernel launch): the table pair both chains
  start from; `init_pairs` writes B instances' pairs into one batched pair;
- `_kernel_step` (`:40-115`), `chain_rounds` (`:337-371`) and
  `prove_chained` (`:460-491`): the per-size chain
  (`SUMCHECK_TPU_CHAIN_IMPL=persize`). Each round launches two kernels, one
  round kernel (`round_cuda.round_step_nofold` in round 0,
  `round_step_fold` after it, which folds into fresh half-width tables)
  adding its sums into the round's row of one zeroed `sum_rows` buffer, and
  one transcript step (`transcript_cuda.transcript_step`) reading that row,
  output feeding input, with no host sync; the kernels cover every extent
  down to one lane, so there is no small-table branch;
- `lift_transcript`, `fetch_chain_outputs` (`_packer`), `col_int`,
  `msgs_from_host` and `restore_transcript` (`:374-457`), shared with the
  generic chain (`generic_prover.py`): one upload of the host transcript
  before the chain, one device-to-host copy after it;
- the batched counterparts for `batch.py`: `chain_rounds_batched` (the
  per-size chain over B instances, `sumcheck_tpu/batch.py:349-416`),
  `lift_transcripts` and `finish_chain_batched`.

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

from ..fields.fr import NUM_DIGITS, NUM_LIMBS, Fr, P, R_INV
from ..ops import init_cuda, round_cuda, transcript_cuda
from ..transcript.device import DevTranscript
from ..utils.errors import SumcheckError


def _fold_plan(polynomial, zero_copies: bool = True):
    """Decide how to fold each product's coefficient into a table slot.

    Returns (products, scale_plan, num_slots, need_ones):
    - products: padded index tuples with coefficients absorbed;
    - scale_plan: list of (dst_slot, src_slot, coeff_int) — dst == src means
      scale in place (slot referenced nowhere else); dst >= num_tables
      appends a scaled copy (slot shared between products, or, with
      `zero_copies`, a coefficient of 0 mod p, which in place would wipe the
      table the state reads back);
    - coefficient 1 folds for free (no scale op).

    Unlike the JAX package's plan (`:141-177`), a zero coefficient takes a
    copy slot while the plan fits the kernels' `init_cuda.MAX_SLOTS`: every
    table then survives unscaled or invertibly scaled, so
    `ProverState.flattened_ml_extensions` can return it. A plan that the
    copies would take past the limit scales in place instead, as the JAX
    plan does: the proof is the same, and only `flattened_ml_extensions`
    refuses the wiped table. A plan past the limit either way raises
    `SumcheckError` before anything is launched.
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
        if usage[t0] == 1 and (coeff.v % P != 0 or not zero_copies):
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
    if num_slots > init_cuda.MAX_SLOTS:
        if zero_copies:
            return _fold_plan(polynomial, zero_copies=False)
        raise SumcheckError(f"the product structure needs {num_slots} table slots, more than "
                            f"the {init_cuda.MAX_SLOTS} the kernels hold")
    return products, tuple(scale_plan), num_slots, need_ones


def _fill_pair(lo, hi, polynomial, plan, device, shard=None) -> None:
    """One `init_cuda.pair_init` launch: every slot of `lo`, `hi` ((U, 8,
    n/2), possibly one instance's slice of a batched pair, or (U, 8, n/2S)
    for a `shard` (s, S)) from the polynomial's device-cached tables
    (`DenseMLE.to_device`) by its `_fold_plan`. The cached tables are only
    read."""
    _products, scale_plan, _num_slots, need_ones = plan
    tabs = [m.to_device(device, shard) for m in polynomial.flattened_ml_extensions]
    init_cuda.pair_init(lo, hi, tabs, init_cuda.slot_specs(len(tabs), scale_plan, need_ones))


def init_pair(polynomial, device, shard=None):
    """Build the (lo, hi) table pair the round kernels consume on `device`:
    unique tables (device-cached, bit-reversed — `DenseMLE.to_device`),
    product coefficients pre-multiplied into one exclusive slot each, a
    constant-one slot only if some product needs ragged padding; one
    `pair_init` kernel launch on a card.

    Returns (lo, hi, products, degree): lo and hi are fresh (U, 8, 2^nv/2)
    int32 tensors, each value 8 x 32-bit limbs (`limbs_torch.pack_limbs`),
    that the rounds fold in place. With `shard` = (s, S) they
    are rank s's (U, 8, 2^nv/2S) lanes of that pair, global pair lanes
    l·S + s as local lanes l (`parallel/mesh.deal`), built from rank s's
    lanes of each table alone: a valid pair of 2^nv/2S lanes."""
    device = resolve_device(device)
    lanes = (1 << polynomial.num_variables) // 2 // (shard[1] if shard else 1)
    plan = _fold_plan(polynomial)
    lo = torch.empty((plan[2], NUM_LIMBS, lanes), dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    _fill_pair(lo, hi, polynomial, plan, device, shard)
    return lo, hi, plan[0], polynomial.max_multiplicands


def init_pairs(polynomials, device):
    """The batched pair of B polynomials of one shape on `device`: instance
    b's `init_pair` written straight into slice b of (B, U, 8, 2^nv/2)
    `lo`, `hi` (one `pair_init` launch each, no stacking copy).

    Returns (lo, hi, products, degree), or None when the instances' fold
    plans differ (their coefficients put different slots in the products):
    one product index structure cannot then serve them all."""
    device = resolve_device(device)
    plans = [_fold_plan(p) for p in polynomials]
    products, _scale, num_slots, _ones = plans[0]
    if any(p[0] != products for p in plans):  # equal products: equal slot counts
        return None
    n = 1 << polynomials[0].num_variables
    shape = (len(polynomials), num_slots, NUM_LIMBS, n // 2)
    lo = torch.empty(shape, dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    for b, (poly, plan) in enumerate(zip(polynomials, plans)):
        _fill_pair(lo[b], hi[b], poly, plan, device)
    return lo, hi, products, polynomials[0].max_multiplicands


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


def sum_rows(num_rounds: int, degree: int, device) -> torch.Tensor:
    """The chain's zeroed (rounds, d+1, 16) int64 buffer: round j's kernel
    adds its per-digit sums into row j, and the transcript step reads it."""
    return torch.zeros((num_rounds, degree + 1, NUM_DIGITS), dtype=torch.int64, device=device)


def _kernel_step(lo, hi, r, products, degree: int, do_fold: bool, step_fns=None, out=None):
    """The per-round table work: [fold by r] -> evaluate at t=0..d ->
    lane-reduce into the row `out`. Returns (pair, sums): the fresh
    half-width (lo, hi) after a fold, None for round 0, and the (d+1, 16)
    int64 per-digit sums. Coefficients do not appear: `init_pair` folds them
    into the tables. `step_fns` replaces (round_step_nofold,
    round_step_fold), a test hook."""
    nofold, fold = step_fns or (round_cuda.round_step_nofold, round_cuda.round_step_fold)
    if do_fold:
        return fold(lo, hi, r, products, degree, None, out)
    return None, nofold(lo, hi, products, degree, None, out)


def chain_rounds(pair: list, state, products, degree: int, num_rounds: int,
                 step_fns=None, transcript_fn=None):
    """Enqueue `num_rounds` rounds with no host sync: per round one round
    kernel, adding its sums into row i of a zeroed `sum_rows` buffer, and
    one transcript step reading that row, output feeding input. `pair` is the
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
    rows = sum_rows(num_rounds, degree, device)
    r = None
    for i in range(num_rounds):
        new_pair, sums = _kernel_step(lo, hi, r, products, degree, i > 0, step_fns, rows[i])
        if new_pair is not None:
            lo, hi = new_pair
        transcript(state, sums, msgs, rs, i)
        r = rs[i]
    return msgs, rs, state, (lo, hi)


def chain_rounds_batched(pair: list, state, products, degree: int, num_rounds: int,
                         step_fns=None, transcript_fn=None):
    """`chain_rounds` over B instances at once, the counterpart of the JAX
    package's `_prove_batched_chained` (`sumcheck_tpu/batch.py:349-416`):
    `pair` is the list [lo, hi] of (B, U, 8, H) tables (emptied here, as
    `chain_rounds` does), `state` the (B, 26, 2) transcripts. Per round one
    batched round kernel (`round_nofold_batched` over all H lanes in round
    0, then `round_step_fold_batched` into fresh half-width tables, each
    instance folded by its own challenge) adding into row j of a zeroed (k,
    B, d+1, 16) buffer, and one batched transcript step reading it: two
    launches a round for all B instances, no host sync. Returns (msgs (k, B,
    16, d+1), rs (k, B, 16), state, (lo, hi)). `step_fns` and
    `transcript_fn` are test hooks."""
    nofold, fold = step_fns or (round_cuda.round_nofold_batched,
                                round_cuda.round_step_fold_batched)
    transcript = transcript_fn or transcript_cuda.transcript_step_batched
    lo, hi = pair
    pair.clear()
    msgs, rs, rows = _batched_buffers(num_rounds, lo.shape[0], degree, lo.device)
    for j in range(num_rounds):
        if j == 0:
            sums = nofold(lo, hi, products, degree, lo.shape[3], rows[0])
        else:
            (lo, hi), sums = fold(lo, hi, rs[j - 1], products, degree, None, rows[j])
        transcript(state, sums, msgs, rs, j)
    return msgs, rs, state, (lo, hi)


def _batched_buffers(num_rounds: int, batch: int, degree: int, device):
    """A batched chain's outputs, (k, B, 16, d+1) msgs and (k, B, 16) rs,
    and its zeroed (k, B, d+1, 16) int64 sums buffer."""
    msgs = torch.empty((num_rounds, batch, NUM_DIGITS, degree + 1), dtype=torch.int32,
                       device=device)
    rs = torch.empty((num_rounds, batch, NUM_DIGITS), dtype=torch.int32, device=device)
    rows = torch.zeros((num_rounds, batch, degree + 1, NUM_DIGITS), dtype=torch.int64,
                       device=device)
    return msgs, rs, rows


def fetch_chain_outputs(msgs, rs, state):
    """One device-to-host copy of everything a chain produced; returns
    (msgs (k, [B,] 16, d+1), rs (k, [B,] 16), state ([B,] 26, 2)) as CPU
    int32 tensors."""
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


def liftable(fs_rng) -> bool:
    """Whether the device transcript can take `fs_rng` over: a
    `Blake2b512Rng` whose pending byte count is a multiple of 8. Any other
    transcript is proved on the host loop."""
    from ..transcript.blake2b_rng import Blake2b512Rng

    return isinstance(fs_rng, Blake2b512Rng) and len(fs_rng.state_tuple()[2]) % 8 == 0


def lift_transcript(fs_rng, device) -> torch.Tensor:
    """The packed device transcript of a host `Blake2b512Rng`, one upload."""
    return upload(DevTranscript.lift(fs_rng.state_tuple()).to_state(), device)


def lift_transcripts(fs_rngs, device):
    """The (B, 26, 2) packed device transcripts of B host `Blake2b512Rng`s,
    one upload; each keeps its own pending-byte count. None if a transcript
    holds a pending byte count that is not a multiple of 8, which the
    device transcript cannot hold."""
    states = [r.state_tuple() for r in fs_rngs]
    if any(len(buf) % 8 for _h, _t, buf in states):
        return None
    return upload(torch.stack([DevTranscript.lift(s).to_state() for s in states]), device)


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


def finish_chain_batched(fs_rngs, msgs, rs, state, degree: int):
    """After a batched chain: one fetch for all B instances, then each
    instance's proof messages and challenges, and each host transcript set
    to its device state. Returns (proofs, challenges), lists of B."""
    msgs_h, rs_h, state_h = fetch_chain_outputs(msgs, rs, state)
    proofs, challenges = [], []
    for b, rng in enumerate(fs_rngs):
        proofs.append(msgs_from_host(msgs_h[:, b], degree))
        challenges.append([Fr(col_int(rd) * R_INV % P) for rd in rs_h[:, b].numpy()])
        restore_transcript(rng, state_h[b])
    return proofs, challenges


def prover_state(polynomial, lo, hi, randomness):
    """The `ProverState` after all rounds of a chained prove."""
    from .prover import pair_state

    state = pair_state(polynomial, lo, hi)
    state.randomness = randomness
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
    return prover_msgs, prover_state(polynomial, lo, hi, randomness)
