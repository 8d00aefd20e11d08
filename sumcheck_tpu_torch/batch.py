"""Batched (throughput-mode) provers: B independent instances of one shape
proved together, each round of all B in one kernel launch. Port of
`sumcheck_tpu/batch.py`.

BASELINE config 4, "many independent nv=16 instances packed per chip". The
JAX package vmaps its generic round step and chain over an instance axis;
here the round kernels and the transcript step take that axis themselves
(`round_cuda.round_*_batched`, `transcript_cuda.transcript_step_batched`:
grid y, or one warp per transcript), so a chained round of all B instances
is two launches, and all B proofs come back in one fetch. Proofs are
byte-identical to proving each instance alone with `MLSumcheck` /
`GKRRoundSumcheck`, and each caller's transcript ends in the same state.

Instances share (num_variables, product index structure); coefficients and
table contents vary freely. `BatchedMLSumcheck.prove_as_subprotocol` picks:

- with every transcript a `Blake2b512Rng` whose pending bytes are a
  multiple of 8, and every instance's coefficients folded into the same
  slots (`device_prover.init_pairs`), the batched generic chain
  (`generic_prover.chain_rounds_generic_batched`) or, for
  `SUMCHECK_TPU_CHAIN_IMPL=persize`, the batched per-size chain
  (`device_prover.chain_rounds_batched`). Each transcript keeps its own
  pending-byte count on the device, so unequal counts need no fallback;
- otherwise the batched host-transcript loop (`batch.py:482-554`): the
  tables unscaled with a ones slot, the coefficients per instance in the
  round kernels, one fetch of all B sums rows a round, each transcript fed
  and sampled on the host. Unlike the JAX package, instances whose fold
  plans differ take this loop on both chains (the JAX generic batch proves
  them against the first instance's plan), and unequal pending bytes need
  no assert.

`BatchedGKRRoundSumcheck.prove` runs each instance's phase inits (torch ops,
`ops/gkr_init.py`) into its slice of one batched pair and both phases'
rounds on the batched generic chain, with one sync for all B proofs; unequal
nnz, the per-size chain or another transcript fall back to per-instance
proves, as in the JAX package.

The sharded batch (`BatchedMLSumcheck.prove(..., group=)`, the JAX
package's `mesh=`, `batch.py:87-133, 157-257, 431-471`) splits the
instance axis over the ranks of a `torch.distributed` group: rank s proves
instances [s·B/S, (s+1)·B/S) as above, with no collective inside (the
instances are independent), then one `parallel/comm.gather_lanes` of every
instance's proof, challenges and final transcript state gives every rank
all B proofs and every caller's transcript. Unlike the JAX package, the
host loop serves a rank whose instances need it, as above.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import limbs_np as L
from .fields.fr import NUM_DIGITS, NUM_LIMBS, Fr, P, R_INV
from .fields.limbs_torch import wide_to_int
from .ml_sumcheck import MLSumcheck
from .ops import init_cuda, round_cuda
from .protocol import device_prover, generic_prover
from .protocol.prover import ProverMsg
from .transcript.blake2b_rng import Blake2b512Rng
from .utils.config import get_config
from .utils.errors import SumcheckError


def _validate(fs_rngs, polynomials) -> None:
    """The reference's checks (`batch.py:435-443`), all before any transcript
    is fed, so that a raise leaves the caller's transcripts untouched."""
    if not polynomials or len(fs_rngs) != len(polynomials):
        raise SumcheckError("batched proving needs at least one instance and one "
                            "transcript per instance")
    first = polynomials[0]
    nv = first.num_variables
    if nv == 0:
        raise SumcheckError("Attempt to prove a constant.")
    structure = [ix for _, ix in first.products]
    for poly in polynomials[1:]:
        if poly.num_variables != nv or [ix for _, ix in poly.products] != structure:
            raise SumcheckError("batched instances must share shape/structure")


def _validate_group(fs_rngs, polynomials, group):
    """The sharded batch's checks (`batch.py:449-464`), before any feed:
    returns (rank, ranks)."""
    from .parallel.mesh import group_shape

    rank, size = group_shape(group)
    if len(polynomials) % size:
        raise SumcheckError(f"batch of {len(polynomials)} instances cannot be sharded over "
                            f"{size} ranks")
    if get_config().chain_impl != "generic" or not all(isinstance(r, Blake2b512Rng)
                                                       for r in fs_rngs):
        raise SumcheckError("sharded batching requires the chained generic engine and "
                            "Blake2b512Rng transcripts")
    return rank, size


def _prove_local(fs_rngs, polynomials, degree: int, nv: int, device):
    """The batch on one device: the batched chain where it can take the
    instances, else the batched host loop."""
    if all(isinstance(r, Blake2b512Rng) for r in fs_rngs):
        res = _prove_batched_chained(fs_rngs, polynomials, degree, nv, device)
        if res is not None:
            return res
    return _prove_batched_host(fs_rngs, polynomials, degree, nv, device)


_MODULUS_BYTES = 32


def _pack(proofs, challenges, rngs) -> np.ndarray:
    """Each instance's proof bytes, challenges and transcript state (h, t
    in 16 bytes, the pending count and the pending block padded to 128
    bytes) as one column of little-endian 32-bit words, (words, instances)
    int64."""
    from .ml_sumcheck import serialize_proof

    cols = []
    for proof, rs, rng in zip(proofs, challenges, rngs):
        h, t, buf = rng.state_tuple()
        blob = (serialize_proof(proof)
                + b"".join(r.v.to_bytes(_MODULUS_BYTES, "little") for r in rs)
                + b"".join(w.to_bytes(8, "little") for w in h) + t.to_bytes(16, "little")
                + bytes([len(buf)]) + buf.ljust(128, b"\0"))
        blob += b"\0" * (-len(blob) % 4)
        cols.append(np.frombuffer(blob, dtype="<u4"))
    return np.stack(cols, axis=1).astype(np.int64)


def _unpack(words: np.ndarray, rngs, nv: int):
    """`_pack`'s columns -> (proofs, challenges), each transcript set to its
    instance's state."""
    from .ml_sumcheck import _deserialize_proof_prefix

    proofs, challenges = [], []
    for col, rng in zip(words.T, rngs):
        blob = col.astype("<u4").tobytes()
        proof, off = _deserialize_proof_prefix(blob)
        rs = [Fr(int.from_bytes(blob[off + _MODULUS_BYTES * i:off + _MODULUS_BYTES * (i + 1)],
                                "little")) for i in range(nv)]
        off += _MODULUS_BYTES * nv
        h = [int.from_bytes(blob[off + 8 * i:off + 8 * i + 8], "little") for i in range(8)]
        t = int.from_bytes(blob[off + 64:off + 80], "little")
        blen = blob[off + 80]
        rng.set_state(h, t, blob[off + 81:off + 81 + blen])
        proofs.append(proof)
        challenges.append(rs)
    return proofs, challenges


def _prove_sharded(fs_rngs, polynomials, degree: int, nv: int, device, group, shard):
    """Rank s proves its B/S instances alone, then one gather of every
    instance's proof, challenges and transcript state over the group."""
    from .parallel import comm

    rank, size = shard
    width = len(polynomials) // size
    mine = slice(rank * width, (rank + 1) * width)
    proofs, challenges = _prove_local(fs_rngs[mine], polynomials[mine], degree, nv, device)
    words = torch.from_numpy(_pack(proofs, challenges, fs_rngs[mine])).to(device)
    return _unpack(comm.gather_lanes(words, group).cpu().numpy(), fs_rngs, nv)


def _prove_batched_chained(fs_rngs, polynomials, degree: int, nv: int, device):
    """Both chains with the transcripts on the device: one upload of the B
    transcripts, B pair-init launches, two launches a round, one fetch.
    None where the chain cannot take the batch (a pending byte count that is
    not a multiple of 8, or diverging fold plans)."""
    state = device_prover.lift_transcripts(fs_rngs, device)
    if state is None:
        return None
    init = device_prover.init_pairs(polynomials, device)
    if init is None:
        return None
    lo, hi, products, _degree = init
    if get_config().chain_impl == "generic":
        msgs, rs, state = generic_prover.chain_rounds_generic_batched(
            lo, hi, state, products, degree, nv)
    else:
        pair = [lo, hi]
        del lo, hi
        msgs, rs, state, _pair = device_prover.chain_rounds_batched(
            pair, state, products, degree, nv)
    return device_prover.finish_chain_batched(fs_rngs, msgs, rs, state, degree)


def _host_pair(polynomials, device):
    """The host loop's (B, T+1, 8, 2^nv/2) pair (`batch.py:482-505`): each
    instance's T tables unscaled, then the ones slot (slot T), one
    `pair_init` launch an instance. Instances of one structure have equal
    table counts (`add_product` numbers tables by first use). Returns (lo,
    hi, T)."""
    tables = len(polynomials[0].flattened_ml_extensions)
    n = 1 << polynomials[0].num_variables
    shape = (len(polynomials), tables + 1, NUM_LIMBS, n // 2)
    lo = torch.empty(shape, dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    specs = tuple((u, None) for u in range(tables)) + ((None, 1),)
    for b, poly in enumerate(polynomials):
        tabs = [m.to_device(device) for m in poly.flattened_ml_extensions]
        init_cuda.pair_init(lo[b], hi[b], tabs, specs)
    return lo, hi, tables


def _prove_batched_host(fs_rngs, polynomials, degree: int, nv: int, device):
    """The batched host-transcript loop: per round one batched round kernel
    with per-instance coefficients (round 0 over all lanes, then folds out
    of place into fresh tables), one fetch of the B sums rows, each
    transcript fed its message and sampled on the host (`Fr.rand`), and one
    upload of the B challenges."""
    lo, hi, ones = _host_pair(polynomials, device)
    structure = [ix for _, ix in polynomials[0].products]
    max_len = max(len(ix) for ix in structure)
    products = tuple(tuple(ix) + (ones,) * (max_len - len(ix)) for ix in structure)
    coeffs = np.stack([np.stack([L.mont_scalar(c.v)[:, 0] for c, _ in p.products])
                       for p in polynomials]).astype(np.int32)  # (B, P, 16)
    coeffs = device_prover.upload(torch.from_numpy(coeffs), device)
    batch = len(polynomials)
    proofs = [[] for _ in range(batch)]
    challenges = [[] for _ in range(batch)]
    r_dev = None
    for j in range(nv):
        if j == 0:
            sums = round_cuda.round_nofold_batched(lo, hi, products, degree, lo.shape[3],
                                                   coeffs=coeffs)
        else:
            (lo, hi), sums = round_cuda.round_step_fold_batched(lo, hi, r_dev, products, degree,
                                                                coeffs)
        sums_h = sums.cpu()  # the round's one sync, all B rows
        r_host = np.empty((batch, NUM_DIGITS), dtype=np.int32)
        for b, rng in enumerate(fs_rngs):
            wide = round_cuda.finish_sums(sums_h[b])
            msg = ProverMsg(
                [Fr(wide_to_int(wide[:, t]) % P * R_INV % P) for t in range(degree + 1)])
            rng.feed(msg)
            proofs[b].append(msg)
            r = Fr.rand(rng)
            challenges[b].append(r)
            r_host[b] = L.mont_scalar(r.v)[:, 0]
        if j + 1 < nv:
            r_dev = device_prover.upload(torch.from_numpy(r_host), device)
    return proofs, challenges


class BatchedMLSumcheck:
    """Prove B same-shaped instances at once (independent Fiat-Shamir
    transcripts; one proof per instance)."""

    @staticmethod
    def prove(polynomials, *, device="cuda", group=None) -> list[list[ProverMsg]]:
        """One proof per polynomial, each with a fresh transcript, on
        `device` (the card unless the caller asks for the CPU); sharded
        over the ranks of `group` if given."""
        rngs = [Blake2b512Rng.setup() for _ in polynomials]
        return BatchedMLSumcheck.prove_as_subprotocol(rngs, polynomials, device=device,
                                                      group=group)[0]

    @staticmethod
    def prove_as_subprotocol(fs_rngs, polynomials, *, device="cuda", group=None):
        """Prove instance b over the caller's transcript `fs_rngs[b]`;
        returns (proofs, challenges), one list each per instance, as B calls
        of `MLSumcheck.prove_as_subprotocol` would give them (the
        challenges are the prover states' randomness).

        With a `torch.distributed` `group` of S ranks, every rank calls this
        with the same B instances and transcripts, proves B/S of them on its
        device (`parallel/mesh.shard_device`), and returns all B, each
        transcript in its final state. It raises `SumcheckError`, before any
        transcript is fed, unless S divides B, the chain is the generic one
        and every transcript is a `Blake2b512Rng`."""
        fs_rngs, polynomials = list(fs_rngs), list(polynomials)
        _validate(fs_rngs, polynomials)
        if group is None:
            device = device_prover.resolve_device(device)
        else:
            from .parallel.mesh import shard_device

            shard = _validate_group(fs_rngs, polynomials, group)
            device = shard_device(group, device)
        for rng, poly in zip(fs_rngs, polynomials):
            rng.feed(poly.info())
        nv = polynomials[0].num_variables
        degree = polynomials[0].max_multiplicands
        if group is None:
            return _prove_local(fs_rngs, polynomials, degree, nv, device)
        return _prove_sharded(fs_rngs, polynomials, degree, nv, device, group, shard)

    @staticmethod
    def verify(polynomial_infos, claimed_sums, proofs):
        """Verify each instance on the host (`batch.py:556-562`)."""
        return [MLSumcheck.verify(info, s, pf)
                for info, s, pf in zip(polynomial_infos, claimed_sums, proofs)]


def _enqueue_gkr(inputs: list, state, dim: int, round_fns=None, transcript_fn=None):
    """Both phases of B GKR instances enqueued with no host sync: each
    instance's phase-1 init into its slice of one (B, 2, 8, 2^dim/2) pair,
    phase 1's rounds on the batched generic chain, each instance's phase-2
    init from its lane-0 final pair and its own column of the challenges,
    and phase 2's rounds. `inputs` are the instances' `_upload`s. Returns
    both phases' (msgs (2 dim, B, 16, 3), rs (2 dim, B, 16)) and the
    transcripts. `round_fns` and `transcript_fn` are test hooks."""
    from .ops import gkr_init as GI

    products = ((0, 1),)
    shape = (len(inputs), 2, NUM_LIMBS, 1 << (dim - 1))
    device = state.device
    lo = torch.empty(shape, dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    ws = []
    for b, ((gbits, _x, y_rev, vals, last_x, _py, _ly), (narrow_x, _ny), f2_d, f3_d, g_r,
            g_omr) in enumerate(inputs):
        _lo, _hi, w = GI.phase1_pair(gbits, last_x, y_rev, vals, g_r, g_omr, f3_d, f2_d, dim,
                                     not narrow_x, out=(lo[b], hi[b]))
        ws.append(w)
    msgs1, rs1, state = generic_prover.chain_rounds_generic_batched(
        lo, hi, state, products, 2, dim, round_fns, transcript_fn)
    lo2 = torch.empty(shape, dtype=torch.int32, device=device)
    hi2 = torch.empty_like(lo2)
    for b, ((_g, x, _y, _v, _lx, perm_y, last_y), (_nx, narrow_y), _f2, f3_d, _gr,
            _go) in enumerate(inputs):
        GI.phase2_pair(lo[b, :, :, :1], hi[b, :, :, :1], rs1[dim - 1, b], x, perm_y, last_y,
                       ws[b], rs1[:, b], f3_d, dim, not narrow_y, out=(lo2[b], hi2[b]))
    msgs2, rs2, state = generic_prover.chain_rounds_generic_batched(
        lo2, hi2, state, products, 2, dim, round_fns, transcript_fn)
    return torch.cat([msgs1, msgs2]), torch.cat([rs1, rs2]), state


class BatchedGKRRoundSumcheck:
    """Prove B independent GKR round-sumcheck instances at once (the same
    pattern as `BatchedMLSumcheck`): the phase inits per instance into one
    batched pair, all 2 dim rounds of all B instances on the batched
    generic chain, one host sync. Instances share (dim, nnz); proofs are
    byte-identical to per-instance `GKRRoundSumcheck.prove`."""

    @staticmethod
    def prove(fs_rngs, f1s, f2s, f3s, gs, *, device="cuda"):
        from .gkr_round_sumcheck import GKRProof, GKRRoundSumcheck, _upload

        device = device_prover.resolve_device(device)
        batch = len(f1s)
        if not (batch and len(fs_rngs) == batch == len(f2s) == len(f3s) == len(gs)):
            raise SumcheckError("batched GKR needs equal-length non-empty lists")
        dim = f2s[0].num_vars
        for f1, f2, f3 in zip(f1s, f2s, f3s):
            if not (f1.num_vars == 3 * dim and f2.num_vars == dim and f3.num_vars == dim):
                raise SumcheckError("batched GKR instances must share dim")

        def alone():
            return [GKRRoundSumcheck.prove(r, f1, f2, f3, g, device=device)
                    for r, f1, f2, f3, g in zip(fs_rngs, f1s, f2s, f3s, gs)]

        if (len({f1.num_nonzero for f1 in f1s}) != 1 or get_config().chain_impl != "generic"
                or not all(isinstance(r, Blake2b512Rng) for r in fs_rngs) or dim < 1):
            return alone()  # the reference's graceful fallback (`batch.py:611-617`)
        state = device_prover.lift_transcripts(fs_rngs, device)
        if state is None:
            return alone()
        inputs = [_upload(f1, f2, f3, list(g), dim, device)
                  for f1, f2, f3, g in zip(f1s, f2s, f3s, gs)]
        msgs, rs, state = _enqueue_gkr(inputs, state, dim)
        msgs_h, _rs_h, state_h = device_prover.fetch_chain_outputs(msgs, rs, state)
        proofs = []
        for b, rng in enumerate(fs_rngs):
            proofs.append(GKRProof(device_prover.msgs_from_host(msgs_h[:dim, b], 2),
                                   device_prover.msgs_from_host(msgs_h[dim:, b], 2)))
            device_prover.restore_transcript(rng, state_h[b])
        return proofs
