"""The port's plain device transcript (`sumcheck_tpu_torch.transcript.device`)
and its transcript step (`ops/transcript_cuda.transcript_step_ref`, what the
wrapper runs on CPU tensors) against the JAX package's
`sumcheck_tpu.transcript.device` and `device_prover._transcript_step`, and
against the host `Blake2b512Rng` of both packages.

Compared: digests, sampled challenges (Montgomery digits), canonical
message digits, and the lowered transcript state `(h, t, buf)`. Tolerance
0. Inputs from `random.Random` / `numpy.random.default_rng` seeds.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sumcheck_tpu import Blake2b512Rng as JRng
from sumcheck_tpu import Fr as JFr
from sumcheck_tpu.protocol import device_prover as JD
from sumcheck_tpu.transcript import device as JDev
from sumcheck_tpu.transcript.serialize import serialize_fr_vec as j_serialize_fr_vec
from sumcheck_tpu_torch import Blake2b512Rng, Fr
from sumcheck_tpu_torch.fields.fr import NUM_DIGITS, P, R_INV
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.protocol.prover import ProverMsg
from sumcheck_tpu_torch.transcript import blake2b_core as core
from sumcheck_tpu_torch.transcript import device as D
from sumcheck_tpu_torch.transcript.blake2b_rng import _DRAW_MASK
from sumcheck_tpu_torch.transcript.blake2b_rng import fr_rand as host_fr_rand
from sumcheck_tpu_torch.transcript.serialize import serialize_fr_vec


def _digits(v: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(NUM_DIGITS)], np.int64)


def _int(d) -> int:
    return sum(int(d[i]) << (16 * i) for i in range(NUM_DIGITS))


def _first_draw_rejected(rng) -> bool:
    """Whether the next `fr_rand` on `rng` rejects its first attempt (the
    rng is not advanced)."""
    h, t, buf = rng.state_tuple()
    probe = Blake2b512Rng.setup()
    probe.set_state(h, t, buf)
    return (int.from_bytes(probe.next_u64s_bytes(4), "little") & _DRAW_MASK) >= P


def _rejecting_prefix() -> bytes:
    """A fed prefix after which the first draw is rejected, found by a
    search over the host rng (about one prefix in ten qualifies)."""
    for i in range(1000):
        rng = Blake2b512Rng.setup()
        rng.feed_bytes(i.to_bytes(8, "little") * 3)
        if _first_draw_rejected(rng):
            return i.to_bytes(8, "little") * 3
    raise AssertionError("no rejecting prefix found")


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("t", [0, 128, 384, (1 << 32) + 256])
def test_compress_matches_host_core(t, last):
    rnd = random.Random(t * 2 + last)
    h = [rnd.getrandbits(64) for _ in range(8)]
    block = bytes(rnd.getrandbits(8) for _ in range(128))
    m = [int.from_bytes(block[8 * i : 8 * i + 8], "little") for i in range(16)]
    got = D.compress(D._halves(h, None), D._halves(m, None), torch.tensor(t), last)
    want = core.compress(h, block, t, last)
    assert [lo | (hi << 32) for lo, hi in got.tolist()] == want


def test_plain_transcript_matches_jax_and_host():
    """Interleaved feed(Vec<Fr>) / fr_rand on the plain transcript == the
    JAX device transcript == the host rng, including the lowered state."""
    rnd = random.Random(0xD1CE)
    host = Blake2b512Rng.setup()
    host.feed_bytes(b"\x07" * 16)
    jhost = JRng.setup()
    jhost.feed_bytes(b"\x07" * 16)
    ts = D.DevTranscript.lift(host.state_tuple())
    jts = JDev.DevTranscript.lift(jhost.state_tuple())
    blen = jts.blen
    vals = [[rnd.randrange(P) for _ in range(4)] for _ in range(3)]
    mats = [np.stack([_digits(v) for v in vs], axis=1) for vs in vals]

    @jax.jit
    def run(carry, mats):
        t = JDev.DevTranscript.from_carry(carry, blen)
        outs = []
        for m in mats:
            t = JDev.feed_fr_vec(t, m)
            dig, t = JDev.fr_rand(t)
            outs.append(dig)
        return t.carry(), jnp.stack(outs)

    jcarry, jdigs = run(jts.carry(), [jnp.asarray(m.astype(np.uint32)) for m in mats])
    jdigs = np.asarray(jdigs)
    for step, (vs, m) in enumerate(zip(vals, mats)):
        ts = D.feed_fr_vec(ts, torch.from_numpy(m))
        dig, ts = D.fr_rand(ts)
        host.feed_bytes(serialize_fr_vec([Fr(v) for v in vs]))
        want = host_fr_rand(host)
        np.testing.assert_array_equal(dig.numpy(), jdigs[step].astype(np.int64))
        assert _int(dig) * R_INV % P == want
        jhost.feed_bytes(j_serialize_fr_vec([JFr(v) for v in vs]))
        JFr.rand(jhost)

    final_blen = len(host.state_tuple()[2])
    assert ts.blen == final_blen == D.blen_after_feed(16, 3 * (8 + 32 * 4))
    jlowered = JDev.DevTranscript.from_carry(jax.device_get(jcarry), final_blen).lower()
    assert ts.lower() == host.state_tuple() == jlowered == jhost.state_tuple()


def test_rejected_draw_matches_host():
    """A schedule whose first draw is rejected: the plain `fr_rand` takes a
    second attempt exactly as the host rng does."""
    prefix = _rejecting_prefix()
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    assert _first_draw_rejected(host)
    ts = D.DevTranscript.lift(host.state_tuple())
    dig, ts = D.fr_rand(ts)
    want = host_fr_rand(host)
    assert _int(dig) * R_INV % P == want
    assert ts.lower() == host.state_tuple()


@pytest.mark.parametrize("nbytes", [0, 8, 120, 128, 136, 1000])
def test_packed_state_round_trip(nbytes):
    """Host state -> plain transcript -> packed (26, 2) int32 state -> back,
    for pending lengths 0..128 (a full pending block included)."""
    host = Blake2b512Rng.setup()
    host.feed_bytes(bytes(range(256)) * 4)
    host.feed_bytes(bytes((7 * i) & 0xFF for i in range(nbytes)))
    st = host.state_tuple()
    packed = D.DevTranscript.lift(st).to_state()
    assert packed.shape == (D.STATE_WORDS, 2) and packed.dtype == torch.int32
    assert D.DevTranscript.from_state(packed).lower() == st
    # the packed words are the little-endian u64 state words
    words = packed.numpy().view(np.uint64).reshape(-1)
    assert [int(w) for w in words[:8]] == st[0]
    assert int(words[8]) == st[1] and int(words[25]) == len(st[2])


def test_unaligned_host_state_is_refused():
    host = Blake2b512Rng.setup()
    host.feed_bytes(b"abc")
    with pytest.raises(ValueError):
        D.DevTranscript.lift(host.state_tuple())


def _sums(seed: int, degree: int) -> torch.Tensor:
    """(d+1, 16) int64 per-digit sums as a round kernel leaves them: up to
    2^40 per digit, so the wide sums carry into digits 16..19."""
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.integers(0, 1 << 40, size=(degree + 1, 16), dtype=np.int64))


def _buffers(rounds: int, degree: int):
    return (torch.zeros((rounds, 16, degree + 1), dtype=torch.int32),
            torch.zeros((rounds, 16), dtype=torch.int32))


@pytest.mark.parametrize("degree", [1, 3])
def test_transcript_step_matches_host(degree):
    """Rounds of the transcript step == the host schedule: reduce each exact
    sum mod p, feed the `ProverMsg`, sample `Fr.rand`. The wrapper on CPU
    tensors takes the plain version and counts no launch."""
    rounds = 4
    host = Blake2b512Rng.setup()
    host.feed_bytes(b"\x01" * 40)
    state = D.DevTranscript.lift(host.state_tuple()).to_state()
    msgs, rs = _buffers(rounds, degree)
    launches = TC.transcript_step.launches
    for j in range(rounds):
        sums = _sums(10 * degree + j, degree)
        TC.transcript_step(state, sums, msgs, rs, j)
        wide = RC.finish_sums(sums)
        vals = [Fr(sum(int(wide[i, t]) << (16 * i) for i in range(wide.shape[0])) % P * R_INV % P)
                for t in range(degree + 1)]
        host.feed(ProverMsg(vals))
        r = Fr.rand(host)
        assert [_int(msgs[j, :, t]) for t in range(degree + 1)] == [v.v for v in vals]
        assert _int(rs[j]) * R_INV % P == r.v
    assert D.DevTranscript.from_state(state).lower() == host.state_tuple()
    assert TC.transcript_step.launches == launches


def test_transcript_step_past_the_old_ceiling_matches_host():
    """Fault F6: the step takes any degree. At degree 7,300, past the 7,241
    that a block's shared memory on the H100 once set, one round of the
    plain step (what the wrapper runs on CPU tensors) from a pending fill of
    56 bytes equals the host schedule: the canonical message, the challenge
    and the state after."""
    degree = 7300
    host = Blake2b512Rng.setup()
    host.feed_bytes(b"\x02" * 56)
    state = D.DevTranscript.lift(host.state_tuple()).to_state()
    msgs, rs = _buffers(1, degree)
    sums = _sums(degree, degree)
    TC.transcript_step(state, sums, msgs, rs, 0)
    wide = RC.finish_sums(sums)
    vals = [sum(int(wide[i, t]) << (16 * i) for i in range(wide.shape[0])) % P * R_INV % P
            for t in range(degree + 1)]
    host.feed(ProverMsg([Fr(v) for v in vals]))
    r = Fr.rand(host)
    m = msgs[0].numpy().astype(np.int64)
    assert [sum(int(m[i, t]) << (16 * i) for i in range(NUM_DIGITS))
            for t in range(degree + 1)] == vals
    assert _int(rs[0]) * R_INV % P == r.v
    assert D.DevTranscript.from_state(state).lower() == host.state_tuple()


def test_transcript_step_matches_jax_transcript_step():
    """One step against `device_prover._transcript_step` (jit) from the same
    lifted state, with a schedule that rejects the step's first draw."""
    degree = 3
    prefix = b"\x05" * 24
    # find sums whose step rejects: the draw follows the fed message
    for seed in range(200):
        sums = _sums(seed, degree)
        host = Blake2b512Rng.setup()
        host.feed_bytes(prefix)
        wide = RC.finish_sums(sums)
        host.feed(ProverMsg([
            Fr(sum(int(wide[i, t]) << (16 * i) for i in range(wide.shape[0])) % P * R_INV % P)
            for t in range(degree + 1)]))
        if _first_draw_rejected(host):
            break
    else:
        raise AssertionError("no rejecting step found")
    jhost = JRng.setup()
    jhost.feed_bytes(prefix)
    jts = JDev.DevTranscript.lift(jhost.state_tuple())
    tfn, blen_out = JD._transcript_step(jts.blen, degree)
    jcarry, jcanon, jr = tfn(jts.carry(), jnp.asarray(RC.finish_sums(sums)))

    state = D.DevTranscript.lift(jhost.state_tuple()).to_state()
    msgs, rs = _buffers(1, degree)
    TC.transcript_step_ref(state, sums, msgs, rs, 0)
    np.testing.assert_array_equal(msgs[0].numpy(), np.asarray(jcanon).astype(np.int32))
    np.testing.assert_array_equal(rs[0].numpy(), np.asarray(jr).astype(np.int32))
    jlowered = JDev.DevTranscript.from_carry(jax.device_get(jcarry), blen_out).lower()
    assert D.DevTranscript.from_state(state).lower() == jlowered


@pytest.mark.parametrize("blocks", [1, 5, 2048])
def test_transcript_step_reads_the_rounds_sums_row(blocks):
    """The chains' schedule: the round kernel adds each block's (d+1, 16)
    per-digit sums into row j of one zeroed (nv, d+1, 16) buffer, and the
    step reads that row. Equal to the step on the reduced sums
    `part.sum(0)` and to JAX `_transcript_step` on their exact wide sums."""
    degree, j, nv = 3, 2, 4
    prefix = b"\x05" * 24
    gen = np.random.default_rng(blocks)
    part = torch.from_numpy(
        gen.integers(0, 1 << 28, size=(blocks, degree + 1, 16), dtype=np.int64))
    rows = torch.zeros((nv, degree + 1, 16), dtype=torch.int64)
    for b in range(blocks):  # the kernels' atomic adds, in any order
        rows[j].add_(part[(7 * b) % blocks])
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    state = D.DevTranscript.lift(host.state_tuple()).to_state()
    state_ref = state.clone()
    msgs, rs = _buffers(nv, degree)
    msgs_ref, rs_ref = _buffers(nv, degree)
    TC.transcript_step(state, rows[j], msgs, rs, j)
    TC.transcript_step_ref(state_ref, part.sum(0), msgs_ref, rs_ref, j)
    assert torch.equal(state, state_ref)
    assert torch.equal(msgs, msgs_ref) and torch.equal(rs, rs_ref)
    assert not msgs[[0, 1, 3]].any() and not rs[[0, 1, 3]].any()

    jhost = JRng.setup()
    jhost.feed_bytes(prefix)
    jts = JDev.DevTranscript.lift(jhost.state_tuple())
    tfn, blen_out = JD._transcript_step(jts.blen, degree)
    jcarry, jcanon, jr = tfn(jts.carry(), jnp.asarray(RC.finish_sums(part.sum(0))))
    np.testing.assert_array_equal(msgs[j].numpy(), np.asarray(jcanon).astype(np.int32))
    np.testing.assert_array_equal(rs[j].numpy(), np.asarray(jr).astype(np.int32))
    jlowered = JDev.DevTranscript.from_carry(jax.device_get(jcarry), blen_out).lower()
    assert D.DevTranscript.from_state(state).lower() == jlowered


@pytest.mark.parametrize("bad", ["state", "sums", "msgs", "round"])
def test_transcript_step_rejects_bad_input(bad):
    state = D.DevTranscript.lift(Blake2b512Rng.setup().state_tuple()).to_state()
    sums = _sums(0, 2)
    msgs, rs = _buffers(2, 2)
    j = 0
    if bad == "state":
        state = state.long()
    elif bad == "sums":
        sums = sums[:, :8]
    elif bad == "msgs":
        msgs = torch.zeros((2, 16, 4), dtype=torch.int32)
    else:
        j = 2
    with pytest.raises(ValueError):
        TC.transcript_step(state, sums, msgs, rs, j)
