"""The port's `GKRRoundSumcheck` (`sumcheck_tpu_torch/gkr_round_sumcheck.py`,
`ops/gkr_init.py`, `mle.SparseMLE`) on the CPU (`device="cpu"`: the round
and transcript kernels' plain versions) against the JAX package.

The same instances go through both packages (`SparseMLE.rand_with_config`
from one `random.Random`, tables carried across by
`convert.gkr_instance_from_numpy`), and the golden fixture
`tests/fixtures/gkr_dim5.json` through the port: on the generic chain, the
per-size chain, in the MXU fold mode, and in the host loop that any other
transcript takes. JAX's jitted pair bodies compile for tens of seconds on
the CPU, so they are compared in a `slow` test; the non-slow tests hold the
port's inits against the JAX package's host inits. Tolerance 0.
"""

from __future__ import annotations

import hashlib
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.gkr_round_sumcheck import initialize_phase_one as j_phase_one
from sumcheck_tpu.gkr_round_sumcheck import initialize_phase_two as j_phase_two
from sumcheck_tpu.ops import gkr_init as JGI
from sumcheck_tpu.utils.config import get_config as j_get_config
from sumcheck_tpu_torch.convert import gkr_instance_from_numpy
from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.fields.fr import P
from sumcheck_tpu_torch.mle import _segment_sum_mod_p
from sumcheck_tpu_torch.ops import gkr_init as GI
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.protocol import device_prover as TD
from sumcheck_tpu_torch.protocol.prover import bitrev_perm
from sumcheck_tpu_torch.utils.config import get_config
from sumcheck_tpu_torch.utils.errors import Reject, SerializationError

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CPU = torch.device("cpu")
MODES = ["generic", "persize", "mxu"]


@pytest.fixture
def mode(request, monkeypatch):
    """Chain and fold mode; "mxu" is the generic chain in the MXU fold
    mode with the banded-product threshold at 1 lane, so the eq tables of
    the init kernels' plain versions take the banded product even at test
    sizes."""
    cfg = get_config()
    monkeypatch.setattr(cfg, "chain_impl", "persize" if request.param == "persize" else "generic")
    if request.param == "mxu":
        monkeypatch.setattr(cfg, "mxu_fold", "kernel")
        monkeypatch.setattr(cfg, "ab", True)
        monkeypatch.setattr(GI, "MXU_MIN_LANES", 1)
    return request.param


def instances(dim: int, seed: int, nnz: int | None = None):
    """One GKR instance for both packages: the JAX objects, then the port's
    (carried across as NumPy arrays)."""
    rnd = random.Random(seed)
    f1 = J.SparseMLE.rand_with_config(3 * dim, nnz or (1 << dim), rnd)
    f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
    g = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
    port = gkr_instance_from_numpy(dim, f1.indices, f1.values, f2.evals, f3.evals,
                                   [x.v for x in g])
    return (f1, f2, f3, g), port


def jax_prove(f1, f2, f3, g):
    """The JAX package's host-engine GKR prove (the test_golden pattern)."""
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        rng = J.Blake2b512Rng.setup()
        return J.GKRRoundSumcheck.prove(rng, f1, f2, f3, g), rng
    finally:
        cfg.engine = saved


class _OtherRng:
    """A transcript other than `Blake2b512Rng`, with the same bytes."""

    def __init__(self):
        self._rng = T.Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def next_u64(self):
        return self._rng.next_u64()


def _golden():
    with open(os.path.join(FIXDIR, "gkr_dim5.json")) as f:
        fx = json.load(f)
    dim = fx["dim"]

    def table(tag):
        return [int.from_bytes(hashlib.blake2b(f"sumcheck-golden/gkr{dim}/{tag}/{i}".encode(),
                                               digest_size=32).digest(), "little") % P
                for i in range(1 << dim)]

    f1 = T.SparseMLE.from_pairs(3 * dim, [(int(k), T.Fr(int(v, 16)))
                                          for k, v in fx["f1_nonzeros"].items()])
    f2 = T.DenseMLE.from_evaluations(dim, table("f2"))
    f3 = T.DenseMLE.from_evaluations(dim, table("f3"))
    return fx, f1, f2, f3, [T.Fr(int(x, 16)) for x in fx["g"]]


@pytest.mark.parametrize("mode", MODES + ["host"], indirect=True)
def test_gkr_golden(mode):
    """`gkr_dim5.json` byte for byte: messages, claimed sum, the verifier's
    challenges and expected evaluation, and the subclaim."""
    fx, f1, f2, f3, g = _golden()
    dim = fx["dim"]
    rng = _OtherRng() if mode == "host" else T.Blake2b512Rng.setup()
    proof = T.GKRRoundSumcheck.prove(rng, f1, f2, f3, g, device="cpu")
    hexes = lambda msgs: [[format(e.v, "064x") for e in m.evaluations] for m in msgs]  # noqa: E731
    assert hexes(proof.phase1_sumcheck_msgs) == fx["phase1_msgs"]
    assert hexes(proof.phase2_sumcheck_msgs) == fx["phase2_msgs"]
    assert proof.extract_sum().v == int(fx["claimed_sum"], 16)
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof,
                                    T.Fr(int(fx["claimed_sum"], 16)))
    assert [format(x.v, "064x") for x in sub.u] == fx["u"]
    assert [format(x.v, "064x") for x in sub.v] == fx["v"]
    assert sub.expected_evaluation.v == int(fx["expected_evaluation"], 16)
    assert sub.verify_subclaim(f1, f2, f3, g)


@pytest.mark.parametrize("dim,nnz", [(3, None), (6, 3 << 6)])
@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_prove_matches_jax(mode, dim, nnz):
    """Proof bytes and the caller's transcript after the prove equal the JAX
    package's host-engine prove; `nnz` > 2^dim makes entries collide."""
    ref, port = instances(dim, seed=dim, nnz=nnz)
    jproof, jrng = jax_prove(*ref)
    rng = T.Blake2b512Rng.setup()
    proof = T.GKRRoundSumcheck.prove(rng, *port, device="cpu")
    assert proof.serialize_uncompressed() == jproof.serialize_uncompressed()
    assert rng.state_tuple() == jrng.state_tuple()


def test_prove_fetches_once(monkeypatch):
    """A chained GKR prove brings its results to the host once: both
    phases' messages, challenges and the transcript in one fetch."""
    fetches = []
    real = TD.fetch_chain_outputs
    monkeypatch.setattr(TD, "fetch_chain_outputs", lambda *a: fetches.append(a) or real(*a))
    _, port = instances(4, seed=1)
    T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *port, device="cpu")
    assert len(fetches) == 1
    msgs, rs, _state = fetches[0]
    assert msgs.shape == (8, 16, 3) and rs.shape == (8, 16)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_unaligned_pending_bytes_prove_on_the_host_loop(mode):
    """A `Blake2b512Rng` pre-fed 3 bytes holds a pending byte count that is
    not a multiple of 8, which the device transcript cannot hold: the prove
    takes the host loop (it raised `ValueError` in the lift before), on
    every path, byte-equal to the JAX package's prove of the same pre-fed
    transcript, and the transcript ends in the same state."""
    ref, port = instances(4, seed=9)
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        jrng = J.Blake2b512Rng.setup()
        jrng.feed_bytes(b"abc")
        jproof = J.GKRRoundSumcheck.prove(jrng, *ref)
    finally:
        cfg.engine = saved
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(b"abc")
    proof = T.GKRRoundSumcheck.prove(rng, *port, device="cpu")
    assert proof.serialize_uncompressed() == jproof.serialize_uncompressed()
    assert rng.state_tuple() == jrng.state_tuple()


def test_host_loop_for_other_rng():
    """Any other transcript takes the host loop, with the chained bytes."""
    _, port = instances(4, seed=2)
    chained = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *port, device="cpu")
    host = T.GKRRoundSumcheck.prove(_OtherRng(), *port, device="cpu")
    assert host.serialize_uncompressed() == chained.serialize_uncompressed()


class _JaxOtherRng:
    """The JAX package's counterpart of `_OtherRng`."""

    def __init__(self):
        self._rng = J.Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def next_u64(self):
        return self._rng.next_u64()


@pytest.mark.parametrize("transcript", ["unaligned", "foreign"])
def test_host_transcript_branch_runs_on_the_device(transcript, monkeypatch):
    """A transcript the device chain cannot lift (pre-fed 3 bytes, or not
    a `Blake2b512Rng`) proves through the chained prove's phase inits and
    round kernels on the device asked for, one `finish_sums` a round,
    byte-equal to the JAX package's prove over the same transcript."""
    ref, port = instances(5, seed=21, nnz=3 << 5)
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        jrng = _JaxOtherRng() if transcript == "foreign" else J.Blake2b512Rng.setup()
        if transcript == "unaligned":
            jrng.feed_bytes(b"abc")
        jproof = J.GKRRoundSumcheck.prove(jrng, *ref)
    finally:
        cfg.engine = saved
    calls = []
    for mod, name in ((RC, "round_nofold"), (RC, "round_fold"), (RC, "finish_sums"),
                      (GI, "phase1_pair"), (GI, "phase2_pair")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real: calls.append(
            (_n, next(t for t in a if isinstance(t, torch.Tensor)).device.type)) or _f(*a))
    rng = _OtherRng() if transcript == "foreign" else T.Blake2b512Rng.setup()
    if transcript == "unaligned":
        rng.feed_bytes(b"abc")
    proof = T.GKRRoundSumcheck.prove(rng, *port, device="cpu")
    assert proof.serialize_uncompressed() == jproof.serialize_uncompressed()
    inner = rng._rng if transcript == "foreign" else rng
    assert inner.state_tuple() == (jrng._rng if transcript == "foreign" else jrng).state_tuple()
    assert {d for _n, d in calls} == {"cpu"}
    names = [n for n, _d in calls]
    assert names.count("phase1_pair") == names.count("phase2_pair") == 1
    assert names.count("round_nofold") == 2 and names.count("round_fold") == 2 * (5 - 1)
    assert names.count("finish_sums") == 2 * 5


@pytest.mark.parametrize("dim,nnz,seed", [(4, 16, 3), (9, 40, 4)])
def test_rand_with_config_matches_jax(dim, nnz, seed):
    a = T.SparseMLE.rand_with_config(3 * dim, nnz, random.Random(seed))
    b = J.SparseMLE.rand_with_config(3 * dim, nnz, random.Random(seed))
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert [(i, v.v) for i, v in a.iter_pairs()] == [(i, v.v) for i, v in b.iter_pairs()]


def test_sparse_mle_matches_jax():
    """fix_variables (with merged collisions), to_dense and evaluate."""
    (f1, *_), (t1, *_) = instances(3, seed=5, nnz=40)
    rnd = random.Random(6)
    pts = [rnd.randrange(P) for _ in range(9)]
    for k in (2, 5):
        a = t1.fix_variables([T.Fr(v) for v in pts[:k]])
        b = f1.fix_variables([J.Fr(v) for v in pts[:k]])
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(t1.to_dense().evals, f1.to_dense().evals)
    assert t1.evaluate([T.Fr(v) for v in pts]).v == f1.evaluate([J.Fr(v) for v in pts]).v
    assert t1.num_nonzero == f1.num_nonzero == 40


def test_split_f1_device_matches_jax():
    """The split in the kernels' layout: int32 index components and the
    values as an (nnz, 8) int32 entry-major limb table, unpacked equal to
    the JAX package's (16, nnz) digits; phase 2's view in y order (`x_y`
    is the JAX x through perm_y, `to_y` perm_y's inverse); each tile plan
    covers its segments once, in order."""
    dim = 5
    nnz = 3 << dim
    (f1, *_), (t1, *_) = instances(dim, seed=7, nnz=nnz)
    got = GI._split_f1_device(t1, dim, CPU)
    gbits, x, y_rev, vals, _perm_x, last_x, perm_y, last_y = \
        (np.asarray(a).astype(np.int64) for a in JGI._split_f1_device(f1, dim))
    tensors = [t for t in got if isinstance(t, torch.Tensor)]
    assert len(tensors) == 7 and all(t.dtype == torch.int32 and t.is_contiguous()
                                      for t in tensors)
    assert got.vals.shape == (nnz, 8)
    np.testing.assert_array_equal(L.unpack_limbs(got.vals.numpy(), axis=1).T, vals)
    for a, b in ((got.gbits, gbits), (got.y_rev, y_rev), (got.last_x, last_x),
                 (got.x_y, x[perm_y]), (got.last_y, last_y)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got.to_y.numpy()[perm_y], np.arange(nnz))
    for plan, last in ((got.plan_x, last_x), (got.plan_y, last_y)):
        items = plan.items.numpy()
        assert plan.long == 0 and (items[:, 1] > 0).all()
        assert items[0, 0] == 0 and (items[1:, 0] == items[:-1, 0] + items[:-1, 1]).all()
        assert items[-1, 0] + items[-1, 1] == 1 << dim and items[-1, 3] == nnz
        assert (items[1:, 2] == items[:-1, 3]).all()
        assert (items[:, 3] == last[items[:, 0] + items[:, 1] - 1] + 1).all()
    assert GI._split_f1_device(t1, dim, CPU) is got  # cached per (dim, device)


def _to_port(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("dim", [6, 8])
def test_phase_inits_match_jax_host(dim):
    """h_g (bit-reversed lane order) and f1(g, u, .) from the port's device
    inits equal the JAX package's host inits, with colliding entries; the
    pairs stack them as the round kernels take them."""
    (f1, f2, f3, g), (t1, t2, t3, tg) = instances(dim, seed=dim, nnz=3 << dim)
    split = GI._split_f1_device(t1, dim, CPU)
    g_r = GI.upload(GI._point_rows(tg), CPU)
    f2_d, f3_d = t2.to_device(CPU), t3.to_device(CPU)
    lo, hi, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
    h_host, f1g_host = j_phase_one(f1, f3, g)
    rev = bitrev_perm(dim)
    assert lo.shape == (2, 8, 1 << (dim - 1)) and lo.dtype == torch.int32
    hg = L.unpack_limbs(torch.cat([lo[0], hi[0]], dim=1).numpy())
    np.testing.assert_array_equal(hg[:, rev], h_host.evals)
    np.testing.assert_array_equal(torch.cat([lo[1], hi[1]], dim=1).numpy(), f2_d.numpy())

    rnd = random.Random(dim)
    u = [rnd.randrange(P) for _ in range(dim)]
    u_dig = torch.from_numpy(np.stack([L.mont_scalar(v)[:, 0] for v in u]).astype(np.int32))
    f1gu = GI.phase2_digits(split, w, u_dig, dim)
    want = j_phase_two(f1g_host, [J.Fr(v) for v in u]).evals
    np.testing.assert_array_equal(L.unpack_limbs(f1gu.numpy())[:, rev], want)

    f2u = torch.from_numpy(L.mont_scalar(rnd.randrange(P))[:, 0].astype(np.int32))
    lo2, hi2 = GI.prep2(f1gu, f3_d, f2u)
    scaled = L.mont_mul(L.unpack_limbs(f3_d.numpy()), f2u.numpy().astype(np.uint32)[:, None])
    np.testing.assert_array_equal(L.unpack_limbs(torch.cat([lo2[1], hi2[1]], dim=1).numpy()),
                                  scaled)


def test_final_fold_is_the_table_at_the_point():
    """The 1-lane pair folded by the last challenge is f2 at that point."""
    rnd = random.Random(3)
    lo = torch.from_numpy(L.from_ints([rnd.randrange(P) for _ in range(2)]).astype(np.int32))
    hi = torch.from_numpy(L.from_ints([rnd.randrange(P) for _ in range(2)]).astype(np.int32))
    r = rnd.randrange(P)
    r_dig = torch.from_numpy(L.mont_scalar(r)[:, 0].astype(np.int32))
    got = GI.final_fold(torch.from_numpy(L.pack_limbs(lo.numpy().T[:, :, None], axis=1)),
                        torch.from_numpy(L.pack_limbs(hi.numpy().T[:, :, None], axis=1)), r_dig, 1)
    l, h = L.to_ints(lo.numpy()[:, 1:].astype(np.uint32))[0], L.to_ints(hi.numpy()[:, 1:].astype(np.uint32))[0]
    assert L.to_ints(got.numpy()[:, None].astype(np.uint32))[0] == (l + r * (h - l)) % P


@pytest.mark.parametrize("split8", [True, False], ids=["split8", "split16"])
def test_segment_reduce_sorted_matches_jax(split8):
    """Sorted segment sums with an empty prefix (last position -1), empty
    segments between full ones (the previous segment's last position, as
    `_split_f1_device` makes them) and one segment of many entries: equal
    to JAX's at both of its segment-sum widths and to the host scatter
    sum."""
    gen = np.random.default_rng(4)
    nnz, nseg = 300, 64
    seg = np.sort(np.concatenate([gen.integers(0, nseg, 200), np.full(100, 17)]))
    seg[seg <= 1] = 2  # the empty prefix
    seg[seg == 5] = 6  # an empty segment
    vals = gen.integers(0, 1 << 16, size=(16, nnz), dtype=np.uint32)
    vals[15] >>= 2
    perm = gen.permutation(nnz)
    shuffled = np.empty_like(vals)
    shuffled[:, perm] = vals  # shuffled[:, perm[i]] = vals[:, i]
    last = np.searchsorted(seg, np.arange(nseg), side="right") - 1
    assert last[0] == last[1] == -1 and last[5] == last[4]
    got = GI._segment_reduce_sorted(_to_port(shuffled), _to_port(perm), _to_port(last))
    want = JGI._segment_reduce_sorted(jnp.asarray(shuffled), jnp.asarray(perm.astype(np.int32)),
                                      jnp.asarray(last.astype(np.int32)), split8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    host = np.zeros((16, nseg), np.uint32)
    present = np.unique(seg)
    host[:, present] = _segment_sum_mod_p(vals, np.searchsorted(present, seg), len(present))
    np.testing.assert_array_equal(got.numpy(), host.astype(np.int64))


def test_eq_table_mxu_matches_cios(monkeypatch):
    """The eq doublings as banded products (threshold at 1 lane) equal the
    CIOS doublings and the JAX package's table."""
    rnd = random.Random(8)
    pts = [T.Fr(rnd.randrange(P)) for _ in range(5)]
    r_np, omr_np = GI._points_arrays(pts)
    r_pts, omr_pts = _to_port(r_np), _to_port(omr_np)
    cios = GI._eq_table(r_pts, omr_pts, 5)
    monkeypatch.setattr(GI, "MXU_MIN_LANES", 1)
    monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
    monkeypatch.setattr(get_config(), "ab", True)
    assert torch.equal(GI._eq_table(r_pts, omr_pts, 5), cios)
    want = JGI._eq_table(jnp.asarray(r_np), jnp.asarray(omr_np), 5)
    np.testing.assert_array_equal(cios.numpy(), np.asarray(want).astype(np.int64))


def test_reject_wrong_sum():
    _, port = instances(4, seed=9)
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *port, device="cpu")
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), 4, proof, proof.extract_sum())
    assert sub.verify_subclaim(*port)
    with pytest.raises(Reject):
        T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), 4, proof,
                                  proof.extract_sum() + T.Fr.one())


def test_proof_serde_round_trip():
    """The JAX package's encoding; the decoded proof re-verifies; malformed
    encodings raise."""
    ref, port = instances(3, seed=10)
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *port, device="cpu")
    blob = proof.serialize_uncompressed()
    back = T.GKRProof.deserialize_uncompressed(blob)
    assert back.serialize_uncompressed() == blob
    jback = J.gkr_round_sumcheck.GKRProof.deserialize_uncompressed(blob)
    assert jback.serialize_uncompressed() == blob
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), 3, back, back.extract_sum())
    assert isinstance(sub, T.GKRRoundSumcheckSubClaim) and sub.verify_subclaim(*port)
    for bad in (blob + b"\x00", blob[:-1], bytes(16)):
        with pytest.raises(SerializationError):
            T.GKRProof.deserialize_uncompressed(bad)


def test_subclaim_matches_jax():
    ref, port = instances(4, seed=11)
    jproof, _ = jax_prove(*ref)
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *port, device="cpu")
    sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), 4, proof, proof.extract_sum())
    jsub = J.GKRRoundSumcheck.verify(J.Blake2b512Rng.setup(), 4, jproof, jproof.extract_sum())
    assert [x.v for x in sub.u] == [x.v for x in jsub.u]
    assert [x.v for x in sub.v] == [x.v for x in jsub.v]
    assert sub.expected_evaluation.v == jsub.expected_evaluation.v
    assert sub.verify_subclaim(*port)
    assert not sub.verify_subclaim(port[0], port[2], port[1], port[3])


def test_convert_checks_shapes():
    (f1, f2, f3, g), (t1, t2, t3, tg) = instances(3, seed=12)
    np.testing.assert_array_equal(t1.indices, f1.indices)
    np.testing.assert_array_equal(t2.evals, f2.evals)
    assert [x.v for x in tg] == [x.v for x in g]
    with pytest.raises(ValueError):
        gkr_instance_from_numpy(3, f1.indices[:-1], f1.values, f2.evals, f3.evals, [x.v for x in g])
    with pytest.raises(ValueError):
        gkr_instance_from_numpy(3, f1.indices, f1.values, f2.evals[:, :4], f3.evals, [x.v for x in g])
    with pytest.raises(ValueError):
        gkr_instance_from_numpy(3, f1.indices, f1.values, f2.evals, f3.evals, [1, 2])


@pytest.mark.slow
@pytest.mark.parametrize("split8", [True, False], ids=["split8", "split16"])
def test_pair_bodies_match_jax(split8):
    """The phase-1 pair and `w`, and the phase-2 pair, array-equal to the
    JAX package's fused bodies `_phase1_pair_body` / `_phase2_pair_body`
    (jitted on the CPU, at both of its segment-sum widths) at dim 6, from
    the same challenges."""
    import jax

    dim = 6
    (f1, f2, f3, g), (t1, t2, t3, tg) = instances(dim, seed=13, nnz=3 << dim)
    jsp = JGI._split_f1_device(f1, dim)
    gr, gomr = JGI._points_arrays(g)
    jlo, jhi, jw = jax.jit(JGI._phase1_pair_body(dim, split8))(
        jsp[0], jsp[4], jsp[5], jsp[2], jsp[3], jnp.asarray(gr), jnp.asarray(gomr),
        f3.device_bitrev(), f2.device_bitrev())
    split = GI._split_f1_device(t1, dim, CPU)
    g_r = GI.upload(GI._point_rows(tg), CPU)
    lo, hi, w = GI.phase1_pair(split, g_r, t3.to_device(CPU), t2.to_device(CPU), dim)
    # the carry is entry-major in y order: row to_y[j] holds the JAX w's entry j
    w_x = L.unpack_limbs(w.numpy(), axis=1)[split.to_y.numpy()].T
    for a, b in ((L.unpack_limbs(lo.numpy(), axis=1), jlo), (L.unpack_limbs(hi.numpy(), axis=1),
                                                            jhi), (w_x, jw)):
        np.testing.assert_array_equal(a.astype(np.int64), np.asarray(b).astype(np.int64))

    rnd = random.Random(14)
    u = np.stack([L.mont_scalar(rnd.randrange(P))[:, 0] for _ in range(dim)])
    r_last = jnp.asarray(u[-1])
    jlo2, jhi2 = jax.jit(JGI._phase2_pair_body(dim, split8))(
        jlo[:, :, :1], jhi[:, :, :1], r_last, jsp[1], jsp[6], jsp[7], jw,
        jnp.asarray(u), f3.device_bitrev())
    lo2, hi2 = GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], torch.from_numpy(u[-1].astype(np.int32)),
                              split, w, torch.from_numpy(u.astype(np.int32)), t3.to_device(CPU),
                              dim)
    for a, b in ((lo2, jlo2), (hi2, jhi2)):
        np.testing.assert_array_equal(L.unpack_limbs(a.numpy(), axis=1).astype(np.int64),
                                      np.asarray(b).astype(np.int64))
