"""The port's batched provers (`sumcheck_tpu_torch/batch.py`) on the CPU
(`device="cpu"`: the kernels' plain versions) against the JAX package.

The same instances go through both packages (tables from
`numpy.random.default_rng`, carried across by
`convert.polynomial_from_numpy` / `gkr_instance_from_numpy`). Compared:
proof bytes, challenges and the next draw of every transcript after the
prove, against the JAX package's `BatchedMLSumcheck` on its host engine and
against its per-instance proves; on both chains, the host-transcript loop,
the two faults of the JAX batch path (diverging fold plans, unequal pending
bytes), the rejections, each batched plain version against its single one,
the pair init against the JAX `init_pair`, and the batched GKR prover with
its fallbacks. Tolerance 0.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.batch import BatchedMLSumcheck as JBatch
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.protocol import device_prover as JD
from sumcheck_tpu.utils.config import get_config as j_get_config
from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck, BatchedMLSumcheck
from sumcheck_tpu_torch.convert import gkr_instance_from_numpy, polynomial_from_numpy
from sumcheck_tpu_torch.fields.fr import P
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import init_cuda as IC
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.protocol import device_prover as TD
from sumcheck_tpu_torch.utils.config import get_config
from sumcheck_tpu_torch.utils.errors import SumcheckError

CPU = torch.device("cpu")


def _tables(gen, nv: int, count: int) -> list[np.ndarray]:
    out = []
    for _ in range(count):
        d = gen.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def _both(nv, tables, products):
    mles = [J.DenseMLE(nv, t.copy()) for t in tables]
    jp = J.ListOfProductsOfPolynomials(nv)
    for c, idx in products:
        jp.add_product([mles[i] for i in idx], J.Fr(c))
    return jp, polynomial_from_numpy(nv, tables, products)


def instances(seed: int, batch: int, nv: int, coeffs=None, structure=((0, 1), (2, 0))):
    """B instances of one structure (the `tests/test_batch.py` shape), for
    both packages: (JAX polynomials, port polynomials)."""
    gen = np.random.default_rng(seed)
    js, ts = [], []
    for b in range(batch):
        cs = coeffs[b] if coeffs else [int(gen.integers(1, 1 << 62)) ** 4 % P for _ in structure]
        count = 1 + max(max(ix) for ix in structure)
        jp, tp = _both(nv, _tables(gen, nv, count), list(zip(cs, [list(ix) for ix in structure])))
        js.append(jp)
        ts.append(tp)
    return js, ts


def jax_alone(polys, prefixes=None):
    """Per-instance JAX host-engine proves: (proof bytes, challenges, rng)."""
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    out = []
    try:
        for b, poly in enumerate(polys):
            rng = J.Blake2b512Rng.setup()
            if prefixes:
                rng.feed_bytes(prefixes[b])
            proof, state = J.MLSumcheck.prove_as_subprotocol(rng, poly)
            out.append((j_serialize(proof), [r.v for r in state.randomness], rng))
    finally:
        cfg.engine = saved
    return out


class _OtherRng:
    """A transcript other than `Blake2b512Rng`, with the same bytes."""

    def __init__(self):
        self._rng = T.Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def feed_bytes(self, data):
        self._rng.feed_bytes(data)

    def next_u64(self):
        return self._rng.next_u64()


@pytest.fixture
def path(request, monkeypatch):
    """"generic" / "persize": the chain for `Blake2b512Rng` transcripts;
    "host": a transcript of another type, which takes the host loop."""
    monkeypatch.setattr(get_config(), "chain_impl",
                        "persize" if request.param == "persize" else "generic")
    return request.param


def _rngs(path, count, prefixes=None):
    make = _OtherRng if path == "host" else T.Blake2b512Rng.setup
    rngs = [make() for _ in range(count)]
    for rng, prefix in zip(rngs, prefixes or []):
        rng.feed_bytes(prefix)
    return rngs


def _check_against(alone, proofs, challenges, rngs):
    for (blob, chal, jrng), pf, ch, rng in zip(alone, proofs, challenges, rngs):
        assert serialize_proof(pf) == blob
        assert [r.v for r in ch] == chal
        assert T.Fr.rand(rng).v == J.Fr.rand(jrng).v  # the transcripts end equal


@pytest.mark.parametrize("nv", [1, 5])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("path", ["generic", "persize", "host"], indirect=True)
def test_batched_ml_matches_jax(path, batch, nv):
    """Against the JAX package's batched prover (its host engine, as
    `tests/test_batch.py` runs it) and its per-instance proves."""
    js, ts = instances(10 * batch + nv, batch, nv)
    alone = jax_alone(js)
    jrngs = [J.Blake2b512Rng.setup() for _ in js]
    jproofs, jchallenges = JBatch.prove_as_subprotocol(jrngs, js)
    assert [j_serialize(p) for p in jproofs] == [a[0] for a in alone]
    assert [[r.v for r in c] for c in jchallenges] == [a[1] for a in alone]
    rngs = _rngs(path, batch)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    _check_against(alone, proofs, challenges, rngs)
    assert [serialize_proof(p) for p in BatchedMLSumcheck.prove(ts, device="cpu")] == \
        [a[0] for a in alone]


@pytest.mark.parametrize("path", ["generic", "persize"], indirect=True)
def test_batched_ml_ragged_shared_structure(path):
    """A structure with a shared table, a unit coefficient and ragged
    products (scaled copies and a ones slot in every fold plan)."""
    structure = ((0, 1, 2), (0, 3), (4, 0, 4, 1))
    js, ts = instances(7, 3, 4, structure=structure)
    rngs = _rngs(path, 3)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    _check_against(jax_alone(js), proofs, challenges, rngs)


@pytest.mark.parametrize("path", ["generic", "persize"], indirect=True)
def test_diverging_fold_plans_prove_each_instance_right(path, monkeypatch):
    """Reference fault 1: over [[0, 1], [0, 2]], coefficients (5, 1) and
    (1, 5) give fold plans ((3, 1), (0, 2)) and ((0, 1), (3, 2)) of equal
    slot counts, which the JAX generic batch stacks and proves against the
    first plan. The port sees the plans differ and takes the host loop on
    both chains: every proof equals the instance's own."""
    structure = ((0, 1), (0, 2))
    js, ts = instances(3, 2, 5, coeffs=[(5, 1), (1, 5)], structure=structure)
    plans = [JD._fold_plan(p)[0] for p in js]
    assert plans == [((3, 1), (0, 2)), ((0, 1), (3, 2))]
    assert [TD._fold_plan(p)[0] for p in ts] == plans
    assert TD.init_pairs(ts, CPU) is None
    ran = []
    real = RC.round_step_fold_batched
    monkeypatch.setattr(RC, "round_step_fold_batched",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    rngs = _rngs(path, 2)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    _check_against(jax_alone(js), proofs, challenges, rngs)
    assert len(ran) == 4  # the host loop's folds, nv - 1 of them


@pytest.mark.parametrize("path", ["generic", "persize", "host"], indirect=True)
def test_zero_coefficient_instance_proves_right(path):
    """Fault F3 in the batch: one instance of three has the coefficient 0
    on its product [2, 0], whose table 2 (used once) then takes a scaled
    copy slot where the others scale it in place. That instance's fold plan
    differs from the others' (one slot more), so the batch takes the host
    loop, and every proof, challenge list and final transcript equals the
    instance's own JAX prove."""
    js, ts = instances(13, 3, 5, coeffs=[(5, 7), (9, 0), (11, 13)])
    plans = [TD._fold_plan(p) for p in ts]
    assert [p[2] for p in plans] == [4, 5, 4] and plans[1][1][1] == (4, 2, 0)
    assert TD.init_pairs(ts, CPU) is None
    rngs = _rngs(path, 3)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    _check_against(jax_alone(js), proofs, challenges, rngs)


@pytest.mark.parametrize("prefixes", [[b"", b"\x07" * 8, b"\x01" * 48],
                                      [b"abc", b"", b"\x02" * 8]],
                         ids=["aligned", "three_bytes"])
@pytest.mark.parametrize("path", ["generic", "persize"], indirect=True)
def test_unequal_pending_bytes(path, prefixes):
    """Reference fault 2: transcripts that hold different pending byte
    counts before the prove. Counts that are multiples of 8 stay on the
    device chain, each block reading its own count; a transcript pre-fed 3
    bytes, which no device transcript holds, takes the host loop. Every
    proof and final transcript equals the instance's own prove."""
    js, ts = instances(11, 3, 5)
    alone = jax_alone(js, prefixes)
    rngs = _rngs(path, 3, prefixes)
    before = TD.lift_transcripts(rngs, CPU)
    assert (before is None) == any(len(p) % 8 for p in prefixes)
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    for (_b, _c, jrng), rng in zip(alone, rngs):
        assert rng.state_tuple() == jrng.state_tuple()
    _check_against(alone, proofs, challenges, rngs)


@pytest.mark.parametrize("case", ["nv0", "mixed_nv", "mixed_structure", "count", "empty"])
def test_rejections_leave_transcripts_untouched(case):
    """Mixed shapes, unequal counts and nv = 0 raise `SumcheckError` before
    any transcript is fed."""
    _js, ts = instances(5, 2, 3)
    if case == "nv0":
        ts = [T.ListOfProductsOfPolynomials(0)] * 2
    elif case == "mixed_nv":
        ts = [ts[0], instances(6, 1, 4)[1][0]]
    elif case == "mixed_structure":
        ts = [ts[0], instances(6, 1, 3, structure=((0, 1), (1, 2)))[1][0]]
    elif case == "empty":
        ts = []
    rngs = [T.Blake2b512Rng.setup() for _ in range(3 if case == "count" else len(ts))]
    for i, rng in enumerate(rngs):
        rng.feed_bytes(bytes([i]) * 5)
    before = [r.state_tuple() for r in rngs]
    with pytest.raises(SumcheckError):
        BatchedMLSumcheck.prove_as_subprotocol(rngs, ts, device="cpu")
    assert [r.state_tuple() for r in rngs] == before


def _pair(gen, batch, slots, width):
    d = gen.integers(0, 1 << 16, size=(2, batch, slots, 16, width), dtype=np.uint32)
    d[:, :, :, 15] >>= 2
    return torch.from_numpy(d[0].astype(np.int32)), torch.from_numpy(d[1].astype(np.int32))


def _r(gen, batch):
    from sumcheck_tpu_torch.fields import limbs_np as L

    return torch.from_numpy(np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)) ** 4 % P)[:, 0]
                                      for _ in range(batch)]).astype(np.int32))


PRODUCTS = ((0, 1, 2), (3, 1, 4))


@pytest.mark.parametrize("extent", [1, 5, 16, 29])
@pytest.mark.parametrize("batch", [1, 3])
def test_batched_plain_round_versions_match_single(batch, extent):
    """Each batched plain round version against B calls of its single plain
    version, instance b by its own challenge and coefficients, at full and
    ragged extents, through the wrappers (a CPU pair runs the plain
    version): sums rows and tables array-equal."""
    gen = np.random.default_rng(batch * 100 + extent)
    lo, hi = _pair(gen, batch, 5, 64)
    r = _r(gen, batch)
    coeffs = torch.stack([_r(gen, len(PRODUCTS)) for _ in range(batch)])
    # round 0, without and with coefficients
    got = RC.round_nofold_batched(lo, hi, PRODUCTS, 3, extent)
    got_c = RC.round_nofold_batched(lo, hi, PRODUCTS, 3, extent, coeffs=coeffs)
    for b in range(batch):
        assert torch.equal(got[b], RC.round_nofold_ref(lo[b], hi[b], PRODUCTS, 3, extent))
        trimmed = (lo[b, ..., :extent].contiguous(), hi[b, ..., :extent].contiguous())
        assert torch.equal(got_c[b], RC.round_step_nofold_ref(*trimmed, PRODUCTS, 3, coeffs[b]))
    # the in-place fold, into a given (B, d+1, 16) buffer
    l1, h1 = lo.clone(), hi.clone()
    rows = torch.zeros((batch, 4, 16), dtype=torch.int64)
    assert RC.round_fold_batched(l1, h1, r, PRODUCTS, 3, extent, rows) is rows
    for b in range(batch):
        l2, h2 = lo[b].clone(), hi[b].clone()
        assert torch.equal(rows[b], RC.round_fold_ref(l2, h2, r[b], PRODUCTS, 3, extent))
        assert torch.equal(l1[b], l2) and torch.equal(h1[b], h2)
    # the out-of-place fold of a pair of width 2 extent, with coefficients
    w = 2 * extent
    ls, hs = lo[..., :w].contiguous(), hi[..., :w].contiguous()
    (nl, nh), sums = RC.round_step_fold_batched(ls, hs, r, PRODUCTS, 3, coeffs)
    assert nl.shape == (batch, 5, 16, extent)
    for b in range(batch):
        (wl, wh), want = RC.round_step_fold_ref(ls[b], hs[b], r[b], PRODUCTS, 3, coeffs[b])
        assert torch.equal(sums[b], want) and torch.equal(nl[b], wl) and torch.equal(nh[b], wh)
    with pytest.raises(ValueError):
        RC.round_fold_batched(lo, hi, r[:, :8], PRODUCTS, 3, extent)


@pytest.mark.parametrize("batch", [1, 3])
def test_batched_plain_transcript_matches_single(batch):
    """The batched plain transcript step against the single one per
    transcript, from unequal pending-byte counts, over rounds that reject
    draws: messages, challenges and states array-equal."""
    gen = np.random.default_rng(batch)
    rngs = []
    for b in range(batch):
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(bytes(range(8 * (3 * b + 1))))
        rngs.append(rng)
    state = TD.lift_transcripts(rngs, CPU)
    singles = [TD.lift_transcript(r, CPU) for r in rngs]
    assert all(torch.equal(state[b], s) for b, s in enumerate(singles))
    rounds, d1 = 6, 3
    sums = torch.from_numpy(gen.integers(0, 1 << 40, size=(rounds, batch, d1, 16),
                                         dtype=np.int64))
    msgs = torch.empty((rounds, batch, 16, d1), dtype=torch.int32)
    rs = torch.empty((rounds, batch, 16), dtype=torch.int32)
    for j in range(rounds):
        TC.transcript_step_batched(state, sums[j], msgs, rs, j)
    for b in range(batch):
        m = torch.empty((rounds, 16, d1), dtype=torch.int32)
        r = torch.empty((rounds, 16), dtype=torch.int32)
        for j in range(rounds):
            TC.transcript_step_ref(singles[b], sums[j, b].contiguous(), m, r, j)
        assert torch.equal(singles[b], state[b])
        assert torch.equal(m, msgs[:, b]) and torch.equal(r, rs[:, b])


# tables 0..4; product 0's coefficient on a shared table (an appended scaled
# copy), a unit coefficient, a coefficient on a table used once (scaled in
# place), ragged products (a ones slot)
INIT_PRODUCTS = [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 1])]


@pytest.mark.parametrize("nv", [1, 4, 6])
def test_pair_init_matches_jax_init_pair(nv):
    """The pair init's plain version, through `init_pair` and
    `init_pairs`, against the JAX `init_pair` (its `_stacker`), array-equal:
    an in-place scaling, an appended scaled copy, a unit coefficient and a
    ones slot; the cached `DenseMLE.to_device` tables stay as they were
    after a prove."""
    gen = np.random.default_rng(nv)
    pairs = [_both(nv, _tables(gen, nv, 5), INIT_PRODUCTS) for _ in range(2)]
    _products, scale_plan, num_slots, need_ones = TD._fold_plan(pairs[0][1])
    assert {dst == src for dst, src, _ in scale_plan} == {True, False} and need_ones
    assert IC.slot_specs(5, scale_plan, need_ones) == (
        (0, None), (1, None), (2, None), (3, None), (4, 9), (0, 5), (None, 1))
    cached = [m.to_device(CPU).clone() for m in pairs[0][1].flattened_ml_extensions]
    batched = TD.init_pairs([tp for _jp, tp in pairs], CPU)
    for b, (jp, tp) in enumerate(pairs):
        jlo, jhi, jprod, jdeg, _reuse = JD.init_pair(jp)
        lo, hi, prod, deg = TD.init_pair(tp, CPU)
        assert (prod, deg, lo.shape[0]) == (jprod, jdeg, num_slots)
        np.testing.assert_array_equal(lo.numpy().astype(np.uint32), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy().astype(np.uint32), np.asarray(jhi))
        assert torch.equal(batched[0][b], lo) and torch.equal(batched[1][b], hi)
    assert batched[2:] == (TD._fold_plan(pairs[0][1])[0], 3)
    T.MLSumcheck.prove(pairs[0][1], device="cpu")
    assert all(torch.equal(m.to_device(CPU), c)
               for m, c in zip(pairs[0][1].flattened_ml_extensions, cached))


def test_pair_init_checks():
    """The pair init refuses a slot plan that does not fit the pair."""
    lo = torch.empty((2, 16, 4), dtype=torch.int32)
    tab = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        IC.pair_init(lo, torch.empty_like(lo), [tab], ((0, None),))
    with pytest.raises(ValueError):
        IC.pair_init(lo, torch.empty_like(lo), [tab[:, :4]], ((0, None), (None, 1)))
    with pytest.raises(ValueError):
        IC.pair_init(lo, torch.empty_like(lo), [tab], ((0, None), (None, None)))


def gkr_instances(dim: int, seed: int, batch: int, nnzs=None):
    """B GKR instances for both packages: (JAX tuples, port tuples)."""
    rnd = random.Random(seed)
    js, ts = [], []
    for b in range(batch):
        f1 = J.SparseMLE.rand_with_config(3 * dim, nnzs[b] if nnzs else 1 << dim, rnd)
        f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
        g = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
        js.append((f1, f2, f3, g))
        ts.append(gkr_instance_from_numpy(dim, f1.indices, f1.values, f2.evals, f3.evals,
                                          [x.v for x in g]))
    return js, ts


def jax_gkr_alone(js):
    cfg = j_get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        out = []
        for inst in js:
            rng = J.Blake2b512Rng.setup()
            out.append((J.GKRRoundSumcheck.prove(rng, *inst).serialize_uncompressed(), rng))
        return out
    finally:
        cfg.engine = saved


@pytest.mark.parametrize("case", ["batched", "unequal_nnz", "persize", "other_rng"])
def test_batched_gkr_matches_jax(case, monkeypatch):
    """`BatchedGKRRoundSumcheck` at dim 4, nnz 16, B 3 against per-instance
    JAX host-engine proves: bytes and the next draw of every transcript. The
    batched generic chain, and the reference's three fallbacks to
    per-instance proves: unequal nnz, the per-size chain, another
    transcript."""
    from sumcheck_tpu_torch import gkr_round_sumcheck as G

    dim, batch = 4, 3
    js, ts = gkr_instances(dim, 40, batch, [16, 12, 16] if case == "unequal_nnz" else None)
    alone = jax_gkr_alone(js)
    if case == "persize":
        monkeypatch.setattr(get_config(), "chain_impl", "persize")
    singles = []
    real = G.GKRRoundSumcheck.prove
    monkeypatch.setattr(G.GKRRoundSumcheck, "prove",
                        staticmethod(lambda *a, **k: singles.append(1) or real(*a, **k)))
    rngs = [(_OtherRng if case == "other_rng" else T.Blake2b512Rng.setup)() for _ in ts]
    proofs = BatchedGKRRoundSumcheck.prove(rngs, *(list(t) for t in zip(*ts)), device="cpu")
    assert len(singles) == (0 if case == "batched" else batch)
    assert [p.serialize_uncompressed() for p in proofs] == [a[0] for a in alone]
    assert [T.Fr.rand(r).v for r in rngs] == [J.Fr.rand(a[1]).v for a in alone]
    for p, (f1, f2, f3, g) in zip(proofs, ts):
        sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, p, p.extract_sum())
        assert sub.verify_subclaim(f1, f2, f3, g)


def test_batched_gkr_rejects_mismatched_lists():
    _js, ts = gkr_instances(3, 41, 2)
    f1s, f2s, f3s, gs = (list(t) for t in zip(*ts))
    rngs = [T.Blake2b512Rng.setup() for _ in ts]
    with pytest.raises(SumcheckError):
        BatchedGKRRoundSumcheck.prove(rngs[:1], f1s, f2s, f3s, gs, device="cpu")
    with pytest.raises(SumcheckError):
        BatchedGKRRoundSumcheck.prove(rngs, f1s, [f2s[0], T.DenseMLE.zero(2)], f3s, gs,
                                      device="cpu")
