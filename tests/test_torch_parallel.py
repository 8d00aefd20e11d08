"""The port's multi-device provers (`sumcheck_tpu_torch/parallel/`, the
sharded batch of `batch.py`) on the CPU against the JAX package.

One spawn per world size S in (1, 2, 4), the three at once, runs every
sharded case in a gloo group (`init_method=file://`, no TCP port), each
rank on `device="cpu"` (the kernels' plain versions). The ranks import
this module, which imports no JAX, and only the port: the parent builds
every instance and every JAX-package reference. Each rank writes what it
got to a file, and the tests compare every rank's results with the JAX
package's single-device proofs (the JAX suite shows that its own sharded
provers give those bytes), tolerance 0:

- ML nv=6, two products of 2-3 multiplicands (the `tests/test_sharded.py`
  chained instance), and the boundary nv with 2^(nv-1) == S: proof bytes,
  the prover state's randomness and the final transcript state;
- GKR dim 4 with 11 nonzeros (the padding of an odd count) at S = 1, 2,
  and dim 5 with 32 nonzeros at S = 4, with each rank's calls of the init
  functions counted (the weight reduce and the dealt finish, 2 each; none
  of the per-size pieces or `pair_slots`) and its collectives (one
  reduce-scatter of the raw sums a phase, no init all-reduce);
- `comm.reduce_scatter_sum_` against the NumPy sum of every rank's blocks,
  with its counts of calls, bytes sent and bytes received;
- the sharded batch, nv=5, B=8 (B=2 at S = 1): each proof, challenges and
  transcript equal to the instance's own prove;
- transcripts holding a pending byte count that is not a multiple of 8:
  every rank proves alone, byte-equal to the JAX package (in the batch, B =
  S with the last rank's instance pre-fed);
- the rejections (nv or dim too small for S, B not a multiple of S, a
  transcript other than `Blake2b512Rng`) raise `SumcheckError` and leave
  every transcript untouched;
- `ChainedShardedProver.auto(S)` and `ShardedGKRProver.auto(S)`: the same
  proofs, and `auto` with a size other than the group's raises;
- fault F5 at S = 2: GKR dim 4 with an f1 of no entries;
- fault F4's structures at S = 2 (`tests/f4_cases.py`: 17 tables at
  nv=4; a product of 9 tables, 17 pairs of 7 tables, 18 tables with a zero
  coefficient and a product of 20 tables beside 40 at nv=3), on the
  chained and the host-transcript sharded provers, against the JAX
  package's single-device prove;
- `ShardedProver` (`parallel/prover.py`, the transcript on the host) over a
  `Blake2b512Rng`, an unaligned one and a transcript of another class,
  against the JAX package's `ShardedProver(default_mesh(S))` on the
  conftest's 8 CPU devices: proof, randomness, final transcript and final
  tables, and at the boundary nv.

Host-only cases check the layouts of `parallel/mesh.py` against the JAX
package's.
"""

from __future__ import annotations

import json
import os
import random
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sumcheck_tpu_torch.parallel import mesh

SIZES = (1, 2, 4)
SP_TRANSCRIPTS = ("aligned", "unaligned", "foreign")  # the `ShardedProver` cases' transcripts
BATCH = {1: 2, 2: 8, 4: 8}
BATCH_NV = 5
ML_STRUCTURE = ((0, 1), (2, 0))  # the batch instances' (the `tests/test_batch.py` shape)


def _log2(size: int) -> int:
    return size.bit_length() - 1


def _gkr_shape(size: int) -> tuple[int, int]:
    """(dim, nnz) of the GKR case at world size `size`."""
    return (5, 32) if size == 4 else (4, 11)


# --- instances as plain arrays (both packages build theirs from them)


def _tables(gen, nv: int, count: int) -> list[np.ndarray]:
    out = []
    for _ in range(count):
        d = gen.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def _ml_arrays(poly) -> dict:
    """A polynomial as (nv, tables, products) of plain arrays and ints."""
    return {"nv": poly.num_variables, "tables": [m.evals for m in poly.flattened_ml_extensions],
            "products": [(c.v, list(ix)) for c, ix in poly.products]}


def _boundary_arrays(size: int) -> dict:
    nv = _log2(size) + 1  # 2^(nv-1) == size: one pair lane a rank
    return {"nv": nv, "tables": _tables(np.random.default_rng(nv), nv, 2),
            "products": [(3, [0, 1])]}


def _batch_arrays(batch: int) -> list[dict]:
    gen = np.random.default_rng(11)
    out = []
    for _ in range(batch):
        coeffs = [int(gen.integers(1, 1 << 62)) for _ in ML_STRUCTURE]
        out.append({"nv": BATCH_NV, "tables": _tables(gen, BATCH_NV, 3),
                    "products": [(c, list(ix)) for c, ix in zip(coeffs, ML_STRUCTURE)]})
    return out


def _gkr_arrays(dim: int, nnz: int, seed: int) -> dict:
    """A GKR instance drawn by the JAX package, as plain arrays."""
    import sumcheck_tpu as J
    from sumcheck_tpu.fields.fr import P

    rnd = random.Random(seed)
    f1 = J.SparseMLE.rand_with_config(3 * dim, nnz, rnd)
    f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
    return {"dim": dim, "indices": f1.indices, "values": f1.values, "f2": f2.evals,
            "f3": f3.evals, "g": [rnd.randrange(P) for _ in range(dim)]}


def _gkr_empty_arrays(size: int) -> dict:
    """Fault F5's case: the GKR case's dim with an f1 of no entries."""
    return _gkr_arrays(_gkr_shape(size)[0], 0, seed=77)


def _port_poly(a: dict):
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    return polynomial_from_numpy(a["nv"], a["tables"], a["products"])


def _port_gkr(a: dict):
    from sumcheck_tpu_torch.convert import gkr_instance_from_numpy

    return gkr_instance_from_numpy(a["dim"], a["indices"], a["values"], a["f2"], a["f3"],
                                   a["g"])


def _state(rng) -> list:
    h, t, buf = rng.state_tuple()
    return [list(h), t, buf.hex()]


# --- the ranks (this part runs in the spawned processes: no JAX)


class _OtherRng:
    """A transcript other than `Blake2b512Rng`, with the same bytes."""

    def __init__(self):
        from sumcheck_tpu_torch import Blake2b512Rng

        self.inner = Blake2b512Rng.setup()

    def feed(self, msg):
        self.inner.feed(msg)

    def next_u64(self):
        return self.inner.next_u64()


class _JaxOtherRng:
    """The JAX package's counterpart of `_OtherRng` (the parent's only)."""

    def __init__(self):
        import sumcheck_tpu as J

        self.inner = J.Blake2b512Rng.setup()

    def feed(self, msg):
        self.inner.feed(msg)

    def next_u64(self):
        return self.inner.next_u64()


def _rejected(fn, rngs) -> list:
    """[raised SumcheckError, every transcript untouched]."""
    from sumcheck_tpu_torch.utils.errors import SumcheckError

    before = [_state(getattr(r, "inner", r)) for r in rngs]
    try:
        fn()
    except SumcheckError:
        raised = True
    else:
        raised = False
    return [raised, [_state(getattr(r, "inner", r)) for r in rngs] == before]


# the GKR init functions a rank's calls are counted of: the kernels' wrappers
# its phase inits take, and the per-size pieces and their kernel, which no
# sharded prove may take
INIT_CALLS = {"gkr_init": ("prep1", "final_fold", "prep2"),
              "gkr_init_cuda": ("weight_reduce", "finish_sums", "pair_slots")}


def _count_init_calls() -> dict:
    """Wrap each of `INIT_CALLS` in this process to count its calls; returns
    the dict of counts, by name, that the wrappers add to."""
    import functools
    import importlib

    calls: dict = {}
    for module, names in INIT_CALLS.items():
        mod = importlib.import_module(f"sumcheck_tpu_torch.ops.{module}")
        for name in names:
            def counted(*a, _real=getattr(mod, name), _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **k)

            setattr(mod, name, functools.wraps(getattr(mod, name))(counted))
    return calls


def _rank(rank: int, size: int, init_file: str, out_dir: str, cases: dict) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        out = _rank_cases(size, cases, _count_init_calls())
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m == "sumcheck_tpu"
                                     or m.startswith(("jax.", "sumcheck_tpu.")))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _rank_cases(size: int, cases: dict, init_calls: dict) -> dict:
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.parallel import (ChainedShardedProver, ShardedGKRProver,
                                             ShardedProver, comm)

    ml = ChainedShardedProver(device="cpu")
    gkr = ShardedGKRProver(device="cpu")
    out = {}

    def ml_prove(name, a, prefix=b"", prover=ml):
        rng = Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        comm.all_reduce_sum_.calls = comm.all_reduce_sum_.bytes = 0
        proof, state = prover.prove_as_subprotocol(rng, _port_poly(a))
        out[name] = {"proof": serialize_proof(proof).hex(), "state": _state(rng),
                     "randomness": [r.v for r in state.randomness],
                     "tables": [t.tolist() for t in state.flattened_ml_extensions],
                     "collectives": comm.all_reduce_sum_.calls}

    def gkr_prove(name, a, prefix=b"", prover=gkr):
        rng = Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        rs = comm.reduce_scatter_sum_
        comm.all_reduce_sum_.calls = comm.all_reduce_sum_.bytes = 0
        rs.calls = rs.bytes = rs.received = 0
        init_calls.clear()
        proof = prover.prove(rng, *_port_gkr(a))
        out[name] = {"proof": proof.serialize_uncompressed().hex(), "state": _state(rng),
                     "collectives": comm.all_reduce_sum_.calls, "init_calls": dict(init_calls),
                     "reduce_scatter": [rs.calls, rs.bytes, rs.received]}

    def batch_prove(name, arrays, prefixes):
        rngs = [Blake2b512Rng.setup() for _ in arrays]
        for rng, prefix in zip(rngs, prefixes):
            rng.feed_bytes(prefix)
        proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
            rngs, [_port_poly(a) for a in arrays], device="cpu", group=ml.group)
        out[name] = {"proofs": [serialize_proof(p).hex() for p in proofs],
                     "challenges": [[r.v for r in rs] for rs in challenges],
                     "states": [_state(r) for r in rngs]}

    sp = ShardedProver(device="cpu")

    def sp_prove(name, a, transcript):
        rng = _OtherRng() if transcript == "foreign" else Blake2b512Rng.setup()
        if transcript == "unaligned":
            rng.feed_bytes(b"abc")
        comm.all_reduce_sum_.calls = comm.all_reduce_sum_.bytes = 0
        proof, state = sp.prove_as_subprotocol(rng, _port_poly(a))
        out[name] = {"proof": serialize_proof(proof).hex(), "state": _state(getattr(rng, "inner",
                                                                                    rng)),
                     "randomness": [r.v for r in state.randomness],
                     "tables": [t.tolist() for t in state.flattened_ml_extensions],
                     "collectives": comm.all_reduce_sum_.calls}

    out["reduce_scatter"] = _reduce_scatters(ml.group)
    for name, a in cases.get("f4", {}).items():
        ml_prove(f"f4_{name}", a)
        sp_prove(f"sp_f4_{name}", a, "aligned")
    for transcript in SP_TRANSCRIPTS:
        sp_prove(f"sp_{transcript}", cases["ml"], transcript)
    sp_prove("sp_boundary", cases["boundary"], "aligned")
    ml_prove("ml", cases["ml"])
    ml_prove("boundary", cases["boundary"])
    ml_prove("ml_unaligned", cases["ml"], b"abc")
    gkr_prove("gkr", cases["gkr"])
    gkr_prove("gkr_unaligned", cases["gkr"], b"abc")
    ml_prove("ml_auto", cases["ml"], prover=ChainedShardedProver.auto(size, device="cpu"))
    gkr_prove("gkr_auto", cases["gkr"], prover=ShardedGKRProver.auto(size, device="cpu"))
    if "gkr_empty" in cases:
        gkr_prove("gkr_empty", cases["gkr_empty"])
    out["auto_reject"] = [
        _rejected(lambda: cls.auto(2 * size, device="cpu"), [])[0]
        for cls in (ChainedShardedProver, ShardedGKRProver, ShardedProver)]
    batch_prove("batch", cases["batch"], [b""] * len(cases["batch"]))
    batch_prove("batch_unaligned", cases["batch"][:size],
                [b"abc" if b == size - 1 else b"" for b in range(size)])

    small = dict(cases["boundary"], nv=cases["boundary"]["nv"] - 1)
    small["tables"] = [t[:, : 1 << small["nv"]] for t in small["tables"]]
    gkr_small = cases["gkr_small"]
    rng, other = Blake2b512Rng.setup(), _OtherRng()
    rngs = [Blake2b512Rng.setup() for _ in range(3)]
    mixed = [Blake2b512Rng.setup() for _ in range(size - 1)] + [other]  # B = S
    out["reject"] = {
        "nv": _rejected(lambda: ml.prove_as_subprotocol(rng, _port_poly(small)), [rng]),
        "dim": _rejected(lambda: gkr.prove(rng, *_port_gkr(gkr_small)), [rng]),
        "ml_rng": _rejected(lambda: ml.prove_as_subprotocol(other, _port_poly(cases["ml"])),
                            [other]),
        "gkr_rng": _rejected(lambda: gkr.prove(other, *_port_gkr(cases["gkr"])), [other]),
        "batch_rng": _rejected(lambda: BatchedMLSumcheck.prove_as_subprotocol(
            mixed, [_port_poly(a) for a in cases["batch"][:size]], device="cpu",
            group=ml.group), mixed),
    }
    if size > 1:  # 3 instances over 2 or 4 ranks
        out["reject"]["batch_size"] = _rejected(lambda: BatchedMLSumcheck.prove_as_subprotocol(
            rngs, [_port_poly(a) for a in cases["batch"][:3]], device="cpu", group=ml.group),
            rngs)
    other = _OtherRng()
    out["sp_reject"] = _rejected(lambda: sp.prove_as_subprotocol(other, _port_poly(small)),
                                 [other])
    if not torch.cuda.is_available():
        try:
            ShardedProver(ml.group, device="cuda")
        except RuntimeError as e:
            out["sp_cuda_without_a_card"] = str(e)
        try:
            ChainedShardedProver(ml.group, device="cuda")
        except RuntimeError as e:
            out["cuda_without_a_card"] = str(e)
    return out


RS_SHAPES = ((8, 6), (3,), (2, 8, 5))  # a block's shapes in the reduce-scatter case


def _rs_blocks(rank: int, size: int, shape: tuple) -> np.ndarray:
    """Rank `rank`'s (S, *shape) int64 input of the reduce-scatter case."""
    gen = np.random.default_rng(1000 * size + 10 * rank + len(shape))
    return gen.integers(-(1 << 40), 1 << 40, size=(size,) + shape, dtype=np.int64)


def _reduce_scatters(group) -> dict:
    """`comm.reduce_scatter_sum_` of `_rs_blocks` at each of `RS_SHAPES`:
    the rank's results, its input unchanged and its counts."""
    from sumcheck_tpu_torch.parallel import comm

    rank, size = comm.rank_and_size(group)
    rs = comm.reduce_scatter_sum_
    rs.calls = rs.bytes = rs.received = 0
    got, kept = [], True
    for shape in RS_SHAPES:
        blocks = _rs_blocks(rank, size, shape)
        t = torch.from_numpy(blocks.copy())
        res = rs(t, group)
        kept = kept and np.array_equal(t.numpy(), blocks)
        got.append([list(res.shape), res.dtype == torch.int64, res.numpy().tolist()])
    return {"got": got, "input_kept": kept, "counts": [rs.calls, rs.bytes, rs.received]}


# --- the parent: instances, JAX references, one spawn per world size


def _cases(size: int) -> dict:
    from conftest import random_list_of_products

    poly, _total = random_list_of_products(6, (2, 4), 2, random.Random(0x5A5A))
    dim = _log2(size)  # 2^(dim-1) < size: too small to shard
    out = {"ml": _ml_arrays(poly), "boundary": _boundary_arrays(size),
           "gkr": _gkr_arrays(*_gkr_shape(size), seed=size),
           "gkr_small": _gkr_arrays(dim, 1, seed=99), "batch": _batch_arrays(BATCH[size])}
    if size == F4_SIZE:
        out["f4"] = {name: _f4_arrays(name) for name in F4_CASES}
        out["gkr_empty"] = _gkr_empty_arrays(size)
    return out


F4_SIZE = 2
F4_CASES = ("a", "b", "c", "tables18", "wide")


def _f4_arrays(name: str) -> dict:
    """Fault F4's structure `name` (`tests/f4_cases.py`) as arrays."""
    from f4_cases import f4_structure

    nv, products, count = f4_structure(name)
    return {"nv": nv, "tables": _tables(np.random.default_rng(40 + count), nv, count),
            "products": products}


def _jax_reference(cases: dict, size: int) -> dict:
    """Every case's single-device proof by the JAX package's host engine."""
    import sumcheck_tpu as J
    from sumcheck_tpu.ml_sumcheck import serialize_proof
    from sumcheck_tpu.utils.config import get_config

    def jpoly(a):
        mles = [J.DenseMLE(a["nv"], t.copy()) for t in a["tables"]]
        poly = J.ListOfProductsOfPolynomials(a["nv"])
        for c, idx in a["products"]:
            poly.add_product([mles[i] for i in idx], J.Fr(c))
        return poly

    def jgkr(a):
        return (J.SparseMLE(3 * a["dim"], np.asarray(a["indices"]), a["values"]),
                J.DenseMLE(a["dim"], a["f2"]), J.DenseMLE(a["dim"], a["f3"]),
                [J.Fr(v) for v in a["g"]])

    def ml(a, prefix=b""):
        rng = J.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        proof, state = J.MLSumcheck.prove_as_subprotocol(rng, jpoly(a))
        return {"proof": serialize_proof(proof).hex(), "state": _state(rng),
                "randomness": [r.v for r in state.randomness],
                "tables": [np.asarray(t).tolist() for t in state.flattened_ml_extensions]}

    def gkr(a, prefix=b""):
        rng = J.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        proof = J.GKRRoundSumcheck.prove(rng, *jgkr(a))
        return {"proof": proof.serialize_uncompressed().hex(), "state": _state(rng)}

    def batch(arrays, prefixes):
        each = [ml(a, p) for a, p in zip(arrays, prefixes)]
        return {"proofs": [e["proof"] for e in each], "challenges": [e["randomness"] for e in each],
                "states": [e["state"] for e in each]}

    def sp(a, transcript):
        """The JAX package's `ShardedProver` over `default_mesh(size)`."""
        from sumcheck_tpu.parallel.mesh import default_mesh
        from sumcheck_tpu.parallel.prover import ShardedProver

        rng = _JaxOtherRng() if transcript == "foreign" else J.Blake2b512Rng.setup()
        if transcript == "unaligned":
            rng.feed_bytes(b"abc")
        proof, state = ShardedProver(default_mesh(size)).prove_as_subprotocol(rng, jpoly(a))
        return {"proof": serialize_proof(proof).hex(), "state": _state(getattr(rng, "inner", rng)),
                "randomness": [r.v for r in state.randomness],
                "tables": [np.asarray(t).tolist() for t in state.flattened_ml_extensions]}

    cfg = get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        n = len(cases["batch"])
        sps = {f"sp_{t}": sp(cases["ml"], t) for t in SP_TRANSCRIPTS}
        sps["sp_boundary"] = sp(cases["boundary"], "aligned")
        for name, a in cases.get("f4", {}).items():
            sps[f"f4_{name}"] = sps[f"sp_f4_{name}"] = ml(a)
        if "gkr_empty" in cases:
            sps["gkr_empty"] = gkr(cases["gkr_empty"])
        return {"ml": ml(cases["ml"]), "boundary": ml(cases["boundary"]),
                "ml_unaligned": ml(cases["ml"], b"abc"), "gkr": gkr(cases["gkr"]),
                "gkr_unaligned": gkr(cases["gkr"], b"abc"),
                "batch": batch(cases["batch"], [b""] * n),
                "batch_unaligned": batch(cases["batch"][:size],
                                         [b"abc" if b == size - 1 else b"" for b in range(size)]),
                **sps}
    finally:
        cfg.engine = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{S: (S, every rank's results, the JAX references)}: the three spawns
    run at once, while the parent computes the references."""
    started = {}
    for size in SIZES:
        cases = _cases(size)
        tmp = tmp_path_factory.mktemp(f"ranks{size}")
        ctx = mp.start_processes(_rank, args=(size, str(tmp / "init"), str(tmp), cases),
                                 nprocs=size, join=False, start_method="spawn")
        started[size] = (ctx, tmp, _jax_reference(cases, size))
    out = {}
    for size, (ctx, tmp, ref) in started.items():
        while not ctx.join():  # raises if a rank failed
            pass
        ranks = []
        for r in range(size):
            with open(tmp / f"rank{r}.json") as f:
                ranks.append(json.load(f))
        out[size] = (size, ranks, ref)
    return out


@pytest.fixture(params=SIZES, ids=lambda s: f"S{s}")
def run(request, runs):
    return runs[request.param]


def _each_rank(run, name):
    _size, ranks, ref = run
    for got in ranks:
        yield got[name], ref[name]


def test_ml_matches_jax(run):
    """Proof bytes, the prover state's randomness and the final transcript
    on every rank equal the JAX package's single-device prove; one
    all-reduce a sharded round and one gather."""
    size = run[0]
    for got, want in _each_rank(run, "ml"):
        assert {k: got[k] for k in want} == want
        assert got["collectives"] == 6 - _log2(size) + (size > 1)


def test_auto_constructors_match_jax(run):
    """`ChainedShardedProver.auto(S)` and `ShardedGKRProver.auto(S)` over
    the default group prove the JAX package's bytes and final transcript
    on every rank, as the constructors given the group do; `auto` with a
    size other than the group's raises `SumcheckError`, for all three
    provers."""
    _size, ranks, ref = run
    for got in ranks:
        for name in ("ml", "gkr"):
            auto, want = got[f"{name}_auto"], ref[name]
            assert {k: auto[k] for k in want} == want
            assert auto == got[name]
        assert got["auto_reject"] == [True, True, True]


def test_boundary_nv_matches_jax(run):
    """nv with 2^(nv-1) == S: one sharded round, then the gathered tail."""
    for got, want in _each_rank(run, "boundary"):
        assert {k: got[k] for k in want} == want


def test_gkr_matches_jax(run):
    """`GKRProof.serialize_uncompressed()` and the final transcript; odd
    nnz pads the last chunk. Two inits, each one reduce-scatter of the raw
    sums; two sharded rounds' worth of all-reduces and two gathers."""
    size = run[0]
    dim = _gkr_shape(size)[0]
    for got, want in _each_rank(run, "gkr"):
        assert {k: got[k] for k in want} == want
        assert got["collectives"] == 2 * (dim - _log2(size) + (size > 1))
        assert got["reduce_scatter"][0] == 2


def test_gkr_rank_finishes_its_dealt_pair(run):
    """A rank's GKR inits are the weight reduce into rank-major raw sums
    and, after their reduce-scatter, the finish of only its dealt lanes
    straight into its pair, slot 1 from the same call (`finish_sums`): 2
    calls a phase, 4 a prove, in every case of the chained sharded prover;
    no prove reaches `prep1`, `final_fold`, `prep2` or `pair_slots`. A
    prove makes 2 reduce-scatters, each sending the whole (8, 2^dim) int64
    sums and receiving only the rank's 2^dim·64/S bytes, and no init
    all-reduce (`test_gkr_matches_jax` counts the rest). A transcript the
    chain cannot lift takes the single device's host loop (1 call a phase,
    no finish, no collective)."""
    size = run[0]
    dim = _gkr_shape(size)[0]
    for got in run[1]:
        for name in ("gkr", "gkr_auto"):
            assert got[name]["init_calls"] == {"weight_reduce": 2, "finish_sums": 2}
            assert got[name]["reduce_scatter"] == [2, 2 * 64 << dim, 2 * (64 << dim) // size]
        assert got["gkr_unaligned"]["init_calls"] == {"weight_reduce": 2}
        assert got["gkr_unaligned"]["reduce_scatter"] == [0, 0, 0]
        assert got["gkr_unaligned"]["collectives"] == 0


def test_reduce_scatter_matches_numpy(run):
    """`comm.reduce_scatter_sum_` on gloo over CPU tensors: rank s gets the
    sum over the ranks of their block [s], shaped as a block, int64, exact
    (values of either sign up to 2^40), its input left as it was; each
    call counts the whole tensor as sent and the block as received."""
    size, ranks, _ref = run
    for rank, got in enumerate(ranks):
        res = got["reduce_scatter"]
        assert res["input_kept"]
        sent = received = 0
        for shape, (got_shape, is_int64, values) in zip(RS_SHAPES, res["got"]):
            want = sum(_rs_blocks(r, size, shape)[rank] for r in range(size))
            assert got_shape == list(shape) and is_int64
            np.testing.assert_array_equal(np.array(values, dtype=np.int64), want)
            sent += 8 * size * int(np.prod(shape))
            received += 8 * int(np.prod(shape))
        assert res["counts"] == [len(RS_SHAPES), sent, received]


def test_f4_structures_match_jax(runs):
    """F4's five structures at S = 2: every rank's chained sharded prove and
    `ShardedProver` prove give the JAX package's single-device proof,
    randomness, final transcript and final tables."""
    size, ranks, ref = runs[F4_SIZE]
    for got in ranks:
        for name in F4_CASES:
            for key in (f"f4_{name}", f"sp_f4_{name}"):
                want = ref[key]
                assert {k: got[key][k] for k in want} == want, key


def test_gkr_empty_f1_matches_jax(runs):
    """Fault F5 at S = 2: an f1 with no entries, which each rank's chunk
    pads to one zero entry, proves on every rank the JAX package's
    single-device bytes and final transcript, with the sharded inits'
    calls (the weight reduce and the dealt finish, 2 each); the proof
    verifies, its subclaim holds, and the sum is 0."""
    from sumcheck_tpu_torch import Blake2b512Rng, GKRProof, GKRRoundSumcheck

    _size, ranks, ref = runs[F4_SIZE]
    want = ref["gkr_empty"]
    for got in ranks:
        assert {k: got["gkr_empty"][k] for k in want} == want
        assert got["gkr_empty"]["init_calls"] == {"weight_reduce": 2, "finish_sums": 2}
    proof = GKRProof.deserialize_uncompressed(bytes.fromhex(want["proof"]))
    assert proof.extract_sum().v == 0
    a = _gkr_empty_arrays(F4_SIZE)
    sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), a["dim"], proof, proof.extract_sum())
    assert sub.verify_subclaim(*_port_gkr(a))


def test_batch_matches_each_instance(run):
    """Every rank returns all B proofs, challenges and transcripts, each
    equal to the instance's own JAX prove."""
    for got, want in _each_rank(run, "batch"):
        assert got == want


def test_unaligned_transcripts_prove_alone(run):
    """Transcripts pre-fed 3 bytes: each rank proves alone on the host
    loop (ML, GKR; in the batch, the rank that holds that instance), byte-
    equal to the JAX package."""
    for name in ("ml_unaligned", "gkr_unaligned", "batch_unaligned"):
        for got, want in _each_rank(run, name):
            assert {k: got[k] for k in want} == want, name


@pytest.mark.parametrize("transcript", SP_TRANSCRIPTS)
def test_sharded_prover_matches_jax(run, transcript):
    """`ShardedProver` over any transcript (a `Blake2b512Rng`, one pre-fed 3
    bytes, one of another class): proof bytes, randomness, the final
    transcript and the final folded tables on every rank equal the JAX
    package's `ShardedProver(default_mesh(S))`; one all-reduce a sharded
    round and one gather."""
    size = run[0]
    for got, want in _each_rank(run, f"sp_{transcript}"):
        assert {k: got[k] for k in want} == want
        assert got["collectives"] == 6 - _log2(size) + (size > 1)


def test_sharded_prover_boundary_and_rejection(run):
    """nv with 2^(nv-1) == S: one sharded round, then the gathered tail;
    one variable fewer is refused before the transcript is fed."""
    for got, want in _each_rank(run, "sp_boundary"):
        assert {k: got[k] for k in want} == want
    for got in run[1]:
        assert got["sp_reject"] == [True, True]
        if not torch.cuda.is_available():
            assert "no CUDA device" in got["sp_cuda_without_a_card"]


def test_rejections_leave_transcripts_untouched(run):
    size, ranks, _ref = run
    expected = {"nv", "dim", "ml_rng", "gkr_rng", "batch_rng"} | ({"batch_size"} if size > 1
                                                                  else set())
    for got in ranks:
        assert set(got["reject"]) == expected
        assert all(raised and untouched for raised, untouched in got["reject"].values()), \
            got["reject"]


def test_ranks_import_no_jax(run):
    for got in run[1]:
        assert got["jax_imported"] == []


def test_cuda_without_a_card_raises(run):
    """`device="cuda"` on a machine without a card raises the no-card
    error, and nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    for got in run[1]:
        assert "no CUDA device" in got["cuda_without_a_card"]


# --- host-only: the layouts against the JAX package's


@pytest.mark.parametrize("nv,k", [(3, 0), (4, 2), (6, 3)])
def test_sharded_layouts_match_jax(nv, k):
    from sumcheck_tpu.parallel import mesh as jmesh

    np.testing.assert_array_equal(mesh.sharded_perm(nv, k), jmesh.sharded_perm(nv, k))
    np.testing.assert_array_equal(mesh.inverse_sharded_perm(nv, k),
                                  jmesh.inverse_sharded_perm(nv, k))
    arr = np.random.default_rng(nv).integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
    np.testing.assert_array_equal(mesh.to_sharded_layout(arr, nv, k),
                                  jmesh.to_sharded_layout(arr, nv, k))
    np.testing.assert_array_equal(mesh.from_sharded_layout(arr, nv, k),
                                  jmesh.from_sharded_layout(arr, nv, k))
    np.testing.assert_array_equal(
        mesh.from_sharded_layout(mesh.to_sharded_layout(arr, nv, k), nv, k), arr)


def test_sharded_pairing_is_local():
    """Fold pairs (2b, 2b+1) live in one shard block, half a block apart."""
    nv, k = 5, 2
    block = (1 << nv) >> k
    perm = mesh.sharded_perm(nv, k)
    for b in range((1 << nv) // 2):
        p0, p1 = perm[2 * b], perm[2 * b + 1]
        assert p0 // block == p1 // block
        assert p1 - p0 == block // 2


@pytest.mark.parametrize("size", [1, 2, 4])
def test_deal_is_the_reference_deal(size):
    """`mesh.deal` gives rank s the lanes the JAX package's cyclic deal
    puts on shard s (`sumcheck_tpu/parallel/chained.py:177-187`), for
    NumPy and torch tables alike."""
    n = 32
    table = np.random.default_rng(size).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    half = n // 2

    def ref(part):  # the reference: (16, H) -> (16, H/S, S) -> moveaxis -> shard blocks
        return np.moveaxis(part.reshape(16, half // size, size), 2, 1).reshape(16, half)

    lo, hi = ref(table[:, :half]), ref(table[:, half:])
    width = half // size
    for s in range(size):
        want = np.concatenate([lo[:, s * width:(s + 1) * width], hi[:, s * width:(s + 1) * width]],
                              axis=1)
        np.testing.assert_array_equal(mesh.deal(table, s, size), want)
        np.testing.assert_array_equal(mesh.deal(torch.from_numpy(table.astype(np.int64)), s, size)
                                      .numpy(), want)


def test_default_group_needs_a_group():
    from sumcheck_tpu_torch.parallel import ChainedShardedProver
    from sumcheck_tpu_torch.utils.errors import SumcheckError

    with pytest.raises(SumcheckError, match="process group"):
        mesh.default_group()
    with pytest.raises(SumcheckError, match="process group"):
        ChainedShardedProver(device="cpu")


def test_group_size_must_be_a_power_of_two(monkeypatch):
    from sumcheck_tpu_torch.parallel import comm
    from sumcheck_tpu_torch.utils.errors import SumcheckError

    monkeypatch.setattr(comm, "rank_and_size", lambda group: (0, 3))
    with pytest.raises(SumcheckError, match="power of two"):
        mesh.group_shape(object())
    monkeypatch.setattr(comm, "world", lambda: object())
    with pytest.raises(SumcheckError, match="power of two"):
        mesh.default_group()


def test_shard_device(monkeypatch):
    """Rank r takes card r % device_count for "cuda"; "cuda" without a card
    raises the no-card error; an NCCL group refuses the CPU at
    construction."""
    from sumcheck_tpu_torch.parallel import comm
    from sumcheck_tpu_torch.utils.errors import SumcheckError

    monkeypatch.setattr(comm, "rank_and_size", lambda group: (3, 4))
    monkeypatch.setattr(comm, "backend", lambda group: "gloo")
    assert mesh.shard_device(object(), "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.shard_device(object(), "cuda")
    monkeypatch.setattr(comm, "backend", lambda group: "nccl")
    with pytest.raises(SumcheckError, match="NCCL"):
        mesh.shard_device(object(), "cpu")


def test_reduce_scatter_is_one_call_that_raises_its_failure(monkeypatch):
    """`comm.reduce_scatter_sum_` makes one SUM `reduce_scatter_tensor` of
    the tensor itself, flat, into a fresh flat block; a failure of it
    raises, with nothing counted and no all-reduce in its place."""
    import torch.distributed as dist

    from sumcheck_tpu_torch.parallel import comm

    seen = []

    def collective(out, t, op, group):
        seen.append((tuple(out.shape), t.data_ptr(), op))
        out.copy_(t[2:4])

    monkeypatch.setattr(comm, "rank_and_size", lambda group: (1, 2))
    monkeypatch.setattr(dist, "reduce_scatter_tensor", collective)
    t = torch.arange(4, dtype=torch.int64).reshape(2, 2)
    before = [comm.reduce_scatter_sum_.calls, comm.all_reduce_sum_.calls]
    got = comm.reduce_scatter_sum_(t, object())
    assert seen == [((2,), t.data_ptr(), dist.ReduceOp.SUM)] and got.tolist() == [2, 3]

    def failing(out, t, op, group):
        raise RuntimeError("the backend refused")

    monkeypatch.setattr(dist, "reduce_scatter_tensor", failing)
    with pytest.raises(RuntimeError, match="refused"):
        comm.reduce_scatter_sum_(t, object())
    assert [comm.reduce_scatter_sum_.calls, comm.all_reduce_sum_.calls] == \
        [before[0] + 1, before[1]]


def test_reduce_scatter_hands_a_fresh_block_of_the_raw_sums_layout(monkeypatch):
    """On the GKR inits' (S, 8, run) raw sums, `comm.reduce_scatter_sum_`
    passes the collective the whole tensor and an 8·run output, flat, and
    returns an (8, run) block in storage of its own: writing it leaves the
    raw sums as they were."""
    import torch.distributed as dist

    from sumcheck_tpu_torch.parallel import comm

    seen = []

    def collective(out, t, op, group):
        seen.append((out.numel(), t.numel()))
        out.copy_(t.reshape(4, -1)[3])

    monkeypatch.setattr(comm, "rank_and_size", lambda group: (3, 4))
    monkeypatch.setattr(dist, "reduce_scatter_tensor", collective)
    t = torch.arange(4 * 8 * 5, dtype=torch.int64).reshape(4, 8, 5)
    got = comm.reduce_scatter_sum_(t, object())
    assert seen == [(8 * 5, 4 * 8 * 5)] and tuple(got.shape) == (8, 5)
    assert torch.equal(got, t[3])
    got.zero_()
    assert t.untyped_storage().data_ptr() != got.untyped_storage().data_ptr()
    assert torch.equal(t, torch.arange(4 * 8 * 5, dtype=torch.int64).reshape(4, 8, 5))


def test_reduce_scatter_refuses_a_bad_tensor(monkeypatch):
    """Refused before any collective: a dtype other than int64, a leading
    axis other than the group's size, no axis, or a tensor that is not
    contiguous; nothing is counted."""
    import torch.distributed as dist

    from sumcheck_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "rank_and_size", lambda group: (1, 2))
    monkeypatch.setattr(dist, "reduce_scatter_tensor", None)
    before = comm.reduce_scatter_sum_.calls
    for t in (torch.zeros((2, 8), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int64),
              torch.zeros((), dtype=torch.int64), torch.zeros((8, 2), dtype=torch.int64).T):
        with pytest.raises(ValueError, match="reduce-scatter sums"):
            comm.reduce_scatter_sum_(t, object())
    assert comm.reduce_scatter_sum_.calls == before
