"""The port under the second field, BN254 Fr, on the CPU against the JAX
package under the same field.

`SUMCHECK_TPU_FIELD` selects the prime at import in both packages, so the
checks run in one child process with `SUMCHECK_TPU_FIELD=bn254_fr` (and
`JAX_PLATFORMS=cpu`), started once for this file. The child imports both
packages, makes every input from `numpy.random.default_rng(seed)` (tables
below 2^253 < p) or the JAX package's `random.Random` draws, and writes each
case's port result beside the JAX package's; the tests compare them,
tolerance 0 (proof bytes, challenges and final transcript states):

- ML nv=6 and 8, two products of three multiplicands, on the generic chain,
  the per-size chain, the generic chain in the MXU fold mode and the
  host-transcript loop (a transcript pre-fed 3 bytes); the same paths for
  fault F4's structures (a) and (b) (`tests/f4_cases.py`: 17 slots at nv=4,
  degree 9 at nv=3), which take the kernels' wide route;
- the batched ML prover, 4 x nv=6 on both chains, and the batched GKR
  prover, 2 x dim 4, against per-instance JAX proves;
- GKR dim 4 and 5 on every path, and dim 9 with colliding f1 entries on
  every path against the JAX package's naive engine (`portable.py`): there
  the JAX limb engines' two-subtraction `reduce_wide` leaves values in
  [p, 3.3 p) and its host engine proves other bytes (ROADMAP section 3);
  the limb reductions against integers;
- the verifier (the C core) on the ML and GKR proofs;
- the sharded provers at S = 2 and 4 (a gloo spawn each of this module's
  `_rank`, which imports no JAX): ML, GKR, the sharded batch and
  `ShardedProver` over a transcript of another class;
- the interactive tier message by message with its folded tables, also
  over fault F3's zero-coefficient polynomials at nv=3 and 10 and a batch
  with one zero-coefficient instance, and the GKR device-init wrappers
  (`phase1_init_device`, `phase2_init_device`);
- the BN254 golden fixture `tests/fixtures/bn254_torch.json`, re-derived
  through the JAX package, equal to the committed file, and proved by the
  port on every path.

The JAX package runs its host engine here (its instances are below its
4096-lane device threshold; its XLA chain under BN254 is the `slow` test in
`tests/test_field_choice.py`). The fixture is written by

    SUMCHECK_TPU_FIELD=bn254_fr JAX_PLATFORMS=cpu python tests/test_torch_field.py --write

and read on the card by `chip_smoke.py`, which has no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURE = os.path.join(TESTS, "fixtures", "bn254_torch.json")
BN254_P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

ML_PATHS = ("generic", "persize", "mxu", "host")
GKR_PATHS = ("generic", "persize", "mxu", "host")
# the ML nv=6 instance's product structure and coefficients: those of
# `tests/fixtures/ml_nv6_rich.json`, reduced mod p
FIXTURE_ML = "ml_nv6_rich.json"
FIXTURE_GKR_DIM = 5
FR_RAND_SEED = b"bn254 fr_rand fixture seed"
FR_RAND_DRAWS = 32
SHARDS = (2, 4)  # world sizes of the sharded cases
F4_BN254 = ("a", "b")  # fault F4's structures (`tests/f4_cases.py`) proved under BN254


# --- inputs as plain arrays (both packages build theirs from them)


def _tables(gen, nv: int, count: int) -> list[np.ndarray]:
    out = []
    for _ in range(count):
        d = gen.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 3  # < 2^253 < p (254 bits)
        out.append(d)
    return out


def _ml_arrays(seed: int, nv: int) -> dict:
    gen = np.random.default_rng(seed)
    tables = _tables(gen, nv, 6)
    return {"nv": nv, "tables": tables,
            "products": [(int(gen.integers(1, 1 << 62)), [0, 1, 2]),
                         (int(gen.integers(1, 1 << 62)), [3, 4, 5])]}


def _batch_arrays(seed: int, batch: int, nv: int) -> list[dict]:
    gen = np.random.default_rng(seed)
    return [{"nv": nv, "tables": _tables(gen, nv, 3),
             "products": [(int(gen.integers(1, 1 << 62)), [0, 1]),
                          (int(gen.integers(1, 1 << 62)), [2, 0])]} for _ in range(batch)]


def _gkr_arrays(dim: int, nnz: int, seed: int) -> dict:
    """A GKR instance drawn by the JAX package, as plain arrays."""
    import sumcheck_tpu as J
    from sumcheck_tpu.fields.fr import P

    rnd = random.Random(seed)
    f1 = J.SparseMLE.rand_with_config(3 * dim, nnz, rnd)
    f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
    return {"dim": dim, "indices": f1.indices, "values": f1.values, "f2": f2.evals,
            "f3": f3.evals, "g": [rnd.randrange(P) for _ in range(dim)]}


def _port_poly(a: dict):
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    return polynomial_from_numpy(a["nv"], a["tables"], a["products"])


def _port_gkr(a: dict):
    from sumcheck_tpu_torch.convert import gkr_instance_from_numpy

    return gkr_instance_from_numpy(a["dim"], a["indices"], a["values"], a["f2"], a["f3"],
                                   a["g"])


def _mont_ints(digits) -> list[int]:
    """(16, n) digit columns -> their n integers."""
    return [sum(int(digits[d, j]) << (16 * d) for d in range(16)) for j in range(digits.shape[1])]


def _state(rng) -> list:
    h, t, buf = rng.state_tuple()
    return [list(h), t, buf.hex()]


# --- the golden fixture's instances (the `tests/test_golden.py` table rule)


def golden_table(tag: str, nv: int, p: int) -> list[int]:
    return [int.from_bytes(hashlib.blake2b(f"sumcheck-golden/{tag}/{i}".encode(),
                                           digest_size=32).digest(), "little") % p
            for i in range(1 << nv)]


def fixture_ml(pkg, fx: dict):
    """The fixture's ML instance in package `pkg` (either package: the same
    names); tables shared by tag, as the golden fixtures build them."""
    nv = fx["nv"]
    shared, poly = {}, pkg.ListOfProductsOfPolynomials(nv)
    for prod in fx["products"]:
        mles = []
        for tag in prod["tables"]:
            if tag not in shared:
                shared[tag] = pkg.DenseMLE.from_evaluations(
                    nv, golden_table(f"nv6/{tag}", nv, BN254_P))
            mles.append(shared[tag])
        poly.add_product(mles, pkg.Fr(int(prod["coeff"], 16)))
    return poly


def fixture_gkr(pkg, fx: dict):
    dim = fx["dim"]
    f1 = pkg.SparseMLE.from_pairs(3 * dim, [(int(k), pkg.Fr(int(v, 16)))
                                            for k, v in fx["f1_nonzeros"].items()])
    f2 = pkg.DenseMLE.from_evaluations(dim, golden_table(f"gkr{dim}/f2", dim, BN254_P))
    f3 = pkg.DenseMLE.from_evaluations(dim, golden_table(f"gkr{dim}/f3", dim, BN254_P))
    return f1, f2, f3, [pkg.Fr(int(x, 16)) for x in fx["g"]]


def _hexes(msgs) -> list:
    return [[format(e.v, "064x") for e in m.evaluations] for m in msgs]


def make_fixture() -> dict:
    """The BN254 golden vectors, by the JAX package's host engine under
    `SUMCHECK_TPU_FIELD=bn254_fr`: the ML nv=6 rich instance (the structure
    and coefficients of `ml_nv6_rich.json` mod p, tables by the golden
    rule under BN254), the GKR dim-5 instance (`gkr_dim5.json`'s f1
    entries and g mod p) and `FR_RAND_DRAWS` draws of `Fr.rand`."""
    import sumcheck_tpu as J
    from sumcheck_tpu.fields.fr import FIELD_NAME, P
    from sumcheck_tpu.ml_sumcheck import serialize_proof
    from sumcheck_tpu.utils.config import get_config

    assert FIELD_NAME == "bn254_fr" and P == BN254_P
    with open(os.path.join(TESTS, "fixtures", FIXTURE_ML)) as f:
        ml_src = json.load(f)
    with open(os.path.join(TESTS, "fixtures", f"gkr_dim{FIXTURE_GKR_DIM}.json")) as f:
        gkr_src = json.load(f)
    ml = {"nv": ml_src["nv"], "products": [
        {"tables": prod["tables"], "coeff": format(int(prod["coeff"], 16) % P, "064x")}
        for prod in ml_src["products"]]}
    gkr = {"dim": gkr_src["dim"],
           "f1_nonzeros": {k: format(int(v, 16) % P, "064x")
                           for k, v in gkr_src["f1_nonzeros"].items()},
           "g": [format(int(x, 16) % P, "064x") for x in gkr_src["g"]]}
    cfg = get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        poly = fixture_ml(J, ml)
        rng = J.Blake2b512Rng.setup()
        proof, state = J.MLSumcheck.prove_as_subprotocol(rng, poly)
        asserted = J.MLSumcheck.extract_sum(proof)
        sub = J.MLSumcheck.verify(poly.info(), asserted, proof)
        ml.update(info_bytes=poly.info().serialize_uncompressed().hex(),
                  proof_bytes=serialize_proof(proof).hex(),
                  challenges=[format(r.v, "064x") for r in state.randomness],
                  asserted_sum=format(asserted.v, "064x"),
                  final_evaluation=format(sub.expected_evaluation.v, "064x"))
        f1, f2, f3, g = fixture_gkr(J, gkr)
        gproof = J.GKRRoundSumcheck.prove(J.Blake2b512Rng.setup(), f1, f2, f3, g)
        gsub = J.GKRRoundSumcheck.verify(J.Blake2b512Rng.setup(), gkr["dim"], gproof,
                                         gproof.extract_sum())
        assert gsub.verify_subclaim(f1, f2, f3, g)
        gkr.update(phase1_msgs=_hexes(gproof.phase1_sumcheck_msgs),
                   phase2_msgs=_hexes(gproof.phase2_sumcheck_msgs),
                   claimed_sum=format(gproof.extract_sum().v, "064x"),
                   u=[format(x.v, "064x") for x in gsub.u],
                   v=[format(x.v, "064x") for x in gsub.v],
                   expected_evaluation=format(gsub.expected_evaluation.v, "064x"))
    finally:
        cfg.engine = saved
    rng = J.Blake2b512Rng.setup()
    rng.feed_bytes(FR_RAND_SEED)
    draws = [format(J.Fr.rand(rng).v, "064x") for _ in range(FR_RAND_DRAWS)]
    return {"field": "bn254_fr", "p": format(P, "064x"),
            "made_by": "tests/test_torch_field.py make_fixture (the JAX package's host "
                       "engine under SUMCHECK_TPU_FIELD=bn254_fr)",
            "table_rule": "blake2b(b'sumcheck-golden/{tag}/{i}', 32 bytes) LE mod p",
            "ml": ml, "gkr": gkr,
            "fr_rand": {"seed_feed": FR_RAND_SEED.hex(), "draws_canonical": draws}}


# --- the ranks of the sharded case (spawned processes: no JAX)


def _rank(rank: int, size: int, init_file: str, out_dir: str, cases: dict) -> None:
    import torch.distributed as dist

    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.fields.fr import FIELD_NAME
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.parallel import ChainedShardedProver, ShardedGKRProver, ShardedProver

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        ml = ChainedShardedProver(device="cpu")
        rng = Blake2b512Rng.setup()
        proof, state = ml.prove_as_subprotocol(rng, _port_poly(cases["ml"]))
        out = {"field": FIELD_NAME,
               "ml": {"proof": serialize_proof(proof).hex(), "state": _state(rng),
                      "randomness": [r.v for r in state.randomness]}}
        rng = Blake2b512Rng.setup()
        gproof = ShardedGKRProver(device="cpu").prove(rng, *_port_gkr(cases["gkr"]))
        out["gkr"] = {"proof": gproof.serialize_uncompressed().hex(), "state": _state(rng)}
        rng = _Recorder(Blake2b512Rng.setup())
        proof, state = ShardedProver(ml.group, device="cpu").prove_as_subprotocol(
            rng, _port_poly(cases["ml"]))
        out["sp"] = {"proof": serialize_proof(proof).hex(), "state": _state(rng.inner),
                     "randomness": [r.v for r in state.randomness]}
        rngs = [Blake2b512Rng.setup() for _ in cases["batch"]]
        proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
            rngs, [_port_poly(a) for a in cases["batch"]], device="cpu", group=ml.group)
        out["batch"] = {"proofs": [serialize_proof(p).hex() for p in proofs],
                        "challenges": [[r.v for r in rs] for rs in challenges],
                        "states": [_state(r) for r in rngs]}
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m == "sumcheck_tpu"
                                     or m.startswith(("jax.", "sumcheck_tpu.")))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


# --- the child: every case under BN254, the port's result beside the JAX package's


def child(out_path: str) -> None:
    import tempfile

    import torch
    import torch.multiprocessing as mp

    import sumcheck_tpu as J
    import sumcheck_tpu_torch as T
    from sumcheck_tpu.fields import fr as jfr
    from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
    from sumcheck_tpu.utils.config import get_config as j_config
    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck, BatchedMLSumcheck
    from sumcheck_tpu_torch.fields import fr as tfr
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.utils.config import get_config

    torch.set_float32_matmul_precision("highest")
    out: dict = {}
    out["constants"] = {
        "port": [tfr.FIELD_NAME, hex(tfr.P), tfr.SHAVE_BITS, hex(tfr.NINV32), hex(tfr.NINV16)],
        "jax": [jfr.FIELD_NAME, hex(jfr.P), jfr.SHAVE_BITS, hex(jfr.NINV32), hex(jfr.NINV16)]}
    out["constants"]["expected"] = ["bn254_fr", hex(BN254_P), 2, hex(0xEFFFFFFF), hex(0xFFFF)]

    # the sharded spawns (S = 2 and 4) run while this process proves the rest
    spawns = {}
    for size in SHARDS:
        tmp = tempfile.mkdtemp(prefix=f"bn254_ranks{size}_")
        cases = {"ml": _ml_arrays(20 + size, 6),
                 "gkr": _gkr_arrays(*((5, 32) if size == 4 else (4, 11)), seed=30 + size),
                 "batch": _batch_arrays(40 + size, 4, 5)}
        ctx = mp.start_processes(_rank, args=(size, os.path.join(tmp, "init"), tmp, cases),
                                 nprocs=size, join=False, start_method="spawn")
        spawns[size] = (ctx, tmp, cases)

    jcfg = j_config()
    jcfg.engine = "host"

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

    def j_ml(poly, prefix=b""):
        rng = J.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        proof, state = J.MLSumcheck.prove_as_subprotocol(rng, poly)
        return {"proof": j_serialize(proof).hex(), "state": _state(rng),
                "randomness": [r.v for r in state.randomness]}

    def j_gkr(inst, prefix=b""):
        rng = J.Blake2b512Rng.setup()
        rng.feed_bytes(prefix)
        proof = J.GKRRoundSumcheck.prove(rng, *inst)
        return {"proof": proof.serialize_uncompressed().hex(), "state": _state(rng)}

    cfg = get_config()

    def set_path(path):
        cfg.chain_impl = "persize" if path == "persize" else "generic"
        cfg.mxu_fold, cfg.ab = ("kernel", True) if path == "mxu" else ("off", False)
        GI.MXU_MIN_LANES = 1 if path == "mxu" else saved_min_lanes

    saved_min_lanes = GI.MXU_MIN_LANES

    def t_ml(poly, path):
        set_path(path)
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(b"abc" if path == "host" else b"")
        proof, state = T.MLSumcheck.prove_as_subprotocol(rng, poly, device="cpu")
        return proof, {"proof": serialize_proof(proof).hex(), "state": _state(rng),
                       "randomness": [r.v for r in state.randomness]}

    def t_gkr(inst, path):
        set_path(path)
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(b"abc" if path == "host" else b"")
        proof = T.GKRRoundSumcheck.prove(rng, *inst, device="cpu")
        return proof, {"proof": proof.serialize_uncompressed().hex(), "state": _state(rng)}

    for nv in (6, 8):
        a = _ml_arrays(nv, nv)
        jp = jpoly(a)
        ref = {"": j_ml(jp), "abc": j_ml(jp, b"abc")}
        proofs = {}
        for path in ML_PATHS:
            proofs[path], got = t_ml(_port_poly(a), path)
            out[f"ml_nv{nv}_{path}"] = {"port": got, "jax": ref["abc" if path == "host" else ""]}
        set_path("generic")
        tp, proof = _port_poly(a), proofs["generic"]
        s = T.MLSumcheck.extract_sum(proof)
        sub = T.MLSumcheck.verify(tp.info(), s, proof)
        jsub = J.MLSumcheck.verify(jp.info(), J.Fr(s.v),
                                   J.ml_sumcheck.deserialize_proof(serialize_proof(proof)))
        rejected = False
        try:
            T.MLSumcheck.verify(tp.info(), s + T.Fr.one(), proof)
        except T.Reject:
            rejected = True
        out[f"ml_nv{nv}_verify"] = {
            "port": [[x.v for x in sub.point], sub.expected_evaluation.v,
                     tp.evaluate(sub.point) == sub.expected_evaluation, rejected],
            "jax": [[x.v for x in jsub.point], jsub.expected_evaluation.v, True, True]}

    # fault F4's structures (a) and (b), past the kernels' by-value plan
    from f4_cases import f4_structure

    for name in F4_BN254:
        nv, products, count = f4_structure(name)
        a = {"nv": nv, "tables": _tables(np.random.default_rng(60 + count), nv, count),
             "products": products}
        jp = jpoly(a)
        ref = {"": j_ml(jp), "abc": j_ml(jp, b"abc")}
        for path in ML_PATHS:
            _proof, got = t_ml(_port_poly(a), path)
            out[f"f4_{name}_{path}"] = {"port": got, "jax": ref["abc" if path == "host" else ""]}
    set_path("generic")

    for dim, nnz, seed in ((4, 11, 4), (5, 32, 5)):
        a = _gkr_arrays(dim, nnz, seed)
        ref = {"": j_gkr(jgkr(a)), "abc": j_gkr(jgkr(a), b"abc")}
        proofs = {}
        for path in GKR_PATHS:
            inst = _port_gkr(a)
            proofs[path], got = t_gkr(inst, path)
            out[f"gkr_dim{dim}_{path}"] = {"port": got, "jax": ref["abc" if path == "host" else ""]}
        set_path("generic")
        proof = proofs["generic"]
        s = proof.extract_sum()
        sub = T.GKRRoundSumcheck.verify(T.Blake2b512Rng.setup(), dim, proof, s)
        jproof = J.GKRProof.deserialize_uncompressed(proof.serialize_uncompressed())
        jsub = J.GKRRoundSumcheck.verify(J.Blake2b512Rng.setup(), dim, jproof, J.Fr(s.v))
        out[f"gkr_dim{dim}_verify"] = {
            "port": [[x.v for x in sub.u + sub.v], sub.expected_evaluation.v,
                     sub.verify_subclaim(*inst)],
            "jax": [[x.v for x in jsub.u + jsub.v], jsub.expected_evaluation.v, True]}

    # the interactive tier, message by message, with its folded tables
    a = _ml_arrays(16, 6)
    jst, st = J.IPForMLSumcheck.prover_init(jpoly(a)), T.IPForMLSumcheck.prover_init(
        _port_poly(a), device="cpu")
    jrng, rng = J.Blake2b512Rng.setup(), T.Blake2b512Rng.setup()
    jv = v = None
    got, want = [], []
    for _ in range(a["nv"]):
        jm, m = J.IPForMLSumcheck.prove_round(jst, jv), T.IPForMLSumcheck.prove_round(st, v)
        got.append([m.serialize_uncompressed().hex(),
                    [t.tolist() for t in st.flattened_ml_extensions]])
        want.append([jm.serialize_uncompressed().hex(),
                     [np.asarray(t).tolist() for t in jst.flattened_ml_extensions]])
        jrng.feed(jm)
        rng.feed(m)
        jv, v = J.IPForMLSumcheck.sample_round(jrng), T.IPForMLSumcheck.sample_round(rng)
    out["interactive_ml_nv6"] = {"port": got, "jax": want}

    # fault F3: zero-coefficient tables read back after every round
    from test_torch_interactive import zero_coefficient_rounds

    for nv in (3, 10):
        got, want = zero_coefficient_rounds(nv)
        out[f"interactive_zero_coefficient_nv{nv}"] = {
            "port": [[m.hex(), t] for m, t in got], "jax": [[m.hex(), t] for m, t in want]}

    # the GKR device-init wrappers, colliding entries, against the JAX
    # package's wrappers' values mod p: their `reduce_wide` leaves a segment
    # sum that passes 3p at or above p (ROADMAP section 3.6; here f1(g, u, .)
    # at lane 3), where the port's tables hold the strict residue
    from sumcheck_tpu.ops import gkr_init as JGI

    a = _gkr_arrays(3, 24, 50)
    u = [random.Random(51).randrange(BN254_P) for _ in range(3)]
    jh, jcarry = JGI.phase1_init_device(a["indices"], a["values"], a["f3"],
                                        [J.Fr(x) for x in a["g"]], 3)
    h, carry = GI.phase1_init_device(a["indices"], a["values"], a["f3"],
                                     [T.Fr(x) for x in a["g"]], 3, device="cpu")
    out["phase_inits_dim3"] = {
        "port": [_mont_ints(h), _mont_ints(GI.phase2_init_device(carry, [T.Fr(x) for x in u], 3))],
        "jax": [[x % BN254_P for x in _mont_ints(np.asarray(t))] for t in (
            jh, JGI.phase2_init_device(jcarry, [J.Fr(x) for x in u], 3))]}

    # GKR dim 9 with 3 x 2^9 colliding f1 entries: segment sums whose low
    # 256 bits pass 3p, which two conditional subtractions (the JAX
    # package's limb `reduce_wide`) leave non-strict under BN254. The port
    # is held to the JAX package's naive engine (`sumcheck_tpu.portable`,
    # plain integers) here: the JAX host engine's proof differs from it
    # (ROADMAP section 3).
    from sumcheck_tpu import portable as JP

    a = _gkr_arrays(9, 3 << 9, 9)
    jbn = J.get_field("bn254_fr")
    jf1, jf2, jf3, jg = jgkr(a)
    naive = JP.gkr_prove(
        J.Blake2b512Rng.setup(),
        J.PortableSparseMLE(jbn, 27, {int(i): jbn.el(v) for i, v in zip(
            a["indices"], [J.Fr.from_mont(x).v for x in _mont_ints(a["values"])])}),
        J.PortableDenseMLE.from_evaluations(jbn, 9, [jf2[i].v for i in range(1 << 9)]),
        J.PortableDenseMLE.from_evaluations(jbn, 9, [jf3[i].v for i in range(1 << 9)]), jg)
    for path in GKR_PATHS:
        set_path(path)
        rng = _Recorder(T.Blake2b512Rng.setup()) if path == "host" else T.Blake2b512Rng.setup()
        proof = T.GKRRoundSumcheck.prove(rng, *_port_gkr(a), device="cpu")
        out[f"gkr_dim9_colliding_{path}"] = {
            "port": proof.serialize_uncompressed().hex(),
            "jax": naive.serialize_uncompressed().hex()}
    set_path("generic")
    from sumcheck_tpu_torch.fields import limbs_np as TL
    from sumcheck_tpu_torch.fields import limbs_torch as LT

    wide = [(1 << 256) - 1, 3 * BN254_P, 5 * BN254_P + 7, (1 << 320) - 1, 4 * BN254_P - 1]
    wide += [random.Random(1).randrange(1 << 320) for _ in range(27)]
    digits = np.array([[(v >> (16 * d)) & 0xFFFF for v in wide] for d in range(20)],
                      dtype=np.uint32)
    out["reduce_wide"] = {
        "port": [_mont_ints(TL.reduce_wide(digits)),
                 _mont_ints(LT.reduce_wide(torch.from_numpy(digits.astype(np.int64))).numpy())],
        "jax": [[v % BN254_P for v in wide]] * 2}

    batch = _batch_arrays(7, 4, 6)
    alone = [j_ml(jpoly(a)) for a in batch]
    for path in ("generic", "persize"):
        set_path(path)
        rngs = [T.Blake2b512Rng.setup() for _ in batch]
        proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
            rngs, [_port_poly(a) for a in batch], device="cpu")
        out[f"batch_ml_{path}"] = {
            "port": [{"proof": serialize_proof(p).hex(), "state": _state(r),
                      "randomness": [x.v for x in rs]}
                     for p, rs, r in zip(proofs, challenges, rngs)],
            "jax": alone}
    set_path("generic")
    batch = _batch_arrays(8, 3, 5)  # F3: one instance's product [2, 0] has the coefficient 0
    batch[1]["products"][1] = (0, batch[1]["products"][1][1])
    rngs = [T.Blake2b512Rng.setup() for _ in batch]
    proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
        rngs, [_port_poly(a) for a in batch], device="cpu")
    out["batch_ml_zero_coefficient"] = {
        "port": [{"proof": serialize_proof(p).hex(), "state": _state(r),
                  "randomness": [x.v for x in rs]} for p, rs, r in zip(proofs, challenges, rngs)],
        "jax": [j_ml(jpoly(a)) for a in batch]}
    gkrs = [_gkr_arrays(4, 16, 40 + b) for b in range(2)]
    rngs = [T.Blake2b512Rng.setup() for _ in gkrs]
    insts = [_port_gkr(a) for a in gkrs]
    proofs = BatchedGKRRoundSumcheck.prove(rngs, *map(list, zip(*insts)), device="cpu")
    out["batch_gkr_generic"] = {
        "port": [{"proof": p.serialize_uncompressed().hex(), "state": _state(r)}
                 for p, r in zip(proofs, rngs)],
        "jax": [j_gkr(jgkr(a)) for a in gkrs]}

    # the golden fixture: re-derived through the JAX package, and proved by the port
    fx = make_fixture()
    with open(FIXTURE) as f:
        committed = json.load(f)
    out["fixture_rederived"] = {"port": committed, "jax": fx}
    for path in ML_PATHS:
        set_path(path)
        rng = _Recorder(T.Blake2b512Rng.setup()) if path == "host" else T.Blake2b512Rng.setup()
        proof, state = T.MLSumcheck.prove_as_subprotocol(rng, fixture_ml(T, fx["ml"]),
                                                         device="cpu")
        out[f"fixture_ml_{path}"] = {
            "port": [serialize_proof(proof).hex(), [format(r.v, "064x") for r in state.randomness]],
            "jax": [fx["ml"]["proof_bytes"], fx["ml"]["challenges"]]}
    for path in GKR_PATHS:
        set_path(path)
        rng = _Recorder(T.Blake2b512Rng.setup()) if path == "host" else T.Blake2b512Rng.setup()
        proof = T.GKRRoundSumcheck.prove(rng, *fixture_gkr(T, fx["gkr"]), device="cpu")
        out[f"fixture_gkr_{path}"] = {
            "port": [_hexes(proof.phase1_sumcheck_msgs), _hexes(proof.phase2_sumcheck_msgs)],
            "jax": [fx["gkr"]["phase1_msgs"], fx["gkr"]["phase2_msgs"]]}
    set_path("generic")
    rng = T.Blake2b512Rng.setup()
    rng.feed_bytes(FR_RAND_SEED)
    out["fixture_fr_rand"] = {"port": [format(T.Fr.rand(rng).v, "064x")
                                       for _ in range(FR_RAND_DRAWS)],
                              "jax": fx["fr_rand"]["draws_canonical"]}

    for size, (ctx, tmp, cases) in spawns.items():
        while not ctx.join():  # raises if a rank failed
            pass
        ranks = []
        for r in range(size):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ref_batch = [j_ml(jpoly(a)) for a in cases["batch"]]
        ref = {"ml": j_ml(jpoly(cases["ml"])), "gkr": j_gkr(jgkr(cases["gkr"])),
               "sp": j_ml(jpoly(cases["ml"])),
               "batch": {"proofs": [e["proof"] for e in ref_batch],
                         "challenges": [e["randomness"] for e in ref_batch],
                         "states": [e["state"] for e in ref_batch]}}
        for name in ("ml", "gkr", "batch", "sp"):
            out[f"sharded_{name}_s{size}"] = {"port": [rk[name] for rk in ranks],
                                              "jax": [ref[name]] * size}
        out[f"sharded_ranks_s{size}"] = {
            "port": [[rk["field"], rk["jax_imported"]] for rk in ranks],
            "jax": [["bn254_fr", []]] * size}
    with open(out_path, "w") as f:
        json.dump(out, f)


class _Recorder:
    """A transcript other than `Blake2b512Rng` with the same bytes: the
    provers take their host loops over it."""

    def __init__(self, inner):
        self.inner = inner

    def feed(self, msg):
        self.inner.feed(msg)

    def next_u64(self):
        return self.inner.next_u64()


CASES = (
    ["constants"]
    + [f"ml_nv{nv}_{p}" for nv in (6, 8) for p in ML_PATHS + ("verify",)]
    + [f"f4_{name}_{p}" for name in F4_BN254 for p in ML_PATHS]
    + [f"gkr_dim{d}_{p}" for d in (4, 5) for p in GKR_PATHS + ("verify",)]
    + [f"gkr_dim9_colliding_{p}" for p in GKR_PATHS] + ["reduce_wide"]
    + ["batch_ml_generic", "batch_ml_persize", "batch_gkr_generic", "batch_ml_zero_coefficient"]
    + ["fixture_rederived"] + [f"fixture_ml_{p}" for p in ML_PATHS]
    + [f"fixture_gkr_{p}" for p in GKR_PATHS] + ["fixture_fr_rand"]
    + [f"sharded_{name}_s{size}" for size in SHARDS
       for name in ("ml", "gkr", "batch", "sp", "ranks")]
    + ["interactive_ml_nv6", "phase_inits_dim3"]
    + [f"interactive_zero_coefficient_nv{nv}" for nv in (3, 10)]
)


def bn254_env() -> dict:
    env = dict(os.environ)
    env.update(SUMCHECK_TPU_FIELD="bn254_fr", JAX_PLATFORMS="cpu")
    return env


def child_outcomes(test_file: str, tmp, select: str, *args: str) -> dict[str, str]:
    """Run `test_file`'s tests selected by `-k select` in a child pytest
    under `SUMCHECK_TPU_FIELD=bn254_fr` (no conftest: the port's files need
    none); {test name with its parameters: "passed", or the outcome and its
    message}. Other test files use it to run their cases under BN254."""
    import xml.etree.ElementTree as ET

    xml = os.path.join(str(tmp), "junit.xml")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-k", select, f"--junitxml={xml}", *args, test_file],
        capture_output=True, text=True, timeout=900, env=bn254_env(), cwd=REPO)
    assert os.path.exists(xml), proc.stdout[-3000:] + proc.stderr[-3000:]
    out = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[case.get("name")] = ("passed" if not bad else
                                 f"{bad[0].tag}: {(bad[0].get('message') or '')[:2000]}")
    assert out, proc.stdout[-3000:] + proc.stderr[-3000:]
    return out


def outcomes_of(outcomes: dict[str, str], name: str) -> dict[str, str]:
    """The child's cases of test function `name`, each with its outcome."""
    return {k: v for k, v in outcomes.items() if k.split("[")[0] == name}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn254") / "results.json"
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {TESTS!r}); "
         f"import test_torch_field as m; m.child({str(out)!r})"],
        capture_output=True, text=True, timeout=600, env=bn254_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES)
def test_bn254_port_equals_jax(results, case):
    got = results[case]
    assert got["port"] == got["jax"]
    if case == "constants":
        assert got["port"] == got["expected"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: SUMCHECK_TPU_FIELD=bn254_fr JAX_PLATFORMS=cpu "
                 "python tests/test_torch_field.py --write")
    sys.path.insert(0, REPO)
    with open(FIXTURE, "w") as f:
        json.dump(make_fixture(), f, indent=1)
        f.write("\n")
