"""The port's entry points (`sumcheck_tpu_torch/entry.py`) on the CPU
against the JAX package's `__graft_entry__.py`.

- `entry(device="cpu")`: the folded tables and the round's exact sums equal
  JAX `entry()`'s `fn(*args)` under `jax.jit`, lane by lane; tolerance 0.
- `dryrun_multichip(S, device="cpu")` for S = 2 and 4 (gloo; the two spawns
  run at once, while the parent computes the JAX references): the proofs
  every rank returns equal the JAX package's of the same instances,
  `MLSumcheck.prove` on the host engine, `GKRRoundSumcheck.prove` and
  `BatchedMLSumcheck.prove`.
- Both default to the card, and raise the no-card error here.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sumcheck_tpu_torch import entry as E

SIZES = (2, 4)


def test_entry_matches_jax():
    import jax

    import __graft_entry__ as GE

    fn, args = GE.entry()
    want_folded, want_sums = (np.asarray(a) for a in jax.jit(fn)(*args))
    port_fn, port_args = E.entry(device="cpu")
    folded, sums = port_fn(*port_args)
    assert folded.shape == want_folded.shape == (16, 4, 128)
    np.testing.assert_array_equal(folded.numpy().astype(np.uint32), want_folded)
    np.testing.assert_array_equal(sums, want_sums)
    # the args are not consumed: a second call gives the same round
    again, again_sums = port_fn(*port_args)
    assert torch.equal(again, folded) and np.array_equal(again_sums, sums)


def test_entry_pair_is_the_jax_example():
    """The pair's first four slots are `_example(nv=8)`'s stacked tables in
    natural lane order; slots 4 and 5 are 123 x table 0 and 456 x table 2."""
    from sumcheck_tpu.fields import limbs_np as JL

    import __graft_entry__ as GE

    stacked = np.asarray(GE._example(8)[0])  # (16, 4, 256)
    _fn, (lo, hi, r) = E.entry(device="cpu")
    from sumcheck_tpu_torch.fields.limbs_np import unpack_limbs

    assert lo.shape == (6, 8, 128) and lo.dtype == torch.int32
    pair = unpack_limbs(torch.cat([lo, hi], dim=2).numpy(), axis=1)  # (6, 16, 256)
    np.testing.assert_array_equal(pair[:4], stacked.transpose(1, 0, 2))
    for slot, (src, c) in zip((4, 5), E.ENTRY_SCALED):
        np.testing.assert_array_equal(pair[slot], JL.mont_mul(pair[src], JL.mont_scalar(c)))
    np.testing.assert_array_equal(r.numpy().astype(np.uint32), JL.mont_scalar(789)[:, 0])


def _jax_references(size: int) -> dict:
    """The JAX package's proofs of the dry run's instances at `size` ranks,
    drawn as `__graft_entry__.dryrun_multichip` draws them."""
    import sumcheck_tpu as J
    from sumcheck_tpu.batch import BatchedMLSumcheck
    from sumcheck_tpu.fields.fr import P
    from sumcheck_tpu.ml_sumcheck import serialize_proof
    from sumcheck_tpu.utils.config import get_config

    k = max(1, (size - 1).bit_length())
    cfg = get_config()
    saved, cfg.engine = cfg.engine, "host"
    try:
        nv = k + 3
        rnd = random.Random(0)
        mles = [J.DenseMLE.rand(nv, rnd) for _ in range(3)]
        poly = J.ListOfProductsOfPolynomials(nv)
        poly.add_product([mles[0], mles[1], mles[2]], J.Fr(123))
        poly.add_product([mles[2], mles[0]], J.Fr(456))
        ml = serialize_proof(J.MLSumcheck.prove(poly))

        dim = k + 1
        rnd = random.Random(1)
        f1 = J.SparseMLE.rand_with_config(3 * dim, (1 << dim) - 1, rnd)
        f2, f3 = J.DenseMLE.rand(dim, rnd), J.DenseMLE.rand(dim, rnd)
        g = [J.Fr(rnd.randrange(P)) for _ in range(dim)]
        gkr = J.GKRRoundSumcheck.prove(J.Blake2b512Rng.setup(), f1, f2, f3, g)

        rnd = random.Random(2)
        polys = []
        for _ in range(size):
            mles = [J.DenseMLE.rand(5, rnd) for _ in range(3)]
            p = J.ListOfProductsOfPolynomials(5)
            p.add_product([mles[0], mles[1]], J.Fr(rnd.randrange(P)))
            p.add_product([mles[2], mles[0]], J.Fr(rnd.randrange(P)))
            polys.append(p)
        batch = [serialize_proof(p) for p in BatchedMLSumcheck.prove(polys)]
    finally:
        cfg.engine = saved
    return {"ml": ml, "gkr": gkr.serialize_uncompressed(), "batch": batch}


@pytest.fixture(scope="module")
def dryruns():
    """{S: (the dry run's result, the JAX references)}: both spawns at
    once, in one pool."""
    with ThreadPoolExecutor(len(SIZES)) as pool:
        started = {s: pool.submit(E.dryrun_multichip, s, device="cpu") for s in SIZES}
        refs = {s: _jax_references(s) for s in SIZES}
        return {s: (started[s].result(), refs[s]) for s in SIZES}


@pytest.fixture(params=SIZES, ids=lambda s: f"S{s}")
def dryrun(request, dryruns):
    return (request.param, *dryruns[request.param])


@pytest.mark.parametrize("case", ["ml", "gkr", "batch"])
def test_dryrun_matches_jax(dryrun, case):
    """The ML proof (`ShardedProver`, `ChainedShardedProver` and the single
    device's host-transcript prove agree on every rank), the sharded GKR
    proof and the sharded batch's proofs, byte-equal to the JAX package's."""
    _size, got, want = dryrun
    assert got[case] == want[case]


def test_dryrun_ranks(dryrun):
    """Every rank ran on the CPU in a gloo group, launched no kernel in any
    of the four sharded proves, and made the dry run's all-reduces: per sharded prove one a sharded round
    and one gather (ML twice: `ShardedProver` and the chained prover), the
    batch one gather; and the GKR inits' 2 reduce-scatters, one a phase."""
    size, got, _want = dryrun
    k = max(1, (size - 1).bit_length())
    sigma = size.bit_length() - 1
    ml = 2 * ((k + 3) - sigma + 1)
    gkr = 2 * ((k + 1) - sigma + 1)
    assert got["backend"] == "gloo"
    assert len(got["ranks"]) == size
    for rank in got["ranks"]:
        assert rank["device"] == "cpu"
        assert set(rank["launches"]) == {"sp", "chained", "gkr", "batch"}
        assert not any(n for case in rank["launches"].values() for n in case.values())
        assert rank["collectives"] == ml + gkr + 1
        assert rank["reduce_scatters"] == 2


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(2)


def test_dryrun_backend_rule(monkeypatch):
    """Gloo on the CPU and for ranks that share a card; NCCL where each
    rank has a card of its own."""
    assert E.dryrun_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert E.dryrun_backend(2, "cuda") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert E.dryrun_backend(2, "cuda") == "nccl"
    assert E.dryrun_backend(4, "cuda") == "nccl"
    assert E.dryrun_backend(8, "cuda") == "gloo"
