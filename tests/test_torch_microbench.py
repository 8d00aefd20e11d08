"""The port's microbench and GKR stage profile (`sumcheck_tpu_torch/
microbench.py`) on the CPU, at nv=8.

- `python -m sumcheck_tpu_torch.microbench 8 --device cpu` reports every
  probe and every stage, each probe's output check passed, and no device
  number (the CPU measures only host walls).
- The probes' ops equal their JAX counterparts on the same inputs:
  `gkr_init._eq_table`, `_segment_reduce_sorted` and `limbs_jnp.mont_mul`
  (and the even/odd multiply's plain version), and the GKR init kernels'
  probes (their plain versions here) the JAX package's `_weight_fold`,
  `_segment_reduce_sorted` and `mont_mul` on the same inputs; the prefix
  stages' tables
  h_g and f1(g, u, .) equal the JAX package's phase inits at phase 1's
  challenges (the eq table and the stages at dim 4: the JAX package
  compiles its inits per dim). Tolerance 0: the field arithmetic is exact.
- The default device is the card.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from sumcheck_tpu_torch import microbench as MB

NV = 8
JAX_NV = 4  # the JAX parity cases' size: the JAX package's inits compile per dim on the CPU


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    path = tmp_path_factory.mktemp("microbench") / "out.json"
    assert MB.main([str(NV), "--device", "cpu", "--reps", "1", "--out", str(path)]) == 0
    with open(path) as f:
        return json.load(f)


def test_every_probe_and_stage_on_the_cpu(report):
    assert report["nv"] == NV and report["device"] == "cpu" and report["card"] is None
    assert tuple(report["probes"]) == MB.PROBES
    assert tuple(report["stages"]) == MB.STAGES
    for name, res in {**report["probes"], **report["stages"]}.items():
        assert res["host_ms"] > 0, name
        for key in ("device_ms", "launches", "copies", "busy_ms", "bound_ms"):
            assert res[key] is None, (name, key)
    assert all(res["ok"] for res in report["probes"].values())


def test_busy_ms_is_the_union_of_intervals():
    """Overlapping and nested device records count once, gaps not at all."""
    events = [(10.0, 30.0, "b"), (0.0, 20.0, "a"), (12.0, 15.0, "c"), (50.0, 60.0, "Memcpy")]
    assert MB.busy_ms(events) == pytest.approx(0.040)
    assert MB.busy_ms([]) == 0
    assert [MB.is_copy(n) for _s, _e, n in events] == [False, False, False, True]


def test_random_tables_are_strict_and_below_p():
    """The one table generator (`limbs_np.random_tables`): strict 16-bit
    digits, the top one shifted below p, the same draws for the same seed."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P, SHAVE_BITS

    tables = L.random_tables(np.random.default_rng(5), 6, 3)
    assert [t.shape for t in tables] == [(16, 64)] * 3
    assert all(t.dtype == np.uint32 and int(t.max()) < 1 << 16 for t in tables)
    assert all(int(t[15].max()) < 1 << (15 - SHAVE_BITS) for t in tables)
    assert all(v < P for t in tables for v in L.to_ints(t, mont=False))
    again = L.random_tables(np.random.default_rng(5), 6, 3)
    assert all(np.array_equal(a, b) for a, b in zip(tables, again))


def test_kernel_probes_and_stage_launches_on_the_cpu(report):
    """The GKR init kernels' probes ran and passed their checks (against
    their plain versions); the stages' kernel launches are null on the CPU,
    where no kernel launches."""
    for name in ("weight_reduce", "pair_slots"):
        assert report["probes"][name]["ok"] and report["probes"][name]["host_ms"] > 0, name
    assert all(report["stages"][s]["kernels"] is None for s in MB.STAGES)
    assert MB.kernel_launches(lambda: None) == {}


def test_stage_work_is_cumulative(report):
    """Each prefix does at least the work of the one before it; the full
    prove's is the last prefix's (the fetch moves no table)."""
    works = [report["stages"][s]["work"] for s in MB.STAGES]
    for before, after in zip(works, works[1:]):
        assert after["bytes"] >= before["bytes"] > 0
        assert after["imads"] >= before["imads"] > 0
    assert works[-1] == works[-2]


@pytest.fixture(scope="module")
def inputs():
    return MB.probe_inputs(NV)


def test_eq_build_matches_jax():
    import jax.numpy as jnp
    from sumcheck_tpu.ops import gkr_init as JGI

    from sumcheck_tpu_torch.ops import gkr_init as GI

    inputs = MB.probe_inputs(JAX_NV)
    want = JGI._eq_table(jnp.asarray(inputs["r_pts"]), jnp.asarray(inputs["omr_pts"]), JAX_NV)
    got = GI._eq_table(torch.from_numpy(inputs["r_pts"].astype(np.int64)),
                       torch.from_numpy(inputs["omr_pts"].astype(np.int64)), JAX_NV)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segreduce_matches_jax(inputs):
    import jax.numpy as jnp
    from sumcheck_tpu.ops import gkr_init as JGI

    from sumcheck_tpu_torch.ops import gkr_init as GI

    want = JGI._segment_reduce_sorted(jnp.asarray(inputs["a"]),
                                      jnp.asarray(inputs["perm"].astype(np.int32)),
                                      jnp.asarray(inputs["last"].astype(np.int32)))
    got = GI._segment_reduce_sorted(*(torch.from_numpy(inputs[k].astype(np.int64))
                                      for k in ("a", "perm", "last")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mont_nnz_matches_jax(inputs):
    """`limbs_torch.mont_mul` and the even/odd multiply's plain version (on
    32-bit limbs) both equal `limbs_jnp.mont_mul`."""
    import jax.numpy as jnp
    from sumcheck_tpu.fields import limbs_jnp as LJ

    from sumcheck_tpu_torch.fields import limbs_torch as LT

    a, b = inputs["a"], inputs["b"]
    want = np.asarray(LJ.mont_mul(jnp.asarray(a), jnp.asarray(b)))
    got = LT.mont_mul(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    eo = MB.mont_mul_eo(torch.from_numpy(MB._limbs(a)), torch.from_numpy(MB._limbs(b)))
    assert eo.dtype == torch.int32 and eo.shape == (1 << NV, 8)
    np.testing.assert_array_equal(MB._digits(eo.numpy()), want)


def test_kernel_probes_match_jax():
    """At dim JAX_NV, on the probes' inputs: the weight reduce's probe (eq
    half tables, phase 1's f3 gather at random lanes, the carry through a
    permutation) gives the carry equal to the JAX package's `_weight_fold`
    and sums equal to its `_segment_reduce_sorted` of the weights times
    the gathered f3 (mod p: under BN254 its `reduce_wide` may leave a sum
    past 3p unreduced), and the pair slots' probe its stacking and multiply
    by the scalar."""
    import jax
    import jax.numpy as jnp
    from sumcheck_tpu.fields import limbs_jnp as LJ
    from sumcheck_tpu.ops import gkr_init as JGI

    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    x = MB.probe_inputs(JAX_NV)
    probes = MB.kernel_probes(x, torch.device("cpu"))
    carry = probes["weight_reduce"][0]()
    with jax.disable_jit():
        jw = JGI._weight_fold(jnp.asarray(x["idx"].astype(np.int32)), jnp.asarray(x["a"]),
                              jnp.asarray(x["r_pts"]), jnp.asarray(x["omr_pts"]), JAX_NV)
        jwv = LJ.mont_mul(jw, jnp.asarray(x["b"][:, x["idx"]]))
        jseg = JGI._segment_reduce_sorted(jwv, None, jnp.asarray(x["last"].astype(np.int32)))
        jscaled = LJ.mont_mul(jnp.asarray(x["b"]), jnp.asarray(x["r_pts"][0]))
    np.testing.assert_array_equal(L.unpack_limbs(carry.numpy(), axis=1)[x["to_y"]].T,
                                  np.asarray(jw))
    for _fn, check, _work in probes.values():
        check()  # each against its plain version
    got = torch.empty((8, 1 << JAX_NV), dtype=torch.int32)
    GK.weight_reduce(torch.from_numpy(x["idx"].astype(np.int32)),
                     torch.from_numpy(MB._limbs(x["a"])),
                     torch.from_numpy(x["r_pts"][:, :, 0].astype(np.int32)),
                     JAX_NV, torch.from_numpy(x["last"].astype(np.int32)),
                     GK.upload_plan(x["last"], 1 << JAX_NV, "cpu"), got,
                     torch.from_numpy(L.pack_limbs(x["b"])),
                     torch.from_numpy(x["idx"].astype(np.int32)),
                     torch.from_numpy(x["to_y"].astype(np.int32)))
    digits = L.unpack_limbs(got.numpy())
    assert int(digits.max()) < 1 << 16 and L.to_ints(digits, mont=False) == \
        L.to_ints(np.asarray(jseg), mont=False)
    assert all(int.from_bytes(digits[:, j].astype("<u2").tobytes(), "little") < P
               for j in range(digits.shape[1]))
    lo = torch.empty((2, 8, 1 << (JAX_NV - 1)), dtype=torch.int32)
    hi = torch.empty_like(lo)
    GK.pair_slots(lo, hi, ((0, torch.from_numpy(L.pack_limbs(x["a"])), None),
                           (1, torch.from_numpy(L.pack_limbs(x["b"])),
                            torch.from_numpy(x["r_pts"][:, :, 0].astype(np.int32))[0])))
    slot1 = L.unpack_limbs(torch.cat([lo[1], hi[1]], dim=1).numpy())
    np.testing.assert_array_equal(slot1, np.asarray(jscaled))


def test_limb_layout_round_trips(inputs):
    np.testing.assert_array_equal(MB._digits(MB._limbs(inputs["a"])), inputs["a"])


def test_stage_tables_match_jax():
    """h_g of `upto_phase1` and f1(g, u, .) of `upto_phase2` on the bench's
    instance equal the JAX package's device inits, at the challenges u of
    the stages' own phase-1 rounds."""
    import sumcheck_tpu as J
    from sumcheck_tpu.ops import gkr_init as JGI

    f1, f2, f3, g = inst = MB.gkr_instance(JAX_NV)
    got = MB.stage_tables(inst, "cpu")
    jg = [J.Fr(x.v) for x in g]
    h, carry = JGI.phase1_init_device(f1.indices, f1.values, f3.evals, jg, JAX_NV)
    np.testing.assert_array_equal(got["h_g"], np.asarray(h))
    f1gu = JGI.phase2_init_device(carry, [J.Fr(v) for v in got["u"]], JAX_NV)
    np.testing.assert_array_equal(got["f1_gu"], np.asarray(f1gu))


def test_compressions_model():
    """One d=2 step from an empty block: 104 fed bytes, then four draws,
    each a finalizing compression and 64 re-absorbed bytes (two full
    blocks compressed on the way); a rejected draw adds four more draws."""
    assert MB.compressions(0, 3, 1) == (6, 104)
    assert MB.compressions(0, 3, 2) == (6 + 4 + 2, 104)


def test_microbench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MB.run(NV)
