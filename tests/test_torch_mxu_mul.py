"""The MXU fold mode of the port against the JAX package: the banded
8-bit-digit multiply (`sumcheck_tpu_torch/ops/mxu_mul.py`), its config
quarantine, the plain version of the tensor-core fold kernel
(`round_cuda.round_fold_mxu_ref`) and a generic-chain prove in the mode.

The same inputs, made from a seed, go through both packages; tolerance 0
(exact integer arithmetic). JAX runs on the CPU; its Pallas kernel
`_kernel_chain_fold_mxu` runs in interpret mode, in a `slow` test, as the
JAX package's own tests run it.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sumcheck_tpu as J
import sumcheck_tpu_torch as T
from sumcheck_tpu.ml_sumcheck import serialize_proof as j_serialize
from sumcheck_tpu.ops import mxu_mul as JM
from sumcheck_tpu.utils.config import get_config as j_get_config
from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.fields.fr import NINV_FULL, P, R_INV
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import mxu_mul as TM
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.utils.config import get_config
from test_torch_prover import both, jax_host_prove

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 255) % P, (1 << 128) % P, (1 << 240) % P]


def _digits(vals) -> np.ndarray:
    """Strict digits of integers taken as they are (no Montgomery map)."""
    return L.from_ints(vals, mont=False)


def _ints(arr) -> list[int]:
    return L.to_ints(np.asarray(arr).astype(np.uint32), mont=False)


@pytest.fixture
def mxu_on(monkeypatch):
    monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
    monkeypatch.setattr(get_config(), "ab", True)


def test_ninv_full_matches_jax():
    from sumcheck_tpu.fields.fr import NINV_FULL as J_NINV_FULL

    assert NINV_FULL == J_NINV_FULL
    assert (P * NINV_FULL + 1) % (1 << 256) == 0


@pytest.mark.parametrize("cv", [0, 1, P - 1, (1 << 240) % P, 0x1234567 ** 5 % P],
                         ids=["0", "1", "p-1", "2^240", "random"])
def test_mont_mul_scalar_mxu_matches_jax_and_integers(cv):
    """Random and edge operands: the port's banded multiply equals JAX's
    `mont_mul_scalar_mxu` and `v * c * R^-1 mod p`."""
    prnd = random.Random(7)
    vals = [prnd.randrange(P) for _ in range(120)] + EDGES
    a = _digits(vals)
    c = _digits([cv])[:, 0]
    got = TM.mont_mul_scalar_mxu(torch.from_numpy(a.astype(np.int64)),
                                 torch.from_numpy(c.astype(np.int64)))
    assert _ints(got.numpy()) == [v * cv * R_INV % P for v in vals]
    want = JM.mont_mul_scalar_mxu(jnp.asarray(a), jnp.asarray(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_mont_mul_band_equals_cios_multidim():
    """(16, U, B) tables, the fold's operand shape, and the band entry point
    with the field's default bands: equal to `limbs_torch.mont_mul`."""
    prnd = random.Random(9)
    vals = [prnd.randrange(P) for _ in range(3 * 8)]
    a = torch.from_numpy(_digits(vals).astype(np.int64)).reshape(16, 3, 8)
    c = torch.from_numpy(L.mont_scalar(prnd.randrange(P))[:, 0].astype(np.int64))
    want = LT.mont_mul(a, c.reshape(16, 1, 1))
    assert torch.equal(TM.mont_mul_scalar_mxu(a, c), want)
    band = TM.mont_mul_band(a.reshape(16, -1), TM.scalar_band(c))
    assert torch.equal(band.reshape(16, 3, 8), want)


def test_inexact_matmul_precision_raises():
    """A float32 matmul precision below 'highest' (TF32 or bf16 passes)
    would round the banded sums: the multiply refuses to run."""
    a = torch.from_numpy(_digits([5, 7]).astype(np.int64))
    c = torch.from_numpy(L.mont_scalar(3)[:, 0].astype(np.int64))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            TM.mont_mul_scalar_mxu(a, c)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert torch.equal(TM.mont_mul_scalar_mxu(a, c), LT.mont_mul(a, c[:, None]))


@pytest.mark.parametrize("cv", [0, 1, P - 1, 0xDEADBEEF ** 7 % P])
def test_scalar_band_matches_jax(cv):
    c = _digits([cv])[:, 0]
    got = TM.scalar_band(torch.from_numpy(c.astype(np.int64)))
    want = np.asarray(JM.scalar_band(jnp.asarray(c)).astype(jnp.float32))
    assert got.dtype == torch.float32 and got.shape == (63, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reduction_bands_match_jax():
    np.testing.assert_array_equal(TM._MU_BAND, JM._MU_BAND.astype(np.float32))
    np.testing.assert_array_equal(TM._P_BAND, JM._P_BAND.astype(np.float32))


def test_mxu_fold_quarantined_without_ab_flag(monkeypatch):
    """The JAX package's quarantine and its error text: a non-off mode
    without SUMCHECK_TPU_AB=1 raises; `auto` is off."""
    cfg = get_config()
    for mode in ("on", "xla", "kernel"):
        monkeypatch.setattr(cfg, "mxu_fold", mode)
        monkeypatch.setattr(cfg, "ab", False)
        with pytest.raises(ValueError, match="SUMCHECK_TPU_AB"):
            cfg.mxu_mode()
        monkeypatch.setattr(cfg, "ab", True)
        assert cfg.mxu_mode() == ("kernel" if mode == "kernel" else "xla")
        assert cfg.use_mxu_fold()
    for mode in ("auto", "off"):
        monkeypatch.setattr(cfg, "mxu_fold", mode)
        assert cfg.mxu_mode() == "off" and not cfg.use_mxu_fold()
    monkeypatch.setattr(cfg, "mxu_fold", "bogus")
    with pytest.raises(ValueError, match="expected off"):
        cfg.mxu_mode()


def test_quarantine_blocks_a_prove(monkeypatch):
    """A prove in a non-off mode without the flag raises before any round."""
    monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
    monkeypatch.setattr(get_config(), "ab", False)
    _, tp = both("2x3", seed=1)
    with pytest.raises(ValueError, match="SUMCHECK_TPU_AB"):
        T.MLSumcheck.prove(tp, device="cpu")


@pytest.mark.parametrize("env", [("", ""), ("kernel", "1"), ("xla", "1"), ("on", "0")])
def test_mxu_env_is_parsed_as_in_jax(env):
    """`SUMCHECK_TPU_MXU_FOLD` and `SUMCHECK_TPU_AB` give both packages the
    same setting and the same resolved mode (or the same error)."""
    fold, ab = env
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("SUMCHECK_TPU_MXU_FOLD", "SUMCHECK_TPU_AB"):
        e.pop(k, None)
    if fold:
        e["SUMCHECK_TPU_MXU_FOLD"] = fold
    if ab:
        e["SUMCHECK_TPU_AB"] = ab
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            from sumcheck_tpu_torch.utils.config import get_config as t
            from sumcheck_tpu.utils.config import get_config as j
            def mode(c):
                try:
                    return c.mxu_mode()
                except ValueError as e:
                    return str(e)
            print(repr([(c.mxu_fold, c.ab, mode(c)) for c in (t(), j())]))
        """)],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    port, ref = eval(proc.stdout.strip())
    assert port == ref


def _pair(seed: int, slots: int, half: int):
    """A random (U, 8, half) limb pair, digits below 2^254 < p."""
    gen = np.random.default_rng(seed)
    d = gen.integers(0, 1 << 16, size=(slots, 16, 2 * half), dtype=np.uint32)
    d[:, 15] >>= 2  # < 2^254 < p
    d = L.pack_limbs(d, axis=1)
    return (torch.from_numpy(np.ascontiguousarray(d[:, :, :half])),
            torch.from_numpy(np.ascontiguousarray(d[:, :, half:])))


@pytest.mark.parametrize("extent", [1, 3, 5, 16])
def test_fold_mxu_ref_equals_fold_ref(extent):
    """The MXU fold's plain version and the CIOS fold's, in place: the
    folded pair and the sums array-equal, lanes past the extent kept."""
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _pair(extent, 6, 32)
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32))
    a, b = (lo.clone(), hi.clone()), (lo.clone(), hi.clone())
    got = RC.round_fold_mxu(*a, r, products, 3, extent)  # CPU pair: the plain version
    want = RC.round_fold_ref(*b, r, products, 3, extent)
    assert torch.equal(got, want)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][:, :, extent:], lo[:, :, extent:])


@pytest.mark.slow
def test_fold_mxu_ref_equals_jax_pallas_kernel():
    """Against `_kernel_chain_fold_mxu` itself (`_build_chain(mxu=True)`,
    interpret mode) at a 16-lane block: the lanes below the active count
    A2 and the block sums. (The Pallas kernel zeroes the lanes at and past
    A2; the port leaves them as they were.)"""
    from sumcheck_tpu.ops.round_pallas import _build_chain

    products, degree, block, a2 = ((0, 1),), 2, 16, 11
    lo, hi = _pair(21, 2, 32)
    r = torch.from_numpy(L.mont_scalar(424242)[:, 0].astype(np.int32))
    fn = _build_chain(block, 2, products, degree, True, block, True, mxu=True)
    u32 = lambda t: jnp.asarray(L.unpack_limbs(t.numpy(), axis=1))  # noqa: E731
    mask = (np.arange(block)[None, :] < a2).astype(np.uint32).repeat(16, axis=0)
    flo, fhi, part = fn(JM.scalar_band(u32(r)), jnp.asarray(mask),
                        u32(lo[:, :, :block]), u32(lo[:, :, a2:a2 + block]),
                        u32(hi[:, :, :block]), u32(hi[:, :, a2:a2 + block]))
    l2, h2 = lo.clone(), hi.clone()
    sums = RC.round_fold_mxu_ref(l2, h2, r, products, degree, a2)
    np.testing.assert_array_equal(L.unpack_limbs(l2[:, :, :a2].numpy(), axis=1),
                                  np.asarray(flo)[:, :, :a2])
    np.testing.assert_array_equal(L.unpack_limbs(h2[:, :, :a2].numpy(), axis=1),
                                  np.asarray(fhi)[:, :, :a2])
    np.testing.assert_array_equal(sums.numpy(), np.asarray(part).astype(np.int64).sum(axis=0))


@pytest.mark.parametrize("shape", ["2x3", "shared_ragged", "single_var"])
def test_generic_prove_in_mxu_mode(shape, mxu_on, monkeypatch):
    """A generic-chain prove with the MXU fold launches the MXU fold in
    every fold round and proves the default mode's bytes, which are the JAX
    host engine's."""
    jp, tp = both(shape, seed=5)
    jproof, _jstate, jrng = jax_host_prove(jp)
    calls = []
    real = RC.round_fold_mxu
    monkeypatch.setattr(RC, "round_fold_mxu", lambda *a: calls.append(1) or real(*a))
    rng = T.Blake2b512Rng.setup()
    proof, state = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert len(calls) == tp.num_variables - 1
    assert serialize_proof(proof) == j_serialize(jproof)
    assert rng.state_tuple() == jrng.state_tuple()
    sub = T.MLSumcheck.verify(tp.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert state.randomness == sub.point


def test_persize_chain_has_no_mxu_branch(mxu_on, monkeypatch):
    """As in the JAX package, the per-size chain ignores the mode."""
    monkeypatch.setattr(get_config(), "chain_impl", "persize")
    monkeypatch.setattr(RC, "round_fold_mxu_ref",
                        lambda *a: pytest.fail("the per-size chain ran the MXU fold"))
    jp, tp = both("2x3", seed=6)
    jproof, _, _ = jax_host_prove(jp)
    assert serialize_proof(T.MLSumcheck.prove(tp, device="cpu")) == j_serialize(jproof)


@pytest.mark.slow
def test_generic_prove_in_mxu_mode_matches_jax_kernel_mode(mxu_on):
    """Against JAX `prove_generic` in kernel mode, which runs
    `_kernel_chain_fold_mxu` in interpret mode (the
    `tests/test_mxu_mul.py:95-111` pattern)."""
    from sumcheck_tpu.protocol.generic_prover import prove_generic

    jp, tp = both("2x3", seed=8)
    cfg = j_get_config()
    saved = (cfg.engine, cfg.mxu_fold, cfg.pallas, cfg.ab)
    try:
        cfg.engine, cfg.mxu_fold, cfg.pallas, cfg.ab = "device", "kernel", "on", True
        jrng = J.Blake2b512Rng.setup()
        jrng.feed(jp.info())
        jproof, _ = prove_generic(jrng, jp, block=16)
    finally:
        cfg.engine, cfg.mxu_fold, cfg.pallas, cfg.ab = saved
    rng = T.Blake2b512Rng.setup()
    proof, _ = T.MLSumcheck.prove_as_subprotocol(rng, tp, device="cpu")
    assert serialize_proof(proof) == j_serialize(jproof)
    assert rng.state_tuple() == jrng.state_tuple()
