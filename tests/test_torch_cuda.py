"""The CUDA round kernels on the card: each against its plain PyTorch
version, and a prove through `device="cuda"` against `device="cpu"`.

Marked `cuda`; every test skips without a CUDA device. This file imports
no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance 0: exact field arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sumcheck_tpu_torch as T
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import round_cuda as RC

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(seed: int, nv: int, count: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def _pair(seed, slots, nv, device):
    t = np.stack(_tables(seed, nv, slots)).astype(np.int32)
    half = 1 << (nv - 1)
    lo = torch.from_numpy(np.ascontiguousarray(t[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(t[:, :, half:])).to(device)
    return lo, hi


@pytest.mark.parametrize("extent", [1, 2, 3, 127, 128, 129, 1 << 10])
@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
def test_kernel_matches_plain(cuda, fold, extent):
    products = ((0, 1, 2), (3, 4, 5))
    lo, hi = _pair(extent, 6, 12, cuda)
    if fold and 2 * extent > lo.shape[2]:
        extent //= 2
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(cuda)
    lo_p, hi_p = lo.clone(), hi.clone()
    if fold:
        got = RC.round_fold(lo, hi, r, products, 3, extent)
        want = RC.round_fold_ref(lo_p, hi_p, r, products, 3, extent)
    else:
        got = RC.round_nofold(lo, hi, products, 3, extent)
        want = RC.round_nofold_ref(lo_p, hi_p, products, 3, extent)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


@pytest.mark.parametrize("slots", [1, 9, 16])
def test_kernel_slot_counts(cuda, slots):
    """From one slot up to the kernel's maximum (dynamic shared memory
    beyond 48 KB per block)."""
    products = (tuple(range(slots))[:4],) if slots >= 4 else ((0,) * 2,)
    degree = len(products[0])
    lo, hi = _pair(slots, slots, 10, cuda)
    r = torch.from_numpy(L.mont_scalar(5)[:, 0].astype(np.int32)).to(cuda)
    lo_p, hi_p = lo.clone(), hi.clone()
    got = RC.round_fold(lo, hi, r, products, degree, 200)
    want = RC.round_fold_ref(lo_p, hi_p, r, products, degree, 200)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


def test_prove_on_cuda_equals_cpu(cuda):
    nv = 12
    tables = _tables(7, nv, 5)
    poly = polynomial_from_numpy(nv, tables, [(5, [0, 1, 2]), (1, [0, 3]), (9, [4, 0, 4, 1])])
    before = (RC.round_nofold.launches, RC.round_fold.launches)
    proof = T.MLSumcheck.prove(poly, device=cuda)
    after = (RC.round_nofold.launches, RC.round_fold.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, nv - 1)
    assert serialize_proof(proof) == serialize_proof(T.MLSumcheck.prove(poly, device="cpu"))
    sub = T.MLSumcheck.verify(poly.info(), T.MLSumcheck.extract_sum(proof), proof)
    assert poly.evaluate(sub.point) == sub.expected_evaluation
