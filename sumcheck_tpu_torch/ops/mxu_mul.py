"""Montgomery multiply by one shared scalar as banded 8-bit-digit matrix
products — the port of `sumcheck_tpu/ops/mxu_mul.py`.

Every fold multiplies a whole table by ONE challenge, and the GKR init's eq
doublings and `f2(u)` scaling multiply by one constant each: `a_i * c` with
`c` shared across lanes. With 8-bit digits the product is a convolution of
each lane's digits with the shared digits of `c`,

    a * c = sum_j a8[j] 2^(8j) c  ==>  T[m] = sum_j c8[m - j] a8[j],

a (63, 32) banded matrix times the (32, N) digit matrix. Montgomery
reduction keeps the shape: m = (T mod R) mu mod R and m p are products by
the constant bands of mu = -p^-1 mod 2^256 and p. Carry normalization stays
elementwise.

The products run as `float32` matmuls with a `float32` result, which is
exact: every operand is an integer <= 255 and every dot product sums at most
32 terms < 2^16, so each result is an integer < 32 * 255^2 < 2^21 < 2^24.
(A bf16 result would not be: 2^21 does not fit bf16's mantissa. CUDA has no
int64 matmul, so the integer route is closed on the card.) Carry-chain
accumulators stay < 2^22. Elsewhere the digits are `int64`, as in
`fields/limbs_torch.py`. Results are bit-identical to
`limbs_torch.mont_mul(a, c_column)`.

This module is the plain version of the multiply inside the MXU fold kernel
(`csrc/round_mxu.cu`, `round_cuda.round_fold_mxu`) and, under the MXU fold
mode (`utils/config.py`), the GKR init's shared-scalar multiply, which the
JAX package also leaves to XLA's dots outside any kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import limbs_torch as LT
from ..fields.fr import NINV_FULL, NUM_DIGITS, P

_D8 = 2 * NUM_DIGITS  # 32 8-bit digits per element
_W = 2 * _D8 - 1  # 63 wide product digits


def _const8(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (8 * i)) & 0xFF for i in range(n)], np.float32)


def _band_np(c8: np.ndarray, rows: int) -> np.ndarray:
    """(rows, 32) banded convolution matrix: B[m, j] = c8[m - j]."""
    m = np.arange(rows)[:, None] - np.arange(_D8)[None, :]
    out = np.where((m >= 0) & (m < len(c8)), c8[np.clip(m, 0, len(c8) - 1)], 0.0)
    return out.astype(np.float32)


# constant reduction matrices: mu = -p^-1 mod 2^256 (truncated band: the
# product mod R keeps only digit weights < 32), and p (full band)
_MU_BAND = _band_np(_const8(NINV_FULL, _D8), _D8)  # (32, 32)
_P_BAND = _band_np(_const8(P, _D8), _W)  # (63, 32)


@functools.cache
def _bands(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The mu and p bands on `device`, uploaded once per device."""
    return (torch.from_numpy(_MU_BAND).to(device), torch.from_numpy(_P_BAND).to(device))


def _to8(a: torch.Tensor) -> torch.Tensor:
    """(16, N) strict 16-bit digits -> (32, N) 8-bit digits."""
    return torch.stack([a & 0xFF, a >> 8], dim=1).reshape((_D8,) + a.shape[1:])


def _from8(r8: torch.Tensor) -> torch.Tensor:
    """(32, N) strict 8-bit digits -> (16, N) strict 16-bit digits."""
    r = r8.reshape((NUM_DIGITS, 2) + r8.shape[1:])
    return r[:, 0] | (r[:, 1] << 8)


def _chain8(rows, keep_carry: bool):
    """Carry-normalize relaxed 8-bit rows (< 2^22 each); returns (strict
    rows, carry) — carry dropped by callers reducing mod 2^256."""
    out = []
    carry = torch.zeros_like(rows[0])
    for r in rows:
        t = r + carry
        out.append(t & 0xFF)
        carry = t >> 8
    return out, (carry if keep_carry else None)


def _conv(band: torch.Tensor, x8: torch.Tensor) -> torch.Tensor:
    """(W, 32) float32 band @ (32, N) 8-bit digits -> (W, N) int64, exact.
    Raises unless float32 matmuls run in full float32: a TF32 or bf16 pass
    would round the 21-bit sums."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"the banded products need exact float32 matmuls, but "
            f"torch.get_float32_matmul_precision() is {precision!r}, not 'highest'")
    return torch.matmul(band, x8.to(torch.float32)).to(torch.int64)


def mont_mul_band(a, cband, mu_band=None, p_band=None):
    """Core banded Montgomery multiply: a (16, N) strict by the prebuilt
    (63, 32) float32 band of the shared scalar (`scalar_band`). The mu and
    p bands default to the field's, on `a`'s device."""
    if mu_band is None or p_band is None:
        mu_band, p_band = _bands(a.device)
    a8 = _to8(a.long())

    # T = a * c: (63, N) wide digits < 32 * 255^2 < 2^21
    T = _conv(cband, a8)
    # xlo = T mod 2^256 as strict 8-bit digits (the carry past digit 31
    # belongs to T's high half and re-enters through the top rows below)
    xlo_rows, c32 = _chain8(list(T[:_D8]), keep_carry=True)
    # m = xlo * mu mod 2^256 (truncated band), normalized mod R
    m_rows, _ = _chain8(list(_conv(mu_band, torch.stack(xlo_rows))), keep_carry=False)
    # y = T + m * p == 0 mod 2^256; result = y >> 256 < 2p
    mp = _conv(p_band, torch.stack(m_rows))
    # low half: its strict digits are zero by construction, only the carry
    # out of digit 31 survives
    carry = torch.zeros_like(T[0])
    for i in range(_D8):
        carry = (xlo_rows[i] + mp[i] + carry) >> 8
    hi_rows = [T[_D8] + c32 + mp[_D8] + carry] + [T[i] + mp[i] for i in range(_D8 + 1, _W)]
    hi_rows.append(torch.zeros_like(T[0]))  # digit 63: a value < 2p needs 32 digits
    res_rows, _ = _chain8(hi_rows, keep_carry=False)
    return LT.cond_sub_p(_from8(torch.stack(res_rows)))


def scalar_band(c: torch.Tensor) -> torch.Tensor:
    """(16,) strict scalar digits -> its (63, 32) float32 convolution band,
    built on `c`'s device with no host sync."""
    c8 = _to8(c.long().reshape(NUM_DIGITS, 1))[:, 0]  # (32,)
    m = (torch.arange(_W, device=c.device)[:, None]
         - torch.arange(_D8, device=c.device)[None, :])
    take = c8[m.clamp(0, _D8 - 1)]
    return torch.where((m >= 0) & (m < _D8), take, 0).to(torch.float32)


def mont_mul_scalar_mxu(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`a * c * R^-1 mod p` for a (16, ...) strict table and ONE shared
    strict scalar `c` (16,), as banded matrix products; bit-identical to
    `limbs_torch.mont_mul(a, c_column)`."""
    shape = a.shape[1:]
    out = mont_mul_band(a.reshape(NUM_DIGITS, -1), scalar_band(c))
    return out.reshape((NUM_DIGITS,) + tuple(shape))
