"""The codec's fixed parameters as device tensors.

The codec has no learned weights.  Its parameters are the Annex K
quantisation and Huffman tables (jpezy_tpu/core/tables.py), the 64x64 DCT
bases (ops/dct.py), the integer forward DCT that the fDCT kernel computes
and its three 8-bit digits (FDCT_INT, FDCT_DIGITS, host memory), the 8x8
cosine and normalisation tables of the separable forward DCT that its
first design computed (their masters here), the float64 ordered-sum term
tables of the oracle (jpezy_tpu/codec/oracle.py) and the float64 factors
of those terms that the exact-mode kernels take (EXACT_TABLES, host
memory).  The other numpy masters stay in those jax-free modules; this
module places them on a device, once per (device, quality).  Callers treat the returned tensors as read-only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .codec import oracle as _o
from .core import tables as T
from .device import resolve
from .ops.dct import _FWD64, _INV64


def _separable_masters() -> tuple[np.ndarray, np.ndarray]:
    """float64 masters of the separable forward DCT: COS[v, x] =
    cos((2x + 1) v pi / 16), unnormalised (row 0 is 1), and SCALE[u, v] =
    c_u c_v / 4 with c_0 = 1/sqrt(2).  In float32 SCALE[0, 0] is 0.125
    exactly, so a DC coefficient (an integer sum times 0.125) is exact;
    folding c_u / 2 into each pass's table instead would not be."""
    v = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    cos = np.cos((2.0 * x + 1.0) * v * np.pi / 16.0)
    c = np.ones(8, dtype=np.float64)
    c[0] = 1.0 / np.sqrt(2.0)
    return cos, np.outer(c, c) / 4.0


FDCT_COS, FDCT_SCALE = _separable_masters()

# The integer forward DCT's fixed point: W_int = round(W 2^FDCT_INT_SHIFT)
FDCT_INT_SHIFT = 24


def _integer_masters() -> tuple[np.ndarray, np.ndarray]:
    """The integer forward DCT that the fDCT kernel computes on the tensor
    cores: W_INT[s][k] = round(W[s][k] 2^24) (int64 [64, 64], sample s =
    8 y + x, coefficient k = 8 u + v, W the float64 forward basis with its
    normalisation c_u c_v / 4), and its three balanced signed 8-bit digits
    DIGITS [3, 64, 64] int8 with W_INT = d0 + 2^8 d1 + 2^16 d2 exactly.
    |W_INT| < 2^22 (the DC column is 2^21 exactly), so the digits lie
    within +-122, +-119 and +-62, and a block's product with one digit is
    an exact int32 sum below 64 * 128 * 128 = 2^20 in magnitude."""
    w = np.round(_FWD64.T * float(1 << FDCT_INT_SHIFT)).astype(np.int64)
    d0 = (w + 128) % 256 - 128
    w1 = (w - d0) // 256
    d1 = (w1 + 128) % 256 - 128
    d2 = (w1 - d1) // 256
    return w, np.stack([d0, d1, d2]).astype(np.int8)


FDCT_INT, FDCT_DIGITS = _integer_masters()


def _exact_masters() -> np.ndarray:
    """The float64 tables of the exact-mode kernels
    (csrc/exact_transforms.cu), one host array of 136: COS[u][x] = cos((2x
    + 1) u pi / 16) (64, u * 8 + x), cu (8: 1/sqrt(2), then 1) and cucv[k]
    = fl(cu[u] cv[v]) (64, k = 8 v + u), all computed by numpy on the host
    as the oracle computes them.  The oracle's term tables are products of
    no two of them: fwd_c1[k, 8i + j] = COS[j][k % 8], fwd_c2[k, 8i + j] =
    COS[i][k // 8], inv_c1[k, 8y + x] = COS[k % 8][x], inv_c2[k, 8y + x] =
    COS[k // 8][y] (tests/test_torch_exact.py holds them equal bit for
    bit), so a kernel that reads the factors makes the oracle's roundings."""
    cos = _o.cos_table()
    cu = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)
    cucv = np.array([cu[k % 8] * cu[k // 8] for k in range(64)])
    return np.ascontiguousarray(np.concatenate([cos.ravel(), cu, cucv]),
                                np.float64)


EXACT_TABLES = _exact_masters()
EXACT_COS = EXACT_TABLES[:64].reshape(8, 8)
EXACT_CU = EXACT_TABLES[64:72]
EXACT_CUCV = EXACT_TABLES[72:]


@functools.lru_cache(maxsize=32)
def _build(device: torch.device, quality: int | None) -> dict:
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yqt, cqt = (T.scale_quant_tables(quality) if quality is not None
                else (T.Y_QUANT, T.C_QUANT))
    i64, i32, f32, f64 = torch.int64, torch.int32, torch.float32, torch.float64
    return {
        "zigzag": t(T.ZIGZAG, i64),
        "y_quant": t(yqt, i32),
        "c_quant": t(cqt, i32),
        "y_dc_size": t(T.Y_DC_SIZE, i64),
        "y_dc_code": t(T.Y_DC_CODE, i64),
        "y_ac_size": t(T.Y_AC_SIZE, i64),
        "y_ac_code": t(T.Y_AC_CODE, i64),
        "c_dc_size": t(T.C_DC_SIZE, i64),
        "c_dc_code": t(T.C_DC_CODE, i64),
        "c_ac_size": t(T.C_AC_SIZE, i64),
        "c_ac_code": t(T.C_AC_CODE, i64),
        "fwd64_f32": t(_FWD64, f32),
        "inv64_f32": t(_INV64, f32),
        "fdct_cos_f32": t(FDCT_COS, f32),
        "fdct_scale_f32": t(FDCT_SCALE, f32),
        "fwd_c1": t(_o._FWD_C1, f64),
        "fwd_c2": t(_o._FWD_C2, f64),
        "cu_j": t(_o._CU_J, f64),
        "inv_cucv": t(_o._INV_CUCV, f64),
        "inv_c1": t(_o._INV_C1, f64),
        "inv_c2": t(_o._INV_C2, f64),
    }


def codec_constants(device: str | torch.device = "cuda",
                    quality: int | None = None) -> dict[str, torch.Tensor]:
    """Annex K tables, DCT bases and ordered-sum term tables on `device`.

    quality (extension): libjpeg-style scaling of the quant tables
    (core.tables.scale_quant_tables); None = the fixed Annex K tables.
    """
    return _build(resolve(device), quality)
