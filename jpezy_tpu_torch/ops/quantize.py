"""Quantization ops (torch).

Counterpart of jpezy_tpu/ops/quantize.py.  The reference quantizes with C
integer division, which truncates toward zero -- NOT floor division.
`torch.div(..., rounding_mode="trunc")` on integer tensors is exactly that,
so the JAX package's float32-reciprocal-plus-fixups form (a TPU workaround
for slow integer division) is not carried over; both give identical
results on the codec's range (tests/test_torch_ops.py).

``rounded=True`` (extension): round-to-nearest quantization, libjpeg-style.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import codec_constants


def _table(qtable, device) -> torch.Tensor:
    if isinstance(qtable, torch.Tensor):
        return qtable.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(qtable), dtype=torch.int32,
                           device=device)


def quantize(coeffs: torch.Tensor, chroma: bool, *, rounded: bool = False,
             qtable=None) -> torch.Tensor:
    """[B, 64] int DCT coefficients -> [B, 64] int32 quantized values.

    qtable: optional [64] table (numpy or tensor); None = Annex K."""
    if qtable is None:
        qtable = codec_constants(coeffs.device)[
            "c_quant" if chroma else "y_quant"]
    q = _table(qtable, coeffs.device)[None, :]
    c32 = coeffs.to(torch.int32)
    a = c32.abs()
    if rounded:
        c = torch.div(2 * a + q, 2 * q, rounding_mode="trunc")
    else:
        c = torch.div(a, q, rounding_mode="trunc")
    return (torch.sign(c32) * c).to(torch.int32)


def dequantize(coeffs: torch.Tensor, qtable) -> torch.Tensor:
    """Elementwise multiply by the (de-zigzagged) table."""
    return coeffs.to(torch.int32) * _table(qtable, coeffs.device)[None, :]
