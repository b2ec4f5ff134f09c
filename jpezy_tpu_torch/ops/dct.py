"""8x8 DCT-II / IDCT as [B, 64] @ [64, 64] products (torch).

Counterpart of jpezy_tpu/ops/dct.py.  float32 is the fast path
(torch.matmul at IEEE float32; device.check_fp32_precision refuses TF32).
float64 reproduces the reference's double-precision int() truncation with
the oracle's exact term and accumulation order, built from separate
multiply and add ops (no fused multiply-add), so `precision="exact"` stays
bit-identical to the oracle.

These ordered float64 forms are the plain versions of exact mode: the
CPU's route and the reference the card is held to.  On CUDA tensors the
codec runs them as hand-written kernels that make the same roundings
(ops/block_transform.py: fdct_quantize_exact, idct_planes_exact;
csrc/exact_transforms.cu), and no CUDA path of the codec calls them here.
"""
from __future__ import annotations

import numpy as np
import torch


def _basis64() -> tuple[np.ndarray, np.ndarray]:
    """Forward and inverse 64x64 DCT matrices (float64 masters).

    A copy of jpezy_tpu.ops.dct._basis64 (that module imports jax);
    tests/test_torch_ops.py asserts the two are equal."""
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    cos = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)  # COS[u, x]
    c = np.ones(8, dtype=np.float64)
    c[0] = 1.0 / np.sqrt(2.0)
    scale = np.outer(c, c) / 4.0  # cu*cv/4

    # forward: D[u,v] = scale[u,v] * sum_{y,x} X[y,x] COS[u,y] COS[v,x]
    fwd = np.einsum("uy,vx->uvyx", cos, cos) * scale[:, :, None, None]
    fwd = fwd.reshape(64, 64)
    # inverse: S[y,x] = sum_{v,u} scale[v,u] * D[v,u] COS[v,y] COS[u,x]
    inv = np.einsum("vy,ux->yxvu", cos, cos) * scale[None, None, :, :]
    inv = inv.reshape(64, 64)
    return fwd, inv


_FWD64, _INV64 = _basis64()


def _consts(device: torch.device) -> dict:
    from ..constants import codec_constants

    return codec_constants(device)


def forward_dct(blocks: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, 64] int spatial blocks -> [B, 64] int32 DCT coefficients.

    Truncation toward zero matches the reference's `int(sum * cu*cv / 4)`;
    float64 uses the reference's exact term and accumulation order."""
    if dtype == torch.float64:
        return _forward_dct_ordered(blocks)
    if dtype != torch.float32:
        raise ValueError(f"forward_dct: unsupported dtype {dtype}")
    m = _consts(blocks.device)["fwd64_f32"]
    return torch.matmul(blocks.to(torch.float32), m.T).to(torch.int32)


def _forward_dct_ordered(blocks: torch.Tensor) -> torch.Tensor:
    c = _consts(blocks.device)
    c1, c2, cu = c["fwd_c1"], c["fwd_c2"], c["cu_j"]
    pic = blocks.to(torch.float64)
    s = torch.zeros(pic.shape, dtype=torch.float64, device=pic.device)
    for k in range(64):
        s = s + torch.mul(torch.mul(pic[:, k:k + 1], c1[k][None, :]),
                          c2[k][None, :])
    s = s.reshape(-1, 8, 8)
    res = torch.mul(torch.mul(s, cu[None, None, :]), cu[None, :, None]) / 4.0
    return res.reshape(-1, 64).to(torch.int32)


def inverse_dct(coeffs: torch.Tensor, level_shift: int = 128,
                dtype=torch.float32) -> torch.Tensor:
    """[B, 64] dequantized int coefficients -> [B, 64] int32 samples.

    Matches `int(sum/4 + sl)` of the reference decoder (sl = 128 for
    8-bit); float64 replicates the reference's accumulation order."""
    if dtype == torch.float64:
        return _inverse_dct_ordered(coeffs, level_shift)
    if dtype != torch.float32:
        raise ValueError(f"inverse_dct: unsupported dtype {dtype}")
    m = _consts(coeffs.device)["inv64_f32"]
    s = torch.matmul(coeffs.to(torch.float32), m.T)
    return (s + float(level_shift)).to(torch.int32)


def _inverse_dct_ordered(coeffs: torch.Tensor,
                         level_shift: int) -> torch.Tensor:
    c = _consts(coeffs.device)
    cucv, c1, c2 = c["inv_cucv"], c["inv_c1"], c["inv_c2"]
    d = coeffs.to(torch.float64)
    s = torch.zeros(d.shape, dtype=torch.float64, device=d.device)
    for k in range(64):
        term = torch.mul(torch.mul(cucv[k] * d[:, k:k + 1], c1[k][None, :]),
                         c2[k][None, :])
        s = s + term
    return (s / 4.0 + float(level_shift)).to(torch.int32)
