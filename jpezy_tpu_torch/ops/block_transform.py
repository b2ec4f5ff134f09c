"""The codec's two block transforms (torch): forward DCT with quantization
on encode, dequantization with the inverse DCT into the packed u8 planes
on decode.

Counterparts of the stages XLA fused on the TPU:
jpezy_tpu/parallel/sharded.py:_quantize_local_ycc (fdct_quantize), and
jpezy_tpu/codec/jax_codec.py:_decode_fused_batch_ycc420 and the tail of
_decode_fused_batch_device after the Huffman scan (idct_planes, in a
sparse and a dense form).

Each has a plain torch version (the CPU's route, and the reference the
kernels are held to on the card), a dispatcher that takes the
hand-written CUDA kernel (ops/transform_cuda.py, csrc/block_transforms.cu)
for CUDA tensors and the plain version for CPU tensors, and a numpy
model of the kernel's arithmetic (integer for the fDCT, float32 in the
kernel's order for the IDCT).

The fDCT kernel computes the integer form (integer_forward): the block's
64 samples X (exact int8) times W_int = round(W 2^24) (constants.FDCT_INT),
truncated toward zero after the division by 2^24; W_int is split into
three signed 8-bit digits, each digit's product an exact int32 sum on the
int8 tensor cores, recombined exactly (digit_sums, recombine_digits), so
no order of summation can change a bit.  Its first design computed the
separable float32 form (separable_forward, kept as the model of that
design): a row pass of 8 terms, t[y][v] = sum over x = 0..7 ascending of
X[y][x] C[v][x], then a column pass, o[u][v] = sum over y = 0..7 ascending
of C[u][y] t[y][v], with the unnormalised cosines C (row 0 exactly 1),
then one multiply by S[u][v] = c_u c_v / 4 (S[0][0] exactly 0.125),
truncated toward zero; every term a float32 multiply then a float32 add.
The IDCT kernel sums each sample over the nonzero coefficients k = 0..63
in ascending order, a float32 multiply then a float32 add per term
(inverse_model).  The plain versions' matrix products (cuBLAS, or the
CPU's BLAS) sum the 64-term float32 form in another order, so a kernel and
its plain version may differ by 1 where a sum falls next to an integer,
while a kernel and its model agree bit for bit.

Exact mode has its own pair (fdct_quantize_exact, idct_planes_exact): the
oracle's ordered float64 sums (ops/dct.py) as hand-written CUDA kernels
(ops/exact_cuda.py, csrc/exact_transforms.cu) on CUDA tensors, equal to
their plain versions bit for bit, since both make the oracle's roundings
and no others; the plain versions on CPU tensors.  The rgb transport's
decode takes idct_planes_rgb: at fast precision the same kernel walk with
the IDCT kernel's float32 arithmetic into unclamped int32 planes
(idct_planes_rgb_model), at exact precision idct_planes_exact.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (FDCT_DIGITS, FDCT_INT, FDCT_INT_SHIFT,
                         codec_constants)
from ..core import tables as T
from . import blocks as B
from . import dct as D
from . import quantize as Q

_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# fDCT + quantize
# ---------------------------------------------------------------------------


def fdct_quantize_plain(y, cb, cr, *, gray: bool, rounded: bool,
                        qtables=None, dtype=torch.float32):
    """YCC planes -> per-component quantized blocks [N, B_c, 64] int32
    (parallel/sharded.py:_quantize_local_ycc): blockify, the DCT at
    `dtype` (float64: the oracle's ordered sums), quantize.

    y: [N, H, W] int (Y-128); cb/cr: [N, H/2, W/2] int.  qtables: optional
    (yqt, cqt) quant tables; None = the fixed Annex K tables."""
    yqt, cqt = qtables if qtables is not None else (None, None)
    yb = B.blockify_luma(y)
    cbb = B.blockify_chroma(cb)
    crb = B.blockify_chroma(cr)
    if gray:
        cbb = torch.zeros_like(cbb)
        crb = torch.zeros_like(crb)
    out = []
    for blk, chroma, qt in ((yb, False, yqt), (cbb, True, cqt),
                            (crb, True, cqt)):
        n, b, _ = blk.shape
        out.append(Q.quantize(
            D.forward_dct(blk.reshape(-1, 64), dtype), chroma,
            rounded=rounded, qtable=qt,
        ).reshape(n, b, 64))
    return tuple(out)


def fdct_quantize(y, cb, cr, *, gray: bool, rounded: bool, qtables=None):
    """fdct_quantize_plain at float32.  CUDA tensors go through the
    hand-written kernel (transform_cuda.fdct_quantize_cuda, one launch for
    the three components, the planes read at their strides), CPU tensors
    through the plain version; a kernel that fails to build or launch
    raises."""
    if y.is_cuda:
        from .transform_cuda import fdct_quantize_cuda

        c = codec_constants(y.device)
        yqt, cqt = qtables if qtables is not None else (None, None)
        return fdct_quantize_cuda(
            y, cb, cr,
            c["y_quant"] if yqt is None else Q._table(yqt, y.device),
            c["c_quant"] if cqt is None else Q._table(cqt, y.device),
            gray=gray, rounded=rounded)
    if y.device.type != "cpu":
        raise ValueError(f"fdct_quantize: unsupported device {y.device}")
    return fdct_quantize_plain(y, cb, cr, gray=gray, rounded=rounded,
                               qtables=qtables)


def fdct_quantize_exact(y, cb, cr, *, gray: bool, rounded: bool,
                        qtables=None):
    """fdct_quantize_plain at float64 (the oracle's ordered sums), bit for
    bit.  CUDA tensors go through the hand-written kernel
    (exact_cuda.fdct_quantize_exact_cuda, one launch for the three
    components, the planes read at their strides), CPU tensors through the
    plain version; a kernel that fails to build or launch raises."""
    if y.is_cuda:
        from .exact_cuda import fdct_quantize_exact_cuda

        c = codec_constants(y.device)
        yqt, cqt = qtables if qtables is not None else (None, None)
        return fdct_quantize_exact_cuda(
            y, cb, cr,
            c["y_quant"] if yqt is None else Q._table(yqt, y.device),
            c["c_quant"] if cqt is None else Q._table(cqt, y.device),
            gray=gray, rounded=rounded)
    if y.device.type != "cpu":
        raise ValueError(f"fdct_quantize_exact: unsupported device "
                         f"{y.device}")
    return fdct_quantize_plain(y, cb, cr, gray=gray, rounded=rounded,
                               qtables=qtables, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Dequantize + IDCT into the planes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def quant_tables(qtuple, device: torch.device) -> torch.Tensor:
    """[ncomp, 64] int32 quant tables (natural order) on device, made once
    per qtuple (one nested int tuple a component)."""
    return torch.tensor(qtuple, dtype=torch.int32, device=device)


def _bytes_as(buf: torch.Tensor, dtype) -> torch.Tensor:
    """Reinterpret a 1-D uint8 slice as `dtype` (little-endian, as the
    host wrote it); the clone gives the view an aligned base."""
    return buf.clone().view(dtype)


def densify(mask_lo, mask_hi, vals):
    """Sparse coefficient transport -> dense [B, 64] int32 blocks.

    mask_lo/hi: [B] uint32 nonzero masks (int64 values; natural index j);
    vals: [B, K] nonzero values in index order.  Each set bit's rank
    (exclusive cumsum) indexes its value; plain gather in place of the JAX
    package's K-way select chain."""
    dev = vals.device
    j = torch.arange(32, dtype=torch.int64, device=dev)[None, :]
    blo = (mask_lo.to(torch.int64)[:, None] >> j) & 1
    bhi = (mask_hi.to(torch.int64)[:, None] >> j) & 1
    bits = torch.cat([blo, bhi], dim=1)                     # [B, 64]
    rank = torch.cumsum(bits, dim=1) - bits
    K = vals.shape[1]
    picked = vals.to(torch.int32).gather(1, rank.clamp(max=K - 1))
    return torch.where((bits == 1) & (rank < K), picked, 0)


def _planes(spat, geom_c):
    """[N, B_c, 64] int samples of one component -> [N, plane bytes]
    clamped u8 plane rows."""
    mcus_y, mcus_x, v, h = geom_c[:4]
    plane = B.deblockify(spat, mcus_y, mcus_x, v, h)
    return plane.clamp(0, 255).to(torch.uint8).reshape(
        spat.shape[0], plane.shape[1] * plane.shape[2])


def idct_planes_sparse_plain(flat: torch.Tensor, *, geom, level, shapes, K,
                             N, caps, qtuple):
    """Sparse coefficients in, packed native-resolution u8 YCC planes out
    (jax_codec._decode_fused_batch_ycc420, same flat layout).

    flat: ONE uint8 buffer.  First N*X bytes are per-image rows holding,
    per component, mask_lo [N,B] u32 | mask_hi [N,B] u32 | vals [N,B,K]
    int8; then, per component, the overflow data oidx [cap] i32 | orows
    [cap, 64] i16, padded with the out-of-range sentinel N*B_i.  Returns
    [N, H*W*1.5] uint8 for 4:2:0."""
    dev = flat.device
    X = sum((4 + 4 + K) * Bn for Bn in shapes)
    packed = flat[: N * X].reshape(N, X)
    ooff = N * X
    qtab = quant_tables(qtuple, dev)
    outs = []
    off = 0
    for c, (Bn, cap, g) in enumerate(zip(shapes, caps, geom)):
        ml = _bytes_as(packed[:, off:off + 4 * Bn], torch.int32)
        off += 4 * Bn
        mh = _bytes_as(packed[:, off:off + 4 * Bn], torch.int32)
        off += 4 * Bn
        vv = packed[:, off:off + Bn * K].reshape(N * Bn, K).view(torch.int8)
        off += Bn * K
        dense = densify(ml.reshape(-1).to(torch.int64) & _M32,
                        mh.reshape(-1).to(torch.int64) & _M32, vv)
        if cap:
            oidx = _bytes_as(flat[ooff:ooff + 4 * cap], torch.int32)
            ooff += 4 * cap
            orows = _bytes_as(flat[ooff:ooff + 128 * cap],
                              torch.int16).reshape(cap, 64)
            ooff += 128 * cap
            # Padding carries the sentinel N*Bn.  It is filtered into one
            # extra row that is dropped afterwards, so it can never wrap
            # onto a real block (and the host need not be waited on).
            drop = N * Bn
            idx = torch.where(oidx.to(torch.int64) < drop,
                              oidx.to(torch.int64), drop)
            ext = torch.cat([dense, torch.zeros((1, 64), dtype=dense.dtype,
                                                device=dev)])
            ext.index_copy_(0, idx, orows.to(dense.dtype))
            dense = ext[:drop]
        deq = Q.dequantize(dense, qtab[c])
        spat = D.inverse_dct(deq, level, torch.float32).reshape(N, Bn, 64)
        outs.append(_planes(spat, g))
    return torch.cat(outs, dim=1)


def _dense_comps(blocks, N: int, nseg: int, ri: int, nmcu: int):
    """The scan's [N*nseg, ri*6, 64] blocks -> per component [N, B_c, 64]
    in MCU-raster order (the deblockify layout)."""
    b6 = blocks.reshape(N, nseg * ri, 6, 64)[:, :nmcu]
    return (b6[:, :, :4].reshape(N, nmcu * 4, 64), b6[:, :, 4], b6[:, :, 5])


def idct_planes_dense_plain(blocks, bad, qarr, *, N, nseg, ri, geom, level):
    """The tail of jax_codec._decode_fused_batch_device after the Huffman
    scan: blocks [N*nseg, ri*6, 64] int16 (4 Y, Cb, Cr per MCU), bad
    [N*nseg] bool, qarr [N, 3, 64] int32 per-image quant tables -> the
    sparse form's planes plus ONE trailing bad-flag byte per image."""
    nmcu = geom[0][0] * geom[0][1]
    outs = []
    for c, (cb, g) in enumerate(zip(_dense_comps(blocks, N, nseg, ri, nmcu),
                                    geom)):
        Bn = cb.shape[1]
        deq = cb.to(torch.int32) * qarr[:, c][:, None, :]
        spat = D.inverse_dct(deq.reshape(-1, 64), level,
                             torch.float32).reshape(N, Bn, 64)
        outs.append(_planes(spat, g))
    badimg = bad.reshape(N, nseg).any(dim=1).to(torch.uint8)
    return torch.cat(outs + [badimg[:, None]], dim=1)


def idct_planes_sparse(flat, *, geom, level, shapes, K, N, caps, qtuple):
    """idct_planes_sparse_plain's planes.  A CUDA buffer goes through the
    hand-written kernel (transform_cuda.idct_planes_sparse_cuda: the
    upload read in place, the tables made on the device once per qtuple),
    a CPU buffer through the plain version; a kernel that fails to build or
    launch raises."""
    if flat.is_cuda:
        from .transform_cuda import idct_planes_sparse_cuda

        return idct_planes_sparse_cuda(
            flat, quant_tables(qtuple, flat.device), geom=geom, level=level,
            shapes=shapes, K=K, N=N, caps=caps)
    if flat.device.type != "cpu":
        raise ValueError(f"idct_planes_sparse: unsupported device "
                         f"{flat.device}")
    return idct_planes_sparse_plain(flat, geom=geom, level=level,
                                    shapes=shapes, K=K, N=N, caps=caps,
                                    qtuple=qtuple)


def idct_planes_dense(blocks, bad, qarr, *, N, nseg, ri, geom, level):
    """idct_planes_dense_plain's planes and flags.  CUDA tensors go
    through the hand-written kernel (transform_cuda.idct_planes_dense_cuda,
    the same arithmetic as the sparse form's), CPU tensors through the
    plain version; a kernel that fails to build or launch raises."""
    if blocks.is_cuda:
        from .transform_cuda import idct_planes_dense_cuda

        return idct_planes_dense_cuda(blocks, bad, qarr, N=N, nseg=nseg,
                                      ri=ri, geom=geom, level=level)
    if blocks.device.type != "cpu":
        raise ValueError(f"idct_planes_dense: unsupported device "
                         f"{blocks.device}")
    return idct_planes_dense_plain(blocks, bad, qarr, N=N, nseg=nseg, ri=ri,
                                   geom=geom, level=level)


def idct_planes_rgb_plain(coeff_all, *, geom, level, gray, sizes, qtuple,
                          dtype):
    """The rgb transport's device program (jax_codec._decode_fused_batch)
    up to the upsampling, at either precision: coefficients
    [N, sum(sizes), 64] of every component in one array -> per component
    its int32 plane [N, mcus_y v 8, mcus_x h 8], unclamped: dequantize,
    the inverse DCT at dtype with the level shift (float64: the oracle's
    ordered sums), and deblockify.  Gray transforms component 0 alone (a
    list of one)."""
    dev = coeff_all.device
    N = coeff_all.shape[0]
    planes, off = [], 0
    for n_b, qt, g in zip(sizes[:1] if gray else sizes, qtuple, geom):
        mcus_y, mcus_x, v, h = g[:4]
        deq = Q.dequantize(coeff_all[:, off:off + n_b].reshape(-1, 64),
                           torch.tensor(qt, dtype=torch.int32, device=dev))
        off += n_b
        spat = D.inverse_dct(deq, level, dtype).reshape(N, n_b, 64)
        planes.append(B.deblockify(spat, mcus_y, mcus_x, v, h))
    return planes


def idct_planes_rgb(coeff_all, *, geom, level, gray, sizes, qtuple,
                    precision: str = "fast"):
    """The rgb transport's planes at either precision.  CUDA tensors go
    through a hand-written kernel, one launch for every component: fast,
    exact_cuda.idct_planes_rgb_cuda (float32, idct_planes_rgb_model's sums
    bit for bit, within 1 of the plain version's matrix product); exact,
    idct_planes_exact (the oracle's ordered float64 sums).  CPU tensors go
    through idct_planes_rgb_plain at the precision's dtype; a kernel that
    fails to build or launch raises."""
    if precision not in ("fast", "exact"):
        raise ValueError(f"precision must be 'fast' or 'exact', got "
                         f"{precision!r}")
    if precision == "exact":
        return idct_planes_exact(coeff_all, geom=geom, level=level, gray=gray,
                                 sizes=sizes, qtuple=qtuple)
    if coeff_all.is_cuda:
        from .exact_cuda import idct_planes_rgb_cuda

        return idct_planes_rgb_cuda(
            coeff_all, quant_tables(qtuple, coeff_all.device), geom=geom,
            level=level, gray=gray, sizes=sizes)
    if coeff_all.device.type != "cpu":
        raise ValueError(f"idct_planes_rgb: unsupported device "
                         f"{coeff_all.device}")
    return idct_planes_rgb_plain(coeff_all, geom=geom, level=level, gray=gray,
                                 sizes=sizes, qtuple=qtuple,
                                 dtype=torch.float32)


# exact mode's plain version: the float64 ordered sums
idct_planes_exact_plain = functools.partial(idct_planes_rgb_plain,
                                            dtype=torch.float64)


def idct_planes_exact(coeff_all, *, geom, level, gray, sizes, qtuple):
    """idct_planes_exact_plain's planes, bit for bit.  A CUDA tensor goes
    through the hand-written kernel (exact_cuda.idct_planes_exact_cuda,
    one launch for every component, zero coefficients skipped), a CPU
    tensor through the plain version; a kernel that fails to build or
    launch raises."""
    if coeff_all.is_cuda:
        from .exact_cuda import idct_planes_exact_cuda

        return idct_planes_exact_cuda(
            coeff_all, quant_tables(qtuple, coeff_all.device), geom=geom,
            level=level, gray=gray, sizes=sizes)
    if coeff_all.device.type != "cpu":
        raise ValueError(f"idct_planes_exact: unsupported device "
                         f"{coeff_all.device}")
    return idct_planes_exact_plain(coeff_all, geom=geom, level=level,
                                   gray=gray, sizes=sizes, qtuple=qtuple)


# ---------------------------------------------------------------------------
# numpy models of the kernels' arithmetic (and its order)
# ---------------------------------------------------------------------------


def sum_ascending(x: np.ndarray, m: np.ndarray) -> np.ndarray:
    """x [B, 64] float32, m [64, 64] float32 -> [B, 64] float32 with
    out[:, i] = sum of x[:, k] * m[i, k] over k = 0..63 in ascending order,
    the sum starting at +0.0, each product and each partial sum rounded to
    float32: the IDCT kernel's order (and the 64-term forward form)."""
    x = np.asarray(x, np.float32)
    m = np.asarray(m, np.float32)
    s = np.zeros(x.shape, np.float32)
    for k in range(64):
        s += x[:, k:k + 1] * m[:, k][None, :]
    return s


def _basis(name: str) -> np.ndarray:
    return codec_constants("cpu")[name].numpy()


def separable_sums(blocks: np.ndarray, cos: np.ndarray) -> np.ndarray:
    """[B, 64] samples, cos [8, 8] float32 -> [B, 8, 8] float32 o[u][v]:
    the row pass t[y][v] = sum_x X[y][x] cos[v][x], then the column pass
    o[u][v] = sum_y cos[u][y] t[y][v], each in ascending order from +0.0,
    every product and partial sum rounded to float32."""
    x = np.asarray(blocks).astype(np.float32).reshape(-1, 8, 8)
    cos = np.asarray(cos, np.float32)
    t = np.zeros(x.shape, np.float32)                       # [B, y, v]
    for k in range(8):
        t += x[:, :, k:k + 1] * cos[:, k][None, None, :]
    o = np.zeros(x.shape, np.float32)                       # [B, u, v]
    for y in range(8):
        o += cos[:, y][None, :, None] * t[:, y:y + 1, :]
    return o


def separable_forward(blocks: np.ndarray) -> np.ndarray:
    """[B, 64] int samples -> [B, 64] int32 coefficients (natural index
    8u + v): separable_sums with the unnormalised cosines, times
    S[u][v] = c_u c_v / 4 as one float32 multiply, truncated toward zero
    (the float part of the fDCT kernel's first design,
    scripts/previous_designs.py fdct_quantize_first)."""
    o = separable_sums(blocks, _basis("fdct_cos_f32"))
    o = o * _basis("fdct_scale_f32")[None]
    return o.reshape(-1, 64).astype(np.int32)


def digit_sums(blocks: np.ndarray) -> np.ndarray:
    """[B, 64] int samples -> [3, B, 64] int64: the block's product with
    each of W_int's three 8-bit digits (constants.FDCT_DIGITS), the sums
    the kernel's int8 tensor-core products accumulate in int32."""
    x = np.asarray(blocks).astype(np.int64)
    return np.stack([x @ d.astype(np.int64) for d in FDCT_DIGITS])


def recombine_digits(acc: np.ndarray) -> np.ndarray:
    """[3, ...] digit sums (each within int32) -> trunc((acc0 + 2^8 acc1 +
    2^16 acc2) / 2^24) as int32, in the kernel's 32-bit steps: L = acc0 +
    2^8 acc1 and C = acc2 + (L >> 16) (arithmetic shifts, floors), the
    floor C >> 8 and the remainder's bits C & 255, L & 0xFFFF; a negative
    floor with a nonzero remainder moves one up (truncation toward zero).
    Exact while |acc0 + 2^8 acc1| < 2^31, which digit sums below 2^20
    keep."""
    a = np.asarray(acc).astype(np.int32)
    lo = a[0] + (a[1] << 8)
    c = a[2] + (lo >> 16)
    q = c >> 8
    rem = ((c & 255) | (lo & 0xFFFF)) != 0
    return (q + ((q < 0) & rem)).astype(np.int32)


def integer_forward(blocks: np.ndarray) -> np.ndarray:
    """[B, 64] int samples -> [B, 64] int32 coefficients (natural index
    8u + v): trunc(X @ W_int / 2^24) toward zero in int64, W_int =
    constants.FDCT_INT (fdct_quantize_kernel's arithmetic; the kernel
    forms it as recombine_digits(digit_sums(X)))."""
    a = np.asarray(blocks).astype(np.int64) @ FDCT_INT
    mag = np.abs(a) >> FDCT_INT_SHIFT
    return (np.sign(a) * mag).astype(np.int32)


def inverse_model(deq: np.ndarray, level: int) -> np.ndarray:
    """[B, 64] int32 dequantized coefficients -> [B, 64] int32 samples: the
    ascending float32 sum, then + level as one more float32 add, truncated
    toward zero (the idct_planes launches' float part, before the
    clamp)."""
    s = sum_ascending(deq.astype(np.float32), _basis("inv64_f32"))
    return (s + np.float32(level)).astype(np.int32)


def _blockify(plane: np.ndarray, v: int, h: int) -> np.ndarray:
    """[N, my*v*8, mx*h*8] -> [N, my*mx*v*h, 64], MCU-raster, blocks raster
    within an MCU (ops/blocks.py's order)."""
    n, hh, ww = plane.shape
    my, mx = hh // (8 * v), ww // (8 * h)
    b = plane.reshape(n, my, v, 8, mx, h, 8).transpose(0, 1, 4, 2, 5, 3, 6)
    return b.reshape(n, my * mx * v * h, 64)


def _deblockify(blocks: np.ndarray, mcus_y, mcus_x, v, h) -> np.ndarray:
    n = blocks.shape[0]
    b = blocks.reshape(n, mcus_y, mcus_x, v, h, 8, 8)
    return b.transpose(0, 1, 3, 5, 2, 4, 6).reshape(
        n, mcus_y * v * 8, mcus_x * h * 8)


def _quantize(coef: np.ndarray, q: np.ndarray, rounded: bool) -> np.ndarray:
    a = np.abs(coef.astype(np.int64))
    q = q.astype(np.int64)[None, :]
    r = (2 * a + q) // (2 * q) if rounded else a // q
    return (np.sign(coef) * r).astype(np.int32)


def fdct_quantize_model(y, cb, cr, *, gray: bool, rounded: bool,
                        qtables=None, transform=integer_forward):
    """fdct_quantize_kernel in numpy: planes (numpy ints) -> (yq, cbq, crq)
    [N, B_c, 64] int32.  transform: [B, 64] int samples -> [B, 64] int32
    coefficients (default the kernel's integer form; separable_forward
    for its first design)."""
    yqt, cqt = qtables if qtables is not None else (T.Y_QUANT, T.C_QUANT)
    out = []
    for plane, vh, qt, zero in ((y, 2, yqt, False), (cb, 1, cqt, gray),
                                (cr, 1, cqt, gray)):
        blk = _blockify(np.asarray(plane).astype(np.int32), vh, vh)
        n, b, _ = blk.shape
        if zero:
            out.append(np.zeros((n, b, 64), np.int32))
            continue
        coef = transform(blk.reshape(-1, 64))
        out.append(_quantize(coef, np.asarray(qt), rounded).reshape(n, b, 64))
    return tuple(out)


def _model_planes(deq, geom_c, level, transform) -> np.ndarray:
    N = deq.shape[0]
    spat = transform(deq.reshape(-1, 64), level).reshape(deq.shape)
    plane = _deblockify(spat, *geom_c[:4])
    return np.clip(plane, 0, 255).astype(np.uint8).reshape(
        N, plane.shape[1] * plane.shape[2])


def _le(buf: np.ndarray, dtype) -> np.ndarray:
    return np.frombuffer(np.ascontiguousarray(buf).tobytes(), dtype)


def idct_planes_sparse_model(flat: np.ndarray, *, geom, level, shapes, K, N,
                             caps, qtuple, transform=inverse_model):
    """The sparse form's launches (idct_planes_sparse_kernel, then
    idct_planes_overflow_kernel) in numpy: the flat
    upload (uint8) -> [N, P] uint8 planes.  Each block's coefficient j is
    vals[rank(j)] where bit j is set and its rank is below K; an overflow
    row with an index in [0, N*B_c) replaces its block.  transform: [B, 64]
    int32 dequantized coefficients, level -> [B, 64] int32 samples."""
    flat = np.asarray(flat, np.uint8)
    X = sum((8 + K) * Bn for Bn in shapes)
    rows = flat[:N * X].reshape(N, X)
    ooff, off = N * X, 0
    j = np.arange(64, dtype=np.uint64)
    outs = []
    for Bn, cap, qt, g in zip(shapes, caps, qtuple, geom):
        ml = _le(rows[:, off:off + 4 * Bn], "<u4").astype(np.uint64)
        mh = _le(rows[:, off + 4 * Bn:off + 8 * Bn], "<u4").astype(np.uint64)
        vals = rows[:, off + 8 * Bn:off + (8 + K) * Bn].reshape(
            N * Bn, K).view(np.int8).astype(np.int32)
        off += (8 + K) * Bn
        mask = ml | (mh << np.uint64(32))
        bit = ((mask[:, None] >> j[None, :]) & np.uint64(1)).astype(np.int64)
        rank = np.cumsum(bit, axis=1) - bit
        coef = np.where((bit == 1) & (rank < K),
                        np.take_along_axis(vals, np.minimum(rank, K - 1), 1),
                        0).astype(np.int32)
        if cap:
            oidx = _le(flat[ooff:ooff + 4 * cap], "<i4")
            orows = _le(flat[ooff + 4 * cap:ooff + 132 * cap],
                        "<i2").reshape(cap, 64)
            ooff += 132 * cap
            keep = (oidx >= 0) & (oidx < N * Bn)
            coef[oidx[keep]] = orows[keep]
        deq = coef * np.asarray(qt, np.int32)[None, :]
        outs.append(_model_planes(deq.reshape(N, Bn, 64), g, level,
                                  transform))
    return np.concatenate(outs, axis=1)


def idct_planes_rgb_model(coeff_all, *, geom, level, gray, sizes, qtuple,
                          transform=inverse_model):
    """idct_planes_rgb_kernel in numpy: the rgb transport's coefficients
    [N, sum(sizes), 64] (numpy ints) -> per component its unclamped int32
    plane [N, mcus_y v 8, mcus_x h 8] (component 0's alone with gray):
    dequantize as a 32-bit product, inverse_model (the ascending float32
    sum over the nonzero coefficients, + level, truncated) and
    deblockify."""
    coeff_all = np.asarray(coeff_all)
    N = coeff_all.shape[0]
    planes, off = [], 0
    for n_b, qt, g in zip(sizes[:1] if gray else sizes, qtuple, geom):
        blk = coeff_all[:, off:off + n_b].astype(np.int32)
        off += n_b
        deq = blk * np.asarray(qt, np.int32)[None, None, :]
        spat = transform(deq.reshape(-1, 64), level).reshape(N, n_b, 64)
        planes.append(_deblockify(spat, *g[:4]))
    return planes


def idct_planes_dense_model(blocks, bad, qarr, *, N, nseg, ri, geom, level,
                            transform=inverse_model):
    """idct_planes_dense_kernel in numpy: the scan's blocks [N*nseg,
    ri*6, 64] int16, bad [N*nseg] bool, qarr [N, 3, 64] int32 -> [N, P + 1]
    uint8 planes and flag bytes."""
    nmcu = geom[0][0] * geom[0][1]
    b6 = np.asarray(blocks).reshape(N, nseg * ri, 6, 64)[:, :nmcu]
    comps = (b6[:, :, :4].reshape(N, nmcu * 4, 64), b6[:, :, 4], b6[:, :, 5])
    outs = []
    for c, (cb, g) in enumerate(zip(comps, geom)):
        deq = cb.astype(np.int32) * np.asarray(qarr)[:, c][:, None, :]
        outs.append(_model_planes(deq, g, level, transform))
    flags = np.asarray(bad).reshape(N, nseg).any(axis=1).astype(np.uint8)
    return np.concatenate(outs + [flags[:, None]], axis=1)
