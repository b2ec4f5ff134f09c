#!/usr/bin/env python3
"""Bring-up check of jpezy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on the card, in phases: the main path (the
pipelined encode+decode round trip of uniform batches of 16 RGB images at
512x512, fast precision, 4:2:0, no restart markers, `ycc420` transport),
the restart path (the same round trip with restart_interval=8 and the
`device` decode transport, whose Huffman decode runs on the card), the
`indexed` decode of the main path's streams, the optimize path (per-image
Huffman tables; encode_batches(optimize=True, restart_interval=8), then
the device decode), the rgb transports and single-image, mixed-size and
command-line entry points, the sharded codec (parallel/) on a 1x1
mesh and over gloo ranks that share the card, exact mode's paths
(precision="exact": the ycc420 and rgb encodes and the rgb decode, colour
and gray, through the float64 kernels) and the fast rgb paths (the colour
kernels and the fast IDCT into planes).  Each phase prints one line and
any failure exits nonzero.  In the order they run:

  1. environment: torch/CUDA versions, the card's name and power limit,
     fp32 matmuls at IEEE precision (no TF32);
  2. build: compiles the CUDA sources of the checkout, all at once (the
     entropy pack alone, the batched entropy kernel with the emissions and
     the DC predictors fused in, in a fixed-table and a custom-table form,
     and the symbol histograms, entropy_pack.cu; the Huffman scan,
     huffman_scan.cu; the one-launch stream concat, stream_concat.cu; the
     fDCT+quantize kernel for int8 and int32 samples and the
     IDCT-to-planes kernel's sparse, overflow and dense launches,
     block_transforms.cu; exact mode's fDCT+quantize and
     dequantize+IDCT-to-planes kernels and the rgb transport's fast
     IDCT-to-planes, exact_transforms.cu; the rgb transport's colour
     kernels, colour.cu; the designs the entropy kernel, the concat,
     exact mode's two kernels and the fast rgb IDCT replaced,
     scripts/previous_designs.cu, and
     the float64 chains of scripts/fp64_ceiling.cu, for phase 6) and
     prints what
     ptxas reports for each kernel (a template's instantiations under one
     name); a stack frame or a spill in any kernel but the scan, or a
     spill in the scan kernel, fails the run.  Counts each kernel's SASS
     instructions (cuobjdump), and in the exact kernels, the three rgb
     kernels and the three kernels of idct_planes (sparse, overflow and
     dense launches) FFMA, DFMA, FMUL, FADD, DMUL and DADD: an FFMA or DFMA
     (a contracted multiply-add) fails the run;
  3. the pack kernels against their plain torch versions: the pack alone
     per component on the real 16x512x512 blocks, on seeded worst-case
     blocks and on the edge-case blocks; the batched entropy kernel (one
     launch for the three components, its predictors found in the kernel)
     on the real batch without and with restart markers and on the
     worst-case and edge-case blocks as an image's components: words and
     bits must be identical.  The pack kernel alone is off every path, so
     its launch count is taken here, over the real blocks (3, one per
     component);
  7. the scan kernel against decode_segments_plain on the card: the 2,048
     real segments of a 16x512x512 restart batch, noise images, the
     edge-case blocks encoded into segments, the 2,048 pseudo-segments of
     the indexed transport (skip0, preds0), a batch with two table sets,
     and a seeded sweep of bit flips, zeroed, truncated and all-ones rows;
     then the shapes the kernel's layout is sensitive to: rows of 16, 64
     and 128 words and the long rows of quality-95 and noise segments, two
     table sets interleaved segment by segment (both in one thread block),
     a luma AC table whose codes all have 10 to 14 bits (no symbol answered
     by the first-level table), and a launch into a buffer filled with a
     pattern, with more block slots than any segment decodes, segments
     with no blocks and a segment count that fills no whole thread block:
     blocks and flags must be identical;
  4. exact parity: 4x512x512 precision="exact" encodes on the card, without
     and with restart markers, must be byte-identical to the host C++ codec
     (the port's verbatim copy of jpezy_tpu's host_codec), each launching
     the exact fDCT, the entropy and the concat kernel once;
  5. main path: roundtrip_batches over 4 batches of 16x512x512 on the card,
     every stream must decode; the port's own decode and the host decoder's
     decode of the port's streams must both reach a PSNR within 0.05 dB of
     the host codec's exact round trip.  Per batch the fDCT kernel, the
     fused kernel, the concat and the IDCT kernel (sparse form) must each
     have been launched once, and no other kernel at all;
  8. restart path: the same batches with restart_interval=8 and
     transport="device": every stream starts FFD8, ends FFD9, carries DRI
     and RSTn cycling 0..7, decodes in the host decoder; the device
     transport's pixels equal the ycc420 transport's exactly; per batch
     the fDCT kernel, the fused kernel, the concat, the scan and the IDCT
     kernel (dense form) once each.
     Then decode_batches with transport="indexed" on the main path's
     restart-free streams: pixels equal to the main path's; one scan and
     one IDCT launch per batch (decode alone on ycc420: one IDCT launch).
     A corrupted stream must raise.  Decode alone, pipelined,
     is timed for the three transports side by side, and the host halves
     (parse, _device_host_frontend, _indexed_host_frontend, the ycc420
     host frontend, encode_batch_finish) per batch on the host's clock;
  10. optimize: the histogram kernel (one launch for the three
     components) against its plain version on the real 16x512x512
     components without and with restarts and a carry, and on images of
     1 to 140 blocks a component cut from the edge-case and long-emission
     blocks; the fused kernel with the batch's 16 per-image table sets
     (one launch), without and with restarts, against its plain version;
     slots of 74 bits
     (entropy.long_emission_tables) encoded on the card to the host C++
     encoder's entropy bytes; 4x512x512 exact optimize streams, with and
     without restarts, byte-identical to host_codec (1 exact fDCT, 1
     histogram, 1 fused and 1 concat launch a call).  Then the optimize
     path over 4 batches: every stream with its own DHT, pixels equal to
     the restart path's, fewer bytes; 1 fDCT, 1 histogram, 1 fused, 1
     concat, 1 scan and 1 IDCT launch per batch; MP/s of encode and
     decode and the host stages
     (the table derivation, the 16 LUT sets of the decode);
  11. rgb and entry points: rgb encode (fast, exact) and rgb decode (fast,
     exact, gray) on the card against the same calls on the CPU, with
     their launches (an encode the colour kernel, its fDCT kernel, fast or
     exact, the fused kernel and the concat; a decode the IDCT of its
     precision, idct_planes_rgb or idct_planes_exact, and the colour
     kernel once each); exact rgb streams at 16x512x512 equal the
     ycc420 transport's and decode to host_codec's pixels; encode/decode
     of a 1000x750 image,
     encode_mixed/decode_mixed of six sizes (exact: equal to host_codec),
     and `python -m jpezy_tpu_torch.cli encode|decode ... --gpu` on a PPM
     (the same stream and pixels as the in-process calls);
  12. the sharded codec (parallel/), world size 1 (a 1x1 mesh, no process
     group): exact encode_sharded of a 16x512x512 batch, without and with
     restart_interval=8, byte-identical to encode_batch(transport="rgb")
     and host_codec (1 exact fDCT, 1 fused, 1 concat launch), and exact
     decode_sharded of the streams without restart markers equal to
     host_codec.decode (1 idct_planes_exact launch); then 4 batches
     through encode_sharded and
     decode_sharded on three paths, `sharded` (no restart markers, host
     Huffman frontend), `sharded_restart` (restart_interval=8, the device
     decode per shard) and `sharded_optimize` (one table set a batch):
     decode_sharded pixels equal decode_batch(transport="rgb")'s, optimize
     streams decode to the restart streams' pixels in fewer bytes,
     launches per batch 1 colour (encode), 1 fDCT, 1 fused, 1 concat, 1
     fast rgb IDCT and 1 colour (decode) (+ 1 scan with restarts, + 1
     histogram with optimize: the shards decode through the rgb
     transport's program, colour on unclamped planes), MP/s beside
     encode_batch/decode_batch; the plain and restart streams decoded
     again in 2 and 4 tile shards rank by rank in this process, shards
     whose MCU rows differ from the whole image's: pixels equal
     decode_batch(transport="rgb")'s exactly.
     Then this
     script spawns itself as 2 gloo ranks (a 1x2 mesh), then 4 (2x2), all
     on the one card, on 4 of the images with restart_interval=8: exact
     restart and optimize streams equal the 1x1 mesh's, the sharded device
     decode's pixels equal decode_batch(transport="rgb")'s, a corrupted
     stream raises on the ranks of its tile row, and each rank's launches
     per step are as expected (RANK_STEPS: an exact encode step launches
     the exact fDCT kernel once); a rank that fails or hangs fails the
     run;
  13. the concat kernel against its plain version, bit for bit: the real
     16x512x512 blocks without and with restart_interval 1, 8, 17 and
     2000 (one segment, longer than the image), the 16 per-image table
     sets of optimize, gray, noise at quality 100 with the default budget
     and a quarter of it (words dropped), the two shards of a 1x2 mesh in
     the shard budget, seeded blocks whose bits reach word 63, one-MCU
     images, and one 3840x2160 image without and with restart_interval=8
     (whose entropy kernel output is held to the plain version too); one
     counted call (one launch) each; the two-pass design phase 6 times
     beside it gives the same combined;
  14. the block transforms against their plain versions and the numpy
     models of the kernels' arithmetic order (ops/block_transform.py):
     fdct_quantize on the main batch's ycc420 int8 planes at Annex K,
     quality 95, rounded and gray, on the rgb path's int32 planes (chroma
     at column stride 2) and on noise; idct_planes' sparse form on the
     uploads of the main and restart batches, of the main batch's images
     at quality 95, of 4 noise images at quality 100 (overflow rows), of
     16x16, 48x16 and 48x32 batches (odd MCU counts put the Cr fields off
     a word boundary) and, at levels 128 and 2048, of
     testing/ycc_uploads.overflow_sets (the overflow launch's cases: the
     float32 tie set, the mixed warp groups, blocks that clamp at both
     ends, noise, sampling factors 1 to 4, caps that are not a multiple of
     8, sentinel and junk padding; the plain version takes no index below
     0, so the junk padding is held to the model alone), its dense
     form on the scan's blocks of the restart path's 2,048 segments and
     of the indexed transport's pseudo-segments: bit-identical to the
     model, within 1 of the plain version (the share that differs
     printed; the fDCT's, separable against the plain 64-term product,
     at most FDCT_DIFF_SHARE per set), the two forms' planes identical on
     the same streams; one counted call each;
  15. exact mode's kernels against their plain versions (the ordered
     float64 sums of ops/dct.py), bit for bit: fdct_quantize_exact on the
     main batch's ycc420 int8 planes at Annex K, quality 95, rounded and
     gray, on the rgb path's int32 planes converted at float64 (chroma at
     column stride 2), on noise at quality 100 and on the tie set
     (testing/exact_ties.forward_tie_blocks: ramps on which another summation
     order truncates differently, and flat blocks; int8 at quantizer 1,
     int32 at Annex K), on blocks in the kernel's warp groups of 4 that mix
     a dense block with sparse, zero, cancelling and tie ones (and groups
     of sparse blocks alone: testing/exact_ties.mixed_sample_groups; the
     kernel's straight and skipping paths) and on blocks whose row-0 sums
     cancel to 0; idct_planes_exact on the main batch's rgb upload
     read as 4:2:0, 4:2:2, 4:4:4, one component and gray, at level 128 and
     2048, as int32, on 16 noise images at quality 100 (their quantized
     blocks from fdct_quantize_exact, as the rgb transport would upload
     them), on the inverse tie set and on mixed warp groups
     (mixed_coefficient_groups) at both levels and on blocks whose partial
     sums cancel to 0; one counted call each.  Then exact mode's
     paths over the 4 batches: the ycc420 and the rgb encode
     byte-identical to host_codec's streams, the rgb decode (colour and
     gray) identical to host_codec.decode's pixels; per batch an encode
     launches the exact fDCT, the fused kernel and the concat once (the rgb
     one the colour kernel too) and no fast fDCT, a decode
     idct_planes_exact and the colour kernel once;
  16. the rgb transport's kernels against their references, bit for bit:
     rgb_to_ycc420 at float32 and float64 against the plain torch version
     on the real 16x512x512 batch and on an 8192x8192 image whose 2x2
     quads hold all 2^24 RGB triples, at float64 also against the host
     C++ rgb_to_ycc420, and every triple's values within int8;
     ycc_planes_to_rgb at both precisions against the plain version on all
     2^24 (Y, Cb, Cr) triples at 4:4:4 and on planes past both clamps at
     4:2:0, 4:2:2, 4:4:4, 4:1:1, a 3x horizontal factor, an upsampled
     luma, one component and gray, at float64 also against the host C++
     ycc_to_rgb_i32 (the triples, 4:2:0); idct_planes_rgb against its
     numpy model (block_transform.idct_planes_rgb_model) bit for bit and
     the plain version (cuBLAS) within 1, the share that differs printed,
     on the main batch's rgb upload read at every sampling and level, as
     int32, on the main batch's images at quality 95, on noise at quality
     100, on the float32 tie set (testing/rgb_ties.inverse_tie_blocks:
     blocks on which another order of the same float32 terms truncates
     differently) and on the kernel's mixed warp groups
     (rgb_ties.mixed_coefficient_groups), both at levels 128 and 2048; one
     counted launch each.  Then the
     fast rgb paths over the 4 batches: encode_batch(transport="rgb")
     (colour, fDCT, fused, concat once a batch) and its decode_batch(
     transport="rgb") (fast IDCT and colour once a batch), PSNR within
     0.05 dB of the host codec's exact round trip;
  5/8 device: only now the profiler: per batch the encode and decode
     programs' CUDA-event spans (host-launch bound), their device-busy
     time (kernel and copy time summed from a torch.profiler trace) and
     number of device events, for both paths, with the plain programs'
     earlier readings (EARLIER_PROGRAMS, EARLIER_ENCODE) beside them and the
     device decode's tail after the scan; each encode program, with and
     without restart markers, must be the fDCT, entropy and concat kernels
     alone (3 device events, no plain torch between the upload and the
     fetch); the encode program's stages alone (the entropy stage and the
     concat also as the earlier designs ran them, the concat and
     fDCT+quantize also as the plain torch stages they replaced), and the
     card's busy share of each pipelined round trip
     (device time of a profiled round trip over the wall time of the
     unprofiled one); 10/11 device: the optimize encode's device stages alone
     and the optimize path's busy share, the rgb transports' device programs
     (fast, exact, gray; beside their plain readings, EARLIER_EXACT and
     EARLIER_RGB, the exact ones beside their readings with the exact
     kernels' first designs, FIRST_EXACT_PROGRAMS, and the fast decode in
     turns with the fast IDCT's first design in its place), each of which
     must be
     the hand kernels alone (4 device
     events an encode: colour, fDCT, entropy, concat; 2 a decode: the
     IDCT into planes and colour), the exact ycc420 encode program,
     which must be the exact fDCT, entropy and concat kernels alone (3
     device events), and the ycc420 decode program on the main batch and
     on noise at quality 100 in turns with the first design of the IDCT's
     overflow launch in its place;
  6. times of the pack kernels, the histogram kernel, the concat and the
     four block transforms alone on the real batch beside their bounds
     (see _bound; the transforms' by bytes or float32 operations, the
     exact ones' by bytes or separate float64 DMUL/DADD, the IDCTs'
     counted from the batch's nonzero coefficients) and their plain
     versions, with the L2 cache overwritten too, the transforms beside
     torch.matmul of the [98304, 64] @ [64, 64] product alone (float32;
     float64, cuBLAS DGEMM, for the exact ones: not the same function), and
     each instantiation's registers and resident thread blocks an SM as the
     card reports them; exact mode's two kernels beside their first designs
     (scripts/previous_designs.py) in turns (now, first, now, first), warm
     and with the L2 cache overwritten first, on the main batch and on
     noise at quality 100, with their bounds, registers, thread blocks an
     SM and static DMUL, DADD and DFMA counts; the float64 rate the card
     sustains as separate DMUL/DADD (scripts/fp64_ceiling.py, three operand
     forms, at the exact forward's occupancy and at 64 warps an SM) with
     the SM clock nvidia-smi reports, and the clock while the exact
     forward runs; the float32 rate of separate FMUL/FADD likewise (x m +
     y, and the rgb IDCT's step of one product into four adds); the fast
     rgb IDCT beside its first design in turns
     likewise, on the main batch, on noise at quality 100 and on the main
     batch's images at quality 95, with its FMUL, FADD and FFMA counts, on
     noise also beside the float32 matmul; idct_planes (the ycc420 IDCT,
     sparse form) beside the first design of its overflow launch
     (previous_designs.idct_planes_overflow_first) in turns, warm and with
     the L2 cache overwritten first, each launch's own time and the two
     together, on the same noise through the ycc420 upload, on the main
     batch and on its images at quality 95, with the overflow rows a
     component, both designs' registers, thread blocks an SM and FMUL,
     FADD and FFMA counts, and the float32 matmul beside them; the
     overflow launch alone on tiles of 8 rows whose union holds 8 to 64
     coefficients (where its branch-free run pays); times of
     the concat on noise at quality 100 (dense blocks), of the IDCT
     kernel's dense form on the restart segments, and of the fused kernel
     with the 16 per-image table sets beside the fixed tables; the entropy
     kernel and the concat beside the designs they replaced
     (scripts/previous_designs.py: three per-component launches, the
     two-pass concat) in turns, without and with restart_interval=8, warm
     and with the L2 cache overwritten first, with both designs' registers
     and thread blocks an SM; the rgb transport's kernels (fast) on the
     main batch beside their bounds (bytes, or separate float32
     operations: the rgb IDCT's those its roundings need, rgb_inv_ops, at
     PEAK_FP32_OPS), their plain versions and, for the fast IDCT, the
     float32 matmul; the colour kernels' float64 and gray forms too, with
     what the card reports for each instantiation;
  9. times of the scan kernel alone on the real segments beside its bound
     and the plain version's time, with the L2 cache overwritten before
     each launch, on four times the segments, and with every segment on
     the slowest one's row; how the launch lies on the card (warps, thread
     blocks, warps per SM) and the share of symbols its first-level table
     answers.

Every wall clock is taken before torch.profiler first traces: after that
every launch in the process costs the host more.

The last three lines are the kernel table as JSON (twelve kernels:
pack_words, encode_blocks, decode_segments, symbol_histograms,
concat_streams, fdct_quantize, idct_planes, fdct_quantize_exact,
idct_planes_exact, rgb_to_ycc420, idct_planes_rgb, ycc_planes_to_rgb;
launches per path in launches_by_path), the card's name and power limit, and {"ok": true,
"device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits nonzero and prints no
result.  Imports nothing of JAX and nothing of the jpezy_tpu package.
`--rank R WORLD DATA STORE OUT` runs one of phase 12's ranks (rank_main).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 512
BATCH = 16
MAIN_BATCHES = 4
RESTART_INTERVAL = 8
PSNR_SLACK_DB = 0.05

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, 67 TFLOP/s at two
# operations per fused multiply-add, taken as the rate of 32-bit integer
# instructions (the data sheet states none; the card has fewer integer
# than float32 lanes, so this favours the operations side of the bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 67e12 / 2
# the float32 rate outside the tensor cores in operations (a multiply-add
# counts two): the rate of the fast block transforms' bound
PEAK_FP32_FLOPS = 67e12
# the same rate as separate FMUL/FADD instructions, one operation each: the
# rate of the kernels that may not contract (no FFMA in their SASS), the
# fast rgb IDCT's and the colour kernels' bounds
PEAK_FP32_OPS = 67e12 / 2
# the float64 rate outside the tensor cores, 33.5 TFLOP/s with a fused
# multiply-add counted two, as separate DMUL and DADD operations (exact
# mode's kernels may not contract): the rate of their bound
PEAK_FP64_OPS = 33.5e12 / 2
# The float64 operations that exact mode's functions need: those whose
# result the oracle's roundings depend on.  A product by exactly 1
# (COS[0][.], cu[j >= 1], cucv[k] for u, v >= 1) and the first add of a
# sum, onto +0, change no value beyond the sign of a zero, which the
# truncation drops; a zero sample or coefficient adds only such terms, and
# a block with no nonzero input needs nothing (its outputs are 0, or
# level).  Forward, per nonzero sample: 7 first products p[k] COS[j][x]
# (j >= 1), 56 second products (i >= 1) and 64 adds; per block with one:
# 64 first adds fewer, and 16 products by cu[0] and 64 divisions by 4 for
# the normalisation.  A block with no zero sample needs 8,144 (the kernel
# issues 8,264, its first design 8,896).  Inverse, per nonzero
# coefficient (u, v): 64 adds, 8 column products if u >= 1, 64 row products
# if v >= 1, the product cucv[k] d[k] if u or v is 0; per block with one:
# 64 first adds fewer, and s / 4 + level for each of its 64 samples.
EXACT_FWD_OPS = (7 + 56 + 64, 16 + 64 - 64)
_U, _V = np.arange(64) % 8, np.arange(64) // 8
EXACT_INV_OPS = (64 + 8 * (_U > 0) + 64 * (_V > 0) + ((_U == 0) | (_V == 0)),
                 2 * 64 - 64)
# Bytes per 8x8 block that each kernel's function must move: its inputs
# read once, 64 32-bit words and one bit count written once.  (The kernels
# store the words zero-extended to 64 bits, 256 bytes more per block: a
# cost of that layout, not part of the bound.)
BLOCK_BYTES = {"pack_words": 3 * 256 + 256 + 4,
               # the coefficients in, the words and the count out: the
               # kernel finds the DC predictors itself (its per-component
               # form read them too, 4 more bytes)
               "encode_blocks": 256 + 256 + 4,
               "symbol_histograms": 256}
# and per image, the histogram kernel's [4, 256] int32 counts
IMAGE_HIST_BYTES = 4 * 256 * 4
# The least 32-bit operations each function needs, whatever computes it:
# (per emission slot, per emission of nonzero length).  Packing: a slot
# costs one add of the prefix sum over the lengths and one test for an
# empty slot; an emission costs splitting its bit offset (2), justifying
# its 64 bits (2), cutting three window words (3) and merging them into
# the block (3).  Encoding from coefficients adds the nonzero test per
# slot, and per emission the magnitude category (2), the zero run (2),
# the table index (3), two table reads, the extra bits (3), the merge of
# code and extra bits (2) and the length (1).  Emissions are counted from
# the run's data.
MIN_OPS = {"pack_words": (2, 10), "encode_blocks": (3, 25),
           # counting: per slot the nonzero test and the zero run (3), per
           # symbol the category (2), the bin (3) and the count (1)
           "symbol_histograms": (3, 6)}
# The least 32-bit operations of the stream concat: per block the scan's
# add and the split of its offset (3), per word it places the two halves
# of the funnel shift, their merge and the store (4).
CONCAT_OPS = (3, 4)
# blocks one warp of each kernel takes (kBlocksPerWarp of the source; the
# histogram kernel takes one a thread)
BLOCKS_PER_WARP = {"pack_words": 1, "encode_blocks": 2,
                   "symbol_histograms": 32}
# The least 32-bit operations per decoded Huffman symbol, whatever decodes
# it: cut the 16-bit window (1), index the table (2), split length and
# value (2), cut and sign-extend the extra bits (4), the coefficient's
# position (2), advance the bit position (1).
MIN_OPS_PER_SYMBOL = 12
# The one-thread-per-segment kernel this one replaced, on the same
# segments (NVIDIA H100 80GB HBM3, 700 W; a reading kept from then, not
# taken again here).
EARLIER_SCAN_MS = 0.1052
KERNELS = ("pack_words", "encode_blocks", "decode_segments",
           "symbol_histograms", "concat_streams", "fdct_quantize",
           "idct_planes", "fdct_quantize_exact", "idct_planes_exact",
           "rgb_to_ycc420", "idct_planes_rgb", "ycc_planes_to_rgb")
# exact mode's kernels, whose SASS must hold no DFMA
EXACT_KERNELS = ("fdct_quantize_exact", "idct_planes_exact")
# the kernels that make torch's or the reference's roundings one operation
# at a time: no contracted multiply-add (FFMA, DFMA) may appear in their
# SASS, and the separate multiplies and adds of each precision they
# compute must
NO_FMA = {"fdct_quantize_exact": ("DMUL", "DADD"),
          "idct_planes_exact": ("DMUL", "DADD"),
          "rgb_to_ycc420": ("FMUL", "FADD", "DMUL", "DADD"),
          "idct_planes": ("FMUL", "FADD"),
          "idct_planes_rgb": ("FMUL", "FADD"),
          "ycc_planes_to_rgb": ("FMUL", "FADD", "DMUL", "DADD")}
SASS_OPS = ("FFMA", "DFMA", "FMUL", "FADD", "DMUL", "DADD")
# the rgb transport's kernels (phase 16)
RGB_KERNELS = ("rgb_to_ycc420", "idct_planes_rgb", "ycc_planes_to_rgb")
# the fused kernel's instantiation for the caller's tables (optimize), built
# and checked beside the fixed-table one, which keeps the name
ENCODE_CUSTOM = "encode_blocks (custom tables)"
# the earlier designs that the encode program's entropy kernel and concat
# replaced (scripts/previous_designs.cu), built and timed beside them in
# this run: the per-component fused kernel, the two-pass concat's scan
# and scatter
PREVIOUS = {"encode_blocks_kernel": "previous encode_blocks",
            "concat_offsets_kernel": "previous concat_streams (offsets)",
            "concat_scatter_kernel": "previous concat_streams (scatter)",
            "fdct_exact_first_kernel": "previous fdct_quantize_exact",
            "idct_exact_first_kernel": "previous idct_planes_exact",
            "idct_rgb_first_kernel": "previous idct_planes_rgb",
            "idct_overflow_first_kernel": "previous idct_planes overflow"}
SOURCES = {"pack_words": "jpezy_tpu_torch/csrc/entropy_pack.cu",
           "encode_blocks": "jpezy_tpu_torch/csrc/entropy_pack.cu",
           "decode_segments": "jpezy_tpu_torch/csrc/huffman_scan.cu",
           "symbol_histograms": "jpezy_tpu_torch/csrc/entropy_pack.cu",
           "concat_streams": "jpezy_tpu_torch/csrc/stream_concat.cu",
           "fdct_quantize": "jpezy_tpu_torch/csrc/block_transforms.cu",
           "idct_planes": "jpezy_tpu_torch/csrc/block_transforms.cu",
           "fdct_quantize_exact": "jpezy_tpu_torch/csrc/exact_transforms.cu",
           "idct_planes_exact": "jpezy_tpu_torch/csrc/exact_transforms.cu",
           "rgb_to_ycc420": "jpezy_tpu_torch/csrc/colour.cu",
           "idct_planes_rgb": "jpezy_tpu_torch/csrc/exact_transforms.cu",
           "ycc_planes_to_rgb": "jpezy_tpu_torch/csrc/colour.cu"}
REPLACES = {"pack_words": "jpezy_tpu/ops/pack_pallas.py:27",
            "encode_blocks": "jpezy_tpu/ops/pack_pallas.py:27",
            "decode_segments": "jpezy_tpu/ops/entropy_decode.py:211",
            "symbol_histograms": "jpezy_tpu/codec/jax_codec.py:464",
            "concat_streams": "jpezy_tpu/codec/jax_codec.py:317",
            "fdct_quantize": "jpezy_tpu/parallel/sharded.py:75",
            "idct_planes": "jpezy_tpu/codec/jax_codec.py:833",
            "fdct_quantize_exact": "jpezy_tpu/ops/dct.py:58",
            "idct_planes_exact": "jpezy_tpu/ops/dct.py:87",
            "rgb_to_ycc420": "jpezy_tpu/ops/colorspace.py:15",
            "idct_planes_rgb": "jpezy_tpu/ops/dct.py:73",
            "ycc_planes_to_rgb": "jpezy_tpu/ops/colorspace.py:30"}
# The block transforms' stages as plain torch on the card, as this script's
# phase 5 read them before the kernels (NVIDIA H100 80GB HBM3, 700 W; kept
# from then, not measured here): fDCT+quantize alone, the encode and
# ycc420 decode programs and the device decode program, device busy ms
# (device events).
EARLIER_PROGRAMS = {"fDCT+quantize": (0.1830, 24), "encode": (0.2441, 35),
                    "ycc420 decode": (0.9582, 97),
                    "device decode": (0.2497, 33)}
# Exact mode's device programs as plain float64 torch on the card, as this
# script's 11 device line read them before the exact kernels (NVIDIA H100
# 80GB HBM3, 700 W; kept from then, not measured here): device busy ms
# (device events).
EARLIER_EXACT = {"rgb exact encode": (7.7399, 634),
                 "exact decode": (7.7703, 827),
                 "gray exact decode": (5.0066, 270)}
# The same programs (and the exact ycc420 encode) with the exact kernels'
# first designs, as this script's 11 device line read them (NVIDIA H100
# 80GB HBM3, 700 W; kept from then, not measured here): device busy ms.
FIRST_EXACT_PROGRAMS = {"ycc420 exact encode": 0.1208,
                        "rgb exact encode": 0.1287,
                        "exact decode": 0.0413,
                        "gray exact decode": 0.0230}
# The rgb transport's device programs before the colour kernels and the
# fast rgb IDCT, as this script's 11 device line read them (NVIDIA H100
# 80GB HBM3, 700 W; kept from then, not measured here): device busy ms
# (device events).  Each now must be the hand kernels alone: 4 events an
# encode, 2 a decode.
EARLIER_RGB = {"rgb encode, fast": (0.3718, 26),
               "rgb encode, exact": (0.6949, 26),
               "rgb decode, fast": (0.5235, 56),
               "rgb decode, exact": (0.6447, 30),
               "rgb decode, gray exact": (0.0925, 5)}
# The three per-component histogram launches that the one-launch kernel
# replaced, summed (chip_smoke.py phase 6, PR 5 and PR 6: NVIDIA H100 80GB
# HBM3, 700 W; kept from then, not measured here).
EARLIER_HISTOGRAM_MS = 0.0268
# The concat stage of the encode program as plain torch on the card, as
# earlier runs read it (chip_smoke.py phase 5 stages, PR 5: NVIDIA H100
# 80GB HBM3, 700 W; kept from then); this run measures it again beside
# the kernel.
EARLIER_CONCAT_MS = 0.5805
# The encode programs before the entropy kernel took the DC predictors
# and the concat became one launch (fDCT kernel, three per-component
# entropy launches beside the plain predictor chains, the two-pass concat;
# this script's phase 5/8 device on an NVIDIA H100 80GB HBM3 at 700 W;
# kept from then, not measured here).
EARLIER_ENCODE = {"encode": "0.0818 ms busy in 12 events",
                  "restart encode": "0.1052 ms busy in 27 events"}
# The share of fdct_quantize's coefficients that may differ from the plain
# version's (phase 14): the separable form and the 64-term product round
# differently, each by at most 1.
FDCT_DIFF_SHARE = 2e-3
# phase 12's gloo ranks: the images they share, and each rank's steps
# with the launches every step must make
PARALLEL_IMAGES = 4
RANK_STEPS = {"exact_restart": {"encode_blocks": 1, "concat_streams": 1,
                                "fdct_quantize_exact": 1, "rgb_to_ycc420": 1},
              "exact_optimize": {"encode_blocks": 1, "symbol_histograms": 1,
                                 "concat_streams": 1,
                                 "fdct_quantize_exact": 1,
                                 "rgb_to_ycc420": 1},
              "fast_restart": {"encode_blocks": 1, "concat_streams": 1,
                               "fdct_quantize": 1, "rgb_to_ycc420": 1},
              "device_decode": {"decode_segments": 1, "idct_planes_rgb": 1,
                                "ycc_planes_to_rgb": 1},
              "corrupt_decode": {"decode_segments": 1, "idct_planes_rgb": 1,
                                 "ycc_planes_to_rgb": 1}}
RANK_TIMEOUT_S = 300
# the smaller batch of the card-against-CPU comparisons (phase 11): the
# plain versions on the host's CPU take seconds per image at 512x512
CPU_BATCH, CPU_HW = 2, 256


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from jpezy_tpu_torch.ops import (colour_cuda, concat_cuda, exact_cuda,
                                     pack_cuda, scan_cuda, transform_cuda)

    pack_cuda.launches = pack_cuda.encode_launches = 0
    pack_cuda.histogram_launches = scan_cuda.launches = 0
    concat_cuda.launches = 0
    transform_cuda.fdct_launches = transform_cuda.idct_launches = 0
    exact_cuda.fdct_exact_launches = exact_cuda.idct_exact_launches = 0
    exact_cuda.idct_rgb_launches = 0
    colour_cuda.rgb_to_ycc420_launches = 0
    colour_cuda.ycc_planes_to_rgb_launches = 0


def read_counts() -> dict:
    from jpezy_tpu_torch.ops import (colour_cuda, concat_cuda, exact_cuda,
                                     pack_cuda, scan_cuda, transform_cuda)

    return {"pack_words": pack_cuda.launches,
            "encode_blocks": pack_cuda.encode_launches,
            "decode_segments": scan_cuda.launches,
            "symbol_histograms": pack_cuda.histogram_launches,
            "concat_streams": concat_cuda.launches,
            "fdct_quantize": transform_cuda.fdct_launches,
            "idct_planes": transform_cuda.idct_launches,
            "fdct_quantize_exact": exact_cuda.fdct_exact_launches,
            "idct_planes_exact": exact_cuda.idct_exact_launches,
            "rgb_to_ycc420": colour_cuda.rgb_to_ycc420_launches,
            "idct_planes_rgb": exact_cuda.idct_rgb_launches,
            "ycc_planes_to_rgb": colour_cuda.ycc_planes_to_rgb_launches}


_T0 = time.perf_counter()


def _say(phase: str, msg: str) -> None:
    """One phase's line, with the seconds since the script started."""
    print(f"[{phase}] ({time.perf_counter() - _T0:.1f} s) {msg}", flush=True)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean CUDA-event span in ms per call of fn (events around `reps`
    calls, after one warm-up call).  For a sequence of many small launches
    the span includes the host's launch gaps; see _profile."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int) -> dict:
    """torch.profiler trace of `reps` calls of fn (after one warm-up call).

    Every fn traced here launches work on the card, so a trace that holds
    no device event lost its events (the profiler drops a whole trace now
    and then): it is taken again, up to three times in all.

    Returns per call: busy_ms, the durations of the kernels, copies and
    memsets traced on the card, summed (None if the trace holds no device
    events); events, their number; by_name, busy ms per device event
    name; wall_ms, the host's time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if dev:
            break
    us = sum(e.self_device_time_total for e in dev)
    return {"busy_ms": us / 1e3 / reps if us > 0 else None,
            "events": sum(e.count for e in dev) / reps,
            "wall_ms": 1e3 * wall / reps,
            "by_name": {e.key: e.self_device_time_total / 1e3 / reps
                        for e in dev}}


def _kernel_ms(prof: dict, name: str, required: bool = True):
    """Device ms per call of the kernels whose name holds `name`; if the
    trace holds none, raises (or None where not required)."""
    hit = [ms for key, ms in prof["by_name"].items() if name in key]
    if not hit or sum(hit) <= 0:
        if not required:
            return None
        raise RuntimeError(f"the profiler traced no device time for {name}")
    return sum(hit)


def _traced(fn, reps: int, *names: str):
    """(device ms per call of the kernels named, summed; the trace) of a
    torch.profiler trace of `reps` calls of fn.  A trace that lost a
    kernel's events (the profiler drops some now and then) is taken
    again, up to three times in all; then it raises."""
    for attempt in range(3):
        prof = _profile(fn, reps)
        ms = [_kernel_ms(prof, name, attempt == 2) for name in names]
        if None not in ms:
            return sum(ms), prof


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _images(n: int, seed0: int) -> np.ndarray:
    from imagegen import make_test_image

    return np.stack([make_test_image(H, W, seed=seed0 + i) for i in range(n)])


def _image_4k() -> np.ndarray:
    """One 3840x2160 RGB test image (32,400 MCUs)."""
    from imagegen import make_test_image

    return make_test_image(2160, 3840, seed=4096)


def _real_blocks(TC, HG, rgbs, dev):
    """Per-component ([B, 64] int32 quantized blocks, chroma) of a batch,
    as the main path makes them."""
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(
        torch.from_numpy(y).to(dev), torch.from_numpy(cb).to(dev),
        torch.from_numpy(cr).to(dev), gray=False, dtype=torch.float32,
        rounded=False)
    return [(qc.reshape(-1, 64), chroma)
            for qc, chroma in zip(q, (False, True, True))]


def _worst_case_blocks(dev, nblocks: int = 4096, seed: int = 5):
    """Seeded blocks with all 63 AC coefficients nonzero, |v| <= 1023."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 1024, size=(nblocks, 64)) * rng.choice(
        [-1, 1], (nblocks, 64))
    q[:, 0] = rng.integers(-1024, 1017, size=nblocks)
    qt = torch.from_numpy(q.astype(np.int32)).to(dev)
    return [(qt, False), (qt, True)]


def _kernel_of(symbol: str) -> str:
    if "encode_blocks_batch_kernelILb1E" in symbol:  # the custom-table form
        return ENCODE_CUSTOM
    for name in ("encode_blocks_batch", "decode_segments", "symbol_histograms",
                 "concat_streams", "fdct_quantize_exact", "idct_planes_exact",
                 "idct_planes_rgb", "rgb_to_ycc420", "ycc_planes_to_rgb",
                 "fdct_quantize", "idct_planes"):
        if name in symbol:
            return name.replace("_batch", "")
    return "pack_words"


def _previous_of(symbol: str):
    """The name of an earlier design's kernel in scripts/previous_designs.cu,
    None for the current kernels that file compiles again."""
    return next((name for key, name in PREVIOUS.items() if key in symbol),
                None)


def _ptxas_by_kernel(log: str, kernel_of=_kernel_of) -> dict:
    """nvcc -Xptxas -v output -> {kernel: resource lines}, the lines of
    every instantiation of a kernel template under its one name (kernels
    that kernel_of names None are left out)."""
    out, cur = {}, None
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            cur = kernel_of(ln.split("'")[1])
            if cur is not None:
                out.setdefault(cur, [])
        elif cur and ("registers" in ln or "stack frame" in ln):
            out[cur].append(ln.replace("ptxas info    : ", ""))
    return out


def _sass_instructions(nvcc: str, lib: str, opcodes=(),
                       kernel_of=_kernel_of) -> tuple:
    """({kernel: number of SASS instructions in its sm_90a code, summed
    over the instantiations of a template}, {kernel: {opcode: how many of
    its instructions are that opcode (predicated or not, any suffix)}}),
    from `cuobjdump -sass` of the built library, NOPs left out (kernels
    that kernel_of names None too)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()}")
    out, ops, cur = {}, {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            cur = kernel_of(ln.split(":", 1)[1])
            if cur is not None:
                out.setdefault(cur, 0)
                ops.setdefault(cur, dict.fromkeys(opcodes, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@\S+\s+)?([A-Z]\w*)",
                     ln)
        if cur and m and m.group(1) != "NOP":
            out[cur] += 1
            if m.group(1) in ops[cur]:
                ops[cur][m.group(1)] += 1
    return out, ops


def exact_fwd_ops(planes) -> int:
    """EXACT_FWD_OPS counted on the planes fdct_quantize_exact reads."""
    total = 0
    for p in planes:
        n, hh, ww = p.shape
        nz = (p.reshape(n, hh // 8, 8, ww // 8, 8) != 0).sum(dim=(2, 4))
        total += (EXACT_FWD_OPS[0] * int(nz.sum())
                  + EXACT_FWD_OPS[1] * int((nz > 0).sum()))
    return total


def exact_inv_ops(coeff, kw) -> int:
    """EXACT_INV_OPS counted on the coefficients idct_planes_exact
    transforms (component 0 alone with gray)."""
    c = coeff[:, :kw["sizes"][0]] if kw["gray"] else coeff
    nz = c.reshape(-1, 64) != 0
    per_term = torch.from_numpy(EXACT_INV_OPS[0]).to(c.device)
    return (int((nz * per_term).sum())
            + EXACT_INV_OPS[1] * int(nz.any(dim=1).sum()))


def rgb_inv_ops(coeff, kw, basis: np.ndarray) -> int:
    """The float32 operations that the fast rgb IDCT's roundings need,
    counted on the coefficients it transforms (component 0 alone with
    gray): per nonzero coefficient its 64 adds and one product per distinct
    |M[.][k]| of its k (a product d M[p][k] is the same, up to its sign, at
    every sample p where |M[p][k]| is; 384 over the 64 k).  A block's 64
    adds of the level balance the 64 first adds onto +0 it need not make."""
    per_k = torch.tensor([64 + len(np.unique(np.abs(basis[:, k])))
                          for k in range(64)], device=coeff.device)
    c = coeff[:, :kw["sizes"][0]] if kw["gray"] else coeff
    return int(((c.reshape(-1, 64) != 0) * per_k).sum())


def _bound(nbytes: int, ops: int, rate: float = PEAK_INT_OPS_PER_S):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over `rate` (the 32-bit rate, or the float32
    one)."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / rate
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _host_ms(fn, reps: int = 5) -> float:
    """Median wall time in ms of fn() on the host's clock."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _to_dev(kw: dict, dev) -> dict:
    """numpy arguments of decode_segments -> tensors on dev."""
    from jpezy_tpu_torch.ops.entropy_decode import words_tensor

    out = {}
    for k, v in kw.items():
        if k == "words":
            out[k] = words_tensor(v).to(dev)
        elif k == "max_blocks" or v is None:
            out[k] = v
        else:
            out[k] = torch.from_numpy(
                np.ascontiguousarray(v, np.int32)).to(dev)
    return out


def _restart_lanes(HG, streams, ri: int) -> dict:
    """decode_segments arguments (numpy) for a batch of restart streams,
    as the device transport makes them."""
    from jpezy_tpu_torch.bitstream.reader import parse

    pjs = [parse(s) for s in streams]
    nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    return dict(words=words, nblk=nblk, lut=lut, tsel=tsel, rawlen=rawlen,
                max_blocks=ri * 6)


def _indexed_lanes(HG, streams, k_mcus: int = 8) -> dict:
    """decode_segments arguments (numpy) for restart-free streams, as the
    indexed transport makes them."""
    from jpezy_tpu_torch.bitstream.reader import parse

    pjs = [parse(s) for s in streams]
    nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
    nseg = -(-nmcu // k_mcus)
    words, nblk, skip0, preds0 = HG._indexed_host_frontend(
        pjs, nmcu, k_mcus, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    return dict(words=words, nblk=nblk, lut=lut, tsel=tsel, skip0=skip0,
                preds0=preds0, max_blocks=k_mcus * 6)


def _edge_case_lanes(E, lut: np.ndarray, encode=None) -> dict:
    """entropy.edge_case_blocks in lanes of six (Y0..Y3 with the luma
    tables, Cb and Cr with the chroma tables, predictors reset per lane),
    each lane spliced into one segment on the host.  The lanes are the
    MCUs of one image with a restart interval of 1: encode(yq, cbq, crq)
    -> (words, bits) per component defaults to the plain version on the
    CPU."""
    from jpezy_tpu_torch.bitstream.splice import splice_blocks

    encode = encode or (lambda *c: E.encode_blocks_batch_plain(*c, 1))
    q = E.edge_case_blocks(3)
    q = q[: (q.shape[0] // 6) * 6].reshape(-1, 6, 64)
    L = q.shape[0]
    comps = (torch.from_numpy(q[:, :4].reshape(1, -1, 64).copy()),
             torch.from_numpy(q[None, :, 4].copy()),
             torch.from_numpy(q[None, :, 5].copy()))
    (wy, wcb, wcr), (by, bcb, bcr) = encode(*comps)
    w = torch.cat([wy.cpu().reshape(L, 4, 64), wcb.cpu().reshape(L, 1, 64),
                   wcr.cpu().reshape(L, 1, 64)], 1).reshape(-1, 64)
    b = torch.cat([by.cpu().reshape(L, 4), bcb.cpu().reshape(L, 1),
                   bcr.cpu().reshape(L, 1)], 1).reshape(-1)
    w = w.numpy().astype(np.uint32)
    b = b.numpy().astype(np.int32)
    raws = [splice_blocks(w[i:i + 6], b[i:i + 6])[0]
            for i in range(0, w.shape[0], 6)]
    L = (max(map(len, raws)) + 8 + 3) // 4 * 4
    rows = np.zeros((len(raws), L), np.uint8)
    for i, raw in enumerate(raws):
        rows[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    return dict(words=rows.view(">u4").astype("=u4"),
                nblk=np.full(len(raws), 6, np.int32), lut=lut,
                rawlen=np.array([len(r) for r in raws], np.int32),
                max_blocks=6), q.astype(np.int16)


def _long_code_lanes(E, lut: np.ndarray, dev):
    """_edge_case_lanes with the luma AC table replaced by one whose 162
    codes all have 10 to 14 bits, so that a first-level table of up to 9
    index bits answers no luma AC symbol.  The blocks are encoded on the
    card by the batched entropy kernel, which takes the tables as
    arrays."""
    from jpezy_tpu_torch.bitstream.reader import HuffTable
    from jpezy_tpu_torch.core import tables as T
    from jpezy_tpu_torch.runtime.native import _huff_lut

    bits = bytes([0] * 9 + [20, 30, 40, 40, 32, 0, 0])
    sizes, codes = T.build_canonical_codes(bits)
    ac_size, ac_code = T.huffval_to_flat_ac(T.AC_LUMA_VALS, sizes, codes)
    long_lut = np.array(lut)
    long_lut[1] = _huff_lut(HuffTable(
        sizes, codes, np.frombuffer(T.AC_LUMA_VALS, np.uint8).astype(np.int32)))
    if int((long_lut[1][long_lut[1] >= 0] & 0xFF).min()) < 10:
        raise AssertionError("a luma AC code shorter than 10 bits")
    dc_size, dc_code, _, _ = E.annex_k_tables("cpu", False)
    rows = (E.kernel_tables((dc_size, dc_code, ac_size, ac_code), dev),
            E.kernel_tables(E.annex_k_tables("cpu", True), dev))

    def encode(*comps):
        return E.encode_blocks_batch(*(c.to(dev) for c in comps), 1,
                                     tables=rows)

    return _edge_case_lanes(E, long_lut, encode)


PER_LANE = ("words", "nblk", "tsel", "rawlen", "skip0", "preds0")


def _take_lanes(kw: dict, index) -> dict:
    """The decode_segments arguments `kw` (numpy) with the lanes `index`
    (a slice or an index array)."""
    return {k: (v[index] if k in PER_LANE and v is not None else v)
            for k, v in kw.items()}


def _repad(kw: dict, lw: int) -> dict:
    """`kw` with its rows zero-extended to lw words."""
    words = kw["words"]
    wide = np.zeros((words.shape[0], lw), words.dtype)
    wide[:, :words.shape[1]] = words
    return dict(kw, words=wide)


def _first_level_share(E, blocks, nblk, lut6: np.ndarray, bits: int):
    """(symbols with a code of at most `bits` bits, all symbols) that
    decoding these blocks takes with the table set lut6 [6, 65536], DC
    predictors starting at 0 in every lane: what a first-level table of
    `bits` index bits answers.  Counted on the host from the decoded
    blocks and the LUT's code lengths."""
    from jpezy_tpu_torch.constants import codec_constants

    S, mb, _ = blocks.shape
    dev = blocks.device
    lens = np.full((6, 256), 99, np.int64)     # code length by row, symbol
    for r in range(6):
        e = lut6[r][lut6[r] >= 0]
        lens[r, e >> 8] = e & 0xFF
    short = torch.from_numpy(lens <= bits).to(dev)
    live = (torch.arange(mb, device=dev)[None, :]
            < nblk[:, None].to(torch.int64))
    slot = torch.arange(mb, device=dev) % 6
    zigzag = codec_constants(dev)["zigzag"]
    hit = total = 0
    for comp, slots in enumerate((slot < 4, slot == 4, slot == 5)):
        q = blocks[:, slots].to(torch.int64)               # [S, n, 64]
        on = live[:, slots]
        dc_sym = E.bit_category(q[..., 0] - E.dc_predictors(q[..., 0]))
        _, nz, zrl, rem, s_ac = E._ac_run_size(q.reshape(-1, 64), zigzag)
        on_ac = on.reshape(-1, 1)
        ac_sym = ((rem << 4) | s_ac)[nz & on_ac]
        n_zrl = int((zrl * on_ac).sum())
        n_eob = int((~nz[:, -1] & on_ac[:, 0]).sum())
        dc_row, ac_row = short[2 * comp], short[2 * comp + 1]
        hit += (int(dc_row[dc_sym[on]].sum()) + int(ac_row[ac_sym].sum())
                + n_zrl * int(ac_row[0xF0]) + n_eob * int(ac_row[0x00]))
        total += int(on.sum()) + ac_sym.numel() + n_zrl + n_eob
    return hit, total


def _count_symbols(E, blocks: torch.Tensor, nblk: torch.Tensor):
    """Huffman symbols that decoding these blocks takes: per decoded block
    one DC symbol, one per nonzero AC coefficient, the ZRLs before them,
    and an EOB unless zigzag position 63 is nonzero.  Returns (total,
    per-lane counts [S])."""
    from jpezy_tpu_torch.constants import codec_constants

    S, mb, _ = blocks.shape
    live = (torch.arange(mb, device=blocks.device)[None, :]
            < nblk[:, None].to(torch.int64))
    _, nz, zrl, _, _ = E._ac_run_size(
        blocks.reshape(-1, 64), codec_constants(blocks.device)["zigzag"])
    per_block = (1 + nz.sum(1) + zrl.sum(1) + (~nz[:, -1]).to(torch.int64))
    per_lane = (per_block.reshape(S, mb) * live).sum(1)
    return int(per_lane.sum()), per_lane


def _destuff_batch(pjs, nmcu: int, ri: int, nseg: int, nthreads: int):
    """The destuff calls of HG._device_host_frontend with `nthreads` per
    call (0: the host library's default, a thread per hardware core)."""
    from jpezy_tpu_torch.runtime import native

    rows = np.zeros((nseg, 256), np.uint8)
    lens = np.zeros(nseg, np.int64)
    for pj in pjs:
        d = np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
        rows[:] = 0
        native.destuff_segments(d, native.find_restart_offsets(d, nmcu, ri),
                                rows, lens, nthreads=nthreads)


def _rst_sequence(stream: bytes, entropy_start: int) -> np.ndarray:
    """Indices n of the RSTn markers in a stream's entropy data, in order."""
    d = np.frombuffer(stream, np.uint8)[entropy_start:-2]
    at = np.nonzero((d[:-1] == 0xFF) & (d[1:] >= 0xD0) & (d[1:] <= 0xD7))[0]
    return d[at + 1].astype(np.int64) - 0xD0


def _dht(stream: bytes) -> bytes:
    """The DHT segments of a stream (our writer puts them last before SOS)."""
    from jpezy_tpu_torch.bitstream.reader import parse

    return stream[stream.find(b"\xff\xc4"):parse(stream).entropy_start]


def _long_emission_bytes(E, encode) -> tuple[bytes, bytes, int]:
    """Two MCUs of entropy.long_emission_blocks, every component on
    entropy.long_emission_tables (slots of up to 74 bits): (stuffed
    entropy bytes of encode(yq, cbq, crq, tables) -> per-component (words,
    bits), the host C++ encoder's bytes, the longest slot in bits)."""
    from jpezy_tpu_torch.bitstream import writer
    from jpezy_tpu_torch.bitstream.splice import splice_blocks
    from jpezy_tpu_torch.codec import host_codec
    from jpezy_tpu_torch.runtime import native

    _, _, *tabs = E.long_emission_tables()
    q = E.long_emission_blocks()
    q12 = np.concatenate([q, q[:4]])
    comps = (np.concatenate([q12[0:4], q12[6:10]]), q12[[4, 10]],
             q12[[5, 11]])
    packed = (host_codec._packed_dc(tabs[0], tabs[1]),
              host_codec._packed_ac(tabs[2], tabs[3]))
    ref = native.entropy_encode(*comps, 0, *packed, *packed)
    (wy, wc, wr), (by, bc, br) = encode(
        *(torch.from_numpy(c)[None] for c in comps), (tabs, tabs))
    wy, wc, wr = (w[0].cpu() for w in (wy, wc, wr))
    by, bc, br = (b[0].cpu() for b in (by, bc, br))
    words = torch.cat([wy[:4], wc[:1], wr[:1], wy[4:], wc[1:], wr[1:]])
    bits = torch.cat([by[:4], bc[:1], br[:1], by[4:], bc[1:], br[1:]])
    raw, _ = splice_blocks(words.numpy().astype(np.uint32), bits.numpy())
    t = torch.from_numpy(q)
    _, _, nb = E.block_emissions(t, E.dc_predictors(t[:, 0]), False, tabs)
    return writer.byte_stuff(raw), ref, int(nb.max())


def _hist_sets(E, comps, dev):
    """(label, (yq, cbq, crq), restart_interval, carry) of the histogram
    kernel's checks: the real batch's components without and with restarts
    and with a carry, then images of 1 to 140 blocks a component cut from
    the edge-case blocks (a thread block's run ends inside a chain, chains
    of one block, chroma longer than luma) and the long-emission blocks."""
    edge = torch.cat([torch.from_numpy(E.edge_case_blocks(3)).to(dev)] * 4)
    longq = torch.from_numpy(E.long_emission_blocks()).to(dev)
    carry = torch.from_numpy(np.random.default_rng(13).integers(
        -1000, 1000, (comps[0].shape[0], 3)).astype(np.int32)).to(dev)
    sets = [("real", comps, 0, None), ("real", comps, RESTART_INTERVAL, None),
            ("real, carry", comps, 0, carry),
            ("real, carry", comps, RESTART_INTERVAL, carry)]
    for ny, nc in ((1, 1), (4, 1), (7, 3), (140, 35), (128, 129),
                   (130, 140)):
        n = edge.shape[0] // (ny + 2 * nc)
        blk = edge[:n * (ny + 2 * nc)].reshape(n, -1, 64)
        cs = (blk[:, :ny], blk[:, ny:ny + nc], blk[:, ny + nc:])
        sets += [(f"edge, images of {ny}+{nc}+{nc} blocks", cs, r_i, None)
                 for r_i in (0, 1, 3)]
    lq = longq.reshape(2, 4, 64)
    sets.append(("long", (lq, lq[:, :1], lq[:, 1:2]), 0, None))
    return sets


def _per_batch(**per_batch) -> dict:
    """Every kernel's launches over MAIN_BATCHES batches, from its launches
    per batch (0 where not given)."""
    return {k: MAIN_BATCHES * per_batch.get(k, 0) for k in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from jpezy_tpu_torch.codec import host_codec
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.device import check_fp32_precision, resolve
    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.ops import cuda_build
    from jpezy_tpu_torch.ops import entropy as E
    from jpezy_tpu_torch.ops import entropy_decode as ED
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.testing import exact_ties as XT
    from jpezy_tpu_torch.testing import rgb_ties as RT
    from jpezy_tpu_torch.testing import ycc_uploads as YU
    from jpezy_tpu_torch.ops import (colour_cuda, concat_cuda, exact_cuda,
                                     pack_cuda, scan_cuda, transform_cuda)
    from jpezy_tpu_torch.runtime import batch as RB
    import fp64_ceiling
    import previous_designs
    from jpezy_tpu_torch.runtime.pipeline import (decode_batches,
                                                  encode_batches,
                                                  roundtrip_batches)

    # ---- 1. environment
    card = _card()
    check_fp32_precision()
    dev = resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    _say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]} device {kind} x"
         f"{torch.cuda.device_count()}; nvidia-smi: {card}; "
         f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
         f"fp32_matmul_precision={torch.get_float32_matmul_precision()}")

    # ---- 2. build the kernels from the checkout's sources, all at once
    import concurrent.futures as cf

    libs = (pack_cuda.LIB, scan_cuda.LIB, concat_cuda.LIB,
            transform_cuda.LIB, exact_cuda.LIB, colour_cuda.LIB)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(libs) + 2) as ex:
        secs = list(ex.map(lambda lib: lib.build(force=True),
                           libs + (previous_designs.LIB, fp64_ceiling.LIB)))
    build_wall = time.perf_counter() - t0
    ptxas, sass, sass_ops = {}, {}, {}
    for lib in libs:
        lib.get()
        ptxas.update(_ptxas_by_kernel(lib.build_log))
        n_sass, ops = _sass_instructions(cuda_build.nvcc(), lib.so,
                                         SASS_OPS)
        sass.update(n_sass)
        sass_ops.update(ops)
    built = sorted(KERNELS + (ENCODE_CUSTOM,))
    if sorted(ptxas) != built or sorted(sass) != built \
            or min(sass.values()) <= 0:
        raise AssertionError(
            f"ptxas reported {sorted(ptxas)}, cuobjdump {sass}:\n"
            + "\n".join(lib.build_log for lib in libs))
    # exact mode and the rgb transport's kernels: every multiply and add
    # separate, none contracted
    for k, want in NO_FMA.items():
        if sass_ops[k]["DFMA"] or sass_ops[k]["FFMA"] or not all(
                sass_ops[k][op] for op in want):
            raise AssertionError(f"{k}'s SASS holds {sass_ops[k]}: want "
                                 f"{', '.join(want)} and no FFMA or DFMA")
    previous_designs.LIB.get()
    fp64_ceiling.LIB.get()
    prev_ptxas = _ptxas_by_kernel(previous_designs.LIB.build_log,
                                  _previous_of)
    if sorted(prev_ptxas) != sorted(PREVIOUS.values()):
        raise AssertionError(f"ptxas reported {sorted(prev_ptxas)} of the "
                             f"earlier designs:\n"
                             f"{previous_designs.LIB.build_log}")
    # the earlier exact designs' float64 operations, for phase 6
    _, prev_ops = _sass_instructions(cuda_build.nvcc(),
                                     previous_designs.LIB.so, SASS_OPS,
                                     _previous_of)
    # and the ycc420 IDCT's overflow launch alone (its three kernels share
    # the name idct_planes above)
    ovf_sass, ovf_ops = _sass_instructions(
        cuda_build.nvcc(), transform_cuda.LIB.so, SASS_OPS,
        lambda sym: "overflow" if "idct_planes_overflow" in sym else None)
    _say("2 build", ", ".join(os.path.basename(lib.src) for lib in libs)
         + f" and the earlier designs' scripts/previous_designs.cu and the "
         f"float64 chains of scripts/fp64_ceiling.cu built for "
         f"sm_90a side by side in {build_wall:.2f} s (nvcc "
         + ", ".join(f"{t:.2f}" for t in secs) + " s); "
         + " || ".join(f"{k}: {' | '.join(v)} | {sass[k]} SASS instructions"
                       + (" (" + ", ".join(f"{n} {op}" for op, n in
                                           sass_ops[k].items()) + ")"
                          if k in NO_FMA else "")
                       for k, v in ptxas.items())
         + " || " + " || ".join(f"{k}: {' | '.join(v)}"
                                for k, v in prev_ptxas.items()))
    for k, lines in list(ptxas.items()) + list(prev_ptxas.items()):
        frames = [ln for ln in lines if "stack frame" in ln]
        clean = ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                 "loads")
        if not frames:
            raise AssertionError(f"ptxas printed no stack frame for {k}")
        for ln in frames:
            # the scan kernel may keep a stack frame; nothing may spill
            ok = (ln.endswith(clean[clean.index("0 bytes spill"):])
                  if k == "decode_segments" else ln.startswith(clean))
            if not ok:
                raise AssertionError(f"{k} uses local memory: {lines}")

    # ---- 3. the pack kernels against their plain torch versions
    real = _real_blocks(TC, HG, _images(BATCH, 0), dev)
    real_comps = tuple(q.reshape(BATCH, -1, 64) for q, _ in real)
    edge = torch.from_numpy(E.edge_case_blocks(3)).to(dev)
    worst = _worst_case_blocks(dev)[0][0]
    err = {"pack_words": 0, "encode_blocks": 0}
    real_inputs = []       # (q, pred, chroma, (hi, lo, nbits)) of the batch
    pack_cuda.launches = pack_cuda.encode_launches = 0
    # the pack alone, per component: the real blocks (per-image DC chains,
    # as the encode program has them), the worst-case and edge-case blocks
    # (one chain), luma and chroma tables
    for label, blocks in (("real", real),
                          ("worst", [(worst, False), (worst, True)]),
                          ("edge", [(edge, False), (edge[:-1], True)])):
        for q, chroma in blocks:
            chains = BATCH if label == "real" else 1
            pred = E.dc_predictors(q[:, 0].reshape(chains, -1)).reshape(-1)
            ems = E.block_emissions(q, pred, chroma)
            wp, bp = E.pack_block_words_plain(*ems)
            wk, bk = pack_cuda.pack_words_cuda(*ems)
            torch.cuda.synchronize()
            e = max(int((wk - wp).abs().max()), int(
                (bk.to(torch.int64) - bp.to(torch.int64)).abs().max()))
            err["pack_words"] = max(err["pack_words"], e)
            if e or wk.dtype != torch.int64:
                raise AssertionError(
                    f"pack_words kernel != plain version on {label} blocks "
                    f"[{q.shape[0]}, 64] chroma={chroma}")
            if label == "real":
                real_inputs.append((q, pred, chroma, ems))
        if label == "real":
            # the pack alone is off the main path: its count is this one
            pack_alone_launches = pack_cuda.launches
    if pack_alone_launches != len(real_inputs):
        raise AssertionError(f"pack_words launched {pack_alone_launches} "
                             f"times on {len(real_inputs)} components")
    # the batched entropy kernel, one launch a set for the three components:
    # the real batch, then the worst-case and edge-case blocks as one
    # image's components (Y with the luma tables, Cb and Cr with the chroma
    # ones), with restart intervals that reset the chains
    k4 = worst.shape[0] // 4
    ke = edge.shape[0] // 4
    enc_sets = [("real", real_comps, 0), ("real", real_comps, RESTART_INTERVAL),
                ("worst", (worst[None], worst[None, :k4], worst[None, -k4:]),
                 0),
                ("edge", (edge[None], edge[None, :ke], edge[None, -ke:]), 1)]
    worst_bits = 0
    for label, comps3, r_i in enc_sets:
        wk, bk = pack_cuda.encode_blocks_batch_cuda(*comps3,
                                                    restart_interval=r_i)
        wp, bp = E.encode_blocks_batch_plain(*comps3, r_i)
        torch.cuda.synchronize()
        e = max(max(int((a - b).abs().max()) for a, b in zip(wk, wp)),
                max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    for a, b in zip(bk, bp)))
        err["encode_blocks"] = max(err["encode_blocks"], e)
        if e or wk[0].dtype != torch.int64:
            raise AssertionError(
                f"encode_blocks kernel != plain version on {label} blocks "
                f"{[tuple(c.shape) for c in comps3]}, restart_interval={r_i}")
        if label == "worst":
            worst_bits = max(int(b.max()) for b in bp)
    if pack_cuda.encode_launches != len(enc_sets):
        raise AssertionError(f"encode_blocks launched "
                             f"{pack_cuda.encode_launches} times on "
                             f"{len(enc_sets)} sets")
    if worst_bits <= 32 * 32:
        raise AssertionError(f"worst-case blocks reach only {worst_bits} bits")

    n_edge = edge.shape[0]
    _say("3 kernels", f"pack_words (per component) and encode_blocks (one "
         f"launch for the three components, predictors found in the kernel)"
         f": words and bits identical to the plain versions on real "
         f"{[tuple(q.shape) for q in real_comps]} with restart_interval 0 "
         f"and {RESTART_INTERVAL}, worst-case (max {worst_bits} bits/block) "
         f"and {n_edge} edge-case blocks; pack_words launches on the real "
         f"blocks {pack_alone_launches}, encode_blocks "
         f"{pack_cuda.encode_launches} on {len(enc_sets)} sets")
    del real, edge, worst, ems, wp, bp, wk, bk, q, pred
    torch.cuda.empty_cache()

    # ---- 7. the scan kernel against its plain torch version
    scan_cuda.launches = 0
    restart0 = TC.encode_batch(_images(BATCH, 0),
                               restart_interval=RESTART_INTERVAL,
                               device="cuda")
    plain0 = TC.encode_batch(_images(BATCH, 0), device="cuda")
    rng = np.random.default_rng(7)
    noise = TC.encode_batch(
        rng.integers(0, 256, (4, 128, 128, 3), np.uint8), restart_interval=1,
        quality=95, device="cuda")
    optimized = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                   optimize=True, restart_interval=4)
                 for im in _images(4, 50)[:, :128, :128]]
    standard = TC.encode_batch(_images(4, 50)[:, :128, :128],
                               restart_interval=4, device="cuda")
    real_np = _restart_lanes(HG, restart0, RESTART_INTERVAL)
    std_lut = real_np["lut"][0]
    edge_np, edge_q = _edge_case_lanes(E, std_lut)
    scan_sets = [("real", real_np),
                 ("noise", _restart_lanes(HG, noise, 1)),
                 ("edge", edge_np),
                 ("indexed", _indexed_lanes(HG, plain0)),
                 ("two table sets", _restart_lanes(
                     HG, [standard[0], optimized[1], standard[2],
                          optimized[3]], 4))]
    sub = _take_lanes(real_np, slice(0, 256))
    scan_sets += [(f"corrupt {seed}", dict(sub, words=ED.corrupt_rows(
        sub["words"], sub["rawlen"], seed))) for seed in range(4)]
    # the shapes the kernel's layout is sensitive to
    short_rows = _restart_lanes(HG, TC.encode_batch(
        _images(4, 60)[:, :128, :128], restart_interval=2, device="cuda"), 2)
    long_rows = _restart_lanes(HG, TC.encode_batch(
        _images(2, 70)[:, :256, :256], restart_interval=32, quality=95,
        device="cuda"), 32)
    noise_rows = _restart_lanes(HG, TC.encode_batch(
        rng.integers(0, 256, (1, 128, 128, 3), np.uint8),
        restart_interval=16, quality=95, device="cuda"), 16)
    two_sets = scan_sets[4][1]
    n2 = two_sets["words"].shape[0]
    mixed = _take_lanes(two_sets, np.arange(n2).reshape(4, -1).T.reshape(-1))
    long_np, long_q = _long_code_lanes(E, std_lut, dev)
    layout = scan_cuda.layout()
    if short_rows["words"].shape[1] != 16 or min(
            long_rows["words"].shape[1], noise_rows["words"].shape[1]) <= 128:
        raise AssertionError("the short and long rows are not what they "
                             "were meant to be")
    if len(set(mixed["tsel"][:layout["warps_per_block"]])) < 2:
        raise AssertionError("no thread block holds two table sets")
    scan_sets += [("rows of 16 words", short_rows),
                  ("re-padded to 64 words", _repad(sub, 64)),
                  ("re-padded to 128 words", _repad(sub, 128)),
                  ("quality 95, restart_interval=32", long_rows),
                  ("noise, quality 95, restart_interval=16", noise_rows),
                  ("two table sets interleaved", mixed),
                  ("luma AC codes of 10 to 14 bits", long_np)]
    err["decode_segments"] = 0
    scan_plain_ms = None
    flagged = lanes_seen = 0
    for label, kw in scan_sets:
        args = _to_dev(kw, dev)
        gb, gbad = ED.decode_segments(**args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb, pbad = ED.decode_segments_plain(**args)
        torch.cuda.synchronize()
        if label == "real":
            # one call of the plain version at the full width, on the card
            scan_plain_ms = 1e3 * (time.perf_counter() - t0)
            real_args, real_blocks = args, gb
        e = max(int((gb.to(torch.int32) - pb.to(torch.int32)).abs().max()),
                int((gbad != pbad).sum()))
        err["decode_segments"] = max(err["decode_segments"], e)
        if e or gb.dtype != torch.int16 or gbad.dtype != torch.bool:
            raise AssertionError(
                f"decode_segments kernel != plain version on {label} "
                f"segments {tuple(kw['words'].shape)}")
        if label.startswith("corrupt"):
            flagged += int(pbad.sum())
            lanes_seen += pbad.numel()
        elif bool(pbad.any()):
            raise AssertionError(f"{label} segments flagged as corrupt")
        for name, want in (("edge", edge_q), ("luma AC codes", long_q)):
            if label.startswith(name) and not np.array_equal(
                    gb.cpu().numpy(), want):
                raise AssertionError(f"{label}: the blocks do not survive "
                                     "the scan")
    if not 0 < flagged < lanes_seen:
        raise AssertionError(f"corruption sweep flagged {flagged} of "
                             f"{lanes_seen} lanes")
    # Into a buffer filled with a pattern: more block slots than any
    # segment decodes, segments with no blocks or a few, a segment count
    # that fills no whole thread block.  A slot the kernel forgets shows.
    ragged = _take_lanes(dict(real_np, rawlen=None), slice(0, 253))
    ragged["nblk"] = ragged["nblk"].copy()
    ragged["nblk"][::7] = 0
    ragged["nblk"][3::11] = 18
    ragged["max_blocks"] = real_np["max_blocks"] + 7
    args = _to_dev(ragged, dev)
    gb = torch.full((253, ragged["max_blocks"], 64), 0x5A5A,
                    dtype=torch.int16, device=dev)
    gbad = torch.full((253,), 0x5A, dtype=torch.uint8, device=dev)
    scan_cuda._launch([args.get(k) for k in (
        "words", "nblk", "lut", "tsel", "rawlen", "skip0", "preds0")],
        gb, gbad)
    pb, pbad = ED.decode_segments_plain(**args)
    torch.cuda.synchronize()
    if (253 % layout["warps_per_block"] == 0 or not torch.equal(gb, pb)
            or not torch.equal(gbad.bool(), pbad) or bool(pbad.any())
            or int(gbad.max()) > 1):
        raise AssertionError("decode_segments kernel != plain version into "
                             "a buffer filled with a pattern")
    if scan_cuda.launches != len(scan_sets) + 1:
        raise AssertionError(f"scan kernel launched {scan_cuda.launches} "
                             f"times in {len(scan_sets) + 1} comparisons")
    _say("7 scan", "decode_segments: blocks and flags identical to the "
         "plain version on "
         + ", ".join(f"{label} {tuple(kw['words'].shape)} x "
                     f"{kw['max_blocks']} blocks" for label, kw in scan_sets)
         + f"; and into a buffer filled with a pattern, {gb.shape[0]} "
         f"segments x {gb.shape[1]} slots with "
         f"{int((ragged['nblk'] == 0).sum())} segments of no blocks; the "
         f"sweep flagged {flagged} of {lanes_seen} lanes; plain version on "
         f"the real segments {scan_plain_ms:.1f} ms (one call)")
    del scan_sets, sub, args, gb, gbad, pb, pbad
    torch.cuda.empty_cache()

    # ---- 4. exact parity with the host C++ codec
    imgs4 = _images(4, 100)
    reset_counts()
    got = TC.encode_batch(imgs4, precision="exact", device="cuda")
    ref = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2]) for im in imgs4]
    if got != ref:
        bad = [i for i in range(4) if got[i] != ref[i]]
        raise AssertionError(f"exact encode differs from host_codec on {bad}")
    got_r = TC.encode_batch(imgs4, precision="exact",
                            restart_interval=RESTART_INTERVAL, device="cuda")
    ref_r = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                               restart_interval=RESTART_INTERVAL)
             for im in imgs4]
    if got_r != ref_r:
        bad = [i for i in range(4) if got_r[i] != ref_r[i]]
        raise AssertionError(
            f"exact restart encode differs from host_codec on {bad}")
    exact4_launches = read_counts()
    if exact4_launches != {k: 2 * int(k in ("fdct_quantize_exact",
                                            "encode_blocks",
                                            "concat_streams"))
                           for k in KERNELS}:
        raise AssertionError(f"two exact encodes launched {exact4_launches}:"
                             " want the exact fDCT, entropy and concat "
                             "kernels once each a call")
    px, _ = TC.decode_batch(got, device="cuda")
    host_px = np.stack([np.stack(host_codec.decode(s)[:3], -1) for s in got])
    p_port, p_host = _psnr(px, imgs4), _psnr(host_px, imgs4)
    diff = np.abs(px.astype(np.int32) - host_px.astype(np.int32))
    if p_port < p_host - PSNR_SLACK_DB:
        raise AssertionError(f"port decode PSNR {p_port} < host {p_host}")
    _say("4 exact", f"4x{H}x{W} exact encode byte-identical to host_codec "
         f"({sum(map(len, got))} bytes), and with restart_interval="
         f"{RESTART_INTERVAL} ({sum(map(len, got_r))} bytes), launches "
         f"{ {k: v for k, v in exact4_launches.items() if v} }; decode PSNR "
         f"port {p_port:.4f} dB, "
         f"host {p_host:.4f} dB, max |diff| {int(diff.max())}, "
         f"{float((diff > 0).mean()):.5f} of samples differ")

    # ---- 5. the main path: pipelined round trip on the card
    batches = [_images(BATCH, 1000 + BATCH * i) for i in range(MAIN_BATCHES)]
    for _ in roundtrip_batches(batches[:1], device="cuda"):
        pass  # warm-up: CUDA context, cuBLAS handle, first allocations
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = list(roundtrip_batches(batches, lookahead=1, device="cuda"))
    wall = time.perf_counter() - t0
    main_launches = read_counts()
    if main_launches != _per_batch(fdct_quantize=1, encode_blocks=1,
                                   concat_streams=1, idct_planes=1):
        raise AssertionError(
            f"main path launches {main_launches}: want per batch the fDCT "
            "kernel, the fused kernel, the concat and the IDCT kernel once "
            "each, and no other kernel")
    streams = [s for ss, _ in results for s in ss]
    src = np.concatenate(batches)
    px = np.concatenate([p for _, p in results])
    for s in streams:
        if s[:2] != b"\xff\xd8" or s[-2:] != b"\xff\xd9":
            raise AssertionError("stream without SOI/EOI")
    host_dec = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                         for s in streams])
    # the host codec's streams of the batches (phase 15's exact paths are
    # held to them too) and their round trip
    host_streams = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2])
                    for im in src]
    ref_rt = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                       for s in host_streams])
    p_rt, p_hostdec, p_ref = (_psnr(px, src), _psnr(host_dec, src),
                              _psnr(ref_rt, src))
    if p_rt < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"round-trip PSNR {p_rt} < host exact {p_ref}")
    if p_hostdec < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"host decode of the port's streams: PSNR "
                             f"{p_hostdec} < host exact {p_ref}")
    mps = len(streams) * H * W / 1e6 / wall
    mpix = len(streams) * H * W / 1e6
    _say("5 main", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W} fast "
         f"round trip: {len(streams)} streams decode; PSNR port "
         f"{p_rt:.4f} dB, host decode of port streams {p_hostdec:.4f} dB, "
         f"host exact round trip {p_ref:.4f} dB; launches {main_launches}; "
         f"pipelined {mps:.3f} MP/s (wall {wall:.3f} s) on {card}")

    # ---- 8. the restart path: restart encode, device Huffman decode
    ri = RESTART_INTERVAL
    rt_kw = dict(lookahead=1, restart_interval=ri, transport="device",
                 device="cuda")
    for _ in roundtrip_batches(batches[:1], **rt_kw):
        pass  # warm-up of this path's shapes
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rresults = list(roundtrip_batches(batches, **rt_kw))
    rwall = time.perf_counter() - t0
    restart_launches = read_counts()
    if restart_launches != _per_batch(fdct_quantize=1, encode_blocks=1,
                                      concat_streams=1, decode_segments=1,
                                      idct_planes=1):
        raise AssertionError(
            f"restart path launches {restart_launches}: want per batch the "
            "fDCT kernel, the fused kernel, the concat, the scan and the "
            "IDCT kernel once each")
    nseg = -(-(H // 16) * (W // 16) // ri)
    want_rst = np.arange(nseg - 1) % 8
    for ss, rpx in rresults:
        for s in ss:
            pj = parse(s)
            if s[:2] != b"\xff\xd8" or s[-2:] != b"\xff\xd9":
                raise AssertionError("restart stream without SOI/EOI")
            if pj.restart_interval != ri:
                raise AssertionError(f"DRI says {pj.restart_interval}")
            if not np.array_equal(_rst_sequence(s, pj.entropy_start),
                                  want_rst):
                raise AssertionError("RSTn markers do not cycle 0..7 "
                                     f"{nseg - 1} times")
        ypx, _ = TC.decode_batch(ss, transport="ycc420", device="cuda")
        if not np.array_equal(rpx, ypx):
            raise AssertionError("device transport's pixels differ from the "
                                 "ycc420 transport's")
    rstreams = [s for ss, _ in rresults for s in ss]
    rpx_all = np.concatenate([p for _, p in rresults])
    rhost = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                      for s in rstreams])
    p_r, p_rhost = _psnr(rpx_all, src), _psnr(rhost, src)
    if min(p_r, p_rhost) < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"restart round-trip PSNR {p_r} / host decode "
                             f"{p_rhost} < host exact {p_ref}")
    # one corrupted stream must raise, naming it
    broken = bytearray(rstreams[1])
    es = parse(rstreams[1]).entropy_start
    broken[es:es + 8] = bytes(8)
    try:
        TC.decode_batch([rstreams[0], bytes(broken)], transport="device",
                        device="cuda")
    except ValueError as exc:
        if "corrupt" not in str(exc) or "[1]" not in str(exc):
            raise
    else:
        raise AssertionError("a corrupted restart stream decoded")

    # indexed: the device Huffman decode of the main path's streams
    plain_lists = [ss for ss, _ in results]
    restart_lists = [ss for ss, _ in rresults]
    dec_walls, dec_launches = {}, {}
    for label, lists, transport in (
            ("ycc420", plain_lists, "ycc420"),
            ("device", restart_lists, "device"),
            ("indexed", plain_lists, "indexed")):
        kw = dict(lookahead=1, transport=transport, device="cuda")
        for _ in decode_batches(lists[:1], **kw):
            pass
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = list(decode_batches(lists, **kw))
        dec_walls[label] = time.perf_counter() - t0
        counts = read_counts()
        dec_launches[label] = counts["decode_segments"]
        if counts != _per_batch(idct_planes=1, decode_segments=int(
                label != "ycc420")):
            raise AssertionError(f"decode_batches transport={transport} "
                                 f"launches {counts}")
        if label == "indexed":
            indexed_launches = counts
        for (p, _), (_, want) in zip(out, results if label != "device"
                                     else rresults):
            if not np.array_equal(p, want):
                raise AssertionError(
                    f"decode_batches transport={transport}: pixels differ "
                    "from the round trip's")
    if dec_launches != {"ycc420": 0, "device": MAIN_BATCHES,
                        "indexed": MAIN_BATCHES}:
        raise AssertionError(f"scan launches by transport: {dec_launches}")

    # host halves per batch, on the host's clock (median of 5)
    pjs_r = [parse(s) for s in restart_lists[0]]
    pjs_p = [parse(s) for s in plain_lists[0]]
    nmcu = (H // 16) * (W // 16)
    parse_kw = dict(gray=False, precision="fast", transport=None)
    host_ms = {
        "parse + checks (_parse_batch)": _host_ms(
            lambda: TC._parse_batch(restart_lists[0], **parse_kw)),
        "_device_host_frontend": _host_ms(
            lambda: HG._device_host_frontend(pjs_r, nmcu, ri, nseg)),
        "destuff alone, the host library's default thread count":
            _host_ms(lambda: _destuff_batch(pjs_r, nmcu, ri, nseg, 0)),
        "destuff alone, calling thread": _host_ms(
            lambda: _destuff_batch(pjs_r, nmcu, ri, nseg, 1)),
        "_indexed_host_frontend": _host_ms(
            lambda: HG._indexed_host_frontend(pjs_p, nmcu, 8, nseg)),
        "_decode_host_prep (ycc420, restart-free streams)": _host_ms(
            lambda: TC._decode_host_prep(plain_lists[0], **parse_kw)),
        "_decode_host_prep (ycc420, restart streams)": _host_ms(
            lambda: TC._decode_host_prep(restart_lists[0], **parse_kw)),
    }
    for label, r_i in (("encode_batch_finish", 0),
                       ("encode_batch_finish, restart", ri)):
        tickets = [TC.encode_batch_dispatch(batches[0], restart_interval=r_i,
                                            device="cuda") for _ in range(5)]
        torch.cuda.synchronize()
        it = iter(tickets)
        host_ms[label] = _host_ms(lambda: TC.encode_batch_finish(next(it)))
    for label, lists, transport in (("decode_batch_finish", plain_lists,
                                     "ycc420"),
                                    ("decode_batch_finish, device",
                                     restart_lists, "device")):
        tickets = [TC.decode_batch_dispatch(lists[0], transport=transport,
                                            device="cuda") for _ in range(5)]
        torch.cuda.synchronize()
        it = iter(tickets)
        host_ms[label] = _host_ms(lambda: TC.decode_batch_finish(next(it)))
    _say("8 restart", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W} with "
         f"restart_interval={ri}, transport=device: {len(rstreams)} streams "
         f"carry DRI and {nseg - 1} RSTn cycling 0..7 and decode in the "
         f"host decoder; device pixels equal ycc420 pixels exactly; PSNR "
         f"{p_r:.4f} dB (host decode {p_rhost:.4f} dB); a corrupted stream "
         f"raised; launches {restart_launches}; pipelined round trip "
         f"{mpix / rwall:.3f} MP/s (wall {rwall:.3f} s) beside the main "
         f"path's {mps:.3f}; decode alone, pipelined: "
         + ", ".join(f"{k} {mpix / v:.3f} MP/s (wall {v:.3f} s, "
                     f"{dec_launches[k]} scan launches)"
                     for k, v in dec_walls.items())
         + "; indexed pixels equal the main path's exactly; host ms per "
         "batch: " + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items())
         + f"; on {card}")

    # ---- 10. optimize: the histogram kernel, per-image table sets, and
    # the optimize path (encode_batches, then the device decode)
    from jpezy_tpu_torch.core import tables as T

    real10 = _real_blocks(TC, HG, _images(BATCH, 0), dev)
    comps = tuple(q.reshape(BATCH, -1, 64) for q, _ in real10)
    hist_sets = _hist_sets(E, comps, dev)
    err["symbol_histograms"] = 0
    pack_cuda.histogram_launches = 0
    for label, cs, r_i, carry in hist_sets:
        hk = pack_cuda.symbol_histograms_batch_cuda(
            *cs, restart_interval=r_i, carry=carry)
        hp = E.symbol_histograms_batch_plain(*cs, r_i, carry)
        torch.cuda.synchronize()
        e = int((hk.to(torch.int64) - hp.to(torch.int64)).abs().max())
        err["symbol_histograms"] = max(err["symbol_histograms"], e)
        if e or hk.dtype != torch.int32:
            raise AssertionError(
                f"symbol_histograms kernel != plain version on {label} "
                f"{[tuple(c.shape) for c in cs]}, restart_interval={r_i}")
    if pack_cuda.histogram_launches != len(hist_sets):
        raise AssertionError(f"histogram kernel launched "
                             f"{pack_cuda.histogram_launches} times in "
                             f"{len(hist_sets)} comparisons")
    # 16 per-image table sets of the real batch, one launch for the three
    # components, with and without restarts
    hists = TC._symbol_histograms_batch(*comps).cpu().numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    set_rows = (E.kernel_tables(ytabs, dev), E.kernel_tables(ctabs, dev))
    for r_i in (0, RESTART_INTERVAL):
        wk, bk = E.encode_blocks_batch(*comps, r_i, tables=set_rows)
        wp, bp = E.encode_blocks_batch_plain(*comps, r_i,
                                             tables=(ytabs, ctabs))
        torch.cuda.synchronize()
        e = max(max(int((a - b).abs().max()) for a, b in zip(wk, wp)),
                max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    for a, b in zip(bk, bp)))
        err["encode_blocks"] = max(err["encode_blocks"], e)
        if e:
            raise AssertionError(f"encode_blocks with {BATCH} table sets != "
                                 f"plain version, restart_interval={r_i}")
    n_sets = len({t.tobytes() for t in ytabs[3]})  # ac_code
    # slots of up to 74 bits: the card's bytes are the host encoder's
    card_bytes, host_bytes, long_bits = _long_emission_bytes(
        E, lambda *c: E.encode_blocks_batch(*(x.to(dev) for x in c[:3]),
                                            tables=c[3]))
    plain_bytes, _, _ = _long_emission_bytes(
        E, lambda *c: E.encode_blocks_batch_plain(*c[:3], tables=c[3]))
    if not card_bytes == plain_bytes == host_bytes or long_bits < 70:
        raise AssertionError(f"{long_bits}-bit emissions: the card's entropy "
                             "bytes differ from the host C++ encoder's")
    # exact optimize streams against the host codec
    reset_counts()
    got_o = TC.encode_batch(imgs4, precision="exact", optimize=True,
                            device="cuda")
    ref_o = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                               optimize=True) for im in imgs4]
    got_or = TC.encode_batch(imgs4, precision="exact", optimize=True,
                             restart_interval=ri, device="cuda")
    ref_or = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                optimize=True, restart_interval=ri)
              for im in imgs4]
    if got_o != ref_o or got_or != ref_or:
        raise AssertionError("exact optimize encode differs from host_codec")
    exact_opt_launches = read_counts()
    if exact_opt_launches != {k: 2 * int(k in (
            "fdct_quantize_exact", "symbol_histograms", "encode_blocks",
            "concat_streams")) for k in KERNELS}:
        raise AssertionError(f"two exact optimize encodes launched "
                             f"{exact_opt_launches}: want the exact fDCT, "
                             "histogram, entropy and concat kernels once "
                             "each a call")
    _say("10 kernels", f"symbol_histograms (one launch for the three "
         f"components) identical to the plain version on {len(hist_sets)} "
         "sets (" + ", ".join(
             f"{label} {[tuple(c.shape)[:2] for c in cs]} ri={r_i}"
             for label, cs, r_i, _ in hist_sets)
         + f"); encode_blocks with {BATCH} per-image table sets ({n_sets} "
         f"distinct luma AC tables, one launch) identical to the plain "
         f"version on {[tuple(q.shape) for q in comps]} with "
         f"restart_interval 0 and {RESTART_INTERVAL}; {long_bits}-bit "
         f"slots: the card's {len(card_bytes)} entropy bytes equal the host "
         f"C++ encoder's; 4x{H}x{W} exact optimize encode byte-identical to "
         f"host_codec, without and with restart_interval={ri}, launches "
         f"{ {k: v for k, v in exact_opt_launches.items() if v} } "
         f"({sum(map(len, got_o))} and {sum(map(len, got_or))} bytes against "
         f"{sum(map(len, got))} and {sum(map(len, got_r))} with the fixed "
         f"tables)")

    opt_kw = dict(lookahead=1, optimize=True, restart_interval=ri,
                  device="cuda")
    odec_kw = dict(lookahead=1, transport="device", device="cuda")
    for ss in encode_batches(batches[:1], **opt_kw):
        for _ in decode_batches([ss], **odec_kw):
            pass  # warm-up of this path's shapes
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    opt_lists = list(encode_batches(batches, **opt_kw))
    owall = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt_dec = list(decode_batches(opt_lists, **odec_kw))
    odwall = time.perf_counter() - t0
    optimize_launches = read_counts()
    if optimize_launches != _per_batch(fdct_quantize=1, symbol_histograms=1,
                                       encode_blocks=1, concat_streams=1,
                                       decode_segments=1, idct_planes=1):
        raise AssertionError(
            f"optimize path launches {optimize_launches}: want per batch the "
            "fDCT kernel, the histogram kernel, the fused kernel, the "
            "concat, the scan and the IDCT kernel once each")
    opt_bytes = sum(len(s) for ss in opt_lists for s in ss)
    fixed_bytes = sum(len(s) for s in rstreams)
    for ss, (opx, _), (_, rpx) in zip(opt_lists, opt_dec, rresults):
        if len({_dht(s) for s in ss}) != len(ss):
            raise AssertionError("optimize streams share a DHT")
        if not np.array_equal(opx, rpx):
            raise AssertionError("optimize streams decode to other pixels "
                                 "than the fixed-table restart streams")
    if opt_bytes >= fixed_bytes:
        raise AssertionError(f"optimize streams take {opt_bytes} bytes, the "
                             f"fixed tables {fixed_bytes}")
    # host stages of the optimize path per batch (median of 5)
    pjs_o = [parse(s) for s in opt_lists[0]]
    opt_host_ms = {
        "encode_batch_dispatch, optimize (blocks on the histogram fetch)":
            _host_ms(lambda: TC.encode_batch_dispatch(
                batches[0], optimize=True, restart_interval=ri,
                device="cuda")),
        "host table build (_optimal_tables: 32 optimal_flat_tables)":
            _host_ms(lambda: TC._optimal_tables(hists)),
        "_device_luts (16 LUT sets)": _host_ms(
            lambda: HG._device_luts(pjs_o, nseg)),
    }

    def lut_upload():
        lut, _ = HG._device_luts(pjs_o, nseg)
        ED._lut_cache.clear()
        ED.device_lut(lut, dev)
        torch.cuda.synchronize()

    opt_host_ms["_device_luts + hash + upload (cache cleared)"] = _host_ms(
        lut_upload)
    _say("10 optimize", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W}, "
         f"encode_batches(optimize=True, restart_interval={ri}) then "
         f"decode_batches(transport='device') with {BATCH} table sets a "
         f"batch in the scan: every stream has its own DHT; pixels equal "
         f"the fixed-table restart path's exactly; {opt_bytes} bytes against "
         f"{fixed_bytes} ({opt_bytes / fixed_bytes:.4f}); launches "
         f"{optimize_launches}; encode pipelined {mpix / owall:.3f} MP/s "
         f"(wall {owall:.3f} s), decode pipelined {mpix / odwall:.3f} MP/s "
         f"(wall {odwall:.3f} s); host ms per batch: "
         + ", ".join(f"{k} {v:.3f}" for k, v in opt_host_ms.items())
         + f"; on {card}")

    # ---- 11. the rgb transports and the entry points, card against CPU
    small = _images(CPU_BATCH, 300)[:, :CPU_HW, :CPU_HW]
    rgb_launches = {}
    fdct_of = {"fast": "fdct_quantize", "exact": "fdct_quantize_exact"}
    for precision in ("fast", "exact"):
        reset_counts()
        on_card = TC.encode_batch(small, transport="rgb", precision=precision,
                                  device="cuda")
        rgb_launches[f"encode {precision}"] = read_counts()
        if rgb_launches[f"encode {precision}"] != {
                k: int(k in (fdct_of[precision], "encode_blocks",
                             "concat_streams", "rgb_to_ycc420"))
                for k in KERNELS}:
            raise AssertionError(f"rgb encode ({precision}) launched "
                                 f"{rgb_launches[f'encode {precision}']}")
        on_cpu = TC.encode_batch(small, transport="rgb", precision=precision,
                                 device="cpu")
        if precision == "exact":
            host = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2])
                    for im in small]
            if not on_card == on_cpu == host:
                raise AssertionError("exact rgb encode: card, CPU and host "
                                     "codec differ")
            exact_small = on_card
        for a, b, im in zip(on_card, on_cpu, small):
            pa = _psnr(np.stack(host_codec.decode(a)[:3], -1), im)
            pb = _psnr(np.stack(host_codec.decode(b)[:3], -1), im)
            if abs(pa - pb) > PSNR_SLACK_DB:
                raise AssertionError(f"{precision} rgb encode PSNR {pa} on "
                                     f"the card, {pb} on the CPU")
    rgb_dec_diff = {}
    for label, kw in (("fast", dict(transport="rgb")),
                      ("exact", dict(precision="exact")),
                      ("gray", dict(precision="exact", gray=True))):
        reset_counts()
        a, _ = TC.decode_batch(exact_small, device="cuda", **kw)
        rgb_launches[f"decode {label}"] = read_counts()
        # the IDCT of the precision into planes, then the colour kernel
        idct_of = "idct_planes_rgb" if label == "fast" else "idct_planes_exact"
        if rgb_launches[f"decode {label}"] != {
                k: int(k in (idct_of, "ycc_planes_to_rgb")) for k in KERNELS}:
            raise AssertionError(f"rgb decode ({label}) launched "
                                 f"{rgb_launches[f'decode {label}']}")
        b, _ = TC.decode_batch(exact_small, device="cpu", **kw)
        d = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
        rgb_dec_diff[label] = d
        # exact: float64 ordered sums on both; fast: the IDCT kernel's
        # ascending float32 sums against the CPU's BLAS order (a sample
        # may truncate 1 apart, and colour moves a pixel by up to 2)
        if d > (2 if label == "fast" else 0):
            raise AssertionError(f"rgb decode ({label}) differs by {d} "
                                 "between the card and the CPU")
        if label == "exact":
            host_px = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                                for s in exact_small])
            if not np.array_equal(a, host_px):
                raise AssertionError("exact rgb decode != host_codec.decode")
    # full width on the card: rgb transport against ycc420, both ways
    reset_counts()
    rgb_full = TC.encode_batch(batches[0], transport="rgb",
                               precision="exact", device="cuda")
    if rgb_full != TC.encode_batch(batches[0], precision="exact",
                                   device="cuda"):
        raise AssertionError("exact rgb and ycc420 streams differ at "
                             f"{BATCH}x{H}x{W}")
    rgb_px, _ = TC.decode_batch(rgb_full, precision="exact", device="cuda")
    ref_px = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                       for s in rgb_full])
    if not np.array_equal(rgb_px, ref_px):
        raise AssertionError(f"exact rgb decode at {BATCH}x{H}x{W} != "
                             "host_codec.decode")
    rgb_launches["full width"] = read_counts()
    if rgb_launches["full width"] != {
            k: {"fdct_quantize_exact": 2, "encode_blocks": 2,
                "concat_streams": 2, "idct_planes_exact": 1,
                "rgb_to_ycc420": 1, "ycc_planes_to_rgb": 1}.get(k, 0)
            for k in KERNELS}:
        raise AssertionError(f"two exact encodes and an exact decode at "
                             f"full width launched "
                             f"{rgb_launches['full width']}")
    rgb_host_ms = {
        "encode_batch, rgb, fast": _host_ms(lambda: TC.encode_batch(
            batches[0], transport="rgb", device="cuda"), 3),
        "encode_batch, ycc420, fast": _host_ms(lambda: TC.encode_batch(
            batches[0], device="cuda"), 3),
        "encode_batch, rgb, exact": _host_ms(lambda: TC.encode_batch(
            batches[0], transport="rgb", precision="exact", device="cuda"),
            3),
        "decode_batch, rgb, fast": _host_ms(lambda: TC.decode_batch(
            plain_lists[0], transport="rgb", device="cuda"), 3),
        "decode_batch, rgb, exact": _host_ms(lambda: TC.decode_batch(
            plain_lists[0], precision="exact", device="cuda"), 3),
        "decode_batch, ycc420, fast": _host_ms(lambda: TC.decode_batch(
            plain_lists[0], device="cuda"), 3),
    }
    # one large image through the single-image entry points
    from imagegen import make_test_image

    big = make_test_image(750, 1000, seed=310)
    planes_big = (big[..., 0], big[..., 1], big[..., 2])
    s_big = TC.encode(*planes_big, precision="exact", device="cuda")
    if s_big != host_codec.encode(*planes_big):
        raise AssertionError("encode of 1000x750, exact, != host_codec")
    big_px = np.stack(TC.decode(s_big, precision="exact", device="cuda")[:3],
                      -1)
    if not np.array_equal(big_px, np.stack(host_codec.decode(s_big)[:3], -1)):
        raise AssertionError("decode of 1000x750, exact, != host_codec")
    s_bigf = TC.encode(*planes_big, device="cuda")
    p_big = _psnr(np.stack(TC.decode(s_bigf, device="cuda")[:3], -1), big)
    p_big_ref = _psnr(np.stack(host_codec.decode(s_big)[:3], -1), big)
    if p_big < p_big_ref - PSNR_SLACK_DB:
        raise AssertionError(f"1000x750 fast round trip PSNR {p_big} < host "
                             f"exact {p_big_ref}")
    big_host_ms = {"encode, fast": _host_ms(
                  lambda: TC.encode(*planes_big, device="cuda"), 3),
              "decode, fast": _host_ms(
                  lambda: TC.decode(s_bigf, device="cuda"), 3),
              "encode, exact": _host_ms(
                  lambda: TC.encode(*planes_big, precision="exact",
                                    device="cuda"), 3),
              "decode, exact": _host_ms(
                  lambda: TC.decode(s_big, precision="exact", device="cuda"),
                  3)}
    # mixed sizes
    mixed = [big, _images(1, 320)[0], _images(1, 321)[0][:500, :500],
             make_test_image(37, 50, seed=322), make_test_image(48, 64, seed=323),
             make_test_image(1, 1, seed=324)]
    m_streams = RB.encode_mixed(mixed, precision="exact", device="cuda")
    if m_streams != [host_codec.encode(im[..., 0], im[..., 1], im[..., 2])
                     for im in mixed]:
        raise AssertionError("encode_mixed (exact) != host_codec")
    for px, s in zip(RB.decode_mixed(m_streams, precision="exact",
                                     device="cuda"), m_streams):
        if not np.array_equal(px, np.stack(host_codec.decode(s)[:3], -1)):
            raise AssertionError("decode_mixed (exact) != host_codec")
    # the command line on a PPM: encode with --gpu, decode with no backend
    # flag (the default is the card)
    from jpezy_tpu_torch.runtime import ppm

    cli_dir = os.path.join(REPO, "build", "smoke_cli")
    os.makedirs(cli_dir, exist_ok=True)
    ppm.write(os.path.join(cli_dir, "in.ppm"), big, fmt="P6")
    cli_out = {}
    for cmd in (["encode", "in.ppm", "out.jpg", "--gpu"],
                ["decode", "out.jpg", "out.ppm"]):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "jpezy_tpu_torch.cli",
                              *cmd], cwd=cli_dir, capture_output=True,
                             text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=REPO))
        cli_out[cmd[0]] = time.perf_counter() - t0
        if res.returncode != 0 or "backend: gpu" not in res.stdout:
            raise AssertionError(f"cli {cmd}: {res.returncode}\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    with open(os.path.join(cli_dir, "out.jpg"), "rb") as f:
        cli_jpg = f.read()
    if cli_jpg != s_bigf:
        raise AssertionError("the cli's --gpu stream != encode() on the card")
    _, _, _, cli_px = ppm.read(os.path.join(cli_dir, "out.ppm"))
    if not np.array_equal(cli_px, np.stack(
            TC.decode(cli_jpg, device="cuda")[:3], -1)):
        raise AssertionError("the cli's decode != decode() on the card")
    _say("11 rgb+entry", f"rgb encode on the card against the CPU "
         f"({CPU_BATCH}x{CPU_HW}x{CPU_HW}): exact byte-identical to the CPU "
         f"and host_codec, fast within {PSNR_SLACK_DB} dB; rgb decode, card "
         f"against CPU, max |diff|: " + ", ".join(
             f"{k} {v}" for k, v in rgb_dec_diff.items())
         + f"; at {BATCH}x{H}x{W} exact rgb streams equal ycc420's and their "
         f"exact rgb decode equals host_codec's; launches " + "; ".join(
             f"{k} { {n: c for n, c in v.items() if c} }"
             for k, v in rgb_launches.items())
         + "; host ms per batch: "
         + ", ".join(f"{k} {v:.3f}" for k, v in rgb_host_ms.items())
         + f"; 1000x750 encode/decode exact equal host_codec, fast PSNR "
         f"{p_big:.4f} dB (host exact {p_big_ref:.4f}); ms: "
         + ", ".join(f"{k} {v:.3f}" for k, v in big_host_ms.items())
         + f"; encode_mixed/decode_mixed of {len(mixed)} sizes exact equal "
         f"host_codec; cli encode --gpu {cli_out['encode']:.2f} s, decode "
         f"with no backend flag {cli_out['decode']:.2f} s (processes, both "
         f"on the card), stream and pixels equal "
         f"the in-process calls; on {card}")

    # ---- 12. the sharded codec (parallel/): world size 1 at full width,
    # then gloo ranks that share the card
    from jpezy_tpu_torch.parallel import (decode_sharded, encode_sharded,
                                          make_mesh)

    mesh = make_mesh(1, 1, device="cuda")
    exact_kw = (("plain", {}), ("restart_interval=8",
                                {"restart_interval": ri}))
    sharded_exact = {}
    for label, kw in exact_kw:
        reset_counts()
        got = encode_sharded(mesh, batches[0], precision="exact", **kw)
        sharded_exact[f"encode_sharded {label}"] = read_counts()
        if got != TC.encode_batch(batches[0], transport="rgb",
                                  precision="exact", device="cuda", **kw):
            raise AssertionError(f"exact encode_sharded ({label}) differs "
                                 "from encode_batch(transport='rgb')")
        if got != [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                     **kw) for im in batches[0]]:
            raise AssertionError(f"exact encode_sharded ({label}) differs "
                                 "from host_codec")
        if kw:
            continue
        # exact decode_sharded: the host Huffman frontend, then the rgb
        # transport's program through idct_planes_exact
        reset_counts()
        px_sh = decode_sharded(mesh, got, precision="exact")
        sharded_exact[f"decode_sharded {label}"] = read_counts()
        if not np.array_equal(px_sh, ref_rt[:BATCH]):
            raise AssertionError(f"exact decode_sharded ({label}) differs "
                                 "from host_codec.decode")
    for k, counts in sharded_exact.items():
        want = ({"fdct_quantize_exact": 1, "encode_blocks": 1,
                 "concat_streams": 1, "rgb_to_ycc420": 1}
                if k.startswith("encode")
                else {"idct_planes_exact": 1, "ycc_planes_to_rgb": 1})
        if counts != {n: want.get(n, 0) for n in KERNELS}:
            raise AssertionError(f"{k} (exact) launched {counts}, want "
                                 f"{want}")
    # dense content over the default budget: the shard emits again, fitted
    from jpezy_tpu_torch.parallel.api import (encode_sharded_dispatch,
                                              encode_sharded_finish,
                                              shard_budget_words)

    dense = np.random.default_rng(12).integers(0, 256, (2, H, W, 3),
                                               dtype=np.uint8)
    dense_maxw = []
    for dri in (0, ri):
        kw = {"quality": 100, "restart_interval": dri}
        ticket = encode_sharded_dispatch(mesh, dense, precision="exact",
                                         **kw)
        dense_maxw.append(ticket[-1])
        if ticket[-1] <= shard_budget_words(H * W // 256):
            raise AssertionError("dense encode_sharded kept the default "
                                 "budget")
        got = encode_sharded_finish(ticket)
        if got != [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                     **kw) for im in dense] or got != (
                TC.encode_batch(dense, transport="rgb", precision="exact",
                                device="cuda", **kw)):
            raise AssertionError(f"dense encode_sharded ({kw}) differs from "
                                 "host_codec or encode_batch(transport='rgb')")
    # the shards encode from RGB through the colour kernel and decode
    # through the rgb transport's program (the fast IDCT into unclamped
    # planes, then the colour kernel)
    rgb_steps = {"rgb_to_ycc420": 1, "fdct_quantize": 1, "encode_blocks": 1,
                 "concat_streams": 1, "idct_planes_rgb": 1,
                 "ycc_planes_to_rgb": 1}
    sharded_paths = (
        ("sharded", {}, rgb_steps),
        ("sharded_restart", {"restart_interval": ri},
         dict(rgb_steps, decode_segments=1)),
        ("sharded_optimize", {"optimize": True, "restart_interval": ri},
         dict(rgb_steps, decode_segments=1, symbol_histograms=1)))
    sharded_launches, sharded_mps, sharded_out = {}, {}, {}
    for label, kw, per_batch in sharded_paths:
        decode_sharded(mesh, encode_sharded(mesh, batches[0], **kw))
        torch.cuda.synchronize()  # warm-up of this path's shapes
        reset_counts()
        t0 = time.perf_counter()
        lists = [encode_sharded(mesh, b, **kw) for b in batches]
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        pxs = [decode_sharded(mesh, ss) for ss in lists]
        t_dec = time.perf_counter() - t0
        sharded_launches[label] = read_counts()
        want = _per_batch(**per_batch)
        if sharded_launches[label] != want:
            raise AssertionError(f"{label} launches "
                                 f"{sharded_launches[label]}, want {want}")
        # the unsharded calls of the same semantics, timed in this run
        ref_kw = dict(kw) if kw.get("optimize") else dict(kw, transport="rgb")
        t0 = time.perf_counter()
        for b in batches:
            TC.encode_batch(b, device="cuda", **ref_kw)
        t_ref_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        refs = [TC.decode_batch(ss, transport="rgb", device="cuda")[0]
                for ss in lists]
        t_ref_dec = time.perf_counter() - t0
        for p, r in zip(pxs, refs):
            if not np.array_equal(p, r):
                d = int(np.abs(p.astype(np.int32) - r.astype(np.int32)).max())
                raise AssertionError(f"{label}: decode_sharded pixels differ "
                                     f"from decode_batch(transport='rgb') by "
                                     f"up to {d}")
        sharded_out[label] = (lists, pxs)
        sharded_mps[label] = {k: mpix / v for k, v in (
            ("encode_sharded", t_enc), ("decode_sharded", t_dec),
            ("encode_batch", t_ref_enc), ("decode_batch rgb", t_ref_dec))}
    # tile shards whose row counts differ from the whole image's, decoded
    # rank by rank in this process (the ranks' own calls): the fast
    # pixels equal decode_batch(transport="rgb")'s exactly, since the IDCT
    # kernel's per-block sums do not depend on a shard's rows
    from jpezy_tpu_torch.parallel import api as PA
    from jpezy_tpu_torch.parallel.mesh import Mesh

    tiled = []
    for label in ("sharded", "sharded_restart"):
        streams_t = sharded_out[label][0][0]
        want_t, _ = TC.decode_batch(streams_t, transport="rgb", device="cuda")
        for tile in (2, 4):
            pjs_t, geom_t, level_t = PA._parse_checked(
                streams_t, tile, gray=False, precision="fast")
            rows_t = [PA._decode_shard(Mesh(1, tile, dev, t), pjs_t, geom_t,
                                       level_t, gray=False,
                                       precision="fast")[0]
                      for t in range(tile)]
            px_t = torch.cat(rows_t, dim=1).cpu().numpy()[:, :H, :W]
            if not np.array_equal(px_t, want_t):
                d = int(np.abs(px_t.astype(np.int32)
                               - want_t.astype(np.int32)).max())
                raise AssertionError(f"{label} streams decoded in {tile} "
                                     f"tile shards differ from decode_batch("
                                     f"transport='rgb') by up to {d}")
            tiled.append(f"{label} streams in {tile} tile shards of "
                         f"{geom_t[0][0] // tile} MCU rows")
    sh_opt_lists, sh_opt_px = sharded_out["sharded_optimize"]
    sh_rst_lists, sh_rst_px = sharded_out["sharded_restart"]
    for a, b in zip(sh_opt_px, sh_rst_px):
        if not np.array_equal(a, b):
            raise AssertionError("sharded optimize streams decode to other "
                                 "pixels than the sharded restart streams")
    sh_opt_bytes = sum(len(s) for ss in sh_opt_lists for s in ss)
    sh_rst_bytes = sum(len(s) for ss in sh_rst_lists for s in ss)
    if sh_opt_bytes >= sh_rst_bytes:
        raise AssertionError(f"sharded optimize streams take {sh_opt_bytes}"
                             f" bytes, the fixed tables {sh_rst_bytes}")
    _say("12 sharded", f"1x1 mesh, {MAIN_BATCHES} batches x {BATCH}x{H}x{W}"
         f": exact encode_sharded byte-identical to encode_batch("
         f"transport='rgb') and host_codec, without and with "
         f"restart_interval={ri}, and exact decode_sharded of the streams "
         f"without equal to host_codec.decode (launches " + "; ".join(
             f"{k} { {n: c for n, c in v.items() if c} }"
             for k, v in sharded_exact.items()) + f"); 2 noise images at quality 100 outgrew the "
         f"default budget of {shard_budget_words(H * W // 256)} words and "
         f"were emitted again into {dense_maxw} (without, with restart "
         f"markers), exact streams equal host_codec's and encode_batch's; "
         f"decode_sharded pixels equal decode_batch("
         f"transport='rgb')'s on every path, and exactly so on "
         + ", ".join(tiled) + f"; optimize ({sh_opt_bytes} bytes "
         f"against {sh_rst_bytes}, one table set a batch) decodes to the "
         f"restart streams' pixels; launches " + "; ".join(
             f"{k} {v}" for k, v in sharded_launches.items())
         + "; MP/s (serial, 4 batches): " + "; ".join(
             f"{k}: " + ", ".join(f"{n} {v:.3f}" for n, v in m.items())
             for k, m in sharded_mps.items()) + f"; on {card}")

    # ranks that share the card: gloo, one process each, on cuda:0
    imgs_p = batches[0][:PARALLEL_IMAGES]
    exact_p = {
        "exact_restart": encode_sharded(mesh, imgs_p, precision="exact",
                                        restart_interval=ri),
        "exact_optimize": encode_sharded(mesh, imgs_p, precision="exact",
                                         optimize=True, restart_interval=ri)}
    ranks_said = []
    for world, data in ((2, 1), (4, 2)):
        t0 = time.perf_counter()
        ranks = _spawn_ranks(world, data)
        wall_p = time.perf_counter() - t0
        n_loc = PARALLEL_IMAGES // data
        for res in ranks:
            d, r = int(res["data_index"]), int(res["rank"])
            rows = slice(d * n_loc, (d + 1) * n_loc)
            if str(res["leaked"]):
                raise AssertionError(f"rank {r} imported {res['leaked']}")
            for name, want in exact_p.items():
                if _unpack_streams(res, name) != want[rows]:
                    raise AssertionError(f"rank {r} of {world}: {name} "
                                         "streams differ from the 1x1 mesh's")
            fast = _unpack_streams(res, "fast_restart")
            ref, _ = TC.decode_batch(fast, transport="rgb", device="cuda")
            if not np.array_equal(res["px_device"], ref):
                d_max = int(np.abs(res["px_device"].astype(np.int32)
                                   - ref.astype(np.int32)).max())
                raise AssertionError(
                    f"rank {r} of {world}: sharded device decode differs "
                    f"from decode_batch(transport='rgb') by up to {d_max}")
            corrupt_err = str(res["corrupt_error"])
            if ((not ("corrupt" in corrupt_err and "[1]" in corrupt_err))
                    if d == 0 else corrupt_err):
                raise AssertionError(f"rank {r} of {world} (data row {d}): "
                                     f"corrupt stream gave {corrupt_err!r}")
            got = {k: {n: int(c) for n, c in zip(KERNELS, res["counts_" + k])}
                   for k in RANK_STEPS}
            want = {k: {n: v.get(n, 0) for n in KERNELS}
                    for k, v in RANK_STEPS.items()}
            if got != want:
                raise AssertionError(f"rank {r} of {world} launches {got}, "
                                     f"want {want}")
        ranks_said.append(
            f"{world} ranks ({data}x{world // data}): {wall_p:.2f} s from "
            "spawn to exit, per rank " + ", ".join(
                f"{k} {v:.3f} s" for k, v in zip(
                    RANK_STEPS, ranks[0]["step_s"])))
    _say("12 ranks", f"gloo ranks sharing cuda:0, {PARALLEL_IMAGES}x{H}x{W}"
         f" with restart_interval={ri}: exact restart and optimize streams "
         f"equal the 1x1 mesh's; the sharded device decode's pixels equal "
         f"decode_batch(transport='rgb')'s; a corrupted stream raised on "
         f"the ranks of its tile row only; launches per rank and step "
         + ", ".join(f"{k} {v}" for k, v in RANK_STEPS.items())
         + "; " + "; ".join(ranks_said) + f"; on {card}")

    # ---- 13. the concat kernel against its plain torch version
    from jpezy_tpu_torch.parallel.sharded import last_dcs

    concat_sets = [(f"real, restart_interval={r_i}",
                    *TC._emit_local(*comps, r_i), r_i, None)
                   for r_i in (0, 1, ri, 17)]
    # the main path's and the restart path's; phase 6 times them
    concat_inputs = concat_sets[0][1:3]
    concat_inputs_r = concat_sets[2][1:3]
    _, owc, obc = TC._encode_batch_custom(*comps, ytabs, ctabs,
                                          restart_interval=ri)
    concat_sets.append((f"{BATCH} per-image table sets", owc, obc, ri, None))
    gray_q = TC._quantize_batch_rgb(torch.from_numpy(batches[0]).to(dev),
                                    gray=True)
    concat_sets.append(("gray", *TC._emit_local(*gray_q), 0, None))
    dense_q = TC._quantize_batch_rgb(torch.from_numpy(dense).to(dev),
                                     quality=100)
    dense_maxw0 = TC.stream_budget_words_batch(6 * (H // 16) * (W // 16))
    for r_i in (0, ri):
        dwc, dbc = TC._emit_local(*dense_q, r_i)
        concat_sets += [
            (f"noise at quality 100, restart_interval={r_i}", dwc, dbc, r_i,
             None),
            (f"the same in {dense_maxw0 // 4} words", dwc, dbc, r_i,
             dense_maxw0 // 4)]
    # the two shards of a 1x2 mesh: each image's halves of MCU rows, the
    # second from the first's last DCs, in the shard budget
    halves = [tuple(c[:, k * c.shape[1] // 2:(k + 1) * c.shape[1] // 2]
                    for c in comps) for k in (0, 1)]
    shard_maxw = shard_budget_words((H // 16) * (W // 16) // 2)
    carries = (None, last_dcs(halves[0]))
    for k, (half, carry) in enumerate(zip(halves, carries)):
        concat_sets.append((f"1x2 shard {k}, restart_interval={ri}",
                            *TC._emit_local(*half, ri, carry=carry), ri,
                            shard_maxw))
    swc, sbc = E.stream_blocks(6, 700, seed=63)
    concat_sets.append(("seeded, bits up to word 63",
                        tuple(w.to(dev) for w in swc),
                        tuple(b.to(dev) for b in sbc), 3, None))
    # a restart interval past the image (one segment), one-MCU images
    concat_sets.append(("real, restart_interval=2000 (one segment)",
                        *TC._emit_local(*comps, 2000), 2000, None))
    for r_i in (0, 1):
        owc1, obc1 = E.stream_blocks(8, 1, seed=64 + r_i)
        concat_sets.append((f"one-MCU images, restart_interval={r_i}",
                            tuple(w.to(dev) for w in owc1),
                            tuple(b.to(dev) for b in obc1), r_i, 64))
    # one 3840x2160 image: 32,400 MCUs in 16 tiles of 2,025
    big = torch.from_numpy(np.stack([_image_4k()])).to(dev)
    big_q = TC._quantize_batch_rgb(big)
    del big
    for r_i in (0, ri):
        bwc, bbc = TC._emit_local(*big_q, r_i)
        bwp, bbp = E.encode_blocks_batch_plain(*big_q, r_i)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(bwc + bbc, bwp + bbp)):
            raise AssertionError(f"encode_blocks on a 3840x2160 image != "
                                 f"plain version, restart_interval={r_i}")
        concat_sets.append((f"3840x2160, restart_interval={r_i}", bwc, bbc,
                            r_i, None))
    del big_q, bwp, bbp
    err["concat_streams"] = 0
    concat_cuda.launches = 0
    dropped = 0
    for label, cwc, cbc, r_i, maxw in concat_sets:
        if maxw is None:
            maxw = TC.stream_budget_words_batch(6 * cbc[1].shape[1])
        got = concat_cuda.concat_streams_cuda(cwc, cbc, maxw=maxw,
                                              restart_interval=r_i)
        want = E.concat_streams_plain(cwc, cbc, r_i, maxw)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        err["concat_streams"] = max(err["concat_streams"], e)
        if e or got.dtype != torch.int64 or got.shape != want.shape:
            raise AssertionError(f"concat_streams kernel != plain version on "
                                 f"{label} {tuple(want.shape)}")
        dropped += int((want[:, 0] > 32 * maxw).sum())
    if concat_cuda.launches != len(concat_sets):
        raise AssertionError(f"concat kernel launched {concat_cuda.launches}"
                             f" times in {len(concat_sets)} comparisons")
    if dropped < 8:  # both noise images in all four noise sets
        raise AssertionError(f"only {dropped} images outgrew their budget")
    # the two-pass design timed in phase 6 computes the same function
    pmaxw = TC.stream_budget_words_batch(6 * concat_inputs[1][1].shape[1])
    for r_i in (0, ri):
        cwc, cbc = concat_sets[0 if r_i == 0 else 2][1:3]
        if not torch.equal(
                previous_designs.concat_two_pass(cwc, cbc, maxw=pmaxw,
                                                 restart_interval=r_i),
                E.concat_streams_plain(cwc, cbc, r_i, pmaxw)):
            raise AssertionError("the two-pass concat != plain version")
    _say("13 concat", "concat_streams (one launch a call) bit-identical "
         f"to the plain version on {len(concat_sets)} sets: "
         + ", ".join(f"{label} ({cbc[1].shape[0]} images of "
                     f"{6 * cbc[1].shape[1]} blocks)"
                     for label, _, cbc, _, _ in concat_sets)
         + f"; {dropped} images outgrew their budget (words dropped, "
         f"totals exact); shard budget {shard_maxw} words; tiles an image "
         f"{concat_cuda.tile_layout((H // 16) * (W // 16))} at {H}x{W}, "
         f"{concat_cuda.tile_layout(32400)} at 3840x2160 (tiles, MCUs a "
         f"tile); encode_blocks on the 3840x2160 image identical to the "
         f"plain version, restart_interval 0 and {ri}; the two-pass design "
         f"(scripts/previous_designs.cu) identical on the main path's sets")
    del concat_sets, owc, obc, gray_q, dense_q, dwc, dbc, halves, bwc, bbc

    # ---- 14. the block transforms against their plain versions and the
    # numpy models of the kernels' arithmetic order
    from jpezy_tpu_torch.ops import blocks as OB
    from jpezy_tpu_torch.ops import colorspace as OC

    def upload(rgbs):
        """The ycc420 transport's int8 plane views of rgbs on the card."""
        y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
        n, h, w = y.shape
        packed = torch.from_numpy(np.concatenate(
            [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)],
            axis=1)).to(dev)
        return TC._unpack_ycc(packed, h, w)

    ycc_real = upload(batches[0])
    rgb0 = torch.from_numpy(batches[0]).to(dev)
    ry, rcb, rcr = OC.rgb_to_ycc(rgb0[..., 0], rgb0[..., 1], rgb0[..., 2])
    noise14 = np.random.default_rng(15).integers(0, 256, (BATCH, H, W, 3),
                                                 dtype=np.uint8)
    q95 = tuple(torch.from_numpy(t).to(dev)
                for t in T.scale_quant_tables(95))
    plain_kw = dict(gray=False, rounded=False)
    fdct_sets = [
        ("ycc420 upload, Annex K", ycc_real, plain_kw),
        ("quality 95", ycc_real, dict(plain_kw, qtables=q95)),
        ("rounded", ycc_real, dict(plain_kw, rounded=True)),
        ("gray", ycc_real, dict(plain_kw, gray=True)),
        ("rgb path, int32 planes, chroma at column stride 2",
         (ry, OB.decimate_420(rcb), OB.decimate_420(rcr)), plain_kw),
        ("noise", upload(noise14), plain_kw)]
    del rgb0, rcb, rcr
    err["fdct_quantize"] = 0
    transform_cuda.fdct_launches = 0
    said14 = []
    for label, planes14, kw in fdct_sets:
        got = BT.fdct_quantize(*planes14, **kw)
        want = BT.fdct_quantize_plain(*planes14, **kw)
        qt = kw.get("qtables")
        model = BT.fdct_quantize_model(
            *(p.cpu().numpy() for p in planes14), gray=kw["gray"],
            rounded=kw["rounded"],
            qtables=None if qt is None else tuple(t.cpu().numpy()
                                                  for t in qt))
        torch.cuda.synchronize()
        n_diff = n_all = 0
        for g, w_, m in zip(got, want, model):
            if g.dtype != torch.int32 or not np.array_equal(g.cpu().numpy(),
                                                            m):
                raise AssertionError(f"fdct_quantize kernel != its model on "
                                     f"{label}")
            e = int((g - w_).abs().max())
            err["fdct_quantize"] = max(err["fdct_quantize"], e)
            if e > 1:
                raise AssertionError(f"fdct_quantize kernel differs from the "
                                     f"plain version by {e} on {label}")
            n_diff += int((g != w_).sum())
            n_all += g.numel()
        if n_diff > FDCT_DIFF_SHARE * n_all:
            raise AssertionError(f"fdct_quantize kernel differs from the "
                                 f"plain version on {n_diff} of {n_all} "
                                 f"coefficients on {label}")
        said14.append(f"{label}: {n_diff} of {n_all} coefficients differ "
                      f"from the plain version ({n_diff / n_all:.2e})")
    if transform_cuda.fdct_launches != len(fdct_sets):
        raise AssertionError(f"fDCT kernel launched "
                             f"{transform_cuda.fdct_launches} times in "
                             f"{len(fdct_sets)} comparisons")
    _say("14 fdct", "fdct_quantize (one launch for the three components) "
         "bit-identical to the numpy model of its separable float32 sums "
         "and within 1 of the plain version (the 64-term product), on at "
         f"most {FDCT_DIFF_SHARE} of the coefficients, on {BATCH}x{H}x{W}: "
         + "; ".join(said14))
    fdct_inputs = ycc_real      # phase 6 times the kernel on these planes
    real_nonzero = sum(int((q != 0).sum()) for q in BT.fdct_quantize(
        *ycc_real, **plain_kw))
    del fdct_sets, got, want, model, noise14

    # the IDCT kernel: the sparse form on ycc420 uploads, the dense form on
    # the scan's blocks, each against its model and its plain version
    def sparse_set(streams):
        flat, kw, *_ = TC._decode_host_prep(streams, gray=False,
                                            precision="fast", transport=None)
        return ("sparse", flat, kw)

    def dense_set(lanes_np, streams):
        """The scan's blocks and flags of these lanes on the card, the
        streams' per-image quant tables, and the form's arguments."""
        args = _to_dev(lanes_np, dev)
        blocks, bad = ED.decode_segments(**args)
        pjs14 = [parse(st) for st in streams]
        _, geom14, level14 = TC._parse_batch(streams)
        kw = dict(N=len(pjs14), nseg=args["words"].shape[0] // len(pjs14),
                  ri=args["max_blocks"] // 6, geom=geom14, level=level14)
        return ("dense", (blocks, bad, torch.from_numpy(
            HG._quant_arr(pjs14)).to(dev)), kw)

    noise_q100 = TC.encode_batch(
        np.random.default_rng(16).integers(0, 256, (BATCH // 4, H, W, 3),
                                           dtype=np.uint8),
        quality=100, device="cuda")
    small = {f"{w}x{h}, quality 95": TC.encode_batch(
        np.stack([make_test_image(h, w, seed=340 + i) for i in range(3)]),
        quality=95, device="cuda") for h, w in ((16, 16), (16, 48), (32, 48))}
    # the main batch's images at quality 95 (phases 16 and 6 take these
    # streams too)
    q95_streams = TC.encode_batch(batches[0], quality=95, device="cuda")
    idct_sets = [("main path's batch", sparse_set(plain_lists[0])),
                 ("restart path's batch", sparse_set(restart_lists[0])),
                 ("main batch's images at quality 95",
                  sparse_set(q95_streams)),
                 (f"{BATCH // 4} noise images at quality 100",
                  sparse_set(noise_q100))]
    idct_sets += [(label, sparse_set(st)) for label, st in small.items()]
    # the overflow launch's cases (testing/ycc_uploads), at both levels
    for lvl in (128, 2048):
        idct_sets += [(f"{label}, level {lvl}", ("sparse", flat, kw))
                      for label, (flat, kw) in YU.overflow_sets(
                          lvl, ties=16384).items()]
    idct_sets += [
        ("restart path's segments", dense_set(
            _restart_lanes(HG, restart_lists[0], ri), restart_lists[0])),
        ("indexed transport's pseudo-segments of the main path's batch",
         dense_set(_indexed_lanes(HG, plain_lists[0]), plain_lists[0]))]
    err["idct_planes"] = 0
    transform_cuda.idct_launches = 0
    said14, planes_by = [], {}
    for label, (form, src, kw) in idct_sets:
        if form == "sparse":
            src_dev = torch.from_numpy(src).to(dev)
            got = BT.idct_planes_sparse(src_dev, **kw)
            # the plain version takes no overflow index below 0 (the
            # transport pads with N B_c): the junk padding is held to the
            # model alone
            want = (None if label.startswith("junk padding") else
                    BT.idct_planes_sparse_plain(src_dev, **kw))
            model = BT.idct_planes_sparse_model(src, **kw)
            extra = f", overflow rows {list(kw['caps'])}"
        else:
            got = BT.idct_planes_dense(*src, **kw)
            want = BT.idct_planes_dense_plain(*src, **kw)
            model = BT.idct_planes_dense_model(
                *(t.cpu().numpy() for t in src), **kw)
            extra = ", flags " + str(got[:, -1].tolist().count(1))
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        if not np.array_equal(got, model):
            raise AssertionError(f"idct_planes kernel != its model on {label}")
        if want is None:
            said14.append(f"{label} ({form}{extra}): the model alone")
            continue
        d = np.abs(got.astype(np.int32) - want.cpu().numpy().astype(np.int32))
        err["idct_planes"] = max(err["idct_planes"], int(d.max()))
        if d.max() > 1:
            raise AssertionError(f"idct_planes kernel differs from the plain "
                                 f"version by {int(d.max())} on {label}")
        planes_by[label] = got
        said14.append(f"{label} ({form}{extra}): {float((d > 0).mean()):.2e}"
                      " of samples differ from the plain version")
    if transform_cuda.idct_launches != len(idct_sets):
        raise AssertionError(f"IDCT kernel launched "
                             f"{transform_cuda.idct_launches} times in "
                             f"{len(idct_sets)} comparisons")
    # the two forms give the same planes for the same blocks
    for sparse_label, dense_label in (
            ("restart path's batch", idct_sets[-2][0]),
            ("main path's batch", idct_sets[-1][0])):
        if not np.array_equal(planes_by[sparse_label],
                              planes_by[dense_label][:, :-1]):
            raise AssertionError(f"the sparse form on the {sparse_label} "
                                 f"differs from the dense form on the "
                                 f"{dense_label}")
    _say("14 idct", "idct_planes bit-identical to the numpy model of its "
         "ascending float32 sums and within 1 of the plain version; the "
         "sparse form on the ycc420 uploads and the dense form on the "
         "scan's blocks of the same streams give identical planes: "
         + "; ".join(said14))
    idct_sparse_input = idct_sets[0][1]     # phase 6 times both forms
    idct_q95_input = idct_sets[2][1]
    idct_dense_input = idct_sets[-2][1]
    del idct_sets, planes_by, got, want, model, noise_q100, small

    # ---- 15. exact mode's kernels against their plain versions, bit for
    # bit, then the exact paths over the batches
    def tie_planes(blocks, dtype):
        """Sample blocks as one image's planes on the card."""
        return tuple(torch.from_numpy(p.astype(dtype)).to(dev)
                     for p in XT.tie_planes(blocks))

    ones = torch.ones(64, dtype=torch.int32, device=dev)
    q100 = tuple(torch.from_numpy(t).to(dev)
                 for t in T.scale_quant_tables(100))
    rgb0 = torch.from_numpy(batches[0]).to(dev)
    ey, ecb, ecr = OC.rgb_to_ycc(rgb0[..., 0], rgb0[..., 1], rgb0[..., 2],
                                 torch.float64)
    noise15 = np.random.default_rng(17).integers(0, 256, (BATCH, H, W, 3),
                                                 dtype=np.uint8)
    fwd_ties = XT.forward_tie_blocks(4096, 18)
    mixed_fwd = XT.mixed_sample_groups(2048, 21)
    cancel_fwd = XT.cancelling_samples(4096, 22)
    fx_sets = [
        ("ycc420 upload, Annex K", ycc_real, plain_kw),
        ("quality 95", ycc_real, dict(plain_kw, qtables=q95)),
        ("rounded", ycc_real, dict(plain_kw, rounded=True)),
        ("gray", ycc_real, dict(plain_kw, gray=True)),
        ("rgb path, int32 planes at float64, chroma at column stride 2",
         (ey, OB.decimate_420(ecb), OB.decimate_420(ecr)), plain_kw),
        ("noise, quality 100", upload(noise15), dict(plain_kw,
                                                     qtables=q100)),
        (f"tie set of {len(fwd_ties)} blocks, int8, quantizer 1",
         tie_planes(fwd_ties, np.int8), dict(plain_kw, qtables=(ones, ones))),
        ("the tie set, int32, Annex K", tie_planes(fwd_ties, np.int32),
         plain_kw),
        (f"{len(mixed_fwd)} blocks in warp groups that mix dense, sparse, "
         f"zero, cancelling and tie blocks, int8, quantizer 1",
         tie_planes(mixed_fwd, np.int8), dict(plain_kw, qtables=(ones, ones))),
        (f"{len(cancel_fwd)} blocks whose row-0 sums cancel to 0, int32, "
         f"Annex K", tie_planes(cancel_fwd, np.int32), plain_kw)]
    exact_fdct_noise = (fx_sets[5][1], q100)  # phase 6 times the kernels
    del rgb0, ecb, ecr
    err["fdct_quantize_exact"] = 0
    exact_cuda.fdct_exact_launches = 0
    said15 = []
    for label, planes15, kw in fx_sets:
        got = BT.fdct_quantize_exact(*planes15, **kw)
        want = BT.fdct_quantize_plain(*planes15, dtype=torch.float64, **kw)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            e = int((g - w_).abs().max())
            err["fdct_quantize_exact"] = max(err["fdct_quantize_exact"], e)
            if e or g.dtype != torch.int32:
                raise AssertionError(f"fdct_quantize_exact kernel != plain "
                                     f"version on {label}")
        said15.append(f"{label} {tuple(planes15[0].shape)} "
                      f"{planes15[0].dtype}")
    if exact_cuda.fdct_exact_launches != len(fx_sets):
        raise AssertionError(f"exact fDCT kernel launched "
                             f"{exact_cuda.fdct_exact_launches} times in "
                             f"{len(fx_sets)} comparisons")
    _say("15 fdct exact", "fdct_quantize_exact (one launch for the three "
         "components) bit-identical to the plain float64 ordered sums on "
         "the card on: " + "; ".join(said15))
    del fx_sets, got, want

    def rgb_upload(streams):
        """The rgb transport's coefficient upload of streams on the card,
        and the decode's kwargs."""
        pjs15, geom15, level15 = TC._parse_batch(streams, precision="exact")
        coeff15, kw15 = TC._rgb_host_prep(pjs15, geom15, level15,
                                          gray=False, precision="exact")
        return torch.from_numpy(coeff15).to(dev), kw15

    main_up, main_kw = rgb_upload(plain_lists[0])
    # the noise batch's coefficients as the rgb transport would upload them
    # (its quantized blocks, component after component), made on the card
    noise_up = torch.cat(BT.fdct_quantize_exact(
        *upload(noise15), gray=False, rounded=False, qtables=q100),
        dim=1).to(torch.int16)
    yq100, cq100 = (tuple(int(x) for x in t)
                    for t in T.scale_quant_tables(100))
    noise_kw = dict(main_kw, qtuple=(yq100, cq100, cq100))
    # the same noise through the ycc420 upload, for idct_planes in phase 6,
    # its nonzero coefficients and the float32 operations that its sums
    # (inverse_model's, as idct_planes_rgb's) need
    noise_streams = TC.encode_batch(noise15, quality=100, device="cuda")
    noise_flat, noise_flat_kw, *_ = TC._decode_host_prep(
        noise_streams, gray=False, precision="fast", transport=None)
    noise_rgb_up, noise_rgb_kw = rgb_upload(noise_streams)
    noise_flat_ops = rgb_inv_ops(noise_rgb_up, noise_rgb_kw,
                                 exact_cuda.INV_BASIS)
    del noise_rgb_up
    del noise15, noise_streams
    my15, mx15 = main_kw["geom"][0][:2]
    ix_sets = []
    for lay15, (geom15, sizes15, gray15) in XT.upload_layouts(
            my15, mx15).items():
        for lvl in (128, 2048):
            ix_sets.append((f"main batch's upload as {lay15}, level {lvl}",
                            main_up, dict(geom=geom15, sizes=sizes15,
                                          gray=gray15, level=lvl,
                                          qtuple=main_kw["qtuple"][
                                              :len(sizes15)])))
    noise_kw = {k: noise_kw[k] for k in ("geom", "sizes", "gray", "level",
                                         "qtuple")}
    ix_sets.append((f"{BATCH} noise images at quality 100", noise_up,
                    noise_kw))
    ix_sets.append(("main batch's upload as int32", main_up.to(torch.int32),
                    ix_sets[0][2]))
    def one_component(blocks, level):
        """Coefficient blocks as one 1-component image on the card, at
        quantizer 1, and the decode's kwargs."""
        nt = len(blocks)
        return (torch.from_numpy(blocks[None].astype(np.int32)).to(dev),
                dict(geom=((1, nt, 1, 1, 1, 1),), sizes=(nt,), gray=False,
                     level=level, qtuple=(tuple([1] * 64),)))

    for lvl in (128, 2048):
        inv_ties = XT.inverse_tie_blocks(4096, 19, lvl)
        ix_sets.append((f"tie set of {len(inv_ties)} blocks, level {lvl}, "
                        f"quantizer 1", *one_component(inv_ties, lvl)))
        mixed_inv = XT.mixed_coefficient_groups(2048, 23 + lvl, lvl)
        ix_sets.append((f"{len(mixed_inv)} blocks in warp groups that mix "
                        f"dense, sparse, zero, cancelling and tie blocks, "
                        f"level {lvl}", *one_component(mixed_inv, lvl)))
    cancel_inv = XT.cancelling_coefficients(4096, 24)
    ix_sets.append((f"{len(cancel_inv)} blocks whose partial sums cancel to "
                    f"0", *one_component(cancel_inv, 128)))
    err["idct_planes_exact"] = 0
    exact_cuda.idct_exact_launches = 0
    for label, src15, kw in ix_sets:
        got = BT.idct_planes_exact(src15, **kw)
        want = BT.idct_planes_exact_plain(src15, **kw)
        torch.cuda.synchronize()
        if len(got) != len(want):
            raise AssertionError(f"idct_planes_exact gave {len(got)} planes, "
                                 f"the plain version {len(want)}, on {label}")
        for g, w_ in zip(got, want):
            e = int((g - w_).abs().max())
            err["idct_planes_exact"] = max(err["idct_planes_exact"], e)
            if e or g.dtype != torch.int32:
                raise AssertionError(f"idct_planes_exact kernel != plain "
                                     f"version on {label}")
    if exact_cuda.idct_exact_launches != len(ix_sets):
        raise AssertionError(f"exact IDCT kernel launched "
                             f"{exact_cuda.idct_exact_launches} times in "
                             f"{len(ix_sets)} comparisons")
    _say("15 idct exact", "idct_planes_exact (one launch for every "
         "component) bit-identical to the plain float64 ordered sums on the "
         "card on: " + "; ".join(
             f"{label} ({src15.dtype}, {len(kw['sizes'])} components "
             f"{[tuple(g[2:4]) for g in kw['geom']]}"
             f"{', gray' if kw['gray'] else ''})"
             for label, src15, kw in ix_sets))
    exact_fdct_input = ycc_real          # phase 6 times the kernels on these
    exact_idct_input = (main_up, ix_sets[0][2])
    exact_idct_noise = (noise_up, noise_kw)
    del ix_sets, got, want

    # the exact paths over the batches: streams byte-identical to the host
    # codec's, pixels identical to its decode, the exact kernels once a batch
    def run_exact_path(label, fn, per_batch):
        reset_counts()
        t0 = time.perf_counter()
        out = [fn(i, b) for i, b in enumerate(batches)]
        walls15[label] = time.perf_counter() - t0
        exact_launches[label] = read_counts()
        if exact_launches[label] != _per_batch(**per_batch):
            raise AssertionError(f"{label} launches {exact_launches[label]},"
                                 f" want per batch {per_batch}")
        return out

    walls15, exact_launches = {}, {}
    enc_once = dict(fdct_quantize_exact=1, encode_blocks=1, concat_streams=1)
    for label, transport in (("exact_encode", "ycc420"),
                             ("exact_rgb_encode", "rgb")):
        lists15 = run_exact_path(label, lambda i, b: TC.encode_batch(
            b, precision="exact", transport=transport, device="cuda"),
            dict(enc_once, rgb_to_ycc420=1) if transport == "rgb"
            else enc_once)
        if [s for ss in lists15 for s in ss] != host_streams:
            raise AssertionError(f"{label}: streams differ from host_codec's")
    host_lists = [host_streams[i * BATCH:(i + 1) * BATCH]
                  for i in range(MAIN_BATCHES)]
    host_gray = np.stack([np.stack(host_codec.decode(s, gray=True)[:3], -1)
                          for s in host_streams])
    for label, gray15, want_px in (("exact_decode", False, ref_rt),
                                   ("exact_gray_decode", True, host_gray)):
        pxs = run_exact_path(label, lambda i, b: TC.decode_batch(
            host_lists[i], precision="exact", gray=gray15,
            device="cuda")[0], dict(idct_planes_exact=1,
                                    ycc_planes_to_rgb=1))
        if not np.array_equal(np.concatenate(pxs), want_px):
            raise AssertionError(f"{label}: pixels differ from "
                                 "host_codec.decode's")
    del host_gray
    _say("15 exact paths", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W} "
         "precision='exact' on the card: ycc420 and rgb encodes "
         "byte-identical to host_codec, the rgb decode's pixels (colour and "
         "gray) identical to host_codec.decode's; launches " + "; ".join(
             f"{k} { {n: c for n, c in v.items() if c} }"
             for k, v in exact_launches.items())
         + "; serial MP/s " + ", ".join(f"{k} {mpix / v:.3f}"
                                        for k, v in walls15.items())
         + f" (no warm-up); on {card}")

    # ---- 16. the rgb transport's kernels against their references, bit
    # for bit, then the fast rgb paths over the batches
    from jpezy_tpu_torch.runtime import native
    from jpezy_tpu_torch.testing import colour_sets as CS

    # colour + 4:2:0 decimation: the real batch, and an 8192x8192 image
    # whose 2x2 quads hold all 2^24 RGB triples (each reaches the chroma)
    triples = CS.triple_quads(dev)
    enc16 = [("real batch", torch.from_numpy(batches[0]).to(dev)),
             (f"all 2^24 RGB triples in 2x2 quads "
              f"{tuple(triples.shape)}", triples)]
    err["rgb_to_ycc420"] = 0
    colour_cuda.rgb_to_ycc420_launches = 0
    ranges16 = {}
    for label, rgb16 in enc16:
        for dt in (torch.float32, torch.float64):
            got = OC.rgb_to_ycc420(rgb16, dt)
            want = OC.rgb_to_ycc420_plain(rgb16, dt)
            torch.cuda.synchronize()
            for g, w_ in zip(got, want):
                e = int((g.to(torch.int32) - w_.to(torch.int32)).abs().max())
                err["rgb_to_ycc420"] = max(err["rgb_to_ycc420"], e)
                if e or g.dtype != torch.int8:
                    raise AssertionError(f"rgb_to_ycc420 kernel != plain "
                                         f"version on {label}, {dt}")
            if dt == torch.float64:
                host = native.rgb_to_ycc420(rgb16.cpu().numpy())
                if not all(np.array_equal(g.cpu().numpy(), h)
                           for g, h in zip(got, host)):
                    raise AssertionError(f"exact rgb_to_ycc420 kernel != "
                                         f"host C++ rgb_to_ycc420 on {label}")
            if rgb16 is triples:
                # every value fits int8: the int32 conversion's range
                full = OC.rgb_to_ycc(triples[..., 0], triples[..., 1],
                                     triples[..., 2], dt)
                ranges16[str(dt).split(".")[1]] = [
                    (int(c.min()), int(c.max())) for c in full]
                if ranges16[str(dt).split(".")[1]] != [
                        (-128, 127), (-127, 127), (-127, 127)]:
                    raise AssertionError(f"RGB triples at {dt} span "
                                         f"{ranges16}")
                del full
    if colour_cuda.rgb_to_ycc420_launches != 2 * len(enc16):
        raise AssertionError(f"colour kernel (encode) launched "
                             f"{colour_cuda.rgb_to_ycc420_launches} times in "
                             f"{2 * len(enc16)} comparisons")
    del triples, enc16, got, want
    # upsampling + colour: every (Y, Cb, Cr) triple at 4:4:4, and each
    # sampling with samples past both clamps
    dec16 = [("all 2^24 (Y, Cb, Cr) triples at 4:4:4",
              CS.ycc_triple_planes(dev), CS.SAMPLINGS["4:4:4"])]
    for lay16, (dups16, gray16) in CS.SAMPLINGS.items():
        dec16.append((f"{lay16}, samples -400..699",
                      CS.sampling_planes(dups16, 4, H, 480, seed=16,
                                         device=dev), (dups16, gray16)))
    err["ycc_planes_to_rgb"] = 0
    colour_cuda.ycc_planes_to_rgb_launches = 0
    for label, planes16, (dups16, gray16) in dec16:
        used16 = planes16[:1] if gray16 else planes16
        geom16 = CS.geom_of(dups16)
        for dt in (torch.float32, torch.float64):
            got = OC.planes_to_rgb(used16, geom16, gray16, dt)
            want = OC.planes_to_rgb_plain(used16, geom16, gray16, dt)
            torch.cuda.synchronize()
            e = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            err["ycc_planes_to_rgb"] = max(err["ycc_planes_to_rgb"], e)
            if e or got.dtype != torch.uint8:
                raise AssertionError(f"ycc_planes_to_rgb kernel != plain "
                                     f"version on {label}, {dt}")
            if dt == torch.float64 and not gray16 and (
                    dups16 == CS.SAMPLINGS["4:2:0"][0] or "triples" in label):
                up16 = [OB.upsample_nearest(p, dy, dx).cpu().numpy()
                        for p, (dy, dx) in zip(used16, dups16)]
                host = np.stack([native.ycc_to_rgb_i32(*(u[i] for u in up16))
                                 for i in range(up16[0].shape[0])])
                if not np.array_equal(got.cpu().numpy(), host):
                    raise AssertionError(f"exact ycc_planes_to_rgb kernel != "
                                         f"host C++ ycc_to_rgb_i32 on {label}")
    if colour_cuda.ycc_planes_to_rgb_launches != 2 * len(dec16):
        raise AssertionError(f"colour kernel (decode) launched "
                             f"{colour_cuda.ycc_planes_to_rgb_launches} times "
                             f"in {2 * len(dec16)} comparisons")
    del dec16, got, want
    # the fast IDCT into planes: the main batch's rgb upload read at every
    # sampling and level, as int32 too, the main batch's images at quality
    # 95, noise at quality 100, the float32 tie set and the kernel's mixed
    # warp groups at both levels
    ir_sets = [(f"main batch's upload as {lay16}, level {lvl}", main_up,
                dict(geom=g16, sizes=s16, gray=gr16, level=lvl,
                     qtuple=main_kw["qtuple"][:len(s16)]))
               for lay16, (g16, s16, gr16) in XT.upload_layouts(
                   my15, mx15).items() for lvl in (128, 2048)]
    ir_sets.append(("main batch's upload as int32", main_up.to(torch.int32),
                    ir_sets[0][2]))
    q95_up, q95_kw = rgb_upload(q95_streams)
    q95_kw = {k: q95_kw[k] for k in ir_sets[0][2]}
    ir_sets.append(("main batch's images at quality 95", q95_up, q95_kw))
    ir_sets.append((f"{BATCH} noise images at quality 100",
                    exact_idct_noise[0], exact_idct_noise[1]))
    for lvl in (128, 2048):
        f32_ties = RT.inverse_tie_blocks(16384, 25 + lvl, lvl)
        ir_sets.append((f"float32 tie set of {len(f32_ties)} blocks, level "
                        f"{lvl}, quantizer 1",
                        *one_component(f32_ties, lvl)))
        mixed16 = RT.mixed_coefficient_groups(2048, 26 + lvl, lvl)
        ir_sets.append((f"{len(mixed16)} blocks in warp groups that mix "
                        f"dense, sparse, zero, cancelling and float32 tie "
                        f"blocks, level {lvl}", *one_component(mixed16, lvl)))
    err["idct_planes_rgb"] = 0
    ir_diff = []
    exact_cuda.idct_rgb_launches = 0
    for label, src16, kw in ir_sets:
        got = BT.idct_planes_rgb(src16, precision="fast", **kw)
        want = BT.idct_planes_rgb_plain(src16, dtype=torch.float32, **kw)
        model = BT.idct_planes_rgb_model(src16.cpu().numpy(), **kw)
        torch.cuda.synchronize()
        if len(got) != len(model):
            raise AssertionError(f"idct_planes_rgb gave {len(got)} planes, "
                                 f"the model {len(model)}, on {label}")
        n_diff = n_all = 0
        for g, w_, m in zip(got, want, model):
            if g.dtype != torch.int32 or not np.array_equal(g.cpu().numpy(),
                                                            m):
                raise AssertionError(f"idct_planes_rgb kernel != its numpy "
                                     f"model on {label}")
            d = (g - w_).abs()
            err["idct_planes_rgb"] = max(err["idct_planes_rgb"],
                                         int(d.max()))
            if int(d.max()) > 1:
                raise AssertionError(f"idct_planes_rgb kernel differs from "
                                     f"the plain version by {int(d.max())} "
                                     f"on {label}")
            n_diff += int((d > 0).sum())
            n_all += d.numel()
        ir_diff.append(f"{label} {n_diff / n_all:.2e}")
    if exact_cuda.idct_rgb_launches != len(ir_sets):
        raise AssertionError(f"fast rgb IDCT kernel launched "
                             f"{exact_cuda.idct_rgb_launches} times in "
                             f"{len(ir_sets)} comparisons")
    rgb_idct_input = (main_up, ir_sets[0][2])   # phase 6 times these
    rgb_idct_q95 = (q95_up, q95_kw)
    del ir_sets, got, want, model
    # the fast rgb paths over the batches: the colour kernel, the fDCT, the
    # entropy kernel and the concat once an encode; the fast IDCT and the
    # colour kernel once a decode; PSNR within the main path's slack of the
    # host codec's exact round trip
    rgb_launches16, walls16 = {}, {}

    def run_rgb_path(label, fn, per_batch):
        reset_counts()
        t0 = time.perf_counter()
        out = [fn(i, b) for i, b in enumerate(batches)]
        walls16[label] = time.perf_counter() - t0
        rgb_launches16[label] = read_counts()
        if rgb_launches16[label] != _per_batch(**per_batch):
            raise AssertionError(f"{label} launches {rgb_launches16[label]}"
                                 f", want per batch {per_batch}")
        return out

    rgb_lists = run_rgb_path("rgb_encode", lambda i, b: TC.encode_batch(
        b, transport="rgb", device="cuda"), dict(
            rgb_to_ycc420=1, fdct_quantize=1, encode_blocks=1,
            concat_streams=1))
    rgb_px = run_rgb_path("rgb_decode", lambda i, b: TC.decode_batch(
        rgb_lists[i], transport="rgb", device="cuda")[0], dict(
            idct_planes_rgb=1, ycc_planes_to_rgb=1))
    p_rgb = _psnr(np.concatenate(rgb_px), np.concatenate(batches))
    if p_rgb < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"fast rgb round trip PSNR {p_rgb} < host exact "
                             f"{p_ref}")
    del rgb_lists, rgb_px
    _say("16 rgb kernels", f"rgb_to_ycc420 (one launch) bit-identical to the "
         f"plain version at float32 and float64 on the real batch and on all "
         f"2^24 RGB triples in 2x2 quads, the float64 form also to the host "
         f"C++ rgb_to_ycc420; the triples' values (Y-128, Cb, Cr) span "
         f"{ranges16}, so int8 holds them; ycc_planes_to_rgb (one launch) "
         f"bit-identical to the plain version at both precisions on all "
         f"2^24 (Y, Cb, Cr) triples at 4:4:4 and on 4x{H}x480 planes past "
         f"both clamps at " + ", ".join(CS.SAMPLINGS) + ", the float64 form "
         f"also to the host C++ ycc_to_rgb_i32 (triples, 4:2:0); "
         f"idct_planes_rgb bit-identical to its numpy model and within 1 of "
         f"the plain version (cuBLAS), share differing: " + "; ".join(ir_diff)
         + f"; fast rgb paths over {MAIN_BATCHES} batches: PSNR {p_rgb:.4f} "
         f"dB (host exact {p_ref:.4f}), launches " + "; ".join(
             f"{k} { {n: c for n, c in v.items() if c} }"
             for k, v in rgb_launches16.items())
         + "; serial MP/s " + ", ".join(f"{k} {mpix / v:.3f}"
                                        for k, v in walls16.items())
         + f" (no warm-up); on {card}")

    # ---- 5/8 device: event spans, then (only now) the profiler
    y, cb, cr = HG.host_rgb_to_ycc420(batches[0])
    packed_dev = torch.from_numpy(np.concatenate(
        [y.reshape(BATCH, -1), cb.reshape(BATCH, -1), cr.reshape(BATCH, -1)],
        axis=1)).to(dev)
    def enc():
        return TC._encode_batch_blocks_packed(packed_dev, h=H, w=W)

    def enc_r():
        return TC._encode_batch_blocks_packed(packed_dev, h=H, w=W,
                                              restart_interval=ri)

    flat_host, kw, _, _, _ = TC._decode_host_prep(
        results[0][0], gray=False, precision="fast", transport=None)
    flat_dev = torch.from_numpy(flat_host).to(dev)
    def dec():
        return TC._decode_fused_batch_ycc420(flat_dev, **kw)

    lanes = _to_dev(_restart_lanes(HG, restart_lists[0], ri), dev)
    qarr = torch.from_numpy(HG._quant_arr(pjs_r)).to(dev)
    geom = kw["geom"]
    def dec_r():
        return TC._decode_fused_batch_device(
            lanes["words"], lanes["nblk"], lanes["lut"], lanes["tsel"],
            lanes["rawlen"], qarr, N=BATCH, nseg=nseg, ri=ri, geom=geom,
            level=128)

    # all event spans first: once the profiler has traced in a process,
    # every later launch costs the host more
    spans = {name: _time_ms(fn, 5) for name, fn in (
        ("enc", enc), ("dec", dec), ("enc_r", enc_r), ("dec_r", dec_r))}
    profs = {name: _profile(fn, 5) for name, fn in (
        ("enc", enc), ("dec", dec), ("enc_r", enc_r), ("dec_r", dec_r))}
    enc_prof, dec_prof = profs["enc"], profs["dec"]
    # the encode programs, with and without restart markers, are the three
    # hand kernels and nothing else between the upload and the fetch
    program_kernels = ("fdct_quantize_kernel", "encode_blocks_batch_kernel",
                       "concat_streams_kernel")
    for name in ("enc", "enc_r"):
        names = sorted(profs[name]["by_name"])
        if profs[name]["events"] > 3 or len(names) != 3 or not all(
                any(k in n for n in names) for k in program_kernels):
            raise AssertionError(
                f"the encode program ({name}) makes "
                f"{profs[name]['events']} device events per call ({names}): "
                "want the fDCT, entropy and concat kernels alone (12 events "
                "before the entropy kernel took the predictors and the "
                "concat became one launch)")
    # the ycc420 decode program is the IDCT kernel (a second launch only
    # for overflow rows); the device one the scan, its flags' conversion
    # and the IDCT kernel
    if dec_prof["events"] > 2 or profs["dec_r"]["events"] > 3:
        raise AssertionError(
            f"the decode programs make {dec_prof['events']} (ycc420) and "
            f"{profs['dec_r']['events']} (device) device events per call, "
            "2 and 3 at most since the IDCT kernel (97 and 33 before it)")

    def earlier(name):
        ms, events = EARLIER_PROGRAMS[name]
        return f"before the kernels: {ms} ms busy in {events} events"
    # the card's busy share of a pipelined round trip: device time of the
    # same round trip under the profiler (which slows the host, not the
    # kernels) over the wall time measured above without it
    rt_prof = _profile(lambda: list(roundtrip_batches(
        batches, lookahead=1, device="cuda")), 1)
    rrt_prof = _profile(lambda: list(roundtrip_batches(batches, **rt_kw)), 1)
    if rt_prof["busy_ms"] is None or rrt_prof["busy_ms"] is None:
        raise RuntimeError("the profiler traced no device time for the "
                           "round trips")
    busy_share = rt_prof["busy_ms"] / (1e3 * wall)
    rbusy_share = rrt_prof["busy_ms"] / (1e3 * rwall)
    _say("5 device", f"main path per batch: encode event span "
         f"{spans['enc']:.3f} ms, device busy "
         f"{_fmt_ms(enc_prof['busy_ms'])} ms in {enc_prof['events']:.1f} "
         f"device events ({earlier('encode')}; {EARLIER_ENCODE['encode']} "
         f"with the earlier entropy tail; fused kernel "
         f"{_fmt_ms(_kernel_ms(enc_prof, 'encode_blocks_batch_kernel', False))}"
         " ms, fDCT kernel "
         f"{_fmt_ms(_kernel_ms(enc_prof, 'fdct_quantize_kernel', False))} "
         "ms, concat kernel "
         f"{_fmt_ms(_kernel_ms(enc_prof, 'concat_streams_kernel', False))} "
         "ms); "
         f"decode event span {spans['dec']:.3f} ms, device busy "
         f"{_fmt_ms(dec_prof['busy_ms'])} ms in {dec_prof['events']:.1f} "
         f"device events ({earlier('ycc420 decode')}; IDCT kernel "
         f"{_fmt_ms(_kernel_ms(dec_prof, 'idct_planes_kernel', False))} "
         "ms); "
         f"device busy over the {MAIN_BATCHES} pipelined batches "
         f"{rt_prof['busy_ms']:.3f} ms in {rt_prof['events']:.0f} device "
         f"events = {busy_share:.4f} of that wall, idle "
         f"{1 - busy_share:.4f} ({rt_prof['busy_ms'] / rt_prof['wall_ms']:.4f}"
         f" of the {rt_prof['wall_ms'] / 1e3:.3f} s the round trip takes "
         f"under the profiler) on {card}")
    scan_in_dec_r = _kernel_ms(profs["dec_r"], "decode_segments_kernel",
                               False)
    _say("8 device", f"restart path per batch: encode event span "
         f"{spans['enc_r']:.3f} ms, device busy "
         f"{_fmt_ms(profs['enc_r']['busy_ms'])} ms in "
         f"{profs['enc_r']['events']:.1f} device events "
         f"({EARLIER_ENCODE['restart encode']} with the earlier entropy "
         f"tail; fused kernel "
         + _fmt_ms(_kernel_ms(profs["enc_r"], "encode_blocks_batch_kernel",
                              False))
         + " ms, concat kernel "
         + _fmt_ms(_kernel_ms(profs["enc_r"], "concat_streams_kernel", False))
         + " ms); device decode "
         f"program (_decode_fused_batch_device) event span "
         f"{spans['dec_r']:.3f} ms, device busy "
         f"{_fmt_ms(profs['dec_r']['busy_ms'])} ms in "
         f"{profs['dec_r']['events']:.1f} device events "
         f"({earlier('device decode')}), of it the scan kernel "
         + _fmt_ms(scan_in_dec_r) + " ms and the tail after the scan "
         + _fmt_ms(None if None in (profs["dec_r"]["busy_ms"],
                                    scan_in_dec_r)
                   else profs["dec_r"]["busy_ms"] - scan_in_dec_r)
         + " ms (the IDCT kernel "
         + _fmt_ms(_kernel_ms(profs["dec_r"], "idct_planes_kernel", False))
         + f" ms); device busy over the {MAIN_BATCHES} pipelined batches "
         f"{rrt_prof['busy_ms']:.3f} ms in {rrt_prof['events']:.0f} device "
         f"events = {rbusy_share:.4f} of that wall, idle "
         f"{1 - rbusy_share:.4f} on {card}")
    del lanes, qarr, flat_dev

    # the encode program's three stages, each alone on the same batch
    ny, nc = H * W, (H // 2) * (W // 2)
    planes = (packed_dev[:, :ny].reshape(BATCH, H, W),
              packed_dev[:, ny:ny + nc].reshape(BATCH, H // 2, W // 2),
              packed_dev[:, ny + nc:].reshape(BATCH, H // 2, W // 2))
    def st_quant():
        return TC._quantize_local_ycc(*planes, gray=False,
                                      dtype=torch.float32, rounded=False)

    def st_quant_plain():  # the stage as it was before the kernel
        return BT.fdct_quantize_plain(*planes, gray=False, rounded=False)

    quantized = st_quant()
    def st_emit():
        return TC._emit_local(*quantized)

    emitted = st_emit()
    stage_maxw = TC.stream_budget_words_batch(6 * (H // 16) * (W // 16))
    def st_concat():
        return TC._concat_batch_combined_comp(*emitted)

    def st_concat_plain():  # the stage as it was before the kernel
        return E.concat_streams_plain(*emitted, 0, stage_maxw)

    parts = []
    for label, fn in (("fDCT+quantize, kernel (one wrapper call)", st_quant),
                      ("fDCT+quantize, plain torch on the card (the stage "
                       f"before the kernel; {earlier('fDCT+quantize')})",
                       st_quant_plain),
                      ("entropy, the batched kernel (one wrapper call)",
                       st_emit),
                      ("entropy, restart_interval=8, the batched kernel",
                       lambda: TC._emit_local(*quantized, ri)),
                      ("entropy as the earlier design ran it: plain "
                       "predictor chains and three per-component launches "
                       "(previous_designs)",
                       lambda: previous_designs.encode_stage(*quantized)),
                      ("the same, restart_interval=8",
                       lambda: previous_designs.encode_stage(*quantized,
                                                             ri)),
                      ("concat, kernel (one wrapper call)", st_concat),
                      ("concat, the two-pass design (previous_designs)",
                       lambda: previous_designs.concat_two_pass(
                           *emitted, maxw=stage_maxw)),
                      ("concat, plain torch on the card (the stage before "
                       f"the kernel; {EARLIER_CONCAT_MS} ms busy in 40 events "
                       "in PR 5)", st_concat_plain)):
        span, prof = _time_ms(fn, 5), _profile(fn, 5)  # spans: after tracing
        parts.append(f"{label}: device busy {_fmt_ms(prof['busy_ms'])} ms, "
                     f"event span {span:.3f} ms, {prof['events']:.1f} events")
    _say("5 stages", "encode program per batch, each stage alone: "
         + "; ".join(parts))
    del planes, quantized, emitted

    def stage_rows(stages):
        """'label: device busy, event span, events' of each stage alone
        (spans after tracing: they hold more host time than phase 5's)."""
        rows = []
        for label, fn in stages:
            span, prof = _time_ms(fn, 5), _profile(fn, 5)
            rows.append(f"{label}: device busy {_fmt_ms(prof['busy_ms'])} "
                        f"ms, event span {span:.3f} ms, "
                        f"{prof['events']:.1f} events")
        return rows

    # optimize: its device stages alone, and the card's busy share
    quantized = TC._quantize_batch_ycc(packed_dev, h=H, w=W)
    hists_b = TC._symbol_histograms_batch(*quantized,
                                          restart_interval=ri).cpu().numpy()
    _, yt_b, ct_b = TC._optimal_tables(hists_b)
    opt_rows = stage_rows((
        ("symbol histograms (one kernel and the memset of the counts)",
         lambda: TC._symbol_histograms_batch(*quantized,
                                             restart_interval=ri)),
        ("symbol histograms, plain torch on the card (the predictor chains "
         "and counts; PR 5 and 6 read 0.0635 ms busy in 29 events for the "
         "three kernels, the chains and the chroma sum)",
         lambda: E.symbol_histograms_batch_plain(*quantized, ri)),
        ("the same and the [N, 4, 256] fetch",
         lambda: TC._symbol_histograms_batch(
             *quantized, restart_interval=ri).cpu()),
        ("entropy with 16 table sets + concat (_encode_batch_custom)",
         lambda: TC._encode_batch_custom(*quantized, yt_b, ct_b,
                                         restart_interval=ri))))
    opt_prof = _profile(lambda: list(decode_batches(
        list(encode_batches(batches, **opt_kw)), **odec_kw)), 1)
    if opt_prof["busy_ms"] is None:
        raise RuntimeError("the profiler traced no device time for the "
                           "optimize path")
    obusy_share = opt_prof["busy_ms"] / (1e3 * (owall + odwall))
    _say("10 device", "optimize encode per batch, device stages alone: "
         + "; ".join(opt_rows)
         + f"; over the {MAIN_BATCHES} pipelined batches (encode then "
         f"device decode) device busy {opt_prof['busy_ms']:.3f} ms in "
         f"{opt_prof['events']:.0f} device events = {obusy_share:.4f} of "
         f"their wall, idle {1 - obusy_share:.4f} on {card}")
    del quantized

    # the rgb transports' device programs, fast and exact
    rgb_dev = torch.from_numpy(np.ascontiguousarray(batches[0])).to(dev)
    pjs_rgb, geom_rgb, level_rgb = TC._parse_batch(plain_lists[0])
    coeff, rkw = TC._rgb_host_prep(pjs_rgb, geom_rgb, level_rgb, gray=False,
                                   precision="fast")
    coeff_dev = torch.from_numpy(coeff).to(dev)
    rgb_prep_ms = _host_ms(lambda: TC._rgb_host_prep(
        pjs_rgb, geom_rgb, level_rgb, gray=False, precision="fast"))
    def was(name, key):
        ms, events = EARLIER_EXACT[name]
        ms2, events2 = EARLIER_RGB[key]
        return (f"before the exact kernels {ms} ms busy in {events} events, "
                f"before the colour kernels {ms2} ms in {events2} events, "
                f"with the exact kernels' first designs "
                f"{FIRST_EXACT_PROGRAMS[name]} ms, kept from then")

    # the rgb programs are the hand kernels alone between the upload and
    # the fetch: 4 device events an encode, 2 a decode
    enc_k = ("rgb_to_ycc420_kernel", "encode_blocks_batch_kernel",
             "concat_streams_kernel")
    dec_k = ("ycc_planes_to_rgb_kernel",)
    rgb_programs = (
        ("rgb encode, fast", "rgb encode program, fast "
         "(_encode_batch_blocks; before the colour kernel "
         f"{EARLIER_RGB['rgb encode, fast'][0]} ms in "
         f"{EARLIER_RGB['rgb encode, fast'][1]} events, kept from then)",
         lambda: TC._encode_batch_blocks(rgb_dev),
         enc_k + ("fdct_quantize_kernel",)),
        ("rgb encode, exact", "rgb encode program, exact ("
         + was("rgb exact encode", "rgb encode, exact") + ")",
         lambda: TC._encode_batch_blocks(rgb_dev, precision="exact"),
         enc_k + ("fdct_quantize_exact_kernel",)),
        ("rgb decode, fast", "rgb decode program, fast "
         "(_decode_fused_batch; before the fast IDCT and colour kernels "
         f"{EARLIER_RGB['rgb decode, fast'][0]} ms in "
         f"{EARLIER_RGB['rgb decode, fast'][1]} events, kept from then)",
         lambda: TC._decode_fused_batch(coeff_dev, **rkw),
         dec_k + ("idct_planes_rgb_kernel",)),
        ("rgb decode, exact", "rgb decode program, exact ("
         + was("exact decode", "rgb decode, exact") + ")",
         lambda: TC._decode_fused_batch(coeff_dev,
                                        **dict(rkw, precision="exact")),
         dec_k + ("idct_planes_exact_kernel",)),
        ("rgb decode, gray exact", "rgb decode program, gray exact ("
         + was("gray exact decode", "rgb decode, gray exact") + ")",
         lambda: TC._decode_fused_batch(
             coeff_dev, **dict(rkw, precision="exact", gray=True)),
         dec_k + ("idct_planes_exact_kernel",)))
    rgb_rows = []
    for key, label, fn, want_k in rgb_programs:
        span = _time_ms(fn, 5)
        for attempt in range(3):  # a trace that lost events is taken again
            prof = _profile(fn, 5)
            names = sorted(prof["by_name"])
            if prof["events"] <= len(want_k) and len(names) == len(want_k) \
                    and all(any(k in n for n in names) for k in want_k):
                break
            if attempt == 2:
                raise AssertionError(
                    f"the {key} program makes {prof['events']} device "
                    f"events per call ({names}): want {', '.join(want_k)} "
                    "alone")
        rgb_rows.append(f"{label}: device busy {_fmt_ms(prof['busy_ms'])} "
                        f"ms, event span {span:.3f} ms, "
                        f"{prof['events']:.1f} events")

    # the fast decode program with the fast IDCT's first design
    # (scripts/previous_designs.py) in its place, in turns with it as it is
    def with_first_rgb(fn):
        def first(coeff_all, qtab, **kw):
            return previous_designs.idct_planes_rgb_first(
                coeff_all.contiguous(), qtab, **kw)

        def run():
            keep = exact_cuda.idct_planes_rgb_cuda
            exact_cuda.idct_planes_rgb_cuda = first
            try:
                return fn()
            finally:
                exact_cuda.idct_planes_rgb_cuda = keep
        return run

    dec_fast = rgb_programs[2][2]
    dec_turns = [(which, _profile(fn, 5)["busy_ms"]) for which, fn in (
        ("now", dec_fast), ("first", with_first_rgb(dec_fast)),
        ("now again", dec_fast), ("first again", with_first_rgb(dec_fast)))]
    rgb_rows.append("rgb decode program, fast, in turns with the fast "
                    "IDCT's first design in its place: " + ", ".join(
                        f"{w} {_fmt_ms(ms)} ms" for w, ms in dec_turns))

    # the ycc420 decode program with the first design of the IDCT's
    # overflow launch (scripts/previous_designs.py, after the same sparse
    # launch) in its place, in turns with it as it is: on the main batch
    # and on noise at quality 100
    def with_first_overflow(fn):
        def run():
            keep = transform_cuda.idct_planes_sparse_cuda
            transform_cuda.idct_planes_sparse_cuda = (
                previous_designs.idct_planes_overflow_first)
            try:
                return fn()
            finally:
                transform_cuda.idct_planes_sparse_cuda = keep
        return run

    for label, flat11, kw11 in (
            ("main batch", idct_sparse_input[1], idct_sparse_input[2]),
            ("noise at quality 100", noise_flat, noise_flat_kw)):
        flat11_dev = torch.from_numpy(flat11).to(dev)

        def dec11(flat11_dev=flat11_dev, kw11=kw11):
            return TC._decode_fused_batch_ycc420(flat11_dev, **kw11)

        turns11 = [(which, _profile(fn, 5)["busy_ms"]) for which, fn in (
            ("now", dec11), ("first", with_first_overflow(dec11)),
            ("now again", dec11),
            ("first again", with_first_overflow(dec11)))]
        rgb_rows.append(
            f"ycc420 decode program on the {label} (overflow rows "
            f"{list(kw11['caps'])}), in turns with the first overflow "
            f"launch in its place: " + ", ".join(
                f"{w} {_fmt_ms(ms)} ms" for w, ms in turns11))
        del flat11_dev
    # the exact ycc420 encode program is the exact fDCT, entropy and concat
    # kernels alone, as the fast one is with its fDCT kernel
    def enc_exact():
        return TC._encode_batch_blocks_packed(packed_dev, h=H, w=W,
                                              precision="exact")

    exact_span = _time_ms(enc_exact, 5)
    exact_prof = _profile(enc_exact, 5)
    names = sorted(exact_prof["by_name"])
    if exact_prof["events"] > 3 or len(names) != 3 or not all(
            any(k in n for n in names) for k in (
                "fdct_quantize_exact_kernel", "encode_blocks_batch_kernel",
                "concat_streams_kernel")):
        raise AssertionError(
            f"the exact ycc420 encode program makes {exact_prof['events']} "
            f"device events per call ({names}): want the exact fDCT, "
            "entropy and concat kernels alone")
    _say("11 device", f"rgb transports per {BATCH}x{H}x{W} batch: "
         + "; ".join(rgb_rows)
         + f"; ycc420 encode program, exact "
         f"(_encode_batch_blocks_packed; with the exact kernels' first "
         f"designs {FIRST_EXACT_PROGRAMS['ycc420 exact encode']} ms busy, "
         f"kept from then): device busy "
         f"{_fmt_ms(exact_prof['busy_ms'])} ms, event span {exact_span:.3f} "
         f"ms, {exact_prof['events']:.1f} events (exact fDCT kernel "
         f"{_fmt_ms(_kernel_ms(exact_prof, 'fdct_quantize_exact_kernel', False))}"
         f" ms); host frontend of the rgb decode (_rgb_host_prep) "
         f"{rgb_prep_ms:.3f} ms on {card}")
    del rgb_dev, coeff_dev

    # ---- 6. each kernel alone, timed (after the round trips: the profiler
    # is first used in phase 5, behind the pipelined wall-clock measurement)
    def bound(name, nblocks, emissions, extra_bytes=0):
        """Bound of `name` on this many blocks holding this many emissions
        of nonzero length (symbols, for the histograms): the bytes and the
        operations its function needs at the least."""
        per_slot, per_emission = MIN_OPS[name]
        return _bound(BLOCK_BYTES[name] * nblocks + extra_bytes,
                      per_slot * 64 * nblocks + per_emission * emissions)

    def sass_ms(name, block_counts):
        """What running every SASS instruction of the kernel once in every
        launched thread would take: more than the kernel executes, since
        it counts each branch as taken (an empty slot skips most of its
        emission code)."""
        per = BLOCKS_PER_WARP[name]
        threads = sum(32 * ((n + per - 1) // per) for n in block_counts)
        return 1e3 * sass[name] * threads / PEAK_INT_OPS_PER_S

    counts = [q.shape[0] for q, *_ in real_inputs]
    n_emitted = [int((ems[2] > 0).sum()) for *_, ems in real_inputs]
    n_symbols = int(E.symbol_histograms_batch_plain(
        *comps, RESTART_INTERVAL).sum())
    # the concat's inputs: the main path's blocks; what its function must
    # move is each block's bit count and used words, and combined
    cwc, cbc = concat_inputs
    cmaxw = TC.stream_budget_words_batch(6 * cbc[1].shape[1])
    n_cblocks = sum(b.numel() for b in cbc)
    used_words = sum(int(((b.to(torch.int64) + 31) // 32).clamp(max=64).sum())
                     for b in cbc)
    combined_bytes = 8 * BATCH * (1 + cmaxw)
    concat_bytes = 4 * n_cblocks + 8 * used_words + combined_bytes
    concat_layout_bytes = (4 + 8 * 64) * n_cblocks + combined_bytes
    # the block transforms on the main path's batch: the bytes their
    # functions must move, and their float32 operations (a multiply-add two;
    # the IDCT's depend on the data: 64 multiply-adds per nonzero
    # coefficient)
    from jpezy_tpu_torch.constants import codec_constants

    n_blocks = sum(counts)
    fdct_bytes = (sum(p.numel() * p.element_size() for p in fdct_inputs)
                  + 4 * 64 * n_blocks + 4 * 64 * 64 + 2 * 4 * 64)
    fdct_ops = 2 * 1024 * n_blocks       # the kernel's separable form
    fdct_ops64 = 2 * 4096 * n_blocks     # the 64-term form (the plain one)
    _, sp_flat, sp_kw = idct_sparse_input
    sp_dev = torch.from_numpy(sp_flat).to(dev)
    idct_out_bytes = BATCH * H * W * 3 // 2
    idct_bytes = sp_flat.size + idct_out_bytes + 4 * 64 * 64 + 3 * 4 * 64
    idct_ops = 128 * real_nonzero
    _, dn_src, dn_kw = idct_dense_input
    dn_used = BATCH * (H // 16) * (W // 16) * 6 * 128
    dn_bytes = (dn_used + dn_src[1].numel() + idct_out_bytes + BATCH
                + dn_src[2].numel() * 4 + 4 * 64 * 64)
    # the one PyTorch call beside them (the port calls it nowhere): the
    # [98304, 64] @ [64, 64] float32 product alone
    lib_x = torch.randn(n_blocks, 64, device=dev)
    lib_m = codec_constants(dev)["inv64_f32"]
    library_ms = _profile(lambda: torch.matmul(lib_x, lib_m.T), 20)[
        "busy_ms"]
    # and the same product in float64 (cuBLAS DGEMM), the yardstick of
    # exact mode's kernels: not the same function, since it reorders the
    # sums and contracts products into the adds
    lib_x64, lib_m64 = lib_x.to(torch.float64), lib_m.to(torch.float64)
    library64_ms = _profile(lambda: torch.matmul(lib_x64, lib_m64.T), 20)[
        "busy_ms"]
    # exact mode's kernels: the forward on the main batch's int8 planes, the
    # inverse on its rgb upload (int16) into int32 planes; float64
    # operations counted from the data (the inverse's from the nonzero
    # coefficients)
    ex_fdct_bytes = (sum(p.numel() * p.element_size()
                         for p in exact_fdct_input)
                     + 4 * 64 * n_blocks + 8 * 136 + 2 * 4 * 64)
    ex_fdct_ops = exact_fwd_ops(exact_fdct_input)
    ex_coeff, ex_kw = exact_idct_input
    ex_samples = ex_coeff.numel()
    ex_idct_bytes = (ex_coeff.numel() * ex_coeff.element_size()
                     + 4 * ex_samples + 8 * 136 + 3 * 4 * 64)
    ex_nonzero = int((ex_coeff != 0).sum())
    ex_idct_ops = exact_inv_ops(ex_coeff, ex_kw)
    # the rgb transport's kernels on the main batch: its RGB samples (fast
    # colour), its rgb upload into the fast IDCT's int32 planes, and those
    # planes (4:2:0) into RGB; their bytes, and their separate float32
    # multiplies and adds (the IDCT's that its roundings need, rgb_inv_ops,
    # counted from the data; colour 6 a pixel for Y and 10 a 2x2 quad for
    # the chroma on encode, 10 a pixel on decode)
    rgb6 = torch.from_numpy(batches[0]).to(dev)
    rgb_src, rgb_kw = rgb_idct_input[0], {
        k: main_kw[k] for k in ("geom", "sizes", "gray", "level", "qtuple")}
    planes6 = BT.idct_planes_rgb(rgb_src, precision="fast", **rgb_kw)
    n_px = BATCH * H * W
    col_enc_bytes = 3 * n_px + n_px + 2 * (n_px // 4)
    col_enc_ops = 6 * n_px + 10 * (n_px // 4)
    ir_bytes = (rgb_src.numel() * rgb_src.element_size()
                + sum(4 * p.numel() for p in planes6) + 4 * 64 * 64
                + 3 * 4 * 64)
    ir_nonzero = int((rgb_src != 0).sum())
    ir_ops = rgb_inv_ops(rgb_src, rgb_kw, exact_cuda.INV_BASIS)
    col_dec_bytes = sum(4 * p.numel() for p in planes6) + 3 * n_px
    col_dec_ops = 10 * n_px
    rgb_geom = rgb_kw["geom"]
    # each kernel's launches on one batch (Y, Cb, Cr, or one for all), its
    # plain version on the same inputs, its symbols in the trace, its bound
    kernels6 = {
        "pack_words": (
            [lambda i=i: pack_cuda.pack_words_cuda(*real_inputs[i][3])
             for i in range(3)],
            lambda: [E.pack_block_words_plain(*ems)
                     for *_, ems in real_inputs],
            ("pack_words_kernel",),
            bound("pack_words", sum(counts), sum(n_emitted)),
            f"{sum(n_emitted)} emissions in {sum(counts)} blocks"),
        "encode_blocks": (
            [lambda: pack_cuda.encode_blocks_batch_cuda(*real_comps)],
            lambda: E.encode_blocks_batch_plain(*real_comps),
            ("encode_blocks_batch_kernel",),
            bound("encode_blocks", sum(counts), sum(n_emitted)),
            f"{sum(n_emitted)} emissions in {sum(counts)} blocks, the three "
            f"components in one launch"),
        "symbol_histograms": (
            [lambda: pack_cuda.symbol_histograms_batch_cuda(
                *comps, restart_interval=RESTART_INTERVAL)],
            lambda: E.symbol_histograms_batch_plain(*comps,
                                                    RESTART_INTERVAL),
            ("symbol_histograms_batch_kernel",),
            bound("symbol_histograms", sum(counts), n_symbols,
                  BATCH * IMAGE_HIST_BYTES),
            f"{n_symbols} symbols in {sum(counts)} blocks, "
            f"restart_interval={RESTART_INTERVAL}; the three launches it "
            f"replaced (PR 5, kept from then) "
            f"{EARLIER_HISTOGRAM_MS} ms"),
        "concat_streams": (
            [lambda: concat_cuda.concat_streams_cuda(cwc, cbc, maxw=cmaxw)],
            lambda: E.concat_streams_plain(cwc, cbc, 0, cmaxw),
            ("concat_streams_kernel",),
            _bound(concat_bytes, CONCAT_OPS[0] * n_cblocks
                   + CONCAT_OPS[1] * used_words),
            f"{used_words} used words in {n_cblocks} blocks, "
            f"{concat_bytes} bytes (all 64 words of every block, as laid "
            f"out: {concat_layout_bytes} bytes, "
            f"{1e3 * concat_layout_bytes / PEAK_BYTES_PER_S:.4f} ms); the "
            f"plain stage it replaced read {EARLIER_CONCAT_MS} ms busy "
            f"(PR 5, kept from then)"),
        "fdct_quantize": (
            [lambda: BT.fdct_quantize(*fdct_inputs, gray=False,
                                      rounded=False)],
            lambda: BT.fdct_quantize_plain(*fdct_inputs, gray=False,
                                           rounded=False),
            ("fdct_quantize_kernel",),
            _bound(fdct_bytes, fdct_ops, PEAK_FP32_FLOPS),
            f"{n_blocks} blocks from int8 planes, {fdct_bytes} bytes; "
            f"{fdct_ops} float32 operations in the kernel's separable form "
            f"({1e3 * fdct_ops / PEAK_FP32_FLOPS:.4f} ms; issued as "
            f"separate multiplies and adds "
            f"{1e3 * fdct_ops / PEAK_FP32_OPS:.4f} ms), {fdct_ops64} in "
            f"the 64-term form of the plain version and of the first kernel "
            f"({1e3 * fdct_ops64 / PEAK_FP32_FLOPS:.4f} ms); the plain stage "
            f"read {EARLIER_PROGRAMS['fDCT+quantize'][0]} ms busy (before "
            f"the kernel, kept from then); torch.matmul of the "
            f"[{n_blocks}, 64] @ [64, 64] float32 product alone "
            f"{_fmt_ms(library_ms)} ms"),
        "idct_planes": (
            [lambda: BT.idct_planes_sparse(sp_dev, **sp_kw)],
            lambda: BT.idct_planes_sparse_plain(sp_dev, **sp_kw),
            ("idct_planes_kernel",) + (("idct_planes_overflow_kernel",)
                                       if any(sp_kw["caps"]) else ()),
            _bound(idct_bytes, idct_ops, PEAK_FP32_FLOPS),
            f"sparse form (its sparse and overflow launches), the main "
            f"path's upload of {sp_flat.size} bytes (overflow rows a "
            f"component {YU.overflow_rows(sp_flat, sp_kw)}, caps "
            f"{list(sp_kw['caps'])}), {idct_bytes} bytes "
            f"with the planes; {real_nonzero} nonzero coefficients x 64 "
            f"multiply-adds = {idct_ops} float32 operations "
            f"({1e3 * idct_ops / PEAK_FP32_FLOPS:.4f} ms); the plain "
            f"program read {EARLIER_PROGRAMS['ycc420 decode'][0]} ms busy "
            f"(before the kernel, kept from then); torch.matmul of the "
            f"product alone "
            f"{_fmt_ms(library_ms)} ms"),
        "fdct_quantize_exact": (
            [lambda: BT.fdct_quantize_exact(*exact_fdct_input, gray=False,
                                            rounded=False)],
            lambda: BT.fdct_quantize_plain(*exact_fdct_input, gray=False,
                                           rounded=False,
                                           dtype=torch.float64),
            ("fdct_quantize_exact_kernel",),
            _bound(ex_fdct_bytes, ex_fdct_ops, PEAK_FP64_OPS),
            f"{n_blocks} blocks from int8 planes, {ex_fdct_bytes} bytes "
            f"({1e3 * ex_fdct_bytes / PEAK_BYTES_PER_S:.4f} ms); "
            f"{ex_fdct_ops} float64 operations that the oracle's roundings "
            f"need ({ex_fdct_ops / n_blocks:.2f} a block; 8144 for a block "
            f"with no zero sample, the kernel issues 8264, its first design "
            f"8896) at "
            f"{PEAK_FP64_OPS:.4g} separate DMUL/DADD a second; the rgb "
            f"exact encode program read "
            f"{EARLIER_EXACT['rgb exact encode'][0]} ms busy before the "
            f"kernel (kept from then); torch.matmul of the "
            f"[{n_blocks}, 64] @ [64, 64] float64 product alone (cuBLAS "
            f"DGEMM, not the same function: it reorders and contracts) "
            f"{_fmt_ms(library64_ms)} ms"),
        "idct_planes_exact": (
            [lambda: BT.idct_planes_exact(ex_coeff, **ex_kw)],
            lambda: BT.idct_planes_exact_plain(ex_coeff, **ex_kw),
            ("idct_planes_exact_kernel",),
            _bound(ex_idct_bytes, ex_idct_ops, PEAK_FP64_OPS),
            f"the main batch's rgb upload {tuple(ex_coeff.shape)} "
            f"{ex_coeff.dtype} into int32 planes, {ex_idct_bytes} bytes "
            f"({1e3 * ex_idct_bytes / PEAK_BYTES_PER_S:.4f} ms); "
            f"{ex_nonzero} nonzero coefficients of {ex_samples}: "
            f"{ex_idct_ops} float64 operations that the oracle's roundings "
            f"need ({ex_idct_ops / max(ex_nonzero, 1):.2f} a nonzero "
            f"coefficient) "
            f"({1e3 * ex_idct_ops / PEAK_FP64_OPS:.4f} ms); the exact decode "
            f"program read {EARLIER_EXACT['exact decode'][0]} ms busy before "
            f"the kernel (kept from then); torch.matmul of the "
            f"float64 product alone (DGEMM, not the same function) "
            f"{_fmt_ms(library64_ms)} ms"),
        "rgb_to_ycc420": (
            [lambda: OC.rgb_to_ycc420(rgb6)],
            lambda: OC.rgb_to_ycc420_plain(rgb6),
            ("rgb_to_ycc420_kernel",),
            _bound(col_enc_bytes, col_enc_ops, PEAK_FP32_OPS),
            f"float32, the main batch's {tuple(rgb6.shape)} uint8 samples "
            f"into int8 Y, Cb, Cr, {col_enc_bytes} bytes "
            f"({1e3 * col_enc_bytes / PEAK_BYTES_PER_S:.4f} ms); "
            f"{col_enc_ops} separate float32 operations "
            f"({1e3 * col_enc_ops / PEAK_FP32_OPS:.4f} ms); the rgb fast "
            f"encode program read {EARLIER_RGB['rgb encode, fast'][0]} ms "
            f"busy before the kernel (kept from then); no PyTorch call "
            f"computes it"),
        "idct_planes_rgb": (
            [lambda: BT.idct_planes_rgb(rgb_src, precision="fast",
                                        **rgb_kw)],
            lambda: BT.idct_planes_rgb_plain(rgb_src, dtype=torch.float32,
                                             **rgb_kw),
            ("idct_planes_rgb_kernel",),
            _bound(ir_bytes, ir_ops, PEAK_FP32_OPS),
            f"the main batch's rgb upload {tuple(rgb_src.shape)} "
            f"{rgb_src.dtype} into int32 planes, {ir_bytes} bytes "
            f"({1e3 * ir_bytes / PEAK_BYTES_PER_S:.4f} ms); {ir_nonzero} "
            f"nonzero coefficients: {ir_ops} separate float32 operations "
            f"that the roundings need "
            f"({1e3 * ir_ops / PEAK_FP32_OPS:.4f} ms; 128 a nonzero "
            f"coefficient, {128 * ir_nonzero}, "
            f"{128e3 * ir_nonzero / PEAK_FP32_OPS:.4f} ms); the rgb fast "
            f"decode program read {EARLIER_RGB['rgb decode, fast'][0]} ms "
            f"busy before the kernels (kept from then); torch.matmul of the "
            f"[{n_blocks}, 64] @ [64, 64] float32 product alone "
            f"{_fmt_ms(library_ms)} ms"),
        "ycc_planes_to_rgb": (
            [lambda: OC.planes_to_rgb(planes6, rgb_geom, False)],
            lambda: OC.planes_to_rgb_plain(planes6, rgb_geom, False),
            ("ycc_planes_to_rgb_kernel",),
            _bound(col_dec_bytes, col_dec_ops, PEAK_FP32_OPS),
            f"float32, the main batch's fast int32 planes at 4:2:0 into "
            f"[{BATCH}, {H}, {W}, 3] uint8, {col_dec_bytes} bytes "
            f"({1e3 * col_dec_bytes / PEAK_BYTES_PER_S:.4f} ms); "
            f"{col_dec_ops} separate float32 operations "
            f"({1e3 * col_dec_ops / PEAK_FP32_OPS:.4f} ms); no PyTorch "
            f"call computes it"),
    }

    # five times the card's 50 MB L2 cache
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    timing = {}
    for name, (calls, plain, syms, (b_ms, b_by), work) in kernels6.items():
        def run(calls=calls):
            for call in calls:
                call()

        t = {"event_ms": _time_ms(run, 20), "plain_ms": _time_ms(plain, 3)}
        t["ms"], prof = _traced(run, 20, *syms)  # the kernels' own time
        t["wrapper_busy_ms"] = prof["busy_ms"]
        # each of the batch's launches alone: repeated on the same buffers,
        # then with the L2 cache overwritten before each
        def alone(call, cold):
            def fn():
                if cold:
                    l2_flush.zero_()
                call()
            return fn

        for key, cold in (("launch_ms", False), ("cold_launch_ms", True)):
            t[key] = [_traced(alone(call, cold), 20, *syms)[0]
                      for call in calls]
        t["cold_ms"] = sum(t["cold_launch_ms"])
        t["bound_ms"], t["bound_by"] = b_ms, b_by
        t["sass_instructions"] = sass[name]
        t["sass_ms"] = (sass_ms(name, counts) if name in BLOCKS_PER_WARP
                        else None)
        t["library_ms"] = {"fdct_quantize": library_ms,
                           "idct_planes": library_ms,
                           "idct_planes_rgb": library_ms,
                           "fdct_quantize_exact": library64_ms,
                           "idct_planes_exact": library64_ms}.get(name)
        if name in EXACT_KERNELS:
            t["library_call"] = (f"torch.matmul, float64 [{n_blocks}, 64] "
                                 "@ [64, 64] (cuBLAS DGEMM): not the same "
                                 "function, it reorders and contracts")
        timing[name] = t
        _say("6 times", f"{name} per {BATCH}x{H}x{W} batch ({len(calls)} "
             f"call{'s' if len(calls) > 1 else ''}): kernel alone "
             f"{t['ms']:.4f} ms (profiler; each call alone "
             f"{' '.join(f'{x:.4f}' for x in t['launch_ms'])} ms), wrapper "
             f"device busy {_fmt_ms(t['wrapper_busy_ms'])} ms in "
             f"{prof['events']:.1f} device events, wrapper event span "
             f"{t['event_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by "
             f"{t['bound_by']} = {t['bound_ms'] / t['ms']:.3f} of the "
             f"kernel's time; with the L2 cache overwritten before each "
             f"call: kernel {t['cold_ms']:.4f} ms (each "
             f"{' '.join(f'{x:.4f}' for x in t['cold_launch_ms'])} ms), "
             f"bound = {t['bound_ms'] / t['cold_ms']:.3f} of it; "
             f"{t['sass_instructions']} SASS instructions"
             + ("" if t["sass_ms"] is None else
                f", all run once per thread would take {t['sass_ms']:.4f} ms")
             + f"; {work}; plain version event span {t['plain_ms']:.4f} ms; "
             f"on {card}")
    # the concat on dense blocks: noise at quality 100 in a budget that
    # holds it whole
    noise = np.random.default_rng(14).integers(0, 256, (BATCH, H, W, 3),
                                               dtype=np.uint8)
    nwc, nbc = TC._emit_local(*TC._quantize_batch_rgb(
        torch.from_numpy(noise).to(dev), quality=100))
    del noise
    n_bits = sum(b.to(torch.int64).sum(dim=1) for b in nbc)
    n_maxw = int(n_bits.max()) // 32 + 2
    n_used = sum(int(((b.to(torch.int64) + 31) // 32).clamp(max=64).sum())
                 for b in nbc)
    n_bytes = 4 * n_cblocks + 8 * n_used + 8 * BATCH * (1 + n_maxw)
    n_bound, n_by = _bound(n_bytes, CONCAT_OPS[0] * n_cblocks
                           + CONCAT_OPS[1] * n_used)
    dense_ms, _ = _traced(lambda: concat_cuda.concat_streams_cuda(
        nwc, nbc, maxw=n_maxw), 20, *kernels6["concat_streams"][2])
    dense_plain_ms = _time_ms(
        lambda: E.concat_streams_plain(nwc, nbc, 0, n_maxw), 3)
    prev_concat = ("concat_offsets_kernel", "concat_scatter_kernel")
    dense_prev_ms, _ = _traced(lambda: previous_designs.concat_two_pass(
        nwc, nbc, maxw=n_maxw), 20, *prev_concat)
    timing["concat_streams"]["dense_ms"] = dense_ms
    timing["concat_streams"]["previous_dense_ms"] = dense_prev_ms
    _say("6 times", f"concat_streams on dense blocks ({BATCH}x{H}x{W} noise "
         f"at quality 100, {n_used} used words in {n_cblocks} blocks, "
         f"budget {n_maxw} words): kernel {dense_ms:.4f} ms, bound "
         f"{n_bound:.4f} ms by {n_by} = {n_bound / dense_ms:.3f} of it; the "
         f"two-pass design in this run {dense_prev_ms:.4f} ms; plain version "
         f"event span {dense_plain_ms:.4f} ms; on {card}")
    del nwc, nbc
    # the entropy kernel and the concat beside the designs they replaced
    # (scripts/previous_designs.cu), in turns on the same inputs: the
    # kernels' own time, then with the L2 cache overwritten before each
    # call, and what the card reports for each
    cwc_r, cbc_r = concat_inputs_r
    vs = {
        "encode_blocks": (
            lambda r_i: lambda: pack_cuda.encode_blocks_batch_cuda(
                *real_comps, restart_interval=r_i),
            ("encode_blocks_batch_kernel",),
            lambda r_i: lambda: previous_designs.encode_stage(*real_comps,
                                                              r_i),
            ("encode_blocks_kernel",)),
        "concat_streams": (
            lambda r_i: lambda: concat_cuda.concat_streams_cuda(
                *((cwc, cbc) if r_i == 0 else (cwc_r, cbc_r)), maxw=cmaxw,
                restart_interval=r_i),
            ("concat_streams_kernel",),
            lambda r_i: lambda: previous_designs.concat_two_pass(
                *((cwc, cbc) if r_i == 0 else (cwc_r, cbc_r)), maxw=cmaxw,
                restart_interval=r_i),
            prev_concat)}
    infos = {**{f"now {k}": v for k, v in pack_cuda.kernel_info().items()},
             "now concat_streams": concat_cuda.kernel_info(),
             **{f"previous {k}": v
                for k, v in previous_designs.kernel_info().items()}}
    vs_rows = []
    for name, (now, now_syms, prev, prev_syms) in vs.items():
        row = {}
        for r_i in (0, RESTART_INTERVAL):
            for which, make, syms in (("now", now, now_syms),
                                      ("previous", prev, prev_syms),
                                      ("now again", now, now_syms),
                                      ("previous again", prev, prev_syms)):
                fn = make(r_i)
                warm = _traced(fn, 20, *syms)[0]
                cold = _traced(lambda: (l2_flush.zero_(), fn()), 20,
                               *syms)[0]
                row[f"{which}, restart_interval={r_i}"] = (warm, cold)
        timing[name]["previous_ms"] = row[
            "previous, restart_interval=0"][0]
        timing[name]["previous_cold_ms"] = row[
            "previous, restart_interval=0"][1]
        timing[name]["versus_previous"] = row
        vs_rows.append(f"{name}: " + "; ".join(
            f"{k} {w:.4f} ms (L2 overwritten first {c:.4f})"
            for k, (w, c) in row.items()))
    timing["encode_blocks"]["kernel_info"] = {
        k: v for k, v in infos.items() if "encode_blocks" in k}
    timing["concat_streams"]["kernel_info"] = {
        k: v for k, v in infos.items() if "concat_streams" in k}
    _say("6 versus", "the current kernels beside the designs they replaced "
         "(kernels' own device time, profiler; the earlier entropy design's "
         "plain predictor chains not counted here, see 5 stages): "
         + " || ".join(vs_rows) + "; what the card reports (registers a "
         "thread, thread blocks an SM, static shared bytes, local bytes, "
         "threads a block): " + ", ".join(f"{k} {v}" for k, v in
                                          infos.items()) + f"; on {card}")
    # the IDCT kernel's dense form on the restart path's 2,048 segments
    dn_ms, _ = _traced(lambda: BT.idct_planes_dense(*dn_src, **dn_kw), 20,
                       "idct_planes_kernel")
    dn_plain_ms = _time_ms(lambda: BT.idct_planes_dense_plain(*dn_src,
                                                              **dn_kw), 3)
    dn_bound, dn_by = _bound(dn_bytes, idct_ops, PEAK_FP32_FLOPS)
    dn_cold_ms, _ = _traced(lambda: (l2_flush.zero_(), BT.idct_planes_dense(
        *dn_src, **dn_kw)), 20, "idct_planes_kernel")
    timing["idct_planes"]["dense_form_ms"] = dn_ms
    timing["idct_planes"]["cold_dense_form_ms"] = dn_cold_ms
    _say("6 times", f"idct_planes, dense form, on the scan's blocks of the "
         f"restart path's {dn_src[0].shape[0]} segments ({dn_bytes} bytes: "
         f"the {dn_used} bytes of used blocks, flags, tables and planes): "
         f"kernel {dn_ms:.4f} ms (L2 overwritten first {dn_cold_ms:.4f}), "
         f"bound {dn_bound:.4f} ms by {dn_by} = {dn_bound / dn_ms:.3f} of "
         f"it; plain version event span {dn_plain_ms:.4f} ms; on {card}")
    # the block transforms with what the card reports for each
    # instantiation (cudaFuncGetAttributes,
    # cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    info = {**transform_cuda.kernel_info(), **exact_cuda.kernel_info(),
            **colour_cuda.kernel_info()}
    for name in ("fdct_quantize", "idct_planes", "fdct_quantize_exact",
                 "idct_planes_exact") + RGB_KERNELS:
        timing[name]["kernel_info"] = {
            k: v for k, v in info.items() if k.split()[0] == name}
    # exact mode's kernels and the fast rgb IDCT beside their first designs
    # (scripts/previous_designs.py), in turns on the same inputs (now,
    # first, now again, first again), warm and with the L2 cache overwritten
    # first: on the main batch and on noise at quality 100 (dense blocks,
    # where operations bound them), the rgb IDCT also on the main batch's
    # images at quality 95, each beside its bound
    nz_coeff, nz_kw = exact_idct_noise
    nzf_planes, nzf_q = exact_fdct_noise
    q95_coeff, q95_kw = rgb_idct_q95
    ak6 = (codec_constants(dev)["y_quant"], codec_constants(dev)["c_quant"])

    def first_idct(coeff, kw, first=previous_designs.idct_planes_exact_first):
        q = BT.quant_tables(kw["qtuple"], dev)
        return lambda: first(coeff, q, geom=kw["geom"], level=kw["level"],
                             gray=kw["gray"], sizes=kw["sizes"])

    def fast_idct(coeff, kw):
        return lambda: BT.idct_planes_rgb(coeff, precision="fast", **kw)

    def rgb_bound(coeff, kw):
        """The fast rgb IDCT's bound and its operation counts on coeff."""
        nbytes = (coeff.numel() * (coeff.element_size() + 4) + 4 * 64 * 64
                  + 3 * 4 * 64)
        ops = rgb_inv_ops(coeff, kw, exact_cuda.INV_BASIS)
        return _bound(nbytes, ops, PEAK_FP32_OPS), ops, 128 * int(
            (coeff != 0).sum())

    nz_samples = nz_coeff.numel()
    (ir_nz_bound, ir_nz_by), ir_nz_ops, ir_nz_128 = rgb_bound(nz_coeff,
                                                              nz_kw)
    (ir_q95_bound, ir_q95_by), ir_q95_ops, _ = rgb_bound(q95_coeff, q95_kw)
    first_rgb = previous_designs.idct_planes_rgb_first
    ex_sets = {
        "fdct_quantize_exact": (
            "fdct_quantize_exact_kernel", "fdct_exact_first_kernel", {
                "main": (
                    lambda: BT.fdct_quantize_exact(
                        *exact_fdct_input, gray=False, rounded=False),
                    lambda: previous_designs.fdct_quantize_exact_first(
                        *exact_fdct_input, *ak6),
                    timing["fdct_quantize_exact"]["bound_ms"]),
                "noise at quality 100": (
                    lambda: BT.fdct_quantize_exact(
                        *nzf_planes, gray=False, rounded=False,
                        qtables=nzf_q),
                    lambda: previous_designs.fdct_quantize_exact_first(
                        *nzf_planes, *nzf_q),
                    _bound(sum(p.numel() for p in nzf_planes)
                           + 4 * 64 * n_blocks, exact_fwd_ops(nzf_planes),
                           PEAK_FP64_OPS)[0])}),
        "idct_planes_exact": (
            "idct_planes_exact_kernel", "idct_exact_first_kernel", {
                "main": (lambda: BT.idct_planes_exact(ex_coeff, **ex_kw),
                         first_idct(ex_coeff, ex_kw),
                         timing["idct_planes_exact"]["bound_ms"]),
                "noise at quality 100": (
                    lambda: BT.idct_planes_exact(nz_coeff, **nz_kw),
                    first_idct(nz_coeff, nz_kw),
                    _bound(nz_coeff.numel() * nz_coeff.element_size()
                           + 4 * nz_samples, exact_inv_ops(nz_coeff, nz_kw),
                           PEAK_FP64_OPS)[0])}),
        "idct_planes_rgb": (
            "idct_planes_rgb_kernel", "idct_rgb_first_kernel", {
                "main": (fast_idct(rgb_src, rgb_kw),
                         first_idct(rgb_src, rgb_kw, first_rgb),
                         timing["idct_planes_rgb"]["bound_ms"]),
                "noise at quality 100": (
                    fast_idct(nz_coeff, nz_kw),
                    first_idct(nz_coeff, nz_kw, first_rgb), ir_nz_bound),
                "quality 95": (fast_idct(q95_coeff, q95_kw),
                               first_idct(q95_coeff, q95_kw, first_rgb),
                               ir_q95_bound)})}
    ex_rows = []
    for name, (sym, first_sym, sets) in ex_sets.items():
        t = timing[name]
        t["versus_previous"] = {}
        for set_name, (now, first, b_ms) in sets.items():
            row = {}
            for which, fn, k_sym in (("now", now, sym),
                                     ("first", first, first_sym),
                                     ("now again", now, sym),
                                     ("first again", first, first_sym)):
                warm = _traced(fn, 20, k_sym)[0]
                cold = _traced(lambda fn=fn: (l2_flush.zero_(), fn()), 20,
                               k_sym)[0]
                row[which] = (warm, cold)
            t["versus_previous"][set_name] = row
            best = min(row["now"][0], row["now again"][0])
            first_best = min(row["first"][0], row["first again"][0])
            if set_name == "main":
                t["previous_ms"], t["previous_cold_ms"] = row["first"]
            else:
                key = "noise" if set_name.startswith("noise") else "q95"
                t[f"{key}_ms"], t[f"{key}_cold_ms"] = row["now"]
                t[f"{key}_previous_ms"] = row["first"][0]
                t[f"{key}_bound_ms"] = b_ms
            ex_rows.append(
                f"{name} on {set_name}: " + ", ".join(
                    f"{k} {w:.4f} ms (L2 overwritten first {c:.4f})"
                    for k, (w, c) in row.items())
                + f"; bound {b_ms:.4f} ms = {b_ms / best:.3f} of the "
                f"faster turn (first design {b_ms / first_best:.3f}); "
                f"{'faster' if best < first_best else 'NOT faster'} than "
                f"the first design by {first_best - best:.4f} ms")
        kinfo = exact_cuda.kernel_info()
        pinfo = previous_designs.kernel_info()
        now_key = {"fdct_quantize_exact": "fdct_quantize_exact int8",
                   "idct_planes_exact": "idct_planes_exact int16",
                   "idct_planes_rgb": "idct_planes_rgb int16"}[name]
        first_key = now_key.replace(" int", " first int")
        prev_ops_k = prev_ops[f"previous {name}"]
        t["sass_ops"] = {"now": sass_ops[name], "first": prev_ops_k}
        ops_k = (("FMUL", "FADD", "FFMA") if name == "idct_planes_rgb"
                 else ("DMUL", "DADD", "DFMA"))
        ex_rows.append(
            f"{name} now: {kinfo[now_key][0]} registers, {kinfo[now_key][1]} "
            f"thread blocks of {kinfo[now_key][4]} an SM, SASS "
            + ", ".join(f"{sass_ops[name][op]} {op}" for op in ops_k)
            + f" (both instantiations); first design: {pinfo[first_key][0]} "
            f"registers, {pinfo[first_key][1]} thread blocks of "
            f"{pinfo[first_key][4]}, "
            + ", ".join(f"{prev_ops_k[op]} {op}" for op in ops_k))
    _say("6 exact", "exact mode's kernels and the fast rgb IDCT beside their "
         "first designs (kernels' own device time, profiler): "
         + " || ".join(ex_rows)
         + f"; plain versions {timing['fdct_quantize_exact']['plain_ms']:.4f}"
         f", {timing['idct_planes_exact']['plain_ms']:.4f} and "
         f"{timing['idct_planes_rgb']['plain_ms']:.4f} ms; "
         f"torch.matmul of the float64 [{n_blocks}, 64] @ [64, 64] product "
         f"(cuBLAS DGEMM on the FP64 tensor cores, which reorders and "
         f"contracts: out of reach of kernels that keep every rounding) "
         f"{_fmt_ms(library64_ms)} ms, of the float32 one "
         f"{_fmt_ms(library_ms)} ms; on {card}")
    # the float64 rate the card sustains as separate DMUL/DADD, at the
    # forward kernel's occupancy and at the full 64 warps, in each operand
    # form, with the SM clock; and the clock while the forward kernel runs
    fdct_sm = exact_cuda.kernel_info()["fdct_quantize_exact int8"][1]
    ceiling = {}
    for form, label in enumerate(fp64_ceiling.FORMS):
        for per_sm in sorted({fdct_sm, 8}):
            ceiling[f"{label}, {per_sm} thread blocks an SM"] = (
                fp64_ceiling.rate(per_sm, form))
    fdct_ms = timing["fdct_quantize_exact"]["ms"]

    def run_fdct(secs):
        for _ in range(int(secs / (1e-3 * fdct_ms))):
            BT.fdct_quantize_exact(*exact_fdct_input, gray=False,
                                   rounded=False)

    fdct_clock = fp64_ceiling.clock_while(run_fdct, 2.0)
    timing["fdct_quantize_exact"]["fp64_ceiling"] = {
        k: {"ops_per_s": r, "sm_clock": c} for k, (r, c) in ceiling.items()}
    timing["fdct_quantize_exact"]["sm_clock"] = fdct_clock
    # and the float32 rate of separate FMUL/FADD, the fast rgb IDCT's
    ceiling32 = {f"{label}, {per_sm} thread blocks an SM": fp64_ceiling.rate(
        per_sm, form, fp32=True)
        for form, label in enumerate(fp64_ceiling.FORMS32)
        for per_sm in (4, 8)}
    timing["idct_planes_rgb"]["fp32_ceiling"] = {
        k: {"ops_per_s": r, "sm_clock": c}
        for k, (r, c) in ceiling32.items()}
    _say("6 fp64", "the float64 chains of scripts/fp64_ceiling.cu (256 "
         "threads a block, 4 chains a thread): " + "; ".join(
             f"{k}: {r:.4g} a second = {r / PEAK_FP64_OPS:.3f} of the data "
             f"sheet's {PEAK_FP64_OPS:.4g}, SM clock {c}"
             for k, (r, c) in ceiling.items())
         + f"; SM clock while fdct_quantize_exact runs {fdct_clock}; the "
         f"exact kernels' bounds stay at the data sheet's rate; the float32 "
         f"chains as separate FMUL/FADD: " + "; ".join(
             f"{k}: {r:.4g} a second = {r / PEAK_FP32_OPS:.3f} of "
             f"{PEAK_FP32_OPS:.4g}, SM clock {c}"
             for k, (r, c) in ceiling32.items()) + f"; on {card}")
    # the fast rgb IDCT on dense blocks (noise at quality 100) beside the
    # float32 matmul and its first design, and on the quality-95 set; the
    # ycc420 IDCT (sparse form) on the same noise, for the record
    ir_t = timing["idct_planes_rgb"]
    ir_nz_ms = min(ir_t["versus_previous"]["noise at quality 100"][k][0]
                   for k in ("now", "now again"))
    ir_nz_first = min(ir_t["versus_previous"]["noise at quality 100"][k][0]
                      for k in ("first", "first again"))
    _say("6 times", f"idct_planes_rgb on {nz_coeff.shape[0]} noise images at "
         f"quality 100 ({int((nz_coeff != 0).sum())} nonzero of {nz_samples} "
         f"coefficients; {ir_nz_ops} separate float32 operations that the "
         f"roundings need, 128 a nonzero coefficient would be {ir_nz_128}, "
         f"{1e3 * ir_nz_128 / PEAK_FP32_OPS:.4f} ms): kernel "
         f"{ir_nz_ms:.4f} ms (the faster turn; L2 overwritten first "
         f"{ir_t['noise_cold_ms']:.4f}), bound {ir_nz_bound:.4f} ms by "
         f"{ir_nz_by} = {ir_nz_bound / ir_nz_ms:.3f} of it; torch.matmul of "
         f"the float32 [{n_blocks}, 64] @ [64, 64] product "
         f"{_fmt_ms(library_ms)} ms (the kernel "
         f"{'is faster' if library_ms and ir_nz_ms < library_ms else 'loses'}"
         f"); "
         f"the first design's faster turn {ir_nz_first:.4f} ms "
         f"({'under' if ir_nz_ms < ir_nz_first / 2 else 'NOT under'} half "
         f"of it); on the main batch's images at quality 95 "
         f"({int((q95_coeff != 0).sum())} nonzero coefficients, {ir_q95_ops} "
         f"operations): kernel {ir_t['q95_ms']:.4f} ms (L2 overwritten first "
         f"{ir_t['q95_cold_ms']:.4f}), first design "
         f"{ir_t['q95_previous_ms']:.4f}, bound {ir_q95_bound:.4f} ms by "
         f"{ir_q95_by}; on {card}")
    # the ycc420 IDCT (idct_planes, sparse form) beside the first design of
    # its overflow launch (previous_designs.idct_planes_overflow_first: the
    # same sparse launch, then the first overflow kernel), in turns (now,
    # first, now again, first again), warm and with the L2 cache
    # overwritten first, each launch's own time from the same trace: noise
    # at quality 100 through the ycc420 upload (nearly every block an
    # overflow row), the main batch and its images at quality 95
    _, q95_flat, q95_flat_kw = idct_q95_input
    yc_sets = {"noise at quality 100": (noise_flat, noise_flat_kw,
                                        noise_flat_ops),
               "main": (sp_flat, sp_kw, ir_ops),
               "quality 95": (q95_flat, q95_flat_kw, ir_q95_ops)}
    yc_sym = "idct_planes_overflow_kernel"
    yc_first_sym = "idct_overflow_first_kernel"
    yc_args = ("geom", "level", "shapes", "K", "N", "caps")

    def yc_read(fn, ovf_sym, has_ovf):
        """(both launches, the sparse launch, the overflow launch): device
        ms a call."""
        syms = ("idct_planes_kernel",) + ((ovf_sym,) if has_ovf else ())
        both, prof = _traced(fn, 20, *syms)
        ovf = _kernel_ms(prof, ovf_sym) if has_ovf else 0.0
        return both, both - ovf, ovf

    yc_t = timing["idct_planes"]
    yc_t["versus_previous"] = {}
    yc_rows = []
    for set_name, (flat6, kw6, ops6) in yc_sets.items():
        flat6_dev = torch.from_numpy(flat6).to(dev)
        q6 = BT.quant_tables(kw6["qtuple"], dev)
        now6 = (lambda flat6_dev=flat6_dev, kw6=kw6:
                BT.idct_planes_sparse(flat6_dev, **kw6))
        first6 = (lambda flat6_dev=flat6_dev, q6=q6, kw6=kw6:
                  previous_designs.idct_planes_overflow_first(
                      flat6_dev, q6, **{k: kw6[k] for k in yc_args}))
        has_ovf = any(kw6["caps"])
        ovf_rows6 = YU.overflow_rows(flat6, kw6)
        row = {}
        for which, fn, sym in (("now", now6, yc_sym),
                               ("first", first6, yc_first_sym),
                               ("now again", now6, yc_sym),
                               ("first again", first6, yc_first_sym)):
            warm = yc_read(fn, sym, has_ovf)
            cold = yc_read(lambda fn=fn: (l2_flush.zero_(), fn()), sym,
                           has_ovf)
            row[which] = dict(zip(
                ("ms", "sparse_ms", "overflow_ms", "cold_ms",
                 "cold_sparse_ms", "cold_overflow_ms"), warm + cold))
        b6, by6 = _bound(flat6.size + BATCH * H * W * 3 // 2 + 4 * 1024
                         + 3 * 4 * 64, ops6, PEAK_FP32_OPS)
        yc_t["versus_previous"][set_name] = dict(
            row, bound_ms=b6, bound_by=by6, overflow_rows=ovf_rows6,
            caps=list(kw6["caps"]))
        best = {k: min(row[w][k] for w in ("now", "now again"))
                for k in row["now"]}
        first_best = {k: min(row[w][k] for w in ("first", "first again"))
                      for k in row["now"]}
        if set_name == "main":
            yc_t["previous_ms"] = row["first"]["ms"]
            yc_t["previous_cold_ms"] = row["first"]["cold_ms"]
        else:
            key = "noise" if set_name.startswith("noise") else "q95"
            yc_t[f"{key}_ms"] = row["now"]["ms"]
            yc_t[f"{key}_cold_ms"] = row["now"]["cold_ms"]
            yc_t[f"{key}_previous_ms"] = row["first"]["ms"]
            yc_t[f"{key}_bound_ms"] = b6
            yc_t[f"{key}_overflow_ms"] = row["now"]["overflow_ms"]
            yc_t[f"{key}_overflow_previous_ms"] = row["first"]["overflow_ms"]
        if set_name.startswith("noise"):
            under = library_ms and best["overflow_ms"] < library_ms
            half = best["ms"] < first_best["ms"] / 2
            verdict = (f"overflow launch alone {best['overflow_ms']:.4f} ms, "
                       f"{'under' if under else 'NOT under'} torch.matmul's "
                       f"{_fmt_ms(library_ms)}; both launches "
                       f"{'under' if half else 'NOT under'} half of the "
                       f"first design's")
        else:
            warm_ok = best["ms"] <= first_best["ms"]
            cold_ok = best["cold_ms"] <= first_best["cold_ms"]
            verdict = (f"both launches "
                       f"{'no slower' if warm_ok else 'SLOWER'} than the "
                       f"first design warm, "
                       f"{'no slower' if cold_ok else 'SLOWER'} cold")
        yc_rows.append(
            f"{set_name} ({flat6.size} bytes, overflow rows a component "
            f"{ovf_rows6}, caps {list(kw6['caps'])}; {ops6} separate float32 "
            f"operations that the roundings need): " + "; ".join(
                f"{w} {r['ms']:.4f} ms = sparse {r['sparse_ms']:.4f} + "
                f"overflow {r['overflow_ms']:.4f} (L2 overwritten first "
                f"{r['cold_ms']:.4f} = {r['cold_sparse_ms']:.4f} + "
                f"{r['cold_overflow_ms']:.4f})" for w, r in row.items())
            + f"; bound {b6:.4f} ms by {by6} = {b6 / best['ms']:.3f} of the "
            f"faster turn (first design {b6 / first_best['ms']:.3f}); "
            + verdict)
        del flat6_dev
    # the overflow launch alone on tiles whose union holds n coefficients:
    # 16 images of 6,144 blocks of one component, every block an overflow
    # row, the 8 blocks of each tile nonzero on the same n seeded
    # coefficients; below kOvfDenseTerms the warps walk the union, from it
    # they take all 64 terms.  The walk's cost is fitted over n < 32 and
    # set against the branch-free run's mean: where the two lines cross
    sweep, rng6, nb6 = {}, np.random.default_rng(60), 6144
    tiles6 = BATCH * nb6 // 8
    for n_u in (8, 16, 24, 31, 32, 40, 48, 56, 64):
        keys6 = np.argsort(rng6.random((tiles6, 64)), axis=1)[:, :n_u]
        blocks6 = np.zeros((tiles6, 8, 64), np.int32)
        np.put_along_axis(
            blocks6, np.broadcast_to(keys6[:, None, :], (tiles6, 8, n_u)),
            rng6.integers(1, 200, (tiles6, 8, n_u))
            * rng6.choice([-1, 1], (tiles6, 8, n_u)), axis=2)
        flat6, kw6 = YU.sparse_upload([blocks6.reshape(BATCH, nb6, 64)],
                                      all_overflow=True, pad=0)
        kw6.update(geom=YU.geometry(64, 96, ((1, 1),)), level=128,
                   qtuple=(tuple([1] * 64),))
        flat6_dev = torch.from_numpy(flat6).to(dev)
        got6 = BT.idct_planes_sparse(flat6_dev, **kw6)
        want6 = BT.idct_planes_sparse_plain(flat6_dev, **kw6)
        if int((got6.to(torch.int32) - want6.to(torch.int32)).abs().max()) > 1:
            raise AssertionError(f"idct_planes differs from the plain "
                                 f"version by more than 1 on tiles of "
                                 f"union {n_u}")
        sweep[n_u], _ = _traced(
            lambda flat6_dev=flat6_dev, kw6=kw6: BT.idct_planes_sparse(
                flat6_dev, **kw6), 20, yc_sym)
        del flat6, flat6_dev, blocks6, got6, want6
    walk = [n for n in sweep if n < 32]
    slope, icept = np.polyfit(walk, [sweep[n] for n in walk], 1)
    straight = float(np.mean([sweep[n] for n in sweep if n >= 32]))
    cross = (straight - icept) / slope if slope > 0 else float("nan")
    yc_t["union_sweep_ms"] = {str(n): ms for n, ms in sweep.items()}
    yc_t["union_sweep_cross"] = cross
    kinfo6 = transform_cuda.kernel_info()["idct_planes overflow"]
    pinfo6 = previous_designs.kernel_info()["idct_planes overflow first"]
    prev_ovf_ops = prev_ops["previous idct_planes overflow"]
    yc_t["sass_ops"] = {"three kernels now": sass_ops["idct_planes"],
                        "overflow now": ovf_ops["overflow"],
                        "overflow first": prev_ovf_ops}
    _say("6 ycc idct", "idct_planes (sparse form) beside the first design of "
         "its overflow launch, in turns (kernels' own device time, "
         "profiler): " + " || ".join(yc_rows)
         + f" || the overflow launch alone on {tiles6} tiles of 8 rows "
         f"whose union holds n coefficients: " + ", ".join(
             f"n = {n} {ms:.4f} ms" for n, ms in sweep.items())
         + f"; the union walk {icept:.4f} + {slope:.6f} n ms (n < 32), the "
         f"branch-free run {straight:.4f} ms (n >= 32): they cross at n = "
         f"{cross:.1f} || overflow launch now: {kinfo6[0]} registers, "
         f"{kinfo6[1]} thread blocks of {kinfo6[4]} an SM, {kinfo6[2]} "
         f"bytes of shared memory, SASS {ovf_sass['overflow']} "
         f"instructions, " + ", ".join(f"{ovf_ops['overflow'][op]} {op}"
                                       for op in ("FMUL", "FADD", "FFMA"))
         + f"; first design: {pinfo6[0]} registers, {pinfo6[1]} thread "
         f"blocks of {pinfo6[4]}, {pinfo6[2]} bytes of shared memory, "
         + ", ".join(f"{prev_ovf_ops[op]} {op}"
                     for op in ("FMUL", "FADD", "FFMA"))
         + f"; the three idct_planes kernels: " + ", ".join(
             f"{sass_ops['idct_planes'][op]} {op}"
             for op in ("FMUL", "FADD", "FFMA"))
         + f"; torch.matmul of the float32 [{n_blocks}, 64] @ [64, 64] "
         f"product {_fmt_ms(library_ms)} ms; on {card}")
    rows6 = []
    for label, ms, cold, b_ms, key in (
            ("fdct_quantize", timing["fdct_quantize"]["ms"],
             timing["fdct_quantize"]["cold_ms"],
             timing["fdct_quantize"]["bound_ms"], "fdct_quantize int8"),
            ("idct_planes sparse", timing["idct_planes"]["ms"],
             timing["idct_planes"]["cold_ms"],
             timing["idct_planes"]["bound_ms"], "idct_planes sparse"),
            ("idct_planes dense", dn_ms, dn_cold_ms, dn_bound,
             "idct_planes dense"),
            ("fdct_quantize_exact", timing["fdct_quantize_exact"]["ms"],
             timing["fdct_quantize_exact"]["cold_ms"],
             timing["fdct_quantize_exact"]["bound_ms"],
             "fdct_quantize_exact int8"),
            ("idct_planes_exact", timing["idct_planes_exact"]["ms"],
             timing["idct_planes_exact"]["cold_ms"],
             timing["idct_planes_exact"]["bound_ms"],
             "idct_planes_exact int16")):
        regs, per_sm, smem, local, threads = info[key]
        rows6.append(
            f"{label}: {ms:.4f} ms (L2 overwritten first {cold:.4f}), bound "
            f"{b_ms:.4f} ms = {b_ms / ms:.3f} of it, {regs} registers a "
            f"thread, {per_sm} thread blocks of {threads} threads an SM "
            f"({per_sm * threads // 32} warps), {smem} bytes of shared and "
            f"{local} of local memory a thread block / thread")
    others = ", ".join(f"{k} {v[0]} registers, {v[1]} thread blocks an SM"
                       for k, v in info.items()
                       if k in ("fdct_quantize int32", "idct_planes overflow",
                                "fdct_quantize_exact int32",
                                "idct_planes_exact int32"))
    _say("6 transforms", "; ".join(rows6) + f"; {others}; torch.matmul "
         f"of the [{n_blocks}, 64] @ [64, 64] float32 product alone "
         f"{_fmt_ms(library_ms)} ms, float64 (DGEMM, not the same function "
         f"as the exact kernels) {_fmt_ms(library64_ms)} ms; on {card}")
    # the colour kernels' other forms: float64 (exact mode) and gray, warm
    # and with the L2 cache overwritten first, beside their bounds (the
    # same bytes; float64 operations at the separate DMUL/DADD rate)
    gray_bytes = 4 * planes6[0].numel() + n_px
    extra6 = (
        ("rgb_to_ycc420", "exact",
         lambda: OC.rgb_to_ycc420(rgb6, torch.float64),
         _bound(col_enc_bytes, col_enc_ops, PEAK_FP64_OPS)),
        ("ycc_planes_to_rgb", "exact",
         lambda: OC.planes_to_rgb(planes6, rgb_geom, False, torch.float64),
         _bound(col_dec_bytes, col_dec_ops, PEAK_FP64_OPS)),
        ("ycc_planes_to_rgb", "gray",
         lambda: OC.planes_to_rgb(planes6[:1], rgb_geom, True),
         _bound(gray_bytes, 0)))
    rows6c = []
    for name, form, fn, (b_ms, b_by) in extra6:
        sym = f"{name}_kernel"
        warm, _ = _traced(fn, 20, sym)
        cold, _ = _traced(lambda fn=fn: (l2_flush.zero_(), fn()), 20, sym)
        timing[name][f"{form}_ms"] = warm
        timing[name][f"{form}_cold_ms"] = cold
        timing[name][f"{form}_bound_ms"] = b_ms
        rows6c.append(f"{name} {form}: {warm:.4f} ms (L2 overwritten first "
                      f"{cold:.4f}), bound {b_ms:.4f} ms by {b_by} = "
                      f"{b_ms / warm:.3f} of it")
    _say("6 colour", "; ".join(rows6c) + "; " + "; ".join(
        f"{name}: {timing[name]['ms']:.4f} ms (L2 overwritten first "
        f"{timing[name]['cold_ms']:.4f}), bound "
        f"{timing[name]['bound_ms']:.4f} ms = "
        f"{timing[name]['bound_ms'] / timing[name]['ms']:.3f} of it"
        for name in RGB_KERNELS) + "; what the card reports (registers a "
        "thread, thread blocks an SM, static shared bytes, local bytes, "
        "threads a block): " + ", ".join(
            f"{k} {v}" for k, v in info.items()
            if k.split()[0] in RGB_KERNELS) + f"; on {card}")
    del sp_dev, dn_src, lib_x, lib_x64, nz_coeff, ex_coeff, rgb6, planes6
    del noise_flat, q95_coeff
    # the fused kernel on four batches in one launch
    comps4 = tuple(torch.cat([c] * 4) for c in real_comps)
    big_ms, _ = _traced(lambda: pack_cuda.encode_blocks_batch_cuda(*comps4),
                        20, "encode_blocks_batch_kernel")
    big_bound, big_by = bound("encode_blocks", 4 * sum(counts),
                              4 * sum(n_emitted))
    _say("6 times", f"encode_blocks on {4 * BATCH} images "
         f"({4 * sum(counts)} blocks) in one launch: kernel {big_ms:.4f} ms, "
         f"bound {big_bound:.4f} ms by {big_by} = {big_bound / big_ms:.3f} "
         f"of it")
    # the fused kernel with the batch's 16 per-image table sets (optimize)
    def run_sets(cold=False):
        if cold:
            l2_flush.zero_()
        pack_cuda.encode_blocks_batch_cuda(*real_comps, tables=set_rows)

    sets_ms, _ = _traced(run_sets, 20, "encode_blocks_batch_kernel")
    sets_cold_ms, _ = _traced(lambda: run_sets(True), 20,
                              "encode_blocks_batch_kernel")
    fixed_ms, _ = _traced(kernels6["encode_blocks"][0][0], 20,
                          "encode_blocks_batch_kernel")
    timing["encode_blocks"]["ms_per_image_tables"] = sets_ms
    timing["encode_blocks"]["cold_ms_per_image_tables"] = sets_cold_ms
    _say("6 times", f"encode_blocks per {BATCH}x{H}x{W} batch with "
         f"{BATCH} per-image table sets (optimize): kernel {sets_ms:.4f} ms "
         f"(L2 overwritten first {sets_cold_ms:.4f}) beside "
         f"{fixed_ms:.4f} ms with the fixed tables in the same run; bound "
         f"{timing['encode_blocks']['bound_ms']:.4f} ms")
    del real_inputs, comps4, real_comps, set_rows, concat_inputs
    del concat_inputs_r, comps, fdct_inputs

    # ---- 9. the scan kernel alone on the real segments of phase 7
    S, Lw = real_args["words"].shape
    mb = real_args["max_blocks"]
    nsym, per_lane = _count_symbols(E, real_blocks, real_args["nblk"])
    scan_bytes = (4 * S * Lw + 3 * 4 * S + 4 * real_args["lut"].numel()
                  + 2 * 64 * mb * S + S)

    def run_scan(args=real_args):
        scan_cuda.decode_segments_cuda(**args)

    def run_scan_cold():
        l2_flush.zero_()
        run_scan()

    t = {"event_ms": _time_ms(run_scan, 20), "plain_ms": scan_plain_ms}
    t["ms"], prof = _traced(run_scan, 20, "decode_segments_kernel")
    t["wrapper_busy_ms"] = prof["busy_ms"]
    t["cold_ms"], _ = _traced(run_scan_cold, 20, "decode_segments_kernel")
    t["bound_ms"], t["bound_by"] = _bound(scan_bytes,
                                          MIN_OPS_PER_SYMBOL * nsym)
    t["sass_ms"], t["sass_instructions"] = None, sass["decode_segments"]
    t["launch_ms"], t["cold_launch_ms"] = [t["ms"]], [t["cold_ms"]]
    # four times the segments in one launch: does the card have room left?
    wide = {k: (torch.cat([v] * 4) if k in (
        "words", "nblk", "tsel", "rawlen") else v)
        for k, v in real_args.items()}
    wide_ms, _ = _traced(lambda: run_scan(wide), 10, "decode_segments_kernel")
    # every segment given the slowest one's row
    slow = int(per_lane.argmax())
    same = {k: (v[slow:slow + 1].expand(S, *v.shape[1:]).contiguous()
                if k in ("words", "nblk", "tsel", "rawlen") else v)
            for k, v in real_args.items()}
    same_ms, _ = _traced(lambda: run_scan(same), 10, "decode_segments_kernel")
    # how the launch lies on the card, and what its first-level table does
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = -(-S // layout["warps_per_block"])
    warps_per_sm = layout["warps_per_block"] * min(
        layout["blocks_per_sm"], -(-ctas // sms))
    hit, seen = _first_level_share(E, real_blocks, real_args["nblk"],
                                   real_args["lut"][0].cpu().numpy(),
                                   layout["first_level_bits"])
    if seen != nsym:
        raise AssertionError(f"{seen} symbols by table row, {nsym} by block")
    timing["decode_segments"] = t
    _say("9 times", f"decode_segments per {BATCH}x{H}x{W} batch with "
         f"restart_interval={RESTART_INTERVAL} (1 launch, {S} segments x "
         f"{mb} block slots, rows of {Lw} words; one warp a segment, {ctas} "
         f"thread blocks of {layout['warps_per_block']} warps on {sms} SMs, "
         f"{warps_per_sm} warps on an SM of the "
         f"{layout['warps_per_block'] * layout['blocks_per_sm']} it could "
         f"hold): kernel alone {t['ms']:.4f} ms (profiler), wrapper device "
         f"busy {_fmt_ms(t['wrapper_busy_ms'])} ms (the blocks are not "
         f"cleared first), wrapper event span {t['event_ms']:.4f} ms; the "
         f"one-thread-per-segment kernel it replaced read "
         f"{EARLIER_SCAN_MS} ms on these segments (NVIDIA H100 80GB HBM3, "
         f"700 W; kept from then, not measured here); bound "
         f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({scan_bytes} bytes: "
         f"rows {4 * S * Lw}, per-lane arguments {12 * S}, LUT "
         f"{4 * real_args['lut'].numel()}, blocks {128 * mb * S}, flags "
         f"{S}; {nsym} symbols x {MIN_OPS_PER_SYMBOL} operations) = "
         f"{t['bound_ms'] / t['ms']:.4f} of the kernel's time; with the L2 "
         f"cache overwritten before each launch: kernel {t['cold_ms']:.4f} "
         f"ms; {4 * S} segments in one launch: {wide_ms:.4f} ms "
         f"({wide_ms / t['ms']:.2f} x the time for 4 x the work); all {S} "
         f"segments on the slowest one's row ({int(per_lane.max())} "
         f"symbols): {same_ms:.4f} ms = "
         f"{1e6 * same_ms / int(per_lane.max()):.1f} ns per symbol; symbols "
         f"per segment: mean {float(per_lane.float().mean()):.1f}, max "
         f"{int(per_lane.max())}: "
         f"{1e6 * t['ms'] / int(per_lane.max()):.1f} ns per symbol of the "
         f"slowest segment; the first-level table of "
         f"{layout['first_level_bits']} index bits answers {hit} of {seen} "
         f"symbols ({hit / seen:.4f}); plain version {t['plain_ms']:.1f} ms (one call, all {S} "
         f"segments, host clock with a synchronise); on {card}")
    del real_args, real_blocks, wide, same, l2_flush

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jpezy_tpu"))
    if leaked:
        raise AssertionError(f"imported {leaked[:5]}")
    # pack_words is off every path: its count is phase 3's, over the real
    # blocks; encode_blocks' and concat_streams' are the main path's;
    # decode_segments' is the restart path's; symbol_histograms' is the
    # optimize path's; the exact kernels' are phase 15's exact encode
    # (ycc420) and exact decode paths'; the rgb transport's kernels' are
    # phase 16's fast rgb encode and decode paths'.
    # launches_by_path holds every path's own counts (phase 12's sharded
    # paths too), each read just after that path's run.
    launches = {"pack_words": pack_alone_launches,
                "encode_blocks": main_launches["encode_blocks"],
                "decode_segments": restart_launches["decode_segments"],
                "symbol_histograms": optimize_launches["symbol_histograms"],
                "concat_streams": main_launches["concat_streams"],
                "fdct_quantize": main_launches["fdct_quantize"],
                "idct_planes": main_launches["idct_planes"],
                "fdct_quantize_exact":
                    exact_launches["exact_encode"]["fdct_quantize_exact"],
                "idct_planes_exact":
                    exact_launches["exact_decode"]["idct_planes_exact"],
                "rgb_to_ycc420":
                    rgb_launches16["rgb_encode"]["rgb_to_ycc420"],
                "idct_planes_rgb":
                    rgb_launches16["rgb_decode"]["idct_planes_rgb"],
                "ycc_planes_to_rgb":
                    rgb_launches16["rgb_decode"]["ycc_planes_to_rgb"]}
    by_path = {name: {"main": main_launches[name],
                      "restart_device": restart_launches[name],
                      "decode_indexed": indexed_launches[name],
                      "optimize": optimize_launches[name],
                      **{path: counts[name]
                         for path, counts in sharded_launches.items()},
                      **{path: counts[name]
                         for path, counts in exact_launches.items()},
                      **{path: counts[name]
                         for path, counts in rgb_launches16.items()}}
               for name in launches}
    per_batch = {name: {path: n / MAIN_BATCHES for path, n in paths.items()}
                 for name, paths in by_path.items()}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": err[name],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
        "launches_by_path": by_path[name],
        "launches_per_batch": per_batch[name],
        "launch_ms": t["launch_ms"], "cold_ms": t["cold_ms"],
        "cold_launch_ms": t["cold_launch_ms"],
        "event_ms": t["event_ms"], "wrapper_busy_ms": t["wrapper_busy_ms"],
        "sass_instructions": t["sass_instructions"], "sass_ms": t["sass_ms"],
        **{k: t[k] for k in ("ms_per_image_tables",
                             "cold_ms_per_image_tables", "dense_ms",
                             "library_call", "noise_ms", "noise_bound_ms",
                             "dense_form_ms", "cold_dense_form_ms",
                             "kernel_info", "previous_ms",
                             "previous_cold_ms", "previous_dense_ms",
                             "versus_previous", "noise_cold_ms",
                             "noise_previous_ms", "sass_ops", "fp64_ceiling",
                             "fp32_ceiling",
                             "sm_clock", "exact_ms", "exact_cold_ms",
                             "exact_bound_ms", "gray_ms", "gray_cold_ms",
                             "gray_bound_ms", "q95_ms", "q95_cold_ms",
                             "q95_previous_ms", "q95_bound_ms",
                             "noise_overflow_ms",
                             "noise_overflow_previous_ms",
                             "q95_overflow_ms", "q95_overflow_previous_ms",
                             "union_sweep_ms", "union_sweep_cross")
           if k in t},
    } for name, t in timing.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _unpack_streams(res: dict, name: str) -> list[bytes]:
    data = res["streams_" + name].tobytes()
    offs = np.concatenate([[0], np.cumsum(res["lens_" + name])])
    return [data[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _spawn_ranks(world: int, data: int) -> list[dict]:
    """Phase 12's gloo ranks: `world` processes of this script (its rank
    mode), a data x (world/data) mesh over one card.  Returns each rank's
    results; a rank that fails or outlives RANK_TIMEOUT_S fails the run,
    and every rank is stopped before this returns."""
    out_dir = os.path.join(REPO, "build", "smoke_parallel")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"store{world}")
    outs = [os.path.join(out_dir, f"rank{r}of{world}.npz")
            for r in range(world)]
    for f in [store] + outs:
        if os.path.exists(f):
            os.remove(f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(world), str(data), store, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"rank {r}: OK" not in log:
            raise AssertionError(f"rank {r} of {world} failed "
                                 f"({p.returncode}):\n{log[-4000:]}")
    return [dict(np.load(f)) for f in outs]


def rank_main(argv: list[str]) -> int:
    """One gloo rank of phase 12 (`chip_smoke.py --rank R WORLD DATA STORE
    OUT`): the mesh over the world's ranks, all on the one card; this
    rank's data row of the PARALLEL_IMAGES images through encode_sharded
    (exact with restart markers, exact optimize, fast with restart
    markers) and decode_sharded (the device decode of the fast streams,
    and of the same streams with image 1's first segment zeroed); the
    results and each step's kernel launches to OUT (.npz)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    rank, world, data = (int(a) for a in argv[:3])
    store, out = argv[3], argv[4]
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import torch.distributed as dist
    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.parallel import decode_sharded, encode_sharded
    from jpezy_tpu_torch.parallel.distributed import (initialize,
                                                      make_global_mesh)

    initialize(f"file://{store}", world, rank, backend="gloo")
    mesh = make_global_mesh(data, device="cuda")
    n_loc = PARALLEL_IMAGES // data
    d = mesh.data_index
    local = _images(PARALLEL_IMAGES, 1000)[d * n_loc:(d + 1) * n_loc]
    ri = RESTART_INTERVAL
    res = {"rank": rank, "data_index": d}
    step_s = []

    def step(name, fn):
        reset_counts()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            res["counts_" + name] = np.array(
                [read_counts()[k] for k in KERNELS])

    def keep(name, streams):
        res["streams_" + name] = np.frombuffer(b"".join(streams), np.uint8)
        res["lens_" + name] = np.array([len(s) for s in streams])
        return streams

    keep("exact_restart", step("exact_restart", lambda: encode_sharded(
        mesh, local, precision="exact", restart_interval=ri)))
    keep("exact_optimize", step("exact_optimize", lambda: encode_sharded(
        mesh, local, precision="exact", optimize=True, restart_interval=ri)))
    fast = keep("fast_restart", step("fast_restart", lambda: encode_sharded(
        mesh, local, restart_interval=ri)))
    res["px_device"] = step("device_decode",
                            lambda: decode_sharded(mesh, fast))
    broken = list(fast)
    if d == 0:  # image 1's first segment: data row 0, tile shard 0
        b = bytearray(broken[1])
        es = parse(broken[1]).entropy_start
        b[es:es + 8] = bytes(8)
        broken[1] = bytes(b)
    try:
        step("corrupt_decode", lambda: decode_sharded(mesh, broken))
        res["corrupt_error"] = ""
    except ValueError as exc:
        res["corrupt_error"] = str(exc)
    res["step_s"] = np.array(step_s)
    res["leaked"] = " ".join(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "jpezy_tpu")))
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
