#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py                    # all phases, as a user would run it
    python3 chip_smoke.py --out DIR          # also write the compiler log and
                                             # the log lines there
    python3 chip_smoke.py --out DIR --profile   # and device-time profiles

Phases, in order; any failure exits non-zero and prints no result line:

1. device: require CUDA; print ``nvidia-smi`` name and power limit.
2. build: compile ``magvit2_pytorch_tpu_torch/csrc`` with nvcc for sm_90a,
   one nvcc per source, all started together.
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (README config, batch 8): float32 with TF32 off, and
   bfloat16 against the plain version computed in float32 on the same
   inputs; median times over 20 runs with CUDA events, the least time the
   card could take for the same work (bound), and one PyTorch library call
   for the same step where there is one. The attention blocks (B1-B3) are
   held relative to the largest value of the reference. B1 also runs at
   ragged and causal shapes (L in 1, 17, 100, 256, 1024; rows not a
   multiple of 64), with its launches timed one by one at the flagship
   shape (norm, qkv GEMM, core, out GEMM) against the whole block as a
   sequence of PyTorch calls and its core against SDPA. B2 at (8, 5, 256,
   512) bf16 causal on its 'fused' route (one launch of
   ``csrc/time_attention.cu``) against its plain version, timed as event
   pairs and by the profiler's kernel events beside its bound, the plain
   version, the whole block as PyTorch calls, SDPA alone and the four
   launches it replaces; float32 on its 'launches' route; a batch boundary
   that must read exactly 0; the kernel's registers, spills and shared
   memory from ptxas and from the runtime, its launcher's plan (the weight
   ring's depth) and the route rule held against what the launcher takes;
   at ``TIME_CASES`` (T = 1, 2, 9, 16 at S = 100, not causal; C = 256) in
   both dtypes with each route counted, and in bf16 at a shape the fused
   route refuses (C = 1024) on its four launches. B3 likewise at
   (160, 1024, 256), 16 heads x 8: its launches timed one by one (norm,
   qkv GEMM with q scaled and cast in its epilogue, the tensor-core moment
   core, out GEMM) beside their bounds and ``F.rms_norm`` / ``F.linear``,
   the core against its plain version in float32 and in bf16 on the same
   qkv with its TFLOP/s and GB/s; then B3 at N = 1, 144, 1000 and 4096 in
   both dtypes (the float32 route) with its launches counted, a batch of
   two against its second frame alone (exactly 0), and
   ``TaylorSeriesLinearAttn(dim_head=16)`` (the gate's plain version) on
   the card against the CPU. The projection
   GEMM runs at every main-path shape on both bf16 routes (``wgmma``,
   WMMA) against ``torch.matmul`` in float32 and ``F.linear``, and at
   ragged shapes, with the epilogue's scaled columns where B3 uses them.
   The fused ResidualUnit (B4) runs
   at every RU stage shape of the flagship and B5 at the packed stem shape,
   with live SqueezeExcite gates, plus a batch-boundary case. B4's five
   launches (conv, 1x1, SE logits, SE reduction, gate + residual) run one by
   one at (8, 20, 16, 16, 512), each against its plain version (relative,
   the gates by their deviations, with planted faults that must fail) and
   beside its bound and one PyTorch call where there is one; the conv
   launch runs at every stage shape on its TMA +
   ``wgmma`` route (TFLOP/s of real taps, beside the WMMA route and
   ``F.conv3d``); and B4 runs at T = 1, 2, 3 (the causal skip), H = W = 12
   (ragged boxes, at C = 128 and 64) and C = 96 (the WMMA route) with its
   conv route counted. Every number is per launch at one shape; B4's
   kernels row is its (8, 20, 16, 16, 512) stage and lists every stage
   under ``stages``, the conv's row likewise.
   Then, outside ``inference_mode`` because they need autograd, the three
   flash-attention kernels (forward, dQ, dK/dV): ragged and small with
   every option ((2, 2, 130, d) / 134 keys, d in 16, 32, 64, causal and
   not, no bias and each bias shape; output, lse and all four gradients),
   the ``'auto'`` gate's edge ((2, 8, 1024, 32) / 1028 keys, causal), the
   causal tile skip's edges (memory keys over more than a tile, fewer
   queries than a tile), each case's three kernels counted once each on
   its route (``'mma'`` bf16, ``'f32'`` float32), and full width
   ((17, 8, 4096, 32) / 4100 keys, float32 and bf16, and causal in bf16)
   with times, bounds and ``F.scaled_dot_product_attention`` forward and
   backward (and ``is_causal``) as the library call; the plain version runs
   there in chunks of frames (its float32 logits would take 9.1 GB at
   once). Every output and gradient is held relative to the largest value
   of its reference. The three ``'mma'`` kernels: registers, spills (a
   spill fails) and shared memory as the CUDA runtime reports them after
   the launches, with ptxas's lines; two calls bit-identical and a batch of
   two against its second element alone exactly 0 (out, lse, dq, dk, dv,
   dS); a causal timing row beside its bound over the visible pairs, and
   the forward's exp floor (one ``ex2`` a visible pair at 16 a clock an
   SM, at the card's largest SM clock).
4. default flagship roundtrip, bfloat16, batch 8, seeded random weights,
   through ``VideoTokenizer.tokenize`` then ``decode_from_code_indices``:
   shapes, finite output, and launches per roundtrip: 2 of each attention
   block, 2 of B2 on its 'fused' route (0 on 'launches'), 8 ``wgmma``
   GEMMs (B1's and B3's), 0 WMMA ones, 2 of B1's tensor-core core, 2 of
   B3's (``taylor_core_mma``; 0 ``taylor_core_f32``), 0 of B4, B5 and the
   flash kernels, and no ResidualUnit kernel call by shape;
   then frames/sec by the slope of chained runs (as ``bench.py``); then the
   same tokenizer and input in bf16 with the blocks and with
   ``MAGVIT2_TPU_NO_FUSED_ATTN=1`` (the general plain attention path):
   latents, code bits and the reconstruction from the same codes.
5. fused flagship roundtrip: the same with ``lane_pack=True`` and
   ``MAGVIT2_TPU_FUSED_RU_WIDE_DIMS=64,128,256,512`` (set only inside the
   phase): 2 launches of each attention kernel, 20 of B4, 2 of B5, 22
   convs and 22 1x1s on the ``wgmma`` route (0 on the others; the default
   path and the attention step launch none), with
   B4's calls by input shape as ``RU_STAGES`` says; a second, warm
   roundtrip times every B4 and B5 call with CUDA events
   (``fused_roundtrip_ms``); then frames/sec.
6. float32 at batch 1, TF32 off, live SqueezeExcite gates: both card paths
   (default and fused) against one CPU reference with the same weights:
   code bits may flip only where the CPU's decision margin |z| <= 5e-3 and
   for <= 1% of bits; decoding the same codes must agree within 1e-3; the
   fused path's convs all take the float32 route and both paths' time
   blocks the 'launches' route. Then a small tokenizer
   with ``linear_attn_dim_head=16`` (32 px, 5 frames) through the same
   entry points: bf16 on the card, and float32 card against CPU (codes,
   and the recon from the CPU's codes within 1e-3), no Taylor launch.
7. the general ``Attention`` path with the flash backend, forward and
   backward: one step of ``SpaceAttention(512, dim_head=32, heads=8,
   backend='flash')`` on (1, 17, 64, 64, 512) bf16 (4096 tokens a frame,
   4100 keys with the memory KV): exactly 1 launch of each flash kernel
   (each on the ``'mma'`` route) and 0 of every other; output
   and the five gradients against the same module
   with ``backend='plain'`` on the card; step times of both backends; then
   float32, TF32 off, 2 frames, against the CPU. Smaller checks: what
   ``'auto'`` picks on the card at n = 1024 and n = 256, flash against plain
   ``attend`` on both sides of that threshold, a causal ``TimeAttention``
   through flash, and a rotary and a ``dim_head=16`` module against the CPU.
8. the JAX package's other configurations (``configs.py``, BASELINE configs
   1, 3 and 4). Config 4, the 256 px image tokenizer with 2^18 LFQ codes,
   at full width, bf16, batch 8 of images through ``tokenize`` and
   ``decode_from_code_indices`` on both paths, with the launches of one
   roundtrip (B1 2 over 1024 tokens at C = 512, B3 2 over 4096 at C = 512,
   8 ``wgmma`` GEMMs, no time block, no flash; B4 14 on the fused path,
   ``MAGVIT2_TPU_FUSED_RU_WIDE_DIMS=128,256,512`` set inside it, 0 on the
   default one, B5 never) and B4's calls by shape; images/s on each path;
   its profile with ``--profile`` (``profile_config4*.txt``); a checkpoint
   round trip on the card (``save`` to a temporary file,
   ``VideoTokenizer.init_and_load_from`` in bf16: weights, codes and
   reconstruction bit-identical); float32 batch 1, TF32 off, live
   SqueezeExcite gates, card against CPU on both paths: a code bit may flip
   only where the CPU's |z| <= 5e-3, in at most 1% of bits, and the
   reconstruction from the CPU's codes agrees within 1e-3. B1 at
   (8, 1024, 512), B3 at (8, 4096, 512) and B4 at (8, 1, 256, 256, 128) and
   (8, 1, 32, 32, 512) run in phase 3 as its other cases do (rows
   ``config4_shapes``). Config 3 (FSQ, levels 8 8 8 5 5 5) at the README
   width: a bf16 batch-8 roundtrip with phase 4's launches, frames/s, and
   float32 card against CPU, where a level may differ only where the CPU's
   bounded value lies within 5e-3 of a rounding boundary. Config 1 (images
   mode, 64 px) float32 card against CPU, as is a small tokenizer with
   separate first-frame encoding and ``pad_mode='reflect'``, which with
   ``MAGVIT2_TPU_FUSED_RU_WIDE_DIMS`` set launches no B4 (its zero-padded
   twin launches 9 in ``tokenize``, ``encode`` and ``decode``). With ``--out`` the readings go to ``configs.json``.
9. the rest of serving. Config 5 (256 px x 65 frames, 2^14 codes, bf16,
   batch 1) whole-clip through ``tokenize`` / ``decode_from_code_indices``
   on both paths (no kernel on the default path: config 5 has no
   attention; B4 20 and B5 2 on the fused one), then ``tokenize_streaming``
   (chunks of 17, 16, 16, 16 frames) and ``decode_streaming`` (5, 4, 4, 4
   latent frames) on each, with frames/s and peak device memory of every
   run and no B2, B4, B5 or flash launch in a stream; float32 streamed
   against whole-clip under the margin rule. The README stack streamed
   (chunks of 5, 4, 4, 4 frames, batch 8): B3 and B1 once a chunk, no
   B2, B4 or B5, codes against whole-clip in bf16 and float32, and the
   kv-cache under ``streaming_kv_window=2``. The ``.pt`` import of that
   tokenizer on the card, bit-identical. A conditioned stack at README
   width (``COND_LAYERS``, dim_cond 32, bf16 batch 8) on both paths at
   attention heads 8 x 16: B3 twice on its no-norm route, no norm launch,
   no B1 or B2, B4 for the plain units; frames/s; its stream with cond
   fixed; float32 card against CPU at 32 px. The same stack at the
   README's heads, 32 x 8, where no attention kernel runs (B3 takes heads
   of 8 only): its launches, frames/s and float32 card against CPU. B3's no-norm route against its plain version at the
   flagship shape (the kernels line's B3 row, key ``no_norm``).
10. training. Each block's backward at the flagship shapes, float32 (TF32
   off) and bf16 (B1; B2 on its 'launches' route in float32 and 'fused' in
   bf16; B3 with and without its norm; B4 at (8, 20, 16, 16, 512); B5 on
   the packed stem): the wrapper's gradients of x and every parameter
   against ``torch.autograd.grad`` of the plain version its backward
   recomputes, on the same inputs and upstream gradient (float32 within
   1e-5 of each gradient's largest value, bf16 within 1e-2), one forward
   and one ``_backward`` count each, and forward + backward times against
   the plain version's (the kernels line's ``backward`` of rows B1-B5).
   Then ``VideoTokenizerTrainer`` on the README flagship as a user runs it
   (the default discriminator, VGG16 with the orthogonal fallback, the bf16
   policy, an in-memory dataset, batch 4 x accum 2, the EMA decaying from
   step 0), 8 ``train_step``s on the default path (monolithic accumulation)
   and on the fused one (split),
   the discriminator from step 1, R1 every 2 steps: every loss finite, each
   block's forward and ``_backward`` launched (B4 and B5 on the fused path
   only, no flash), seconds a step with and without R1 and at the default
   cadence, samples/s, peak memory; with ``--profile`` one warm step's
   device time by kernel (``profile_train_<path>.txt``) and its share under
   the blocks' backward recompute. One step each with ``remat=True`` and
   ``remat='dots'``: the same losses and, leaf by leaf, the same generator
   gradients within the bf16 limit, a lower peak. A B4 unit of the trained
   and of the EMA module after one more step against the plain version on
   the updated weights (the re-lay cache), the EMA's weights a decayed
   update; the EMA tokenizer's roundtrip contract; a tiny float32
   configuration on the card against the CPU (the first step's losses and
   gradients within 1e-4, the generator's and discriminator's parameters
   after two steps within 2 lr a step, and each leaf's 99% within 1e-2 lr);
   and ``save`` -> ``load`` -> one step bit for bit the step without the
   reload.

The second-to-last line is the card's ``nvidia-smi`` name and power limit,
the line before it a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


# with --out, every log line also goes to DIR/chip_smoke.log (the end of
# standard output alone may not hold them all)
LOG_FILES = []


def fail(msg: str):
    log(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def log(msg: str, file=None):
    print(msg, flush=True, file=file)
    for f in LOG_FILES:
        print(msg, file=f, flush=True)


# kernel name -> (CUDA source, TPU kernel it replaces)
RU_SOURCE = 'magvit2_pytorch_tpu_torch/csrc/residual_unit.cu'
FLASH_SOURCE = 'magvit2_pytorch_tpu_torch/csrc/flash_attention.cu'
ATTN_SOURCE = 'magvit2_pytorch_tpu_torch/csrc/attention_block.cu'
TAYLOR_SOURCE = 'magvit2_pytorch_tpu_torch/csrc/taylor_attention.cu'
TIME_SOURCE = 'magvit2_pytorch_tpu_torch/csrc/time_attention.cu'
B1_TPU = 'magvit2_pytorch_tpu/ops/pallas/axial_attention.py:49'
B2_TPU = 'magvit2_pytorch_tpu/ops/pallas/axial_attention.py:224'
B3_TPU = 'magvit2_pytorch_tpu/ops/pallas/taylor_attention.py:55'
KERNELS = {
    'space_attention_block': (ATTN_SOURCE, B1_TPU),
    # B2 in one launch: the time block's 'fused' route (bf16)
    'time_attention_block_fused': (TIME_SOURCE, B2_TPU),
    'taylor_attention_block': (TAYLOR_SOURCE, B3_TPU),
    # launches inside the three blocks above: the projections of B1-B3
    # (B1's at axial_attention.py:56 and :95) and B1's attention step
    # (:59-91)
    'gemm_wgmma': ('magvit2_pytorch_tpu_torch/csrc/gemm.cu', B1_TPU),
    'space_attention_core_mma': (ATTN_SOURCE, B1_TPU),
    # B3's moment core: the feature maps, A = phi(k)^T v, S and the output
    # of _taylor_frame (taylor_attention.py:78-107)
    'taylor_core_mma': (TAYLOR_SOURCE, B3_TPU),
    'residual_unit_wide': (
        RU_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/residual_unit_wide.py:56'),
    'residual_unit_packed': (
        RU_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/residual_unit.py:121'),
    # the conv launch inside B4 and B5 (the TPU kernels' 27 tap products,
    # residual_unit_wide.py:92-116) on its TMA + wgmma route
    'ru_conv_wgmma': (
        RU_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/residual_unit_wide.py:56'),
    'flash_attention_fwd': (
        FLASH_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/flash_attention.py:51'),
    'flash_attention_bwd_dq': (
        FLASH_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/flash_attention.py:190'),
    'flash_attention_bwd_dkv': (
        FLASH_SOURCE, 'magvit2_pytorch_tpu/ops/pallas/flash_attention.py:249'),
}
FLASH_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv')
# the flash kernels by route (ops/kernels/flash_attention.py flash_route):
# 'mma' for bf16, 'f32' for float32
FLASH_ROUTES = {f'{kernel}_{route}': route
                for kernel in FLASH_KERNELS for route in ('mma', 'f32')}
# the 'mma' kernels: (name in flash_attention.mma_attributes, CUDA kernel)
FLASH_MMA = (('fwd', 'fwd_mma_kernel'), ('dq', 'bwd_dq_mma_kernel'),
             ('dkv', 'bwd_dkv_mma_kernel'))
# what every entry of the kernels line holds
KERNEL_KEYS = ('name', 'route', 'source', 'replaces', 'launches',
               'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
               'library_ms')
# launches per roundtrip on each path (encoder + decoder): the flagship has
# 11 ResidualUnits a side, the first (64 channels, the lane-packed stem) B5;
# B1 and B3 make two projection GEMMs each, all on the wgmma route in bf16,
# B1 one launch of its tensor-core core and B3 one of its own; B2 one
# launch of its own on the 'fused' route; and per step (forward + backward)
# of the general Attention path
NO_FLASH = dict.fromkeys((*FLASH_KERNELS, *FLASH_ROUTES), 0)
BLOCKS = {'space_attention_block': 2, 'time_attention_block': 2,
          'time_attention_block_fused': 2, 'time_attention_block_launches': 0,
          'taylor_attention_block': 2, 'gemm_wgmma': 8, 'gemm_wmma': 0,
          'gemm_f32': 0, 'space_attention_core_mma': 2, 'taylor_core_mma': 2,
          'taylor_core_f32': 0}
# each fused unit launches one conv and one 1x1, in bf16 on the wgmma route
FUSED_RU = {'residual_unit_wide': 20, 'residual_unit_packed': 2,
            'ru_conv_wgmma': 22, 'ru_conv_wmma': 0, 'ru_conv_f32': 0,
            'ru_pointwise_wgmma': 22, 'ru_pointwise_wmma': 0,
            'ru_pointwise_f32': 0}
NO_RU = dict.fromkeys(FUSED_RU, 0)
LAUNCHES = {
    'default': {**BLOCKS, **NO_RU, **NO_FLASH},
    'fused': {**BLOCKS, **FUSED_RU, **NO_FLASH},
    # bf16: each flash kernel on the 'mma' route
    'attention_step': {**dict.fromkeys(BLOCKS, 0), **NO_RU,
                       **dict.fromkeys(FLASH_KERNELS, 1),
                       **{name: int(route == 'mma')
                          for name, route in FLASH_ROUTES.items()}},
}
# the bf16 in-situ check: encode + decode with MAGVIT2_TPU_NO_FUSED_ATTN=1
# sends space and time attention down the general plain path; Taylor
# attention keeps its block
IN_SITU_PLAIN = {**dict.fromkeys(BLOCKS, 0), 'taylor_attention_block': 2,
                 'taylor_core_mma': 2, 'gemm_wgmma': 4}
FUSED_ENV = {'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64,128,256,512'}

# kernel vs plain tolerances, with their reasons, each within ~10x of the
# readings on an H100 80GB HBM3 at 700 W:
# - the attention blocks B1-B3, held as max |kernel - plain| over the
#   largest |plain| (outputs are ~0.06 in standard deviation at the flagship
#   shape, so an absolute limit that admits bf16 would admit a wrong
#   kernel). float32 (TF32 off): the same float32 math summed in another
#   order (K = 256..512 projections, 260 softmax keys, 1024-token moments),
#   read <= 1.2e-6 of the largest value, so 1e-5. bfloat16 against the
#   plain version in float32 on the same inputs: the kernel rounds to bf16
#   where the JAX kernel does (normed input, qkv, P, the attention output,
#   the block output: 2^-9 relative each), read <= 4.8e-3, so 2e-2.
# - bfloat16, ResidualUnit: the JAX kernel test's 6e-2 absolute
#   (tests/test_fused_residual_wide.py:60): the kernel rounds the conv, the
#   1x1, the SE logit, attention, context, MLP and gate products to bf16, and
#   the output (up to ~6 in magnitude) to 2^-8 relative.
# - the projection GEMM against torch.matmul in float32 on the same bf16
#   inputs, relative to the largest value: a bf16 output rounds each value
#   to 2^-9 relative (read <= 3.3e-3), so 1e-2.
# - flash attention, against its plain version in float32 on the same
#   inputs (N(0, 1) q, k, v, dO and bias). Outputs and gradients are held
#   relative to the largest value of the reference, max|a - r| / max|r|,
#   because their size depends on the shape: ~4-8 at 134 keys, ~0.4-0.7 at
#   4100 keys (a softmax over m keys averages v down by sqrt(m)), and one
#   absolute limit that admits the first would pass a wrong kernel at the
#   second. float32: the same sums in tiles of 64 keys with an online
#   softmax, observed ~1e-6 of the largest value, so 1e-4. bfloat16: the
#   kernel rounds P and dS to bf16 (2^-9 relative) as tensor-core operands
#   and the outputs to bf16; such roundings summed over the keys gave up to
#   5.4e-3 of the largest value (dk, 1028 keys, causal), so 2e-2. lse is of
#   magnitude 3-9 and stays float32 in both (products of bf16 inputs are
#   exact in float32): 1e-4 absolute.
TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
RU_TOL = {'float32': 1e-4, 'bfloat16': 6e-2}
# B4's five launches one by one in bf16, against their plain versions in
# float32 on the same inputs, each held relative to the largest value of its
# reference (an absolute limit near the unit's 6e-2 would pass a wrong
# logit or gate kernel: those values are ~1 and their errors ~1e-3). The
# gates are held by their deviations from each frame's mean and from each
# channel's mean over the frames (what the context moves), on a sharpened
# SqueezeExcite; phase_ru_launches fails where a planted fault (constant
# gates, uniform attention, the next frame's context) would pass the limit.
# Each output rounds to bf16 (2^-9 relative) after bf16 products; read on an
# H100 80GB HBM3 at 700 W: conv 4.7e-3, 1x1 5.1e-3, logits 5.4e-3, gates
# 1.0e-2 (the context and the MLP round to bf16 before the sigmoid), gate +
# residual 2.9e-3; the planted faults read 1.0, 1.19 and 1.23.
RU_LAUNCH_TOL = {'conv': 3e-2, 'pointwise': 3e-2, 'se_logits': 3e-2,
                 'se_gates': 1e-1, 'gate_residual': 2e-2}
RU_LAUNCH_HELD = dict.fromkeys(RU_LAUNCH_TOL, 'of the largest value')
RU_LAUNCH_HELD['se_gates'] = ('deviations from the frame and channel means, '
                              'of the largest')
GEMM_TOL = 1e-2
FLASH_TOL = {'float32': 1e-4, 'bfloat16': 2e-2, 'lse': 1e-4}
# module-level checks of the attention step, relative to the largest value
# of the reference: bf16 flash against bf16 plain on the card (both round
# q, k, v, the output and every gradient to bf16; parameter gradients sum
# 69632 tokens of such terms), float32 card against float32 CPU
STEP_TOL = {'bfloat16': 5e-2, 'float32': 1e-4}
# the bf16 in-situ check of the default roundtrip, blocks against the general
# plain attention path on the same tokenizer and input. Both run in bf16 and
# differ by where they round: the blocks round P to bf16 before P V, the
# plain path keeps its float32 softmax until the output; through the
# encoder and the decoder that reads, on an H100 80GB HBM3 at 700 W,
# 1.2e-2 of the largest latent and 1.5e-2 of the largest reconstructed
# value, so 5e-2 each; 0.15% of code bits flipped (1%), each where the
# plain run's |z| was at most 9.6e-3 of its largest (5e-2)
IN_SITU_TOL = {'latents': 5e-2, 'bits_flipped': 1e-2,
               'worst_flip_margin': 5e-2, 'recon': 5e-2}
# the attention step's shape: the flagship's space-attention stage at 512 px
STEP_SHAPE = (1, 17, 64, 64, 512)
FLASH_FULL = dict(b=17, h=8, n=4096, m=4100, d=32)
PLAIN_CHUNK = 4     # frames per call of the plain version at full width
BATCH = 8
REPS = 20           # timed runs per kernel, after warm-up
INNER = 10          # back-to-back calls a timed run of a kernel below 1 ms
# the flagship's ResidualUnit stages: (C, T, H = W, launches of B4 per fused
# roundtrip); the 64-channel stem takes B5 there, at PACKED_STEM (T, H = W)
RU_STAGES = ((64, 20, 128, 0), (128, 20, 64, 4), (256, 20, 32, 4),
             (512, 20, 16, 4), (512, 10, 16, 4), (512, 5, 16, 4))
PACKED_STEM = (20, 128)
B4_ROW_SHAPE = (BATCH, 20, 16, 16, 512)    # the stage B4's kernels row shows
# B4 cases the stage shapes do not reach: (what, shape, the conv's bf16
# route). T < 3 makes every frame skip taps before frame 0; H = W = 12 leaves
# boxes of 16 x 8 pixels partly outside the frame; C = 96 takes WMMA
RU_EXTRA_CASES = (
    ('T = 1 (causal skip)', (2, 1, 16, 16, 128), 'wgmma'),
    ('T = 2 (causal skip)', (2, 2, 16, 16, 128), 'wgmma'),
    ('T = 3 (causal skip)', (2, 3, 16, 16, 128), 'wgmma'),
    ('H = W = 12 (ragged boxes)', (2, 3, 12, 12, 128), 'wgmma'),
    ('H = W = 12 at C = 64 (ragged, 128 x 64 tiles)', (2, 3, 12, 12, 64),
     'wgmma'),
    ('C = 96 (WMMA route)', (2, 3, 16, 8, 96), 'wmma'),
)
# the ResidualUnit wrappers (ops/kernels/residual_unit.py) and their kernels
RU_WRAPPERS = {'fused_residual_unit_wide': 'residual_unit_wide',
               'fused_residual_unit': 'residual_unit_packed'}
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
EX2_PER_CLOCK = 16  # ex2 results a clock an SM (the special-function unit)


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def set_tf32(enabled: bool):
    import torch
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


def median_ms(fn, reps: int, warmup: int = 3, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call (``times_ms``)."""
    times = times_ms(fn, reps, warmup, inner)
    return times[len(times) // 2]


def times_ms(fn, reps: int, warmup: int = 3, inner: int = 1) -> list:
    """``reps`` CUDA-event timings of ``inner`` back-to-back calls, per
    call, sorted. With ``inner`` > 1 the card's queue stays full, so a
    call's host work (the wrapper, the launch) overlaps the previous call's
    kernel and the time is the device's; with 1 a short kernel's time also
    holds its own host work."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)


def bound(flops: float, nbytes: float):
    """The least time (ms) the card could take: the larger of the work over
    the bf16 tensor-core peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def attention_cost(groups, L, C, heads, dh, M, causal):
    """FLOPs and bytes of one attention block in bf16: the qkv and out
    projections, then scores and values over each query's visible keys (M
    memory keys plus the sequence, or its causal prefix); x and the output
    once, the weights once."""
    inner = heads * dh
    rows = groups * L
    keys = sum(M + (i + 1 if causal else L) for i in range(L))
    flops = 2 * rows * C * 4 * inner + 4 * dh * heads * groups * keys
    nbytes = 2 * (2 * rows * C + C + 4 * inner * C + 2 * heads * M * dh)
    return flops, nbytes


def taylor_cost(frames, N, C, heads, d):
    """FLOPs and bytes of one Taylor block in bf16: the two projections and,
    per token and head, the second-order moments of k (k k^T, k v^T,
    (k k^T) v^T) and their products with q and q q^T, numerator and
    denominator (4 d^3 + 8 d^2 + 2 d)."""
    rows = frames * N
    inner = heads * d
    flops = (2 * rows * C * 4 * inner
             + rows * heads * (4 * d ** 3 + 8 * d * d + 2 * d))
    nbytes = 2 * (2 * rows * C + C + 4 * inner * C)
    return flops, nbytes


def real_taps(n, before, after):
    """Taps that read a real position, summed over n outputs of a 1-D
    window reaching ``before`` back and ``after`` ahead (the rest read the
    zero pad)."""
    return sum(min(i, before) + 1 + min(n - 1 - i, after) for i in range(n))


def ru_cost(shape, hidden):
    """FLOPs and bytes of one ResidualUnit in bf16: the causal 3x3x3 conv
    over each output pixel's real taps only (none before frame 0 or outside
    the frame, as ``attention_cost`` counts only visible keys), the 1x1
    (2 M C^2), the SE logit and context (4 M C) and the gate MLP per frame;
    x and the output once, the weights once."""
    b, t, h, w, c = shape
    m = b * t * h * w
    taps = b * real_taps(t, 2, 0) * real_taps(h, 1, 1) * real_taps(w, 1, 1)
    flops = (2 * taps * c * c + 2 * m * c * c + 4 * m * c
             + b * t * 4 * c * hidden)
    nbytes = 2 * (2 * m * c + 28 * c * c + 2 * c * hidden + 4 * c + hidden
                  + 1)
    return flops, nbytes


def ru_launch_costs(shape, hidden):
    """FLOPs and bytes of each of the unit's five launches in bf16 (each
    input read once, each output written once; the conv over real taps
    only, the logits and the SE scratch in float32)."""
    b, t, h, w, c = shape
    m, frames = b * t * h * w, b * t
    taps = b * real_taps(t, 2, 0) * real_taps(h, 1, 1) * real_taps(w, 1, 1)
    return {
        'conv': (2 * taps * c * c, 2 * (2 * m * c + 27 * c * c + c)),
        'pointwise': (2 * m * c * c, 2 * (2 * m * c + c * c + c)),
        'se_logits': (2 * m * c, 2 * (m * c + c + 1) + 4 * m),
        'se_gates': (2 * m * c + 4 * frames * c * hidden,
                     2 * (m * c + 2 * c * hidden + hidden + c + frames * c)
                     + 4 * m),
        'gate_residual': (2 * m * c, 2 * (3 * m * c + frames * c)),
    }


def memory_mask(torch, L, M, dev):
    """Causal attention with M memory keys in front: key j is visible to
    query i when j < M or j - M <= i."""
    j = torch.arange(M + L, device=dev)
    i = torch.arange(L, device=dev)[:, None]
    return (j < M) | (j - M <= i)


def ru_params(torch, c, gen):
    """One ResidualUnit's tensors in ``residual_unit_ref``'s order: the
    module's init bounds, and live SqueezeExcite gates (kaiming-uniform
    output weight, zero bias) so the check sees the whole unit."""
    hidden = max(16, c // 2)

    def u(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    conv, lin, hid = (27 * c) ** -0.5, c ** -0.5, hidden ** -0.5
    return [u((c, c, 3, 3, 3), conv), u((c,), conv), u((c, c), lin),
            u((c,), lin), u((1, c), lin), u((1,), lin), u((hidden, c), lin),
            u((hidden,), lin), u((c, hidden), (6.0 / hidden) ** 0.5),
            torch.zeros(c)]


def uniform(torch, gen, shape, fan_in):
    """U(-fan_in^-1/2, fan_in^-1/2), nn.Linear's init range."""
    b = fan_in ** -0.5
    return (torch.rand(shape, generator=gen) * 2 - 1) * b


def attn_params(torch, gen, c, heads, dh):
    """gamma, wqkv, mem_kv, wout of one attention block: gamma around 1."""
    inner = heads * dh
    return [1 + 0.1 * torch.randn(c, generator=gen),
            uniform(torch, gen, (3 * inner, c), c),
            torch.randn(2, heads, 4, dh, generator=gen),
            uniform(torch, gen, (c, inner), inner)]


def space_block_torch(torch, x, gamma, wqkv, mem_kv, wout, heads, dh):
    """B1's function as a sequence of PyTorch calls (the yardstick of the
    whole block, never used by the port): ``F.rms_norm``, ``F.linear``,
    the memory keys concatenated in front, SDPA, ``F.linear``."""
    import torch.nn.functional as F
    g, L, c = x.shape
    xn = F.rms_norm(x, (c,), gamma)
    q, k, v = F.linear(xn, wqkv).view(g, L, 3, heads, dh).permute(2, 0, 3, 1, 4)
    mem = mem_kv[:, None].expand(2, g, heads, mem_kv.shape[2], dh)
    k, v = torch.cat((mem[0], k), dim=2), torch.cat((mem[1], v), dim=2)
    o = F.scaled_dot_product_attention(q, k, v)
    return F.linear(o.transpose(1, 2).reshape(g, L, heads * dh), wout)


def time_block_torch(torch, x, gamma, wqkv, mem_kv, wout, heads, dh, mask):
    """B2's function as a sequence of PyTorch calls (the yardstick of the
    whole time block, never used by the port) on ``x (B, T, S, C)``:
    ``F.rms_norm``, ``F.linear``, the permute to ``(B S, T, .)``, the memory
    keys concatenated in front, SDPA with the causal memory mask,
    ``F.linear``, the permute back."""
    import torch.nn.functional as F
    b, t, s, c = x.shape
    qkv = F.linear(F.rms_norm(x, (c,), gamma), wqkv)
    q, k, v = (qkv.view(b, t, s, 3, heads, dh).permute(3, 0, 2, 4, 1, 5)
               .reshape(3, b * s, heads, t, dh))
    mem = mem_kv[:, None].expand(2, b * s, heads, mem_kv.shape[2], dh)
    k, v = torch.cat((mem[0], k), dim=2), torch.cat((mem[1], v), dim=2)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out = F.linear(o.transpose(1, 2).reshape(b * s, t, heads * dh), wout)
    return out.view(b, s, t, c).permute(0, 2, 1, 3)


def kernel_cases(torch, dev):
    """Inputs at the flagship shapes: README config, batch 8, 20 padded
    frames at the encoder's attention stages; the ResidualUnit at every
    stage of the flagship. Each case: name, the wrapper and its plain
    version, the arguments, the work (FLOPs, bytes) and one library call for
    the same step (or None)."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.conv import (
        pad_time_front, to_channels_first)
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        axial_attention as ax, residual_unit as ru, taylor_attention as ta)
    gen = torch.Generator(device='cpu').manual_seed(1234)

    def u(shape, fan_in):
        return uniform(torch, gen, shape, fan_in)

    cases = []
    c, heads, dh = 512, 8, 32
    x = torch.randn(BATCH * 20, 16 * 16, c, generator=gen)
    cases.append(dict(
        name='space_attention_block', fn=ax.attention_block,
        ref=ax.attention_block_ref,
        args=[x, *attn_params(torch, gen, c, heads, dh)],
        kw=dict(heads=heads, dim_head=dh, causal=False),
        cost=attention_cost(BATCH * 20, 256, c, heads, dh, 4, False),
        library=lambda x16, p16, heads=heads, dh=dh: lambda: (
            space_block_torch(torch, x16, *p16, heads, dh)),
        library_call='a sequence of PyTorch calls: F.rms_norm, F.linear, '
                     'torch.cat of the memory keys, '
                     'F.scaled_dot_product_attention, F.linear',
        relative=True))
    c, heads, dh = 256, 16, 8
    x = torch.randn(BATCH * 20, 32 * 32, c, generator=gen)
    cases.append(dict(
        name='taylor_attention_block', fn=ta.taylor_attention,
        ref=ta.taylor_attention_ref,
        args=[x, 1 + 0.1 * torch.randn(c, generator=gen),
              u((3 * heads * dh, c), c), u((c, heads * dh), heads * dh)],
        kw=dict(heads=heads, dim_head=dh),
        cost=taylor_cost(BATCH * 20, 1024, c, heads, dh),
        library=None, library_call=None, relative=True))

    def conv_call(x16, p16):
        """The unit's conv step alone: one F.conv3d on the channels-last
        view, the causal front pad made beforehand."""
        xp = to_channels_first(pad_time_front(x16, 2))
        return lambda: F.conv3d(xp, p16[0], p16[1], padding=(0, 1, 1))

    for c, t, hw, n in RU_STAGES:
        shape = (BATCH, t, hw, hw, c)
        cases.append(dict(
            name='residual_unit_wide', fn=ru.fused_residual_unit_wide,
            ref=ru.residual_unit_ref,
            args=[torch.randn(shape, generator=gen), *ru_params(torch, c, gen)],
            kw={}, cost=ru_cost(shape, max(16, c // 2)), per_roundtrip=n,
            library=conv_call, library_call='F.conv3d, the conv step',
            boundary=c == 128))
    # B5 on the lane-packed view of the stem: (B, T, H, W/2, 2C)
    t, hw = PACKED_STEM
    shape = (BATCH, t, hw, hw // 2, 128)
    cases.append(dict(
        name='residual_unit_packed', fn=ru.fused_residual_unit,
        ref=lambda xb, *p, packed_io: ru.residual_unit_ref(
            xb.reshape(*xb.shape[:3], -1, 64), *p).reshape(xb.shape),
        args=[torch.randn(shape, generator=gen), *ru_params(torch, 64, gen)],
        kw=dict(packed_io=True), cost=ru_cost((BATCH, t, hw, hw, 64), 32),
        library=lambda x16, p16: conv_call(
            x16.reshape(*x16.shape[:3], -1, 64), p16),
        library_call='F.conv3d, the conv step', boundary=True))
    # outside inference mode: the RU conv caches its re-laid weight only for
    # a tensor with a version counter, as the module's parameters have
    with torch.inference_mode(False):
        for case in cases:
            case['args'] = [a.to(dev) for a in case['args']]
    return cases


def check_case(torch, case, reps):
    """One kernel case: float32 (TF32 off) and bf16 against the plain
    version, the batch boundary where asked, and median times. A case with
    ``relative`` holds its error over the largest value of the reference,
    the others their max abs error."""
    name, fn, ref, args, kw = (case[k] for k in
                               ('name', 'fn', 'ref', 'args', 'kw'))
    tol = RU_TOL if name.startswith('residual_unit') else TOL
    set_tf32(False)
    got = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    peak32 = want.abs().max().item()
    finite = bool(torch.isfinite(got).all())
    del got, want
    with torch.inference_mode(False):
        args16 = [a.to(torch.bfloat16) for a in args]
    got16 = fn(*args16, **kw)
    want16 = ref(*[a.float() for a in args16], **kw)
    torch.cuda.synchronize()
    err16 = (got16.float() - want16).abs().max().item()
    peak16 = want16.abs().max().item()
    finite = finite and bool(torch.isfinite(got16).all())
    del got16, want16
    row = dict(shape=list(args[0].shape), max_abs_err=err16,
               max_abs_err_fp32=err32)
    held = {'float32': err32, 'bfloat16': err16}
    if case.get('relative'):
        held = {'float32': err32 / peak32, 'bfloat16': err16 / peak16}
        row.update(max_rel_err=held['bfloat16'],
                   max_rel_err_fp32=held['float32'])
    if case.get('boundary'):
        # batch element 1 alone equals its place in a batch of two, to the
        # bit: no causal tap reaches into element 0, and no launch sums a
        # frame in an order that depends on the batch
        both = args[0][:2]
        row['batch_boundary_err'] = (
            fn(both, *args[1:], **kw)[1:] - fn(both[1:], *args[1:], **kw)
        ).abs().max().item()
    # the attention blocks are short: their calls are timed back to back,
    # as a case with ``inner`` asks; each time's median and [min, max]
    inner = case.get('inner', INNER if case.get('relative') else 1)

    def timed(key, call):
        times = times_ms(call, reps, inner=inner)
        row[key], row[f'{key}_range'] = times[len(times) // 2], [times[0],
                                                                 times[-1]]

    timed('ms', lambda: fn(*args16, **kw))
    timed('plain_ms', lambda: ref(*args16, **kw))
    timed('ms_fp32', lambda: fn(*args, **kw))
    timed('plain_ms_fp32', lambda: ref(*args, **kw))
    library = case['library']
    row['library_ms'] = None
    if library is not None:
        timed('library_ms', library(args16[0], args16[1:]))
    row['calls_per_timing'] = inner
    row['library_call'] = case['library_call']
    row['bound_ms'], row['bound_by'] = bound(*case['cost'])
    how = 'of the largest value' if case.get('relative') else 'max abs'

    def ms(key):
        lo, hi = row.get(f'{key}_range', (None, None))
        return (f'{row[key]:.4f} ms [{lo:.4f}, {hi:.4f}]' if lo is not None
                else f'{row[key]} ms')

    log(f'[kernel] {name} {tuple(args[0].shape)}: error ({how}) fp32 '
        f'{held["float32"]:.3e} (tol {tol["float32"]:g}), bf16 '
        f'{held["bfloat16"]:.3e} (tol {tol["bfloat16"]:g}); max abs fp32 '
        f'{err32:.3e}, bf16 {err16:.3e}; bf16 kernel {ms("ms")}, '
        f'plain {ms("plain_ms")}, library {ms("library_ms")} '
        f'({row["library_call"]}), bound '
        f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}); fp32 kernel '
        f'{ms("ms_fp32")}, plain {ms("plain_ms_fp32")}'
        + (f'; batch boundary {row["batch_boundary_err"]:.3e}'
           if 'batch_boundary_err' in row else '')
        + f' (median [min, max] of {reps}, {inner} calls a timing)')
    if not finite:
        fail(f'{name}: non-finite kernel output')
    for dt in ('float32', 'bfloat16'):
        if not held[dt] <= tol[dt]:
            fail(f'{name}: {dt} error {held[dt]} ({how}) > {tol[dt]}')
    if row.get('batch_boundary_err', 0.0) != 0.0:
        fail(f'{name}: batch element 1 differs alone and in a batch of two '
             f'by {row["batch_boundary_err"]}')
    return row


def phase_kernels(torch, dev, reps):
    """Every case; one row per kernel for the result line, every number per
    launch at one shape. B4 runs at six shapes: its row is the one at
    ``B4_ROW_SHAPE``, and ``stages`` holds the row of each shape."""
    rows, stages = {}, []
    for case in kernel_cases(torch, dev):
        row = dict(check_case(torch, case, reps), per='launch')
        torch.cuda.empty_cache()
        if case['name'] != 'residual_unit_wide':
            rows[case['name']] = row
            continue
        stages.append(dict(row, launches_per_roundtrip=case['per_roundtrip']))
        if tuple(row['shape']) == B4_ROW_SHAPE:
            rows['residual_unit_wide'] = row
    rows['residual_unit_wide']['stages'] = stages
    return rows


def gate_errors(torch, ru, got, want, y2, se):
    """The SE gates ``(frames, C)`` held by their deviations: from each
    frame's mean gate (the channel pattern) and from each channel's mean
    over the frames (what the context adds), each relative to the largest
    deviation of the reference; the worse of the two. Also the readings of
    three planted faults: constant gates, uniform attention (the logits
    ignored) and the neighbouring frame's context."""
    def reading(g):
        g = g.float()
        return max(relative_error(g - g.mean(1, keepdim=True),
                                  want - want.mean(1, keepdim=True)),
                   relative_error(g - g.mean(0, keepdim=True),
                                  want - want.mean(0, keepdim=True)))
    uniform = ru.se_gates_ref(
        y2.float(), torch.zeros(y2.numel() // y2.shape[-1],
                                device=y2.device), *[t.float() for t in se[2:]])
    planted = {'constant gates 0.5': reading(torch.full_like(want, 0.5)),
               'uniform attention': reading(uniform),
               "the next frame's context": reading(want.roll(1, 0))}
    return reading(got), planted


def phase_ru_launches(torch, dev, reps, smi):
    """B4's five launches one by one at ``B4_ROW_SHAPE`` in bf16, each held
    against its plain version in float32 on the same inputs under
    ``RU_LAUNCH_TOL`` and timed beside its bound, its plain version and,
    but for the SE reduction, one PyTorch call (``F.conv3d``, ``F.linear``
    for the 1x1 and the logits, ``torch.addcmul``); then the conv launch at every
    ``RU_STAGES`` shape (its route's launch counted) with TFLOP/s of real
    taps, beside the WMMA route on the same call; then the
    ``RU_EXTRA_CASES`` in both dtypes against ``residual_unit_ref`` with
    their conv routes counted. Returns the split, the conv's kernels-line
    row and the extra cases."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.conv import (
        pad_time_front, to_channels_first)
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts, residual_unit as ru)
    set_tf32(False)
    gen = torch.Generator().manual_seed(51)
    tol = RU_TOL['bfloat16']      # the conv at every stage, as B4's check

    def inputs(shape, dtype=torch.bfloat16):
        with torch.inference_mode(False):
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            p = [t.to(dev, dtype) for t in ru_params(torch, shape[-1], gen)]
        return x, p

    def f32(ts):
        return [t.float() for t in ts]

    x, p = inputs(B4_ROW_SHAPE)
    b, t, h, w, c = B4_ROW_SHAPE
    costs = ru_launch_costs(B4_ROW_SHAPE, p[6].shape[0])
    # the SE launches on a sharpened SqueezeExcite (k x 8, both gate-MLP
    # weights x 4: exact in bf16). With ru_params' init the logits spread
    # ~0.3 and the gates sit within a few hundredths of 0.5, closer than
    # bf16's step there from frame to frame, so no check could tell a kernel
    # with uniform attention or another frame's context from a right one
    se = [p[4] * 8, p[5], p[6] * 4, p[7], p[8] * 4, p[9]]
    y1 = ru.ru_conv(x, *p[:2])
    y2 = ru.ru_pointwise(y1, *p[2:4])
    logits = ru.se_logits(y2, *se[:2])
    gates = ru.se_gates(y2, logits, *se[2:])
    out = ru.gate_residual(y2.clone(), gates, x)
    xp = to_channels_first(pad_time_front(x, 2))
    y2_timed = y2.clone()      # gate_residual's timing rewrites it in place
    gates5 = gates.view(b, t, 1, 1, c)
    steps = (
        ('conv', y1, lambda: ru.conv_ref(x.float(), *f32(p[:2])),
         lambda: ru.ru_conv(x, *p[:2]), lambda: ru.conv_ref(x, *p[:2]),
         lambda: F.conv3d(xp, p[0], p[1], padding=(0, 1, 1)),
         'F.conv3d on the padded channels-first view'),
        ('pointwise', y2, lambda: ru.pointwise_ref(y1.float(), *f32(p[2:4])),
         lambda: ru.ru_pointwise(y1, *p[2:4]),
         lambda: ru.pointwise_ref(y1, *p[2:4]),
         lambda: F.linear(y1, p[2], p[3]), 'F.linear with the bias'),
        ('se_logits', logits,
         lambda: ru.se_logits_ref(y2.float(), *f32(se[:2])),
         lambda: ru.se_logits(y2, *se[:2]),
         lambda: ru.se_logits_ref(y2, *se[:2]),
         lambda: F.linear(y2, se[0], se[1]), 'F.linear with the bias'),
        ('se_gates', gates,
         lambda: ru.se_gates_ref(y2.float(), logits, *f32(se[2:])),
         lambda: ru.se_gates(y2, logits, *se[2:]),
         lambda: ru.se_gates_ref(y2, logits, *se[2:]), None, None),
        ('gate_residual', out,
         lambda: ru.gate_residual_ref(y2.float(), gates.float(), x.float()),
         lambda: ru.gate_residual(y2_timed, gates, x),
         lambda: ru.gate_residual_ref(y2, gates, x),
         lambda: torch.addcmul(x, y2, gates5), 'torch.addcmul'),
    )
    split = {}
    for name, got, want, fn, plain, library, library_call in steps:
        want = want()
        err = (got.float() - want).abs().max().item()
        if name == 'se_gates':
            held, planted = gate_errors(torch, ru, got, want, y2, se)
        else:
            held, planted = relative_error(got, want), {}
        row = dict(max_abs_err=err, max_rel_err=held,
                   ms=median_ms(fn, reps, inner=INNER),
                   plain_ms=median_ms(plain, reps, inner=INNER),
                   library_ms=(median_ms(library, reps, inner=INNER)
                               if library else None),
                   library_call=library_call)
        if planted:
            row['planted_faults'] = planted
        row['bound_ms'], row['bound_by'] = bound(*costs[name])
        split[name] = row
        tol = RU_LAUNCH_TOL[name]
        log(f'[ru launches] {name} {B4_ROW_SHAPE} bf16: error {held:.3e} '
            f'(tol {tol:g}; {RU_LAUNCH_HELD[name]}), max abs {err:.3e}'
            + (f', planted faults {planted}' if planted else '')
            + f'; kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, '
            f'library {row["library_ms"]} ms ({library_call}), bound '
            f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}) (median of {reps}, '
            f'{INNER} calls a timing) on {smi}')
        if not held <= tol:
            fail(f'RU launch {name}: error {held} > {tol}')
        for fault, reading in planted.items():
            if not reading > tol:
                fail(f'RU launch {name}: the planted fault "{fault}" reads '
                     f'{reading}, within the limit {tol}')
    conv_split = split['conv']
    total = sum(r['ms'] for r in split.values())
    log(f'[ru launches] sum of the five {total:.4f} ms at {B4_ROW_SHAPE}')
    del x, p, y1, y2, y2_timed, logits, gates, out, xp

    stages = []
    for c, t, hw, _ in RU_STAGES:
        shape = (BATCH, t, hw, hw, c)
        x, p = inputs(shape)
        reset_launch_counts()
        y1 = ru.ru_conv(x, *p[:2])
        routed = launch_counts()['ru_conv_wgmma']
        err = (y1.float() - ru.conv_ref(x.float(), *f32(p[:2]))).abs().max(
            ).item()
        del y1
        xp = to_channels_first(pad_time_front(x, 2))
        flops, nbytes = ru_launch_costs(shape, p[6].shape[0])['conv']
        row = dict(shape=list(shape), route='wgmma', max_abs_err=err,
                   ms=median_ms(lambda: ru.ru_conv(x, *p[:2]), reps),
                   wmma_ms=median_ms(
                       lambda: ru.ru_conv(x, *p[:2], route='wmma'), reps),
                   library_ms=median_ms(lambda: F.conv3d(
                       xp, p[0], p[1], padding=(0, 1, 1)), reps))
        row['bound_ms'], row['bound_by'] = bound(flops, nbytes)
        row['tflops'] = {k: flops / row[k] / 1e9
                         for k in ('ms', 'wmma_ms', 'library_ms')}
        stages.append(row)
        log(f'[ru conv] {shape} bf16: route wgmma ({routed} launch), max abs '
            f'err {err:.3e}; wgmma {row["ms"]:.4f} ms, WMMA route '
            f'{row["wmma_ms"]:.4f} ms, F.conv3d {row["library_ms"]:.4f} ms, '
            f'bound {row["bound_ms"]:.4f} ms ({row["bound_by"]}); TFLOP/s of '
            f'real taps {row["tflops"]} (median of {reps}) on {smi}')
        if routed != 1:
            fail(f'RU conv {shape}: {routed} wgmma launches, expected 1')
        if not err <= tol:
            fail(f'RU conv {shape}: error {err} > {tol}')
        del x, p, xp
        torch.cuda.empty_cache()
    conv_row = dict(stages[[tuple(s['shape']) for s in stages].index(
        B4_ROW_SHAPE)], plain_ms=conv_split['plain_ms'],
        library_call='F.conv3d on the padded channels-first view',
        per='launch', stages=stages)

    extra = []
    for what, shape, route in RU_EXTRA_CASES:
        row = dict(what=what, shape=list(shape))
        for dtype, want_route in ((torch.float32, 'f32'),
                                  (torch.bfloat16, route)):
            x, p = inputs(shape, dtype)
            reset_launch_counts()
            got = ru.fused_residual_unit_wide(x, *p)
            counts = launch_counts()
            err = (got.float() - ru.residual_unit_ref(
                x.float(), *f32(p))).abs().max().item()
            name = str(dtype).split('.')[-1]
            row[f'max_abs_err_{name}'] = err
            if counts[f'ru_conv_{want_route}'] != 1:
                fail(f'B4 {what} {name}: conv launches '
                     f'{ {k: v for k, v in counts.items() if v} }, expected '
                     f'one on {want_route}')
            if not (err <= RU_TOL[name] and bool(torch.isfinite(got).all())):
                fail(f'B4 {what} {name}: error {err} > {RU_TOL[name]}')
        extra.append(row)
        log(f'[ru cases] B4 {what} {shape}: max abs err float32 '
            f'{row["max_abs_err_float32"]:.3e}, bf16 '
            f'{row["max_abs_err_bfloat16"]:.3e} (conv route {route}; tol '
            f'{RU_TOL})')
    return split, conv_row, extra


# the projection GEMMs of the main path, each twice per roundtrip (encoder
# and decoder), and ragged ones: (what, M, N, K, the route gemm_route must
# pick, timed, the epilogue's scaled columns). Rows: B1 160 frames x 256
# tokens, B3 160 frames x 1024 tokens, whose qkv GEMM scales q (128
# columns) by 8^-1/2 (B2's bf16 projections run inside its own kernel).
GEMM_CASES = (
    ('B1 qkv', 40960, 768, 512, 'wgmma', True, 0),
    ('B1 out', 40960, 512, 256, 'wgmma', True, 0),
    ('B3 qkv', 163840, 384, 256, 'wgmma', True, 128),
    ('B3 out', 163840, 256, 128, 'wgmma', True, 0),
    ('ragged M', 1000, 192, 320, 'wgmma', False, 64),
    ('ragged K', 1000, 200, 100, 'wmma', False, 66),
)
TAYLOR_SCALE = 8 ** -0.5
# B1 at ragged and causal shapes: (frames, L, causal) at the flagship widths
# (C 512, 8 heads x 32, 4 memory keys); 3 frames make rows (3 L) that are
# not a multiple of 64 where L is ragged
SPACE_CASES = tuple((3, L, causal) for L in (1, 17, 100, 256, 1024)
                    for causal in (False, True))


def phase_gemm(torch, dev, reps, smi):
    """The projection GEMM on the route ``gemm_route`` picks, against
    ``torch.matmul`` in float32 (TF32 off) on the same bf16 inputs, held
    relative to the largest value; at the main-path shapes also the WMMA
    route's result, and times of both bf16 routes, the plain version and
    ``F.linear``. Returns the ``wgmma`` route's kernels-line row (at B1's
    qkv shape, every shape under ``shapes``)."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.kernels import gemm
    set_tf32(False)
    gen = torch.Generator(device=dev).manual_seed(31)
    shapes = []
    for what, m, n, k, want_route, timed, scaled in GEMM_CASES:
        a = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        w = (torch.randn(n, k, device=dev, generator=gen)
             * k ** -0.5).bfloat16()
        route = gemm.gemm_route(n, k, a.dtype, a, w)
        if route != want_route:
            fail(f'gemm {what} ({m}, {n}, {k}): route {route}, expected '
                 f'{want_route}')
        want = torch.matmul(a.float(), w.float().t())
        want[:, :scaled] *= TAYLOR_SCALE
        epilogue = dict(scaled_cols=scaled, col_scale=TAYLOR_SCALE)
        got = gemm.gemm_nt(a, w, **epilogue)
        torch.cuda.synchronize()
        row = dict(what=what, shape=[m, n, k], route=route,
                   scaled_cols=scaled,
                   max_abs_err=(got.float() - want).abs().max().item(),
                   max_rel_err=relative_error(got, want))
        held = {route: row['max_rel_err']}
        if timed:
            held['wmma'] = relative_error(
                gemm.gemm_nt(a, w, route='wmma', **epilogue), want)
            flops = 2 * m * n * k
            nbytes = 2 * (m * k + n * k + m * n)
            row.update(
                ms=median_ms(lambda: gemm.gemm_nt(a, w, **epilogue), reps,
                             inner=INNER),
                wmma_ms=median_ms(lambda: gemm.gemm_nt(
                    a, w, route='wmma', **epilogue), reps, inner=INNER),
                plain_ms=median_ms(
                    lambda: gemm.gemm_nt_ref(a, w, **epilogue), reps,
                    inner=INNER),
                library_ms=median_ms(lambda: F.linear(a, w), reps,
                                     inner=INNER),
                library_call='F.linear (bf16 out)', wmma_max_rel_err=held[
                    'wmma'])
            row['bound_ms'], row['bound_by'] = bound(flops, nbytes)
            row['tflops'] = {key: flops / row[key] / 1e9 for key in
                             ('ms', 'wmma_ms', 'library_ms')}
        del a, w, want, got
        log(f'[gemm] {what} ({m}, {n}, {k}), route {route}, {scaled} '
            f'scaled columns: error over the largest value {held} (tol '
            f'{GEMM_TOL:g})' + (
                f'; wgmma {row["ms"]:.4f} ms, WMMA {row["wmma_ms"]:.4f} ms, '
                f'plain {row["plain_ms"]:.4f} ms, F.linear '
                f'{row["library_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms '
                f'({row["bound_by"]}); TFLOP/s {row["tflops"]} (median of '
                f'{reps}, {INNER} calls a timing) on {smi}' if timed else ''))
        for key, err in held.items():
            if not err <= GEMM_TOL:
                fail(f'gemm {what} ({m}, {n}, {k}) route {key}: error '
                     f'{err} of the largest value > {GEMM_TOL}')
        shapes.append(row)
    return dict(shapes[0], per='launch', shapes=shapes)


def phase_space_block(torch, dev, reps, smi):
    """B1 at the flagship shape (bf16, 160 frames x 256 tokens x 512), its
    four launches timed one by one; its core against the plain version on
    the same qkv and against SDPA on the same step; the whole block as a
    sequence of PyTorch calls against the plain version. Then B1 at
    ``SPACE_CASES`` in both dtypes with its launches counted. Returns the
    core's kernels-line row and the split for B1's row."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        axial_attention as ax, gemm, launch_counts, reset_launch_counts)
    set_tf32(False)
    gen = torch.Generator().manual_seed(41)
    g, L, c, heads, dh, m = BATCH * 20, 256, 512, 8, 32, 4
    x = torch.randn(g, L, c, generator=gen).to(dev).bfloat16()
    params = [t.to(dev).bfloat16()
              for t in attn_params(torch, gen, c, heads, dh)]
    gamma, wqkv, mem_kv, wout = params
    mem_k, mem_v = mem_kv[0].contiguous(), mem_kv[1].contiguous()
    core_kw = dict(groups=g, L=L, inner_groups=1, outer_stride=L,
                   pos_stride=1)
    xf = x.reshape(-1, c)

    def core(qkv):
        return ax.attention_core(qkv, mem_k, mem_v, heads, dh, False,
                                 **core_kw)

    xn = gemm.rmsnorm(xf, gamma)
    qkv = gemm.gemm_nt(xn, wqkv)
    attn = core(qkv)
    split = dict(
        rmsnorm=median_ms(lambda: gemm.rmsnorm(xf, gamma), reps,
                          inner=INNER),
        qkv_gemm=median_ms(lambda: gemm.gemm_nt(xn, wqkv), reps,
                           inner=INNER),
        core=median_ms(lambda: core(qkv), reps, inner=INNER),
        out_gemm=median_ms(lambda: gemm.gemm_nt(attn, wout), reps,
                           inner=INNER))
    def plain(dtype):
        return ax.attention_core_ref(
            qkv.to(dtype), mem_k.to(dtype), mem_v.to(dtype), heads, dh,
            False, **core_kw)

    want = plain(torch.float32)
    err = relative_error(attn, want)
    abs_err = (attn.float() - want).abs().max().item()
    del want
    plain_ms = median_ms(lambda: plain(torch.bfloat16), reps, inner=INNER)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(g, L, 3, heads, dh)
               .unbind(2))
    k, v = (torch.cat((mem[None].expand(g, -1, -1, -1), t), dim=2)
            .contiguous() for mem, t in ((mem_k, k), (mem_v, v)))
    q = q.contiguous()
    sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                        reps, inner=INNER)
    seq_err = relative_error(
        space_block_torch(torch, x, *params, heads, dh),
        ax.attention_block_ref(x.float(), *(t.float() for t in params),
                               heads, dh))
    del q, k, v, xn, qkv, attn
    flops = 4 * dh * heads * g * L * (L + m)
    nbytes = 2 * (4 * g * L * heads * dh + 2 * heads * m * dh)
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(shape=[g, heads, L, dh], keys=L + m, per='launch',
               max_rel_err=err, max_abs_err=abs_err, ms=split['core'],
               plain_ms=plain_ms,
               plain_call='attention_core_ref (attend_with_memory) on the same qkv',
               library_ms=sdpa_ms,
               library_call='F.scaled_dot_product_attention, the memory '
                            'keys in front', bound_ms=bound_ms,
               bound_by=bound_by)
    log(f'[space block] ({g}, {L}, {c}) bf16, launch by launch (median of '
        f'{reps}, {INNER} calls a timing): {split} ms, sum {sum(split.values()):.4f} ms; core '
        f'against attention_core_ref in float32 on the same qkv: error over '
        f'the largest value {err:.3e} (tol {TOL["bfloat16"]:g}); core '
        f'{split["core"]:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the same '
        f'step {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); the '
        f'block as a sequence of PyTorch calls against the plain version: '
        f'{seq_err:.3e} of the largest value, on {smi}')
    if not err <= TOL['bfloat16']:
        fail(f'space attention core: error {err} of the largest value > '
             f'{TOL["bfloat16"]}')

    want_counts = {
        'float32': dict(gemm_f32=2, gemm_wgmma=0, gemm_wmma=0,
                        space_attention_core_mma=0),
        'bfloat16': dict(gemm_f32=0, gemm_wgmma=2, gemm_wmma=0,
                         space_attention_core_mma=1)}
    worst = dict.fromkeys(want_counts, 0.0)
    for frames, L, causal in SPACE_CASES:
        x = torch.randn(frames, L, c, generator=gen)
        params = attn_params(torch, gen, c, heads, dh)
        for name, want in want_counts.items():
            args = [t.to(dev, getattr(torch, name)) for t in (x, *params)]
            reset_launch_counts()
            got = ax.attention_block(*args, heads, dh, causal)
            counts = launch_counts()
            err = relative_error(got, ax.attention_block_ref(
                *(a.float() for a in args), heads, dh, causal))
            worst[name] = max(worst[name], err)
            what = f'space block ({frames}, {L}, {c}) causal={causal} {name}'
            if not bool(torch.isfinite(got).all()):
                fail(f'{what}: non-finite output')
            if not err <= TOL[name]:
                fail(f'{what}: error {err} of the largest value > '
                     f'{TOL[name]}')
            if any(counts[key] != n for key, n in want.items()):
                fail(f'{what}: launches {counts}, expected {want}')
    log(f'[space block] {len(SPACE_CASES)} cases (3 frames, L in 1, 17, '
        f'100, 256, 1024, causal and not): worst error over the largest '
        f'value {worst} (tol {TOL})')
    return row, dict(split, library_ms_attention_step=sdpa_ms)


# B2 at shapes the flagship does not reach, on its 'fused' route in bf16
# and its 'launches' route in float32: (B, T, S, C, heads, causal), T = 1,
# 2, 9, 16 at S = 100 not causal, and C = 256 with 8 and 2 heads. On 132
# SMs the wrapper takes 3 pixels a block at T = 1 and 2 and at C = 256 (a
# last tile of 1 pixel), 5 at T = 9 (45 rows) and 3 at T = 16 (48 rows, a
# last tile of 1 pixel)
TIME_CASES = ((3, 1, 100, 512, 8, False), (3, 2, 100, 512, 8, False),
              (16, 9, 100, 512, 8, False), (8, 16, 100, 512, 8, False),
              (3, 5, 100, 256, 8, True), (3, 5, 100, 256, 2, True))
# B2 in bf16 at a shape the fused route refuses (C = 1024): the four
# launches (two wgmma GEMMs) with the scalar core
TIME_LAUNCHES_CASE = (3, 5, 100, 1024, 8, True)
# (T, pixels, C, heads, M) at the edges of what the fused route sends, and
# one past each: time_block_route and the launcher's plan must agree
TIME_EDGES = ((16, 3, 512, 8, 4), (1, 60, 512, 8, 4), (5, 12, 512, 8, 4),
              (5, 12, 64, 2, 0), (17, 1, 512, 8, 4), (1, 61, 512, 8, 4),
              (5, 12, 576, 8, 4), (5, 12, 512, 12, 4), (5, 12, 512, 8, 5),
              (5, 12, 96, 8, 4))
TIME_SHAPE = (BATCH, 5, 256, 512)    # the flagship's time block
TIME_KERNEL = 'time_block_kernel'


def device_ms(torch, fn, calls: int = 20):
    """Device time per call of ``fn`` from torch.profiler's kernel events
    (device events only), and the same by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
    by = {name: us / calls / 1e3 for name, us in by.items()}
    return sum(by.values()), by


def phase_time_block(torch, dev, reps, smi):
    """B2 at the flagship shape ``TIME_SHAPE`` (bf16, causal, 8 heads x 32,
    4 memory keys) on its 'fused' route, one launch: against the plain
    version in float32 and in bf16, timed as event pairs around 10 calls
    and by the profiler's kernel events (so the row says whether the host
    still holds it), beside its bound, the plain version, the whole block as
    PyTorch calls (``time_block_torch``) and SDPA alone, and the bf16 four
    launches on the time layout it replaces; float32 on the 'launches'
    route; a batch boundary that must read exactly 0; the kernel's
    registers, spills and shared memory from ptxas and from the runtime
    (its dynamic shared memory must be what the launcher's plan says); the
    route rule against the launcher at ``TIME_EDGES``; then ``TIME_CASES``
    in both dtypes and ``TIME_LAUNCHES_CASE`` in bf16 with their routes
    counted. Returns the kernels-line row."""
    import re

    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, axial_attention as ax, launch_counts, reset_launch_counts)
    set_tf32(False)
    gen = torch.Generator().manual_seed(47)
    b, t, s, c = TIME_SHAPE
    heads, dh, m = 8, 32, 4
    x32 = torch.randn(TIME_SHAPE, generator=gen).to(dev)
    p32 = [a.to(dev) for a in attn_params(torch, gen, c, heads, dh)]
    x, params = x32.bfloat16(), [a.bfloat16() for a in p32]
    kw = dict(heads=heads, dim_head=dh, causal=True)
    fused_counts = dict(time_attention_block_fused=1,
                        time_attention_block_launches=0, gemm_wgmma=0,
                        gemm_wmma=0, gemm_f32=0)
    launch_counts_f32 = dict(time_attention_block_fused=0,
                             time_attention_block_launches=1, gemm_f32=2,
                             gemm_wgmma=0, gemm_wmma=0)

    def run(args, want, what):
        reset_launch_counts()
        out = ax.time_attention_block(*args, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        if any(counts[key] != n for key, n in want.items()):
            fail(f'{what}: launches {counts}, expected {want}')
        if not bool(torch.isfinite(out).all()):
            fail(f'{what}: non-finite output')
        return out

    got = run([x, *params], fused_counts, 'time block bf16')
    want = ax.time_attention_block_ref(x.float(), *(a.float() for a in params),
                                       **kw)
    err = relative_error(got, want)
    abs_err = (got.float() - want).abs().max().item()
    err_plain16 = relative_error(
        got, ax.time_attention_block_ref(x, *params, **kw))
    got32 = run([x32, *p32], launch_counts_f32, 'time block float32')
    err32 = relative_error(got32, ax.time_attention_block_ref(x32, *p32,
                                                              **kw))
    del got32, want
    both = x[:2]
    boundary = (ax.time_attention_block(both, *params, **kw)[1:]
                - ax.time_attention_block(both[1:].contiguous(), *params,
                                          **kw)).abs().max().item()

    mask = memory_mask(torch, t, m, dev)
    seq_err = relative_error(
        time_block_torch(torch, x, *params, heads, dh, mask),
        ax.time_attention_block_ref(x.float(), *(a.float() for a in params),
                                    **kw))
    q, k, v = (torch.randn(b * s, heads, t + keys, dh, generator=gen)
               .to(dev).bfloat16() for keys in (0, m, m))

    def timed(fn):
        return median_ms(fn, reps, inner=INNER)

    fused = lambda: ax.time_attention_block(x, *params, **kw)
    four = lambda: ax.block_launches(x, *params, **kw,
                                     **ax.time_layout(x))
    row = dict(
        shape=list(TIME_SHAPE), per='launch', kernel_route='fused',
        max_abs_err=abs_err, max_rel_err=err, max_rel_err_fp32=err32,
        max_rel_err_vs_bf16_plain=err_plain16, batch_boundary_err=boundary,
        ms=timed(fused), device_ms=device_ms(torch, fused)[0],
        plain_ms=timed(lambda: ax.time_attention_block_ref(x, *params, **kw)),
        library_ms=timed(lambda: time_block_torch(torch, x, *params, heads,
                                                  dh, mask)),
        library_call='a sequence of PyTorch calls: F.rms_norm, F.linear, '
                     'the permute to (B S, T, .), torch.cat of the memory '
                     'keys, F.scaled_dot_product_attention with the causal '
                     'memory mask, F.linear, the permute back',
        library_ms_attention_step=timed(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        launches_ms=timed(four), launches_device_ms=device_ms(torch, four)[1],
        ms_fp32=timed(lambda: ax.time_attention_block(x32, *p32, **kw)),
        plain_ms_fp32=timed(lambda: ax.time_attention_block_ref(x32, *p32,
                                                                **kw)),
        calls_per_timing=INNER)
    row['bound_ms'], row['bound_by'] = bound(*attention_cost(
        b * s, t, c, heads, dh, m, True))
    ptxas = [ln for lines in ptxas_lines(_build.build_info.get('log', ''),
                                         TIME_KERNEL).values()
             for ln in lines]
    spills = [ln for ln in ptxas for st, ld in re.findall(
        r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
        if int(st) or int(ld)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pixels = ax.time_block_pixels(b, t, s, sms)
    plan = ax.time_block_plan(t, pixels, c, heads, m)
    fused()     # the flagship's launch is the last to set the kernel's
    torch.cuda.synchronize()        # dynamic shared memory
    attrs = ax.time_block_attributes()
    row.update(ptxas=ptxas, pixels_per_block=pixels,
               ring_stages=plan['stages'], **attrs)
    log(f'[time block] {TIME_SHAPE} bf16 causal on the fused route, one '
        f'launch: error over the largest value {err:.3e} against the plain '
        f'version in float32 (tol {TOL["bfloat16"]:g}), {err_plain16:.3e} '
        f'against it in bf16; float32 on the launches route {err32:.3e} '
        f'(tol {TOL["float32"]:g}); batch boundary {boundary}; kernel '
        f'{row["ms"]:.4f} ms ({INNER} calls an event pair, median of '
        f'{reps}), device {row["device_ms"]:.4f} ms (profiler kernel '
        f'events), bound {row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
        f'plain {row["plain_ms"]:.4f} ms, the block as PyTorch calls '
        f'{row["library_ms"]:.4f} ms (against the plain version '
        f'{seq_err:.3e}), SDPA alone (the attention step) '
        f'{row["library_ms_attention_step"]:.4f} ms; the four launches it '
        f'replaces {row["launches_ms"]:.4f} ms, device '
        f'{row["launches_device_ms"]}; fp32 (launches) '
        f'{row["ms_fp32"]:.4f} ms, plain {row["plain_ms_fp32"]:.4f} ms; '
        f'on {smi}')
    log(f'[ptxas] {TIME_KERNEL}: {"; ".join(ptxas)}; at the flagship '
        f'{pixels} pixels a block (the wrapper\'s), the runtime\'s '
        f'attributes {attrs}, the launcher\'s plan {plan}')
    if attrs['dynamic_smem_bytes'] != plan['dynamic_smem_bytes']:
        fail(f'{TIME_KERNEL}: the runtime reports '
             f'{attrs["dynamic_smem_bytes"]} B of dynamic shared memory, '
             f'the launcher plans {plan["dynamic_smem_bytes"]} B')
    if attrs['local_bytes']:
        fail(f'{TIME_KERNEL}: {attrs["local_bytes"]} B of local memory a '
             f'thread')
    edges = []
    for et, ep, ec, eh, em in TIME_EDGES:
        routed = (ep * et <= ax.TIME_MAX_ROWS and ax.time_block_route(
            torch.bfloat16, et, 256, ec, eh, dh, em) == 'fused')
        planned = ax.time_block_plan(et, ep, ec, eh, em)
        edges.append(planned and planned['stages'])
        if routed != (planned is not None):
            fail(f'time block at (T, pixels, C, heads, M) = '
                 f'{(et, ep, ec, eh, em)}: the route says fused={routed}, '
                 f'the launcher plans {planned}')
    lib = _build.load_library()
    refused = lib.mv2_time_attention_block(
        x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
        params[2][0].data_ptr(), params[2][1].data_ptr(),
        params[3].data_ptr(), x.data_ptr(), _build.dtype_code(x), b, t, s,
        c, heads, dh, m, pixels, 1, ax.TIME_ROUTES['launches'],
        _build.stream_handle(dev))
    log(f'[time block] the route rule and the launcher agree at '
        f'{TIME_EDGES} (T, pixels, C, heads, M): ring stages {edges} (None '
        f'refused); the C entry point on the launches route returns '
        f'{refused}')
    if refused == 0:
        fail('time block: the C entry point took the launches route')
    if not err <= TOL['bfloat16']:
        fail(f'time block bf16: error {err} of the largest value > '
             f'{TOL["bfloat16"]}')
    if not err32 <= TOL['float32']:
        fail(f'time block float32: error {err32} of the largest value > '
             f'{TOL["float32"]}')
    if boundary != 0.0:
        fail(f'time block: batch element 1 differs alone and in a batch of '
             f'two by {boundary}')
    if spills:
        fail(f'{TIME_KERNEL} spills: {spills}')
    if _build.build_info.get('log') not in (None, '(cached)') and not ptxas:
        fail(f'ptxas lines missing from the build log for {TIME_KERNEL}')

    launch_counts_bf16 = dict(time_attention_block_fused=0,
                              time_attention_block_launches=1, gemm_wgmma=2,
                              gemm_wmma=0, gemm_f32=0)
    worst = {'float32': 0.0, 'bfloat16': 0.0, 'bfloat16_launches': 0.0}
    tilings = []
    runs = [(case, name, want) for case in TIME_CASES
            for name, want in (('bfloat16', fused_counts),
                               ('float32', launch_counts_f32))]
    runs.append((TIME_LAUNCHES_CASE, 'bfloat16_launches',
                 dict(time_attention_block_fused=0,
                      time_attention_block_launches=1, gemm_wgmma=2,
                      gemm_wmma=0, gemm_f32=0)))
    for (bb, tt, ss, cc, hh, causal), name, want_counts in runs:
        dtype = 'float32' if name == 'float32' else 'bfloat16'
        if name != 'float32':   # new inputs a case; float32 takes them too
            xc = torch.randn(bb, tt, ss, cc, generator=gen)
            pc = attn_params(torch, gen, cc, hh, dh)
        if name == 'bfloat16':
            pix = ax.time_block_pixels(bb, tt, ss, sms)
            tilings.append((pix, ax.time_block_plan(tt, pix, cc, hh,
                                                    m)['stages']))
        args = [a.to(dev, getattr(torch, dtype)) for a in (xc, *pc)]
        what = (f'time block {(bb, tt, ss, cc)} {hh} heads causal={causal} '
                f'{name}')
        reset_launch_counts()
        got = ax.time_attention_block(*args, hh, dh, causal)
        torch.cuda.synchronize()
        counts = launch_counts()
        if any(counts[k] != n for k, n in want_counts.items()):
            fail(f'{what}: launches {counts}, expected {want_counts}')
        if not bool(torch.isfinite(got).all()):
            fail(f'{what}: non-finite output')
        e = relative_error(got, ax.time_attention_block_ref(
            *(a.float() for a in args), hh, dh, causal))
        worst[name] = max(worst[name], e)
        if not e <= TOL[dtype]:
            fail(f'{what}: error {e} of the largest value > {TOL[dtype]}')
    row['cases_worst'] = worst
    log(f'[time block] {len(TIME_CASES)} cases {TIME_CASES} (B, T, S, C, '
        f'heads, causal), bf16 fused and float32 launches, each route '
        f'counted, their tilings {tilings} (pixels a block, ring stages); '
        f'bf16 at {TIME_LAUNCHES_CASE} on the launches: worst error over '
        f'the largest value {worst} (tol {TOL})')
    return row


# B3 at shapes the flagship does not reach: (frames, N) at the flagship
# widths (C 256, 16 heads x 8); N = 1, 144 and 1000 leave the last 64-token
# chunk and 16-token tile part empty, 4096 is a 64 x 64 frame
TAYLOR_CASES = ((3, 1), (3, 144), (3, 1000), (2, 4096))
# the small tokenizer of the dim_head = 16 roundtrip (the block's gate sends
# that head size to the plain version on both devices)
TAYLOR_D16 = dict(image_size=32, init_dim=32, codebook_size=64,
                  layers=('residual', 'compress_space', 'linear_attend_space',
                          'compress_time', 'linear_attend_space'),
                  linear_attn_dim_head=16, linear_attn_heads=4,
                  use_gan=False, perceptual_loss_weight=0.0)


def taylor_inputs(torch, gen, frames, n, c=256, heads=16, dh=8):
    """x (frames, n, C) and the block's parameters, float32 on the CPU."""
    return [torch.randn(frames, n, c, generator=gen),
            1 + 0.1 * torch.randn(c, generator=gen),
            uniform(torch, gen, (3 * heads * dh, c), c),
            uniform(torch, gen, (c, heads * dh), heads * dh)]


def phase_taylor_block(torch, dev, reps, smi):
    """B3 at the flagship shape (bf16, 160 frames x 1024 tokens x 256, 16
    heads x 8), its four launches timed one by one, the GEMMs beside
    ``F.linear``; its core against the plain version on the same qkv (in
    float32 and in bf16), with TFLOP/s and GB/s. Then B3 at
    ``TAYLOR_CASES`` in both dtypes with its launches counted, the batch
    boundary in both dtypes, and ``TaylorSeriesLinearAttn(dim_head=16)``
    (the gate's plain version) against the CPU. Returns the core's
    kernels-line row and the split for B3's row."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops import attention
    from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        gemm, launch_counts, reset_launch_counts, taylor_attention as ta)
    set_tf32(False)
    gen = torch.Generator().manual_seed(43)
    g, n, c, heads, dh = BATCH * 20, 1024, 256, 16, 8
    hd = heads * dh
    x, gamma, wqkv, wout = (t.to(dev).bfloat16()
                            for t in taylor_inputs(torch, gen, g, n))
    xf = x.reshape(-1, c)
    epilogue = dict(scaled_cols=hd, col_scale=dh ** -0.5)
    xn = gemm.rmsnorm(xf, gamma)
    qkv = gemm.gemm_nt(xn, wqkv, **epilogue)
    attn = ta.taylor_core(qkv, g, heads, dh)

    def timed(fn):
        return median_ms(fn, reps, inner=INNER)

    split = dict(
        rmsnorm=timed(lambda: gemm.rmsnorm(xf, gamma)),
        qkv_gemm=timed(lambda: gemm.gemm_nt(xn, wqkv, **epilogue)),
        core=timed(lambda: ta.taylor_core(qkv, g, heads, dh)),
        out_gemm=timed(lambda: gemm.gemm_nt(attn, wout)))
    library = dict(
        rmsnorm=timed(lambda: F.rms_norm(xf, (c,), gamma)),
        qkv_gemm=timed(lambda: F.linear(xn, wqkv)),
        out_gemm=timed(lambda: F.linear(attn, wout)))
    plain = dict(
        rmsnorm=timed(lambda: gemm.rmsnorm_ref(xf, gamma)),
        qkv_gemm=timed(lambda: gemm.gemm_nt_ref(xn, wqkv, **epilogue)),
        out_gemm=timed(lambda: gemm.gemm_nt_ref(attn, wout)))
    # each launch against its plain version in float32 on the same inputs
    launch_err = dict(
        rmsnorm=relative_error(xn, gemm.rmsnorm_ref(xf.float(),
                                                    gamma.float())),
        qkv_gemm=relative_error(qkv, gemm.gemm_nt_ref(
            xn.float(), wqkv.float(), **epilogue)),
        out_gemm=relative_error(gemm.gemm_nt(attn, wout),
                                gemm.gemm_nt_ref(attn.float(),
                                                 wout.float())))
    rows = g * n
    launch_cost = dict(   # FLOPs, bytes: each input read once, output once
        rmsnorm=(3 * rows * c, 2 * (2 * rows * c + c)),
        qkv_gemm=(2 * rows * c * 3 * hd,
                  2 * (rows * c + 3 * hd * c + rows * 3 * hd)),
        core=(rows * heads * (4 * dh ** 3 + 8 * dh * dh + 2 * dh),
              2 * (rows * 3 * hd + rows * hd)),
        out_gemm=(2 * rows * hd * c, 2 * (rows * hd + c * hd + rows * c)))
    bounds = {k: bound(*v) for k, v in launch_cost.items()}

    want = ta.taylor_core_ref(qkv.float(), g, heads, dh)
    err = relative_error(attn, want)
    abs_err = (attn.float() - want).abs().max().item()
    del want
    want16 = ta.taylor_core_ref(qkv, g, heads, dh)
    err16 = relative_error(attn, want16)
    share16 = (attn != want16).float().mean().item()
    del want16
    plain_ms = timed(lambda: ta.taylor_core_ref(qkv, g, heads, dh))
    flops, nbytes = launch_cost['core']
    bound_ms, bound_by = bounds['core']
    row = dict(shape=[g, n, heads, dh], per='launch', max_rel_err=err,
               max_abs_err=abs_err, max_rel_err_bf16_plain=err16,
               differing_share_bf16_plain=share16, ms=split['core'],
               plain_ms=plain_ms,
               plain_call='taylor_core_ref (bf16 casts) on the same qkv',
               library_ms=None, library_call=None, bound_ms=bound_ms,
               bound_by=bound_by, tflops=flops / split['core'] / 1e9,
               gbytes_per_s=nbytes / split['core'] / 1e6)
    log(f'[taylor block] ({g}, {n}, {c}) bf16, launch by launch (median of '
        f'{reps}, {INNER} calls a timing): {split} ms, sum '
        f'{sum(split.values()):.4f} ms; bounds {bounds}; plain versions '
        f'{plain} ms; PyTorch calls for the same launches (F.rms_norm, '
        f'F.linear) {library} ms; norm and GEMMs against their plain '
        f'versions in float32, over the largest value: {launch_err} (tol '
        f'{TOL["bfloat16"]:g}); core '
        f'against taylor_core_ref in float32 on the same qkv: error over '
        f'the largest value {err:.3e} (tol {TOL["bfloat16"]:g}); against '
        f'the bf16 plain version {err16:.3e}, {share16:.4%} of values '
        f'differ; core {split["core"]:.4f} ms ({row["tflops"]:.1f} TFLOP/s '
        f'of the moment work, {row["gbytes_per_s"]:.0f} GB/s of q, k, v and '
        f'the output), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms '
        f'({bound_by}), on {smi}')
    for what, e in (*launch_err.items(), ('core', err)):
        if not e <= TOL['bfloat16']:
            fail(f'taylor block, {what} launch: error {e} of the largest '
                 f'value > {TOL["bfloat16"]}')
    del x, xf, xn, qkv, attn

    want_counts = {
        'float32': dict(gemm_f32=2, gemm_wgmma=0, gemm_wmma=0,
                        taylor_core_mma=0, taylor_core_f32=1),
        'bfloat16': dict(gemm_f32=0, gemm_wgmma=2, gemm_wmma=0,
                         taylor_core_mma=1, taylor_core_f32=0)}
    worst = dict.fromkeys(want_counts, 0.0)
    boundary = {}
    for frames, n in TAYLOR_CASES:
        inputs = taylor_inputs(torch, gen, frames, n)
        for name, want_n in want_counts.items():
            args = [t.to(dev, getattr(torch, name)) for t in inputs]
            reset_launch_counts()
            got = ta.taylor_attention(*args, heads, dh)
            counts = launch_counts()
            err = relative_error(got, ta.taylor_attention_ref(
                *(a.float() for a in args), heads, dh))
            worst[name] = max(worst[name], err)
            what = f'taylor block ({frames}, {n}, {c}) {name}'
            if not bool(torch.isfinite(got).all()):
                fail(f'{what}: non-finite output')
            if not err <= TOL[name]:
                fail(f'{what}: error {err} of the largest value > '
                     f'{TOL[name]}')
            if any(counts[key] != v for key, v in want_n.items()):
                fail(f'{what}: launches {counts}, expected {want_n}')
            if n == 1000:
                # frame 1 alone equals its place in a batch of two, to the
                # bit: the core sums each frame in a fixed order
                boundary[name] = (
                    ta.taylor_attention(args[0][:2], *args[1:], heads, dh)[1:]
                    - ta.taylor_attention(args[0][1:2], *args[1:], heads, dh)
                ).abs().max().item()
    log(f'[taylor block] {len(TAYLOR_CASES)} cases ((frames, N) in '
        f'{TAYLOR_CASES}): worst error over the largest value {worst} (tol '
        f'{TOL}); batch boundary at N = 1000 {boundary}')
    if any(v != 0.0 for v in boundary.values()):
        fail(f'taylor block: frame 1 differs alone and in a batch of two by '
             f'{boundary}')

    # dim_head = 16: the gate's plain version on the card against the CPU
    module = attention.TaylorSeriesLinearAttn(c, dim_head=16, heads=8)
    init_module_parameters(module, torch.Generator().manual_seed(5))
    xs, gs = taylor_inputs(torch, gen, 4, 256)[:2]
    errs = {}
    for name in ('float32', 'bfloat16'):     # bf16 rounds the weights
        dt = getattr(torch, name)
        reset_launch_counts()
        card = module.to(dev, dt)(xs.to(dev, dt), gs.to(dev, dt))
        if any(launch_counts().values()):
            fail(f'TaylorSeriesLinearAttn(dim_head=16) {name} launched '
                 f'{launch_counts()}: the gate sends it to the plain version')
        # the CPU in float32 on the same (rounded) inputs and weights
        cpu = module.to('cpu', torch.float32)(xs.to(dt).float(),
                                              gs.to(dt).float())
        errs[name] = relative_error(card, cpu)
        if not errs[name] <= TOL[name]:
            fail(f'TaylorSeriesLinearAttn(dim_head=16) {name}: card against '
                 f'CPU {errs[name]} of the largest value > {TOL[name]}')
    log(f'[taylor block] TaylorSeriesLinearAttn(256, dim_head=16, heads=8) '
        f'on (4, 256, 256), card against CPU, no kernel launched: error '
        f'over the largest value {errs} (tol {TOL})')
    return row, dict(split, bounds_ms={k: v[0] for k, v in bounds.items()},
                     plain_ms=plain, library_ms=library,
                     launch_errors=launch_err, batch_boundary=boundary,
                     cases_worst=worst, dim_head_16=errs)


def phase_taylor_roundtrip(torch, dev):
    """A small tokenizer with ``linear_attn_dim_head=16`` through
    ``tokenize`` and ``decode_from_code_indices`` on the card: bf16 shapes
    and finite values, and float32 (TF32 off) against the CPU on the same
    weights and input; no Taylor kernel launches (the gate)."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    set_tf32(False)
    video = torch.rand(2, 5, 32, 32, 3,
                       generator=torch.Generator().manual_seed(3))
    out = {}
    for where, dt in (('cpu', torch.float32), ('card', torch.float32),
                      ('card', torch.bfloat16)):
        tok = VideoTokenizer(seed=0, device=dev if where == 'card' else 'cpu',
                             dtype=dt, **TAYLOR_D16)
        reset_launch_counts()
        codes = tok.tokenize(video)
        # float32 on the card decodes the CPU's codes (a flipped code would
        # hide the decoder's agreement)
        given = out[('cpu', dt)][0] if ('cpu', dt) in out else codes
        recon = tok.decode_from_code_indices(
            given.to(codes.device).reshape(2, -1))
        taylor = {k: v for k, v in launch_counts().items()
                  if k.startswith('taylor')}
        if any(taylor.values()):
            fail(f'dim_head=16 roundtrip ({where}, {dt}): Taylor launches '
                 f'{taylor}')
        if (tuple(recon.shape) != (2, 5, 32, 32, 3)
                or not bool(torch.isfinite(recon).all())):
            fail(f'dim_head=16 roundtrip ({where}, {dt}): recon '
                 f'{tuple(recon.shape)}, finite '
                 f'{bool(torch.isfinite(recon).all())}')
        out[(where, dt)] = (codes.cpu(), recon.float().cpu())
    (c_cpu, r_cpu), (c_card, r_card) = (out[('cpu', torch.float32)],
                                        out[('card', torch.float32)])
    same = (c_card == c_cpu).float().mean().item()
    err = (r_card - r_cpu).abs().max().item()
    log(f'[taylor roundtrip] linear_attn_dim_head=16, (2, 5, 32, 32, 3): '
        f'bf16 on the card codes '
        f'{tuple(out[("card", torch.bfloat16)][0].shape)}, finite; float32 '
        f'card against CPU: {same:.2%} of codes equal, recon from the same '
        f'codes max abs err {err:.3e}')
    if same < 0.99 or not err <= 1e-3:
        fail(f'dim_head=16 roundtrip: card against CPU {same:.2%} of codes '
             f'equal, recon {err}')
    return dict(codes_equal=same, recon_max_abs_err=err)


def phase_in_situ(torch, tok, video):
    """bf16, the default path's tokenizer and input, encoded and decoded
    with the attention blocks and with ``MAGVIT2_TPU_NO_FUSED_ATTN=1``
    (space and time attention on the general plain path): latents, code
    bits and the reconstruction from the plain run's codes, and the
    launches of encode + decode on each."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    runs = {}
    for name, env, want in (
            ('plain', {'MAGVIT2_TPU_NO_FUSED_ATTN': '1'}, IN_SITU_PLAIN),
            ('blocks', {}, BLOCKS)):
        with environment(env):
            reset_launch_counts()
            lat = tok.encode(video)
            with torch.inference_mode():
                codes = tok.module.quantize(lat).indices
            codes_plain = runs['plain']['codes'] if runs else codes
            recon = tok.decode_from_code_indices(codes_plain)
            torch.cuda.synchronize()
            counts = launch_counts()
        runs[name] = dict(lat=lat, codes=codes, recon=recon)
        if any(counts[key] != n for key, n in want.items()):
            fail(f'in-situ check, {name}: encode + decode launched {counts}, '
                 f'expected {want}')
    plain, blocks = runs['plain'], runs['blocks']
    quantizer = tok.module.quantizers
    margins = decision_margins(torch, quantizer, plain['lat'])
    frac, worst = flips(code_digits(torch, quantizer, plain['codes']),
                        code_digits(torch, quantizer, blocks['codes']), margins)
    got = dict(latents=relative_error(blocks['lat'], plain['lat']),
               bits_flipped=frac,
               worst_flip_margin=worst / margins.max().item(),
               recon=relative_error(blocks['recon'], plain['recon']))
    log(f'[in situ] bf16 batch {BATCH}, blocks against the general plain '
        f'path: latents {got["latents"]:.3e} of the largest value, code '
        f'bits flipped {got["bits_flipped"]:.4%} (worst margin '
        f'{got["worst_flip_margin"]:.3e} of the largest |z|), recon from the '
        f'same codes {got["recon"]:.3e} of the largest value (tol '
        f'{IN_SITU_TOL})')
    for key, tol in IN_SITU_TOL.items():
        if not got[key] <= tol:
            fail(f'in-situ check: {key} {got[key]} > {tol}')
    return got


@contextlib.contextmanager
def timed_ru_calls(torch):
    """For the block, record every call of the ResidualUnit wrappers with
    its input shape and CUDA events around it (the launch counts stay the
    wrappers' own)."""
    from magvit2_pytorch_tpu_torch.ops.kernels import residual_unit as ru
    calls, real = [], {n: getattr(ru, n) for n in RU_WRAPPERS}

    def spy(name, fn):
        def call(x, *args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(x, *args, **kw)
            end.record()
            calls.append((RU_WRAPPERS[name], tuple(x.shape), start, end))
            return out
        return call

    for name, fn in real.items():
        setattr(ru, name, spy(name, fn))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ru, name, fn)


def ru_calls_by_shape(calls):
    """(kernel, input shape) -> [calls, summed ms]; after a synchronize."""
    out = {}
    for name, shape, start, end in calls:
        entry = out.setdefault((name, shape), [0, 0.0])
        entry[0] += 1
        entry[1] += start.elapsed_time(end)
    return out


def ru_calls_expected(path):
    """(kernel, input shape) -> calls per roundtrip on ``path``: B4 at each
    stage as ``RU_STAGES`` says, B5 on the unpacked stem activation."""
    if path == 'default':
        return {}
    want = {('residual_unit_wide', (BATCH, t, hw, hw, c)): n
            for c, t, hw, n in RU_STAGES if n}
    t, hw = PACKED_STEM
    want[('residual_unit_packed', (BATCH, t, hw, hw, 64))] = 2
    return want


def flagship_tokenizer(torch, device, dtype, **overrides):
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    return VideoTokenizer(seed=0, device=device, dtype=dtype,
                          **readme_video_tokenizer_kwargs(
                              use_gan=False, perceptual_loss_weight=0.0,
                              **overrides))


@contextlib.contextmanager
def environment(env: dict):
    """Set ``env`` for the block and restore what was there before."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def whole_roundtrip(tok, video, cond=None):
    """``tokenize`` and ``decode_from_code_indices`` of the flattened codes,
    the user's whole-clip roundtrip: (codes, reconstruction)."""
    codes = tok.tokenize(video, cond=cond)
    return codes, tok.decode_from_code_indices(
        codes.reshape(codes.shape[0], -1), cond=cond)


def phase_roundtrip(torch, what, tok, video, codes_shape, launches,
                    ru_shapes, cond=None):
    """One bf16 roundtrip of ``video`` (a batch of clips, or of images)
    through the user's entry points, ``tokenize`` and
    ``decode_from_code_indices``, the launch counts set to 0 just before and
    read just after, and the ResidualUnit kernels' calls by shape; then a
    second, warm roundtrip times each of those calls with CUDA events. Fails
    unless the codes are integers of ``codes_shape`` in the codebook, the
    reconstruction is finite and of the input's shape (a frame axis added
    for images), the launches are ``launches`` and the calls by shape
    ``ru_shapes``. ``cond``: the cond vector of a conditioned config.
    Returns the counts and each RU kernel's summed ms in the warm run."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    n = video.shape[0]
    recon_shape = (tuple(video.shape) if video.dim() == 5
                   else (n, 1, *video.shape[1:]))

    torch.cuda.synchronize()
    with timed_ru_calls(torch) as calls:
        reset_launch_counts()
        t0 = time.perf_counter()
        codes, recon = whole_roundtrip(tok, video, cond)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    by_shape = {k: c for k, (c, _) in ru_calls_by_shape(calls).items()}
    with timed_ru_calls(torch) as calls:
        whole_roundtrip(tok, video, cond)
        torch.cuda.synchronize()
    ru_ms = {}
    for (name, shape), (calls_n, ms) in sorted(
            ru_calls_by_shape(calls).items()):
        ru_ms[name] = ru_ms.get(name, 0.0) + ms
        log(f'[{what}] {name} {shape}: {calls_n} calls, {ms:.4f} ms '
            '(warm roundtrip, CUDA events around each call)')
    log(f'[{what}] bf16 batch {n}: codes {tuple(codes.shape)} {codes.dtype}, '
        f'recon {tuple(recon.shape)} {recon.dtype}, {seconds:.3f} s (first '
        f'call), launches {counts}, ResidualUnit kernels in the warm '
        f'roundtrip {ru_ms} ms')
    if by_shape != ru_shapes:
        fail(f'{what}: ResidualUnit kernel calls by shape {by_shape}, '
             f'expected {ru_shapes}')
    if tuple(codes.shape) != codes_shape or codes.is_floating_point():
        fail(f'{what}: codes {tuple(codes.shape)} {codes.dtype}, expected '
             f'{codes_shape}')
    if not bool(((codes >= 0) & (codes < tok.codebook_size)).all()):
        fail(f'{what}: codes outside [0, {tok.codebook_size})')
    if tuple(recon.shape) != recon_shape:
        fail(f'{what}: recon shape {tuple(recon.shape)}, expected '
             f'{recon_shape}')
    if not bool(torch.isfinite(recon).all()):
        fail(f'{what}: recon has non-finite values')
    check_launches(f'{what} roundtrip', counts, launches)
    return counts, ru_ms


def phase_card_vs_cpu(torch, dev):
    """Both flagship card paths against one CPU float32 reference
    (``card_against_cpu``; the CPU's math does not depend on lane_pack or
    the fused gates), and on each path the float32 routes: every time block
    on its launches route, fused units on the fused path only, each fused
    unit's conv on the f32 route."""
    clip = torch.rand(1, 17, 128, 128, 3,
                      generator=torch.Generator().manual_seed(7))
    results, counts = card_against_cpu(
        torch, dev, 'flagship', lambda device, path: flagship_tokenizer(
            torch, device, torch.float32, lane_pack=path == 'fused'), clip,
        paths=(('default', {}), ('fused', FUSED_ENV)))
    for path, c in counts.items():
        fused_launches = c['residual_unit_wide'] + c['residual_unit_packed']
        if (path == 'fused') != (fused_launches > 0):
            fail(f'{path} card path: {fused_launches} ResidualUnit kernel '
                 'launches')
        if not (c['time_attention_block_launches']
                == c['time_attention_block'] > 0):
            fail(f'{path} card path, float32: of {c["time_attention_block"]} '
                 f'time blocks {c["time_attention_block_launches"]} took the '
                 'launches route, expected all')
        if c['ru_conv_f32'] != fused_launches:
            fail(f'{path} card path, float32: {c["ru_conv_f32"]} convs on the '
                 f'f32 route for {fused_launches} fused units')
    return results


def phase_throughput(torch, tok, video, n_short=2, n_long=10, cond=None):
    """Frames (images, for a one-frame clip) per second of chained bf16
    roundtrips, by the slope of ``n_long`` against ``n_short`` runs."""
    module = tok.module
    x0 = video.to(torch.bfloat16)
    if cond is not None:
        cond = cond.to(torch.bfloat16)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            v = x0
            for i in range(n):
                recon, _ = module(v, cond=cond)
                v = recon + 1e-6 * i      # data dependency across iterations
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(n_short)                          # warm up
    t_short, t_long = run(n_short), run(n_long)
    per_iter = (t_long - t_short) / (n_long - n_short)
    fps = video.shape[0] * video.shape[1] / per_iter
    return dict(fps=fps, ms_per_roundtrip=per_iter * 1e3,
                t_short=t_short, t_long=t_long)


def profile_roundtrip(torch, tok, video, path, slope_ms, cond=None):
    """One bf16 roundtrip under torch.profiler: the device time of its
    kernels (device events only, so no operator row counts its kernels a
    second time), their share of ``slope_ms`` (the unprofiled roundtrip time
    from the throughput phase), and a table by kernel in ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = video.to(torch.bfloat16)
    if cond is not None:
        cond = cond.to(torch.bfloat16)
    with torch.inference_mode():
        tok.module(x, cond=cond)          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tok.module(x, cond=cond)
            torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    table = prof.key_averages().table(sort_by='self_device_time_total',
                                      row_limit=60)
    busy = device_us / 1e3 / slope_ms
    with open(path, 'w') as f:
        f.write(f'device events {device_us / 1e3:.3f} ms per roundtrip, '
                f'{busy:.1%} of the {slope_ms:.3f} ms slope time\n{table}\n')
    log(f'[profile] one bf16 roundtrip: device events {device_us / 1e3:.2f} '
        f'ms, {busy:.1%} of the unprofiled {slope_ms:.2f} ms per roundtrip; '
        f'table in {path}')


def drive_path(torch, dev, path, smi, profile_dir):
    """Phases 4 and 5: one path's roundtrip of the flagship, bf16, batch
    ``BATCH``, its frames/s, the default path's in-situ check, its
    profile."""
    tok = flagship_tokenizer(torch, dev, torch.bfloat16,
                             lane_pack=path == 'fused')
    gen = torch.Generator(device=dev).manual_seed(0)
    video = torch.rand(BATCH, 17, 128, 128, 3, generator=gen, device=dev)
    counts, ru_ms = phase_roundtrip(
        torch, f'roundtrip {path}', tok, video, (BATCH, 5, 16, 16),
        LAUNCHES[path], ru_calls_expected(path))
    tp = phase_throughput(torch, tok, video)
    log(f'[throughput {path}] bf16 batch {BATCH} roundtrip: '
        f'{tp["fps"]:.2f} frames/s ({tp["ms_per_roundtrip"]:.2f} ms per '
        f'roundtrip; slope of 2 vs 10 chained runs) on {smi}')
    if path == 'default':
        tp['in_situ'] = phase_in_situ(torch, tok, video)
    if profile_dir:
        name = 'profile.txt' if path == 'default' else f'profile_{path}.txt'
        profile_roundtrip(torch, tok, video, os.path.join(profile_dir, name),
                          tp['ms_per_roundtrip'])
    del tok, video
    torch.cuda.empty_cache()
    return counts, dict(tp, ru_ms=ru_ms)


def visible_pairs(bh, n, m, causal):
    """The (query, key) pairs a flash call computes: with causal, row i sees
    keys 0 .. i + m - n."""
    return bh * sum(min(m, i + 1 + m - n) if causal else m for i in range(n))


def flash_cost(bh, n, m, d, causal, kernel):
    """FLOPs and bytes of one flash-attention kernel in bf16 over the
    visible (query, key) pairs only: the forward forms S and P V (4 d per
    pair), dQ forms S, dP and dS K (6 d), dK/dV forms S, P^T dO, dP and
    dS^T Q (8 d); every input read once, every output written once (q, k,
    v, dO and the outputs in bf16, lse and delta in float32)."""
    pairs = visible_pairs(bh, n, m, causal)
    qo, kv, rows = 2 * bh * n * d, 2 * bh * m * d, 4 * bh * n
    if kernel == 'flash_attention_fwd':
        return 4 * d * pairs, 2 * qo + 2 * kv + rows
    if kernel == 'flash_attention_bwd_dq':
        return 6 * d * pairs, 3 * qo + 2 * kv + 2 * rows
    return 8 * d * pairs, 2 * qo + 4 * kv + 2 * rows


def exp_floor_ms(torch, pairs):
    """The least time (ms) for one ex2 a pair on the special-function units
    of every SM at the card's largest SM clock (nvidia-smi clocks.max.sm): a
    floor of the forward beside the bound, which counts products and bytes
    only."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs / (sms * EX2_PER_CLOCK * hz) * 1e3


def flash_inputs(torch, dev, dtype, b, h, n, m, d, bias_kind, seed):
    """q, k, v, dO and the bias (or None) from a seed, N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)]
    if bias_kind:
        shapes.append({'nm': (n, m), 'hnm': (h, n, m),
                       'bhnm': (b, h, n, m)}[bias_kind])
    ts = [torch.randn(s, generator=gen).to(dev).to(dtype) for s in shapes]
    return ts if bias_kind else ts + [None]


def flash_errors(torch, fa, q, k, v, dout, bias, causal, frames=None):
    """Errors of the wrapper's output, lse and gradients against the plain
    forward and backward in float32 on the same inputs: for each tensor the
    max abs error and that error over the largest value of the reference
    (``flash_relative`` makes one dict of the two), and the launch counts of
    the wrapper's forward and backward. The forward kernel alone then gives
    lse, and its output must equal the wrapper's bit for bit. With
    ``frames`` the plain version runs that many batch elements at a time."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    b, h, n, d = q.shape
    m = k.shape[2]
    scale = d ** -0.5
    ins = [t.detach().clone().requires_grad_()
           for t in (q, k, v) + ((bias,) if bias is not None else ())]
    reset_launch_counts()
    out = fa.flash_attention(*ins[:3], causal=causal,
                             bias=ins[3] if bias is not None else None)
    grads = torch.autograd.grad(out, ins, dout)
    counts = launch_counts()
    groups = (None if bias is None
              else fa.bias_groups(bias, b, h, n, m))
    out_alone, lse = fa.flash_forward(q, k, v, groups, causal, scale)
    torch.cuda.synchronize()
    if not torch.equal(out_alone, out.detach()):
        fail(f'flash forward ({b}, {h}, {n}, {d}) / {m} keys causal='
             f'{causal}: the kernel alone and through autograd differ')
    errs = dict.fromkeys(('out', 'lse', 'dq', 'dk', 'dv'), 0.0)
    peaks = dict(errs)
    step = frames or b
    assert bias is None or step == b
    for i in range(0, b, step):
        f = [t[i:i + step].float() for t in (q, k, v, dout)]
        g32 = None if groups is None else groups.float()
        o_ref, lse_ref = fa.flash_attention_ref(*f[:3], causal, scale, g32)
        ref = fa.flash_attention_bwd_ref(*f[:3], g32, o_ref, lse_ref, f[3],
                                         causal, scale)
        got = (out, lse, *grads[:3])
        for key, a, r in zip(errs, got, (o_ref, lse_ref, *ref[:3])):
            errs[key] = max(errs[key],
                            (a[i:i + step].float() - r).abs().max().item())
            peaks[key] = max(peaks[key], r.abs().max().item())
        if bias is not None:
            db_ref = ref[3].reshape(grads[3].shape)
            errs['dbias'] = (grads[3].float() - db_ref).abs().max().item()
            peaks['dbias'] = db_ref.abs().max().item()
        del f, o_ref, lse_ref, ref
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, *grads))
    return errs, peaks, finite, counts


def flash_relative(errs, peaks):
    """What the flash checks hold to their tolerance: lse's max abs error,
    every other tensor's max abs error over the reference's largest value."""
    return {key: err if key == 'lse' else err / max(peaks[key], 1e-30)
            for key, err in errs.items()}


def check_flash_errors(what, dtype_name, errs, peaks, finite):
    if not finite:
        fail(f'{what}: non-finite kernel output')
    for key, rel in flash_relative(errs, peaks).items():
        tol = FLASH_TOL['lse' if key == 'lse' else dtype_name]
        if not rel <= tol:
            fail(f'{what}: {key} differs from the plain version by {rel} '
                 f'{"" if key == "lse" else "of its largest value "}> {tol} '
                 f'(max abs error {errs[key]}, largest value {peaks[key]})')


def check_flash_routes(what, counts, route):
    """One launch of each flash kernel, on ``route`` and on no other."""
    moved = {key: counts[key] for key in (*FLASH_KERNELS, *FLASH_ROUTES)}
    want = {**dict.fromkeys(FLASH_KERNELS, 1),
            **{key: int(r == route) for key, r in FLASH_ROUTES.items()}}
    if moved != want:
        fail(f'{what}: flash launches {moved}, expected one of each kernel '
             f'on the {route!r} route')


def ptxas_lines(log: str, kernel: str):
    """ptxas's lines for each instantiation of ``kernel`` in the build log:
    {its int template argument (a head size), 0 for a kernel that is no
    template: [lines]}, from its 'Compiling entry function' line to its
    'Used N registers' line."""
    out, current = {}, None
    name = f'{len(kernel)}{kernel}'     # as the mangled name spells it
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            current = None
            if f'{name}ILi' in line:
                current = int(line.split(f'{kernel}ILi')[1].split('E')[0])
            elif f'{name}E' in line:
                current = 0
            if current is not None:
                out[current] = []
        if current is not None:
            out[current].append(line.strip())
            if 'Used' in line and 'registers' in line:
                current = None
    return out


def flash_mma_resources(fa):
    """Registers, spills and shared memory of the three 'mma' kernels as
    the CUDA runtime reports them after this run's launches (the dynamic
    shared memory is what each launcher set), with ptxas's lines from this
    run's build (none when the library came from the cache). Fails on a
    spill."""
    import re
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    build_log = _build.build_info.get('log', '')
    report = {}
    for kernel, name in FLASH_MMA:
        lines = ptxas_lines(build_log, name)
        for d in fa.SUPPORTED_DIM_HEAD:
            attrs = fa.mma_attributes(kernel, d)
            ptxas = lines.get(d, [None])[1:]
            spills = [ln for ln in ptxas for st, ld in re.findall(
                r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
                if int(st) or int(ld)]
            if spills or attrs['local_bytes']:
                fail(f'{name}<{d}> spills: {spills}, {attrs}')
            report[f'{name}<{d}>'] = dict(ptxas=ptxas, **attrs)
            log(f'[ptxas] {name}<{d}>: {"; ".join(ptxas)}; on the card '
                f'{attrs}')
    if build_log not in ('', '(cached)') and not all(
            row['ptxas'] for row in report.values()):
        fail('ptxas lines missing from the build log for '
             f'{[k for k, row in report.items() if not row["ptxas"]]}')
    return report


def plain_in_chunks(fa, q, k, v, dout, out, lse, causal, scale, backward):
    """The plain forward or backward over PLAIN_CHUNK frames at a time."""
    for i in range(0, q.shape[0], PLAIN_CHUNK):
        part = [t[i:i + PLAIN_CHUNK] for t in (q, k, v)]
        if backward:
            fa.flash_attention_bwd_ref(
                *part, None, out[i:i + PLAIN_CHUNK], lse[i:i + PLAIN_CHUNK],
                dout[i:i + PLAIN_CHUNK], causal, scale)
        else:
            fa.flash_attention_ref(*part, causal, scale)


def flash_kernels_alone(fa, q, k, v, dout, bias, causal, need_dbias=False):
    """The three kernels alone on prepared tensors, the forward giving out
    and lse: (out, lse, dq, dk, dv, ds or None)."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, bias, causal, scale)
    delta = fa.row_delta(dout, out)
    dq, ds = fa.flash_backward_dq(q, k, v, bias, dout, lse, delta, causal,
                                  scale, need_dbias)
    dk, dv = fa.flash_backward_dkv(q, k, v, bias, dout, lse, delta, causal,
                                   scale)
    return out, lse, dq, dk, dv, ds


def flash_invariants(torch, fa, dev):
    """Two calls of the three kernels give bit-identical out, lse, dq, dk,
    dv and dS, and a batch of two against its second element alone reads
    exactly 0: (2, 8, 1024, 32) / 1028 keys, causal, a (h, n, m) bias, both
    dtypes."""
    b, h, n, m, d = 2, 8, 1024, 1028, 32
    names = ('out', 'lse', 'dq', 'dk', 'dv', 'dS')
    out = {}
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        q, k, v, dout, bias = flash_inputs(torch, dev, dtype, b, h, n, m, d,
                                           'hnm', 77)
        groups = fa.bias_groups(bias, b, h, n, m).contiguous()
        first = flash_kernels_alone(fa, q, k, v, dout, groups, True, True)
        second = flash_kernels_alone(fa, q, k, v, dout, groups, True, True)
        alone = flash_kernels_alone(fa, *(t[1:] for t in (q, k, v, dout)),
                                    groups, True, True)
        torch.cuda.synchronize()
        same = dict(zip(names, (bool(torch.equal(x, y))
                                for x, y in zip(first, second))))
        if not all(same.values()):
            fail(f'flash kernels {name}: two calls differ (equal: {same})')
        boundary = max(
            *((x[1] - y[0]).abs().max().item()
              for x, y in zip(first[:5], alone[:5])),
            (first[5][h:] - alone[5]).abs().max().item())
        if boundary != 0:
            fail(f'flash kernels {name}: a batch of two against its second '
                 f'element alone differs by {boundary}')
        out[name] = dict(two_calls_identical=True, batch_boundary=boundary)
    log(f'[kernel] flash forward and backward, ({b}, {h}, {n}, {d}) / {m} '
        f'keys, causal, (h, n, m) bias: two calls bit-identical '
        f'({", ".join(names)}) and a batch of two against its second element '
        f'alone {out}')
    return out


def flash_dead_row(torch, fa, dev):
    """A row whose bias is -inf at every key has no visible finite score:
    on both routes, causal and not, the three kernels must give finite out,
    lse, dq, dk, dv and dS, and 0 in that row's dq and dS. (2, 2, 130, 32)
    / 134 keys with an (h, n, m) bias, row 7 of head 0 dead."""
    b, h, n, m, d, row = 2, 2, 130, 134, 32, 7
    names = ('out', 'lse', 'dq', 'dk', 'dv', 'dS')
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        for causal in (False, True):
            q, k, v, dout, bias = flash_inputs(torch, dev, dtype, b, h, n, m,
                                               d, 'hnm', 5)
            bias[0, row] = float('-inf')
            got = flash_kernels_alone(fa, q, k, v, dout, bias, causal, True)
            torch.cuda.synchronize()
            what = (f'flash kernels {name} causal={causal}, a row with a '
                    f'bias of -inf at every key')
            bad = [key for key, t in zip(names, got)
                   if not bool(torch.isfinite(t).all())]
            if bad:
                fail(f'{what}: non-finite {bad}')
            dead = max(got[2][:, 0, row].abs().max().item(),
                       got[5][0::h, row].abs().max().item())
            if dead != 0:
                fail(f'{what}: its dq and dS read {dead}, not 0')
    log(f'[kernel] flash kernels, ({b}, {h}, {n}, {d}) / {m} keys with row '
        f'{row} of head 0 biased -inf at every key, float32 and bf16, causal '
        f'and not: out, lse, dq, dk, dv and dS finite, that row\'s dq and dS '
        f'exactly 0')


def phase_flash_kernels(torch, dev, reps, smi):
    """The three flash-attention kernels against their plain versions on
    the card, then their times at full width. Returns one row per kernel
    for the result line."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
    set_tf32(False)
    dtypes = (('float32', torch.float32), ('bfloat16', torch.bfloat16))
    worst = {name: dict.fromkeys(('out', 'lse', 'dq', 'dk', 'dv', 'dbias'),
                                 0.0) for name, _ in dtypes}
    cases = [(2, 2, 130, 134, d, causal, bias)
             for d in (16, 32, 64) for causal in (False, True)
             for bias in (None, 'nm', 'hnm', 'bhnm')]
    cases.append((2, 8, 1024, 1028, 32, True, None))    # the 'auto' gate's edge
    # the causal tile skip of the 'mma' kernels: memory keys over more than
    # one tile (80 > 64), fewer queries than a tile
    cases += [(1, 2, 70, 150, d, True, None) for d in (16, 64)]
    cases += [(2, 2, 5, 9, 16, causal, 'hnm') for causal in (False, True)]
    for seed, (b, h, n, m, d, causal, bias_kind) in enumerate(cases):
        for name, dtype in dtypes:
            *qkvo, bias = flash_inputs(torch, dev, dtype, b, h, n, m, d,
                                       bias_kind, seed)
            errs, peaks, finite, counts = flash_errors(torch, fa, *qkvo,
                                                       bias, causal)
            what = (f'flash attention ({b}, {h}, {n}, {d}) / {m} keys '
                    f'{name} causal={causal} bias={bias_kind}')
            check_flash_routes(what, counts, fa.flash_route(dtype, d))
            check_flash_errors(what, name, errs, peaks, finite)
            rel = flash_relative(errs, peaks)
            for key, err in rel.items():
                worst[name][key] = max(worst[name][key], err)
            if n == 1024:
                log(f'[kernel] {what}: max_abs_err {errs}, held as {rel}')
    for name, _ in dtypes:
        log(f'[kernel] flash attention, {len(cases)} cases: (2, 2, 130, d) '
            f'/ 134 keys, d in 16, 32, 64, causal and not, no bias and (n, '
            f'm), (h, n, m), (b, h, n, m) biases; the (2, 8, 1024, 32) / '
            f'1028 causal case; (1, 2, 70, d) / 150 keys causal, d in 16, '
            f'64; (2, 2, 5, 16) / 9 keys with an (h, n, m) bias, causal and '
            f'not; {name}, each kernel on the '
            f'{fa.flash_route(dict(dtypes)[name], 32)!r} route: worst '
            f'error over the largest value of the reference (lse: max abs '
            f'error) {worst[name]} (tol {FLASH_TOL[name]:g}, lse '
            f'{FLASH_TOL["lse"]:g})')
    resources = flash_mma_resources(fa)    # every head size has launched
    invariants = flash_invariants(torch, fa, dev)
    flash_dead_row(torch, fa, dev)

    # full width: the flagship's space-attention stage at 512 px, every
    # frame of it in both dtypes (65 key tiles, the last one of 4 keys),
    # and causal in bf16
    b, h, n, m, d = (FLASH_FULL[key] for key in 'bhnmd')
    scale = d ** -0.5
    q, k, v, dout, _ = flash_inputs(torch, dev, torch.bfloat16, b, h, n, m,
                                    d, None, 99)
    full = {}
    for name, dtype, causal in (*((n_, dt, False) for n_, dt in dtypes),
                                ('bfloat16', torch.bfloat16, True)):
        errs, peaks, finite, counts = flash_errors(
            torch, fa, *(t.to(dtype) for t in (q, k, v, dout)), None, causal,
            frames=PLAIN_CHUNK)
        what = (f'flash attention ({b}, {h}, {n}, {d}) / {m} keys {name}'
                f'{" causal" if causal else ""}')
        check_flash_routes(what, counts, fa.flash_route(dtype, d))
        check_flash_errors(what, name, errs, peaks, finite)
        full[(name, causal)] = (errs, flash_relative(errs, peaks))
        log(f'[kernel] {what}, plain in float32 {PLAIN_CHUNK} frames at a '
            f'time: max_abs_err {errs}, largest values {peaks}, held as '
            f'{full[(name, causal)][1]} (tol {FLASH_TOL[name]:g}, lse '
            f'{FLASH_TOL["lse"]:g})')
    prepared = {}
    for causal in (False, True):
        first = flash_kernels_alone(fa, q, k, v, dout, None, causal)
        second = flash_kernels_alone(fa, q, k, v, dout, None, causal)
        if not all(torch.equal(x, y) for x, y in zip(first[:5], second[:5])):
            fail(f'flash kernels at full width, causal={causal}: two calls '
                 'differ')
        prepared[causal] = (first[0], first[1], fa.row_delta(dout, first[0]))
        del first, second
    log(f'[kernel] flash kernels ({b}, {h}, {n}, {d}) / {m} keys bf16, '
        'causal and not: two calls bit-identical (out, lse, dq, dk, dv)')

    def calls(causal):
        _, lse, delta = prepared[causal]
        return {
            'flash_attention_fwd': lambda *t: fa.flash_forward(
                t[0], t[1], t[2], None, causal, scale),
            'flash_attention_bwd_dq': lambda *t: fa.flash_backward_dq(
                t[0], t[1], t[2], None, t[3], lse, delta, causal, scale),
            'flash_attention_bwd_dkv': lambda *t: fa.flash_backward_dkv(
                t[0], t[1], t[2], None, t[3], lse, delta, causal, scale),
        }

    out, lse, _ = prepared[False]
    out_c, lse_c, _ = prepared[True]
    with torch.no_grad():
        ms = {name: median_ms(lambda: call(q, k, v, dout), reps)
              for name, call in calls(False).items()}
        ms_causal = {name: median_ms(lambda: call(q, k, v, dout), reps)
                     for name, call in calls(True).items()}
        plain = {(bwd, causal): median_ms(lambda: plain_in_chunks(
            fa, q, k, v, dout, *((out, lse) if not causal else (out_c, lse_c)),
            causal, scale, bwd), 5, warmup=1)
            for bwd in (False, True) for causal in (False, True)}
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
        ms32 = {name: median_ms(lambda: call(q32, k32, v32, do32), 5,
                                warmup=1)
                for name, call in calls(False).items()}
        plain32 = {bwd: median_ms(lambda: plain_in_chunks(
            fa, q32, k32, v32, do32, out, lse, False, scale, bwd), 5,
            warmup=1) for bwd in (False, True)}
        del q32, k32, v32, do32
        sdpa_fwd = {causal: median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal), reps)
            for causal in (False, True)}
    sdpa_bwd = {}
    for causal in (False, True):
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        sdpa_bwd[causal] = median_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), dout, retain_graph=True), reps)
        del qg, kg, vg, o
    floor = {causal: exp_floor_ms(torch, visible_pairs(b * h, n, m, causal))
             for causal in (False, True)}
    rows = {}
    for name in FLASH_KERNELS:
        fwd = name == 'flash_attention_fwd'
        bound_ms, bound_by = bound(*flash_cost(b * h, n, m, d, False, name))
        keys = (('out', 'lse') if fwd else ('dq',) if name.endswith('dq')
                else ('dk', 'dv'))
        err, err32 = (max(full[(dt, False)][0][key] for key in keys)
                      for dt in ('bfloat16', 'float32'))
        rel, rel32 = (max(full[(dt, False)][1][key] for key in keys
                          if key != 'lse')
                      for dt in ('bfloat16', 'float32'))
        library = sdpa_fwd if fwd else sdpa_bwd
        library_call = 'F.scaled_dot_product_attention' + (
            '' if fwd else ' backward, which forms dq, dk and dv together')
        kernel = dict(FLASH_MMA)[name.split('_')[-1]]
        rows[name] = dict(
            shape=[b, h, n, d], keys=m, per='launch', max_abs_err=err,
            max_abs_err_fp32=err32, max_rel_err=rel, max_rel_err_fp32=rel32,
            ms=ms[name], plain_ms=plain[(not fwd, False)],
            plain_call=('flash_attention_ref' if fwd else
                        'flash_attention_bwd_ref, which forms dq, dk and dv '
                        'together') + f', {PLAIN_CHUNK} frames at a time',
            ms_fp32=ms32[name], plain_ms_fp32=plain32[not fwd],
            library_ms=library[False], library_call=library_call,
            bound_ms=bound_ms, bound_by=bound_by,
            kernel_route=fa.flash_route(torch.bfloat16, d),
            ptxas={key: val for key, val in resources.items()
                   if key.startswith(kernel + '<')},
            invariants=invariants)
        log(f'[kernel] {name} ({b}, {h}, {n}, {d}) / {m} keys: max_abs_err '
            f'bf16 {err:.3e}, fp32 {err32:.3e}; over the largest value bf16 '
            f'{rel:.3e} (tol {FLASH_TOL["bfloat16"]:g}), fp32 {rel32:.3e} '
            f'(tol {FLASH_TOL["float32"]:g}); bf16 kernel '
            f'{ms[name]:.4f} ms (median of {reps}), plain '
            f'{rows[name]["plain_ms"]:.4f} ms ({rows[name]["plain_call"]}), '
            f'library {rows[name]["library_ms"]:.4f} ms ({library_call}), '
            f'bound {bound_ms:.4f} ms ({bound_by})'
            + (f', exp floor {floor[False]:.4f} ms' if fwd else '') +
            f'; fp32 kernel {ms32[name]:.4f} ms, plain '
            f'{rows[name]["plain_ms_fp32"]:.4f} ms (medians of 5) on {smi}')
        # the causal row
        c_bound, c_by = bound(*flash_cost(b * h, n, m, d, True, name))
        c_rel = max(full[('bfloat16', True)][1][key] for key in keys
                    if key != 'lse')
        rows[name]['causal'] = dict(
            ms=ms_causal[name], bound_ms=c_bound, bound_by=c_by,
            plain_ms=plain[(not fwd, True)], library_ms=library[True],
            library_call=library_call.replace(
                'attention', 'attention(is_causal=True)', 1) + ': its mask '
            'is aligned to the top left, 4 keys a row fewer than this one',
            max_rel_err=c_rel)
        log(f'[kernel] {name} causal ({b}, {h}, {n}, {d}) / {m} keys bf16: '
            f'{ms_causal[name]:.4f} ms (median of {reps}), bound '
            f'{c_bound:.4f} ms ({c_by}, visible pairs only)'
            + (f', exp floor {floor[True]:.4f} ms' if fwd else '') +
            f', plain {plain[(not fwd, True)]:.4f} ms, library '
            f'{library[True]:.4f} ms (SDPA is_causal, top-left aligned), '
            f'error over the largest value {c_rel:.3e} on {smi}')
    return rows


def relative_error(got, want):
    """max |got - want| over the largest |want|, in float32."""
    want = want.float()
    return ((got.float().to(want.device) - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def attention_module(torch, kind, device, dtype, seed=0, **kw):
    """An attention module of the port with seeded weights (norm gamma
    around 1), as the tokenizer seeds its layers."""
    from magvit2_pytorch_tpu_torch.ops import attention
    from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
    module = getattr(attention, kind)(512, heads=8, **kw)
    gen = torch.Generator().manual_seed(seed)
    init_module_parameters(module, gen)
    with torch.no_grad():
        module.norm.gamma.copy_(
            1 + 0.1 * torch.randn(module.norm.gamma.shape, generator=gen))
    return module.to(device=device, dtype=dtype)


def attention_step(torch, module, x, g):
    """One step: forward, ``loss = (out * g).sum()``, backward. Returns the
    output and the gradients of x and the four parameters."""
    x = x.detach().clone().requires_grad_()
    module.zero_grad(set_to_none=True)
    out = module(x)
    (out * g).sum().backward()
    return [out.detach(), x.grad] + [p.grad for p in module.parameters()]


# module.parameters(): the module's own mem_kv first, then its children's
STEP_NAMES = ('out', 'dx', 'dmem_kv', 'dgamma', 'dwqkv', 'dwout')


def compare_steps(what, got, want, tol):
    errs = {}
    for name, a, b in zip(STEP_NAMES, got, want):
        if a is None or not bool(a.isfinite().all()):
            fail(f'{what}: {name} is missing or not finite')
        errs[name] = relative_error(a, b)
        if not errs[name] <= tol:
            fail(f'{what}: {name} differs by {errs[name]} of the largest '
                 f'value (> {tol})')
    return errs


def phase_attention_step(torch, dev, reps, smi):
    """The general Attention path with the flash backend, forward and
    backward, at the flagship's space-attention stage at 512 px. Returns the
    launch counts of the step."""
    from magvit2_pytorch_tpu_torch.ops import attend as attend_mod
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    set_tf32(False)
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(STEP_SHAPE, generator=gen).to(dev).bfloat16()
    g = torch.randn(STEP_SHAPE, generator=gen).to(dev).bfloat16()
    modules = {backend: attention_module(
        torch, 'SpaceAttention', dev, torch.bfloat16, dim_head=32,
        backend=backend) for backend in ('flash', 'plain')}
    torch.cuda.synchronize()
    reset_launch_counts()
    flash = attention_step(torch, modules['flash'], x, g)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, want in LAUNCHES['attention_step'].items():
        if counts.get(name) != want:
            fail(f'attention step: {name} launched {counts.get(name)} '
                 f'times, expected {want}')
    if tuple(flash[0].shape) != STEP_SHAPE:
        fail(f'attention step: output shape {tuple(flash[0].shape)}')
    plain = attention_step(torch, modules['plain'], x, g)
    errs = compare_steps('attention step, flash against plain, bf16', flash,
                         plain, STEP_TOL['bfloat16'])
    del flash, plain
    times = {}
    for backend in ('plain', 'flash', 'flash', 'plain'):
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: attention_step(torch, modules[backend], x, g),
                       10, warmup=1)
        times.setdefault(backend, []).append(
            (ms, torch.cuda.max_memory_allocated() / 1e9))
    log(f'[attention step] SpaceAttention(512, dim_head=32, heads=8) on '
        f'{STEP_SHAPE} bf16, forward + backward: launches {counts}; flash '
        f'against plain, error over the largest value {errs} (tol '
        f'{STEP_TOL["bfloat16"]:g}); step ms and peak GB, medians of 10 in '
        f'the order plain, flash, flash, plain: flash {times["flash"]}, '
        f'plain {times["plain"]} on {smi}')
    del modules, x, g
    torch.cuda.empty_cache()

    # float32, TF32 off, 2 frames: the card (flash) against the CPU (plain)
    shape = (1, 2) + STEP_SHAPE[2:]
    x = torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen)
    card = attention_step(torch, attention_module(
        torch, 'SpaceAttention', dev, torch.float32, dim_head=32,
        backend='flash'), x.to(dev), g.to(dev))
    cpu = attention_step(torch, attention_module(
        torch, 'SpaceAttention', 'cpu', torch.float32, dim_head=32,
        backend='plain'), x, g)
    errs = compare_steps('attention step, card flash against CPU plain, '
                         'float32', card, cpu, STEP_TOL['float32'])
    log(f'[attention step] float32 {shape}, TF32 off, card (flash) against '
        f'CPU (plain): error over the largest value {errs} (tol '
        f'{STEP_TOL["float32"]:g})')
    del card, cpu

    # what 'auto' picks on the card, and flash against plain around it
    def qkv(n, frames=17):
        return [torch.randn(frames, 8, s, 32, device=dev,
                            dtype=torch.bfloat16) for s in (n, n + 4, n + 4)]
    picks = {}
    for n in (1024, 256):
        reset_launch_counts()
        with torch.no_grad():
            attend_mod.attend(*(t[:1, :, :n] for t in qkv(n)), backend='auto')
        picks[n] = launch_counts()['flash_attention_fwd']
    if picks != {1024: 1, 256: 0}:
        fail(f"'auto' on the card: flash forward launches by n {picks}, "
             'expected flash at n = m = 1024 and plain at 256')
    for n in (256, 1024, 4096):
        q, k, v = (t.requires_grad_() for t in qkv(n))
        go = torch.randn_like(q)
        row = {}
        for backend in ('plain', 'flash', 'flash', 'plain'):
            def fwd():
                with torch.no_grad():
                    attend_mod.attend(q, k, v, backend=backend)

            def both():
                out = attend_mod.attend(q, k, v, backend=backend)
                torch.autograd.grad(out, (q, k, v), go)

            row.setdefault(backend, []).append(
                (median_ms(fwd, 10, warmup=1), median_ms(both, 10, warmup=1)))
        log(f"[auto threshold] attend on (17, 8, {n}, 32) / {n + 4} keys "
            f'bf16, (forward, forward + backward) ms, medians of 10 in the '
            f'order plain, flash, flash, plain: flash {row["flash"]}, plain '
            f'{row["plain"]} on {smi}')
        del q, k, v, go
    torch.cuda.empty_cache()

    # a causal TimeAttention through flash (n = 5, m = 9); the block gate
    # would take t <= 16, so it is switched off inside this check only
    shape = (8, 5, 16, 16, 512)
    x = torch.randn(shape, generator=gen).to(dev)
    g = torch.randn(shape, generator=gen).to(dev)
    with environment({'MAGVIT2_TPU_NO_FUSED_ATTN': '1'}):
        steps = {}
        for backend in ('flash', 'plain'):
            reset_launch_counts()
            steps[backend] = attention_step(torch, attention_module(
                torch, 'TimeAttention', dev, torch.float32, dim_head=32,
                backend=backend), x, g)
            moved = launch_counts()['flash_attention_fwd']
            if moved != (1 if backend == 'flash' else 0):
                fail(f'TimeAttention(backend={backend!r}): {moved} flash '
                     'forward launches')
    errs = compare_steps('TimeAttention, flash against plain, float32',
                         steps['flash'], steps['plain'], STEP_TOL['float32'])
    log(f'[attention step] TimeAttention(512, backend=flash) on {shape} '
        f'float32, causal, 5 queries / 9 keys, flash against plain: error '
        f'over the largest value {errs} (tol {STEP_TOL["float32"]:g})')
    del steps

    # modules the block kernels do not take, on the card against the CPU
    shape = (1, 2, 16, 16, 512)
    x = torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen)
    for what, kw in (('use_rotary=True', dict(dim_head=32, use_rotary=True)),
                     ('dim_head=16', dict(dim_head=16))):
        reset_launch_counts()
        card = attention_step(torch, attention_module(
            torch, 'SpaceAttention', dev, torch.float32, **kw),
            x.to(dev), g.to(dev))
        if any(launch_counts().values()):
            fail(f'SpaceAttention({what}) launched {launch_counts()}: the '
                 'general path without flash is plain PyTorch')
        cpu = attention_step(torch, attention_module(
            torch, 'SpaceAttention', 'cpu', torch.float32, **kw), x, g)
        errs = compare_steps(f'SpaceAttention({what}), card against CPU',
                             card, cpu, STEP_TOL['float32'])
        log(f'[attention step] SpaceAttention(512, {what}) on {shape} '
            f'float32, card against CPU: error over the largest value '
            f'{errs} (tol {STEP_TOL["float32"]:g})')
    return counts

# -- the JAX package's other configurations (BASELINE configs 1, 3 and 4) ---

# config 4, the Open-MAGVIT2 256 px image tokenizer (2^18 LFQ codes): B1
# over 32 x 32 = 1024 tokens at C = 512 and B3 over 64 x 64 = 4096 at C = 512,
# once a side, with their GEMMs on the wgmma route; no time attention; seven
# ResidualUnits a side, one at 256^2 x 128, two each at 128^2 x 256,
# 64^2 x 512 and 32^2 x 512, all B4 on the fused path (init_dim 128 leaves
# lane packing off, so no B5)
C4_BATCH = 8
C4_FUSED_ENV = {'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '128,256,512'}
C4_BLOCKS = {**dict.fromkeys(BLOCKS, 0), 'space_attention_block': 2,
             'space_attention_core_mma': 2, 'taylor_attention_block': 2,
             'taylor_core_mma': 2, 'gemm_wgmma': 8}
C4_RU_STAGES = ((128, 256, 2), (256, 128, 4), (512, 64, 4), (512, 32, 4))
C4_FUSED_RU = {**NO_RU, 'residual_unit_wide': 14, 'ru_conv_wgmma': 14,
               'ru_pointwise_wgmma': 14}
C4_LAUNCHES = {'default': {**C4_BLOCKS, **NO_RU, **NO_FLASH},
               'fused': {**C4_BLOCKS, **C4_FUSED_RU, **NO_FLASH}}
# card against CPU (float32, TF32 off, live SqueezeExcite gates): a code
# digit (an LFQ bit, an FSQ level) may differ only where the CPU's decision
# margin is at most MARGIN_TOL, in at most DIGITS_TOL of the digits; the
# reconstruction decoded from the CPU's codes agrees within RECON_TOL
# (BASELINE.md:17)
MARGIN_TOL, DIGITS_TOL, RECON_TOL = 5e-3, 1e-2, 1e-3
# a small tokenizer with separate first-frame encoding and reflect padding,
# channels the fused ResidualUnit would take at every stage under
# SFF_FUSED_ENV but for the pad mode
SFF_REFLECT = dict(image_size=32, init_dim=64, codebook_size=256,
                   layers=('residual', 'compress_space', 'residual',
                           'compress_time', 'residual'),
                   separate_first_frame_encoding=True, pad_mode='reflect',
                   use_gan=False, perceptual_loss_weight=0.0)
SFF_FUSED_ENV = {'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64,128,256'}


def config_tokenizer(torch, name, device, dtype, **overrides):
    """A tokenizer of ``configs.<name>()`` with seeded random weights, for
    serving (no GAN, no perceptual loss)."""
    import warnings
    from magvit2_pytorch_tpu_torch import VideoTokenizer, configs
    kwargs = getattr(configs, name)(use_gan=False, perceptual_loss_weight=0.0,
                                    **overrides)
    with warnings.catch_warnings():
        # config 4's codebook-collapse warning concerns training
        warnings.simplefilter('ignore', UserWarning)
        return VideoTokenizer(seed=0, device=device, dtype=dtype, **kwargs)


def decision_margins(torch, quantizer, latents):
    """Each code digit's decision margin, ``(..., d)`` of the first
    codebook: |z| for an LFQ bit, the distance of the bounded value to the
    nearest rounding boundary (a half-integer) for an FSQ level."""
    with torch.inference_mode():
        if hasattr(quantizer, 'bounded_values'):
            b = quantizer.bounded_values(latents)
            margins = 0.5 - (b - torch.round(b)).abs()
        else:
            margins = quantizer.sign_values(latents).abs()
    return margins[..., 0, :].cpu()


def code_digits(torch, quantizer, codes):
    """Integer codes ``(...)`` -> their digits ``(..., d)``: LFQ bits MSB
    first, FSQ levels in the mixed radix."""
    codes = codes.cpu()
    if hasattr(quantizer, 'levels'):
        return ((codes[..., None] // torch.tensor(quantizer.basis))
                % torch.tensor(quantizer.levels))
    d = quantizer.codebook_dim
    return (codes[..., None] & 2 ** torch.arange(d - 1, -1, -1)) != 0


def flips(digits_ref, digits_got, margins):
    """The share of code digits that differ and the largest decision margin
    at a flip (0 where none flipped)."""
    flipped = digits_ref != digits_got
    worst = margins[flipped].max().item() if flipped.any() else 0.0
    return flipped.float().mean().item(), worst


def check_bits(what, frac, worst, limit):
    """The code-digit contract: at most DIGITS_TOL of the digits flipped,
    each where the margin is at most ``limit``."""
    if frac > DIGITS_TOL:
        fail(f'{what}: {frac:.2%} of code digits flipped (> {DIGITS_TOL:.0%})')
    if worst > limit:
        fail(f'{what}: a code digit flipped at margin {worst} > {limit}')


def card_against_cpu(torch, dev, what, make, clip, paths=(('default', {}),),
                     cond=None):
    """float32, TF32 off, live SqueezeExcite gates: the card's codes and its
    reconstruction from the CPU's codes against the CPU, on the same
    weights, under the contract of MARGIN_TOL, DIGITS_TOL and RECON_TOL.
    ``make(device, path)`` builds the tokenizer (``path`` None for the
    CPU); each of ``paths`` is run with its environment; ``cond`` goes to
    every call of a conditioned config. Returns the readings and the
    launches of each path."""
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    set_tf32(False)
    live = lambda tok: live_squeeze_excite_(
        tok.module, torch.Generator().manual_seed(11))
    cpu = make('cpu', None)
    live(cpu)
    t0 = time.perf_counter()
    lat_cpu = cpu.encode(clip, cond=cond)
    with torch.inference_mode():
        codes_cpu = cpu.module.quantize(lat_cpu).indices     # as tokenize
    margins = decision_margins(torch, cpu.module.quantizers, lat_cpu)
    recon_cpu = cpu.decode_from_code_indices(codes_cpu, cond=cond)
    cpu_s = time.perf_counter() - t0
    quantizer = cpu.module.quantizers
    digits_cpu = code_digits(torch, quantizer, codes_cpu)
    del cpu
    results, counts = {}, {}
    for path, env in paths:
        card = make(dev, path)
        live(card)
        with environment(env):
            reset_launch_counts()
            codes_card = card.tokenize(clip, cond=cond).cpu()
            lat_card = card.encode(clip, cond=cond).cpu()
            recon_card = card.decode_from_code_indices(
                codes_cpu.to(dev), cond=cond).cpu()
            counts[path] = launch_counts()
        del card
        torch.cuda.empty_cache()
        frac, worst = flips(digits_cpu, code_digits(torch, quantizer,
                                                     codes_card), margins)
        got = dict(latents_max_abs_err=(lat_card - lat_cpu).abs().max().item(),
                   digits_flipped=frac, worst_flip_margin=worst,
                   recon_max_abs_err=(recon_card - recon_cpu).abs().max()
                   .item(), cpu_reference_s=cpu_s)
        log(f'[card vs cpu {what} {path}] fp32 {tuple(clip.shape)}, TF32 '
            f'off, live SE gates: latents max_abs_err '
            f'{got["latents_max_abs_err"]:.3e}, code digits flipped '
            f'{frac:.4%} (worst CPU margin {worst:.3e}), recon from the '
            f'CPU codes max_abs_err {got["recon_max_abs_err"]:.3e}; CPU '
            f'reference {cpu_s:.1f} s')
        check_bits(f'{what} {path}', frac, worst, MARGIN_TOL)
        if not got['recon_max_abs_err'] <= RECON_TOL:
            fail(f'{what} {path}: recon from the CPU codes differs by '
                 f'{got["recon_max_abs_err"]} > {RECON_TOL}')
        results[path] = got
    return results, counts


def check_launches(what, counts, want):
    for name, n in want.items():
        if counts.get(name) != n:
            fail(f'{what}: {name} launched {counts.get(name)} times, '
                 f'expected {n}')


def config4_roundtrip(torch, dev, path, smi, profile_dir):
    """Config 4 at full width, bf16, batch 8 of 256 px images, seeded random
    weights, through ``phase_roundtrip``; then images/s by the slope of
    chained runs, and a profile with ``profile_dir``."""
    tok = config_tokenizer(torch, 'open_magvit2_image_tokenizer_kwargs', dev,
                           torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(4)
    images = torch.rand(C4_BATCH, 256, 256, 3, generator=gen, device=dev)
    ru_shapes = ({} if path == 'default' else {
        ('residual_unit_wide', (C4_BATCH, 1, hw, hw, c)): n
        for c, hw, n in C4_RU_STAGES})
    counts, _ = phase_roundtrip(torch, f'config 4 {path}', tok, images,
                                (C4_BATCH, 1, 32, 32), C4_LAUNCHES[path],
                                ru_shapes)
    clip = images[:, None]
    tp = phase_throughput(torch, tok, clip)
    log(f'[throughput config 4 {path}] bf16 batch {C4_BATCH} roundtrip: '
        f'{tp["fps"]:.2f} images/s ({tp["ms_per_roundtrip"]:.2f} ms per '
        f'roundtrip; slope of 2 vs 10 chained runs) on {smi}')
    if profile_dir:
        name = 'profile_config4.txt' if path == 'default' else (
            f'profile_config4_{path}.txt')
        profile_roundtrip(torch, tok, clip, os.path.join(profile_dir, name),
                          tp['ms_per_roundtrip'])
    return tok, images, counts, tp


def phase_checkpoint(torch, dev, tok, images):
    """``save`` the tokenizer to a temporary file and
    ``VideoTokenizer.init_and_load_from`` it on the card in its dtype: the
    weights, codes and reconstruction must be bit-identical."""
    import tempfile
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    n = images.shape[0]
    codes = tok.tokenize(images)
    recon = tok.decode_from_code_indices(codes.reshape(n, -1))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'tokenizer.ckpt')
        t0 = time.perf_counter()
        tok.save(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = VideoTokenizer.init_and_load_from(path, device=dev,
                                                   dtype=tok.dtype)
        load_s = time.perf_counter() - t0
    weights = all(torch.equal(v, loaded.state_dict()[k])
                  for k, v in tok.state_dict().items())
    codes2 = loaded.tokenize(images)
    recon2 = loaded.decode_from_code_indices(codes2.reshape(n, -1))
    same = dict(weights=weights, codes=torch.equal(codes, codes2),
                recon=torch.equal(recon, recon2))
    log(f'[checkpoint] config 4 {tok.dtype}: save {save_s:.1f} s, '
        f'{size / 2 ** 20:.1f} MiB; init_and_load_from on '
        f'{loaded.device} {load_s:.1f} s; bit-identical {same}')
    if not all(same.values()):
        fail(f'checkpoint round trip on the card is not bit-identical: {same}')
    del loaded
    torch.cuda.empty_cache()
    return dict(same, save_s=save_s, load_s=load_s, bytes=size)


def config4_kernel_cases(torch, dev):
    """B1, B3 and B4 at the shapes config 4 gives them (batch 8, one
    frame): B1 over 32 x 32 tokens at C = 512, B3 over 64 x 64 at C = 512,
    B4 at its largest and smallest stage."""
    import torch.nn.functional as F
    from magvit2_pytorch_tpu_torch.ops.conv import (
        pad_time_front, to_channels_first)
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        axial_attention as ax, residual_unit as ru, taylor_attention as ta)
    gen = torch.Generator(device='cpu').manual_seed(4321)
    cases = []
    c, heads, dh = 512, 8, 32
    cases.append(dict(
        name='space_attention_block', fn=ax.attention_block,
        ref=ax.attention_block_ref,
        args=[torch.randn(C4_BATCH, 1024, c, generator=gen),
              *attn_params(torch, gen, c, heads, dh)],
        kw=dict(heads=heads, dim_head=dh, causal=False),
        cost=attention_cost(C4_BATCH, 1024, c, heads, dh, 4, False),
        library=lambda x16, p16, heads=heads, dh=dh: lambda: (
            space_block_torch(torch, x16, *p16, heads, dh)),
        library_call='a sequence of PyTorch calls: F.rms_norm, F.linear, '
                     'torch.cat of the memory keys, '
                     'F.scaled_dot_product_attention, F.linear',
        relative=True))
    heads, dh = 16, 8
    cases.append(dict(
        name='taylor_attention_block', fn=ta.taylor_attention,
        ref=ta.taylor_attention_ref,
        args=[torch.randn(C4_BATCH, 4096, c, generator=gen),
              1 + 0.1 * torch.randn(c, generator=gen),
              uniform(torch, gen, (3 * heads * dh, c), c),
              uniform(torch, gen, (c, heads * dh), heads * dh)],
        kw=dict(heads=heads, dim_head=dh),
        cost=taylor_cost(C4_BATCH, 4096, c, heads, dh),
        library=None, library_call=None, relative=True))

    def conv_call(x16, p16):
        xp = to_channels_first(pad_time_front(x16, 2))
        return lambda: F.conv3d(xp, p16[0], p16[1], padding=(0, 1, 1))

    for c, hw, _ in (C4_RU_STAGES[0], C4_RU_STAGES[-1]):
        shape = (C4_BATCH, 1, hw, hw, c)
        cases.append(dict(
            name='residual_unit_wide', fn=ru.fused_residual_unit_wide,
            ref=ru.residual_unit_ref,
            args=[torch.randn(shape, generator=gen),
                  *ru_params(torch, c, gen)],
            kw={}, cost=ru_cost(shape, max(16, c // 2)), library=conv_call,
            library_call='F.conv3d, the conv step', boundary=True,
            inner=INNER))
    with torch.inference_mode(False):
        for case in cases:
            case['args'] = [a.to(dev) for a in case['args']]
    return cases


def phase_config4_kernels(torch, dev, reps):
    """Each config-4 case against its plain version (``check_case``: float32
    and bf16, the tolerances of phase 3, times, bound, library call):
    name -> the list of its rows."""
    rows = {}
    for case in config4_kernel_cases(torch, dev):
        rows.setdefault(case['name'], []).append(
            dict(check_case(torch, case, reps), per='launch'))
        torch.cuda.empty_cache()
    return rows


def phase_config4(torch, dev, smi, profile_dir):
    """Config 4 on both paths, the checkpoint round trip, then float32
    batch 1 card against CPU on both paths."""
    out = {}
    for path, env in (('default', {}), ('fused', C4_FUSED_ENV)):
        with environment(env):
            tok, images, counts, tp = config4_roundtrip(
                torch, dev, path, smi, profile_dir)
        out[path] = dict(launches=counts, **tp)
        if path == 'default':
            out['checkpoint'] = phase_checkpoint(torch, dev, tok, images)
        del tok, images
        torch.cuda.empty_cache()
    clip = torch.rand(1, 1, 256, 256, 3,
                      generator=torch.Generator().manual_seed(8))
    out['card_vs_cpu'], counts = card_against_cpu(
        torch, dev, 'config 4', lambda device, _: config_tokenizer(
            torch, 'open_magvit2_image_tokenizer_kwargs', device,
            torch.float32), clip,
        paths=(('default', {}), ('fused', C4_FUSED_ENV)))
    # tokenize and encode run the encoder's 7 units each, decode 7 more
    for path, n in (('default', 0), ('fused', 21)):
        if counts[path]['residual_unit_wide'] != n:
            fail(f'config 4 float32 {path}: '
                 f'{counts[path]["residual_unit_wide"]} B4 launches, '
                 f'expected {n}')
    return out


def phase_config3(torch, dev, smi):
    """Config 3 (FSQ, levels 8 8 8 5 5 5) at the README width: one bf16
    batch-8 roundtrip through ``phase_roundtrip`` with phase 4's launches,
    frames/s, then float32 batch 1 card against CPU with the FSQ margin."""
    name = 'fsq_gan_tokenizer_kwargs'
    tok = config_tokenizer(torch, name, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(3)
    video = torch.rand(BATCH, 17, 128, 128, 3, generator=gen, device=dev)
    counts, _ = phase_roundtrip(torch, 'config 3', tok, video,
                                (BATCH, 5, 16, 16), LAUNCHES['default'], {})
    tp = phase_throughput(torch, tok, video)
    log(f'[throughput config 3] FSQ bf16 batch {BATCH} roundtrip: '
        f'{tp["fps"]:.2f} frames/s ({tp["ms_per_roundtrip"]:.2f} ms per '
        f'roundtrip; slope of 2 vs 10 chained runs) on {smi}')
    del tok, video
    torch.cuda.empty_cache()
    clip = torch.rand(1, 17, 128, 128, 3,
                      generator=torch.Generator().manual_seed(9))
    got, _ = card_against_cpu(
        torch, dev, 'config 3', lambda device, _: config_tokenizer(
            torch, name, device, torch.float32), clip)
    return dict(launches=counts, card_vs_cpu=got, **tp)


def phase_small_configs(torch, dev):
    """Config 1 (images mode, 64 px) and the SFF + reflect tokenizer, each
    float32 card against CPU. Under ``SFF_FUSED_ENV`` the reflect tokenizer
    launches no B4, where the same one with zero padding launches one a
    ResidualUnit (9 in tokenize, encode and decode)."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    out = {}
    clip = torch.rand(4, 1, 64, 64, 3,
                      generator=torch.Generator().manual_seed(10))
    out['config1'], _ = card_against_cpu(
        torch, dev, 'config 1', lambda device, _: config_tokenizer(
            torch, 'images_mode_tokenizer_kwargs', device, torch.float32),
        clip)
    clip = torch.rand(2, 9, 32, 32, 3,
                      generator=torch.Generator().manual_seed(12))
    runs = {}
    for mode in ('reflect', 'constant'):
        kwargs = dict(SFF_REFLECT, pad_mode=mode)
        runs[mode], counts = card_against_cpu(
            torch, dev, f'SFF + {mode}', lambda device, _: VideoTokenizer(
                seed=0, device=device, **kwargs), clip,
            paths=(('fused', SFF_FUSED_ENV),))
        runs[mode]['b4_launches'] = counts['fused']['residual_unit_wide']
    log(f'[SFF] B4 launches with {SFF_FUSED_ENV}: reflect '
        f'{runs["reflect"]["b4_launches"]}, constant '
        f'{runs["constant"]["b4_launches"]}')
    if runs['reflect']['b4_launches'] != 0:
        fail(f'SFF + reflect: {runs["reflect"]["b4_launches"]} B4 launches '
             '(a unit that pads with the mode never takes B4)')
    # tokenize and encode run the encoder's 3 units each, decode 3 more
    if runs['constant']['b4_launches'] != 9:
        fail(f'SFF + constant: {runs["constant"]["b4_launches"]} B4 '
             'launches, expected 9 (the control)')
    out['sff'] = runs
    return out


# ---- phase 9: the rest of serving ---------------------------------------------

# config 5 (BASELINE config 5, configs.streaming_video_tokenizer_kwargs):
# 256 px x 65 frames, batch 1; streamed in chunks of 17, 16, 16, 16 frames
# and of 5, 4, 4, 4 latent frames
C5_SHAPE = (1, 65, 256, 256, 3)
C5_CHUNK_FRAMES, C5_CHUNK_LATENTS = 16, 4
# its ResidualUnit stages after the stem (C, T, H = W, B4 per fused
# roundtrip); the 64-channel stem takes B5 (lane_pack) at C5_STEM
C5_RU_STAGES = ((128, 68, 128, 4), (256, 68, 64, 4), (512, 68, 32, 4),
                (512, 34, 32, 4), (512, 17, 32, 4))
C5_STEM = (68, 256)
NO_BLOCKS = dict.fromkeys(BLOCKS, 0)
# config 5 has no attention layer: its default path launches no kernel,
# its fused path B4 and B5
C5_LAUNCHES = {'default': {**NO_BLOCKS, **NO_RU, **NO_FLASH},
               'fused': {**NO_BLOCKS, **FUSED_RU, **NO_FLASH}}
# a stream launches no B2 and no fused ResidualUnit (their gates refuse a
# stream, as the JAX package's do), and no flash kernel
STREAM_NONE = {'time_attention_block': 0, 'time_attention_block_fused': 0,
               'time_attention_block_launches': 0, **NO_RU, **NO_FLASH}
# the README stack streamed in chunks of 5, 4, 4, 4 frames (2, 1, 1, 1
# latent frames) and decoded a latent frame at a time (2, 1, 1, 1): its
# Taylor and space blocks run on every chunk, per frame as whole-clip
# (SpaceAttention keeps no stream state and takes the block, as in the JAX
# package); its time attention takes the general path with the kv-cache
README_CHUNK_FRAMES, README_CHUNK_LATENTS = 4, 1
README_STREAM = {**STREAM_NONE, 'taylor_attention_block': 8,
                 'taylor_core_mma': 8, 'space_attention_block': 8,
                 'space_attention_core_mma': 8, 'gemm_wgmma': 32,
                 'rmsnorm': 16}
# the conditioned stack: README_LAYERS with linear_attend_space,
# attend_space and attend_time conditioned, the last consecutive pair of
# ResidualUnits two cond_residual and a gateloop_time after the time
# attention. The conditioned linear attention takes the full attention's
# head shape (attn_dim_head x attn_heads, as the JAX package builds it,
# tokenizer_module.py:301-308), so the stack runs at two head shapes: the
# README's 32 x 8, where B3 does not run (it takes heads of 8 only, and a
# 32-wide head has 1057 Taylor features: the conditioned linear attention
# runs its plain version on the card, where the JAX kernel's VMEM fit takes
# this head up to 744 tokens a frame), and 8 x 16, the linear attention's
# own, where B3 runs on its no-norm route
COND_DIM = 32
COND_LAYERS = (
    'residual', 'compress_space', ('consecutive_residual', 2),
    'compress_space', ('consecutive_residual', 2), 'cond_linear_attend_space',
    'compress_space', ('consecutive_residual', 2), 'cond_attend_space',
    'compress_time', ('consecutive_residual', 2), 'compress_time',
    'cond_residual', 'cond_residual', 'cond_attend_time', 'gateloop_time')
COND_HEADS = {'8x16': dict(attn_dim_head=8, attn_heads=16),
              '32x8': dict(attn_dim_head=32, attn_heads=8)}
# per roundtrip at 8 x 16: B3 twice on its no-norm route (two GEMMs each),
# no norm launch, no B1 or B2 (the conditioned norm sends both to the
# general path); at 32 x 8 no attention kernel at all. B4 on the fused path
# for the plain ResidualUnits, RU_STAGES but the last stage, whose pair
# became cond_residual
COND_BLOCKS = {'8x16': {**NO_BLOCKS, 'taylor_attention_block': 2,
                        'taylor_attention_block_no_norm': 2,
                        'taylor_core_mma': 2, 'gemm_wgmma': 4, 'rmsnorm': 0},
               '32x8': {**NO_BLOCKS, 'taylor_attention_block_no_norm': 0,
                        'rmsnorm': 0}}
COND_FUSED_RU = {**FUSED_RU, 'residual_unit_wide': 16, 'ru_conv_wgmma': 18,
                 'ru_pointwise_wgmma': 18}
COND_LAUNCHES = {heads: {'default': {**blocks, **NO_RU, **NO_FLASH},
                         'fused': {**blocks, **COND_FUSED_RU, **NO_FLASH}}
                 for heads, blocks in COND_BLOCKS.items()}
COND_STREAM = {**STREAM_NONE, 'space_attention_block': 0,
               'taylor_attention_block': 8,
               'taylor_attention_block_no_norm': 8, 'rmsnorm': 0}


def cond_stack_kwargs(heads='8x16', **overrides):
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    return readme_video_tokenizer_kwargs(**{
        **dict(layers=COND_LAYERS, dim_cond=COND_DIM, use_gan=False,
               perceptual_loss_weight=0.0, **COND_HEADS[heads]),
        **overrides})


def peak_run(torch, fn, reps: int = 3):
    """``fn()`` once to warm up, then ``reps`` timed runs (host clock,
    synchronized): the output of the last, the median seconds, and the
    peak device memory of one run above what was allocated before it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    return out, sorted(times)[reps // 2], dict(peak_bytes=peak,
                                               peak_above_bytes=peak - before)


def counted(torch, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (output, counts)."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def stream_roundtrip(tok, video, chunk_frames, chunk_latents, cond=None):
    from magvit2_pytorch_tpu_torch.models.streaming import (
        decode_streaming, tokenize_streaming)
    codes = tokenize_streaming(tok, video, chunk_frames=chunk_frames,
                               cond=cond)
    return codes, decode_streaming(tok, codes, chunk_latents=chunk_latents,
                                   cond=cond)


def bits_against(torch, tok, video, codes, cond=None, relative=False):
    """Code digits of ``codes`` against the whole-clip encode of ``video``
    on ``tok``: the share flipped and the largest decision margin |z| (of
    the largest |z| with ``relative``) at a flip."""
    lat = tok.encode(video, cond=cond)
    quantizer = tok.module.quantizers
    with torch.inference_mode():
        whole = quantizer(lat).indices
    margins = decision_margins(torch, quantizer, lat)
    frac, worst = flips(code_digits(torch, quantizer, whole),
                        code_digits(torch, quantizer, codes), margins)
    if relative:
        worst /= margins.max().item()
    return whole, frac, worst


def phase_config5(torch, dev, smi):
    """Config 5 at full width, bf16, batch 1 of 256 px x 65 frames:
    whole-clip ``tokenize`` + ``decode_from_code_indices`` on the default
    and the fused path (``phase_roundtrip``), then ``tokenize_streaming`` /
    ``decode_streaming`` on each, with frames/s and peak device memory of
    each run and the launches of each stream (no B2, B4, B5 or flash);
    then float32, TF32 off, live SqueezeExcite gates, default path:
    streamed against whole-clip on the card (MARGIN_TOL, DIGITS_TOL; the
    reconstruction from the same codes within RECON_TOL)."""
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    gen = torch.Generator(device=dev).manual_seed(5)
    video = torch.rand(C5_SHAPE, generator=gen, device=dev)
    frames = C5_SHAPE[0] * C5_SHAPE[1]
    out = {}
    for path, env in (('default', {}), ('fused', FUSED_ENV)):
        with environment(env):
            tok = config_tokenizer(torch, 'streaming_video_tokenizer_kwargs',
                                   dev, torch.bfloat16,
                                   lane_pack=path == 'fused')
            ru = {}
            if path == 'fused':
                ru = {('residual_unit_wide', (1, t, hw, hw, c)): n
                      for c, t, hw, n in C5_RU_STAGES}
                t, hw = C5_STEM
                ru[('residual_unit_packed', (1, t, hw, hw, 64))] = 2
            counts, _ = phase_roundtrip(
                torch, f'config 5 {path}', tok, video, (1, 17, 32, 32),
                C5_LAUNCHES[path], ru)
            (codes_w, _), whole_s, whole_mem = peak_run(
                torch, lambda: whole_roundtrip(tok, video))
            (codes_s, recon_s), stream_counts = counted(
                torch, lambda: stream_roundtrip(
                    tok, video, C5_CHUNK_FRAMES, C5_CHUNK_LATENTS))
            _, stream_s, stream_mem = peak_run(
                torch, lambda: stream_roundtrip(
                    tok, video, C5_CHUNK_FRAMES, C5_CHUNK_LATENTS))
        check_launches(f'config 5 {path} stream', stream_counts, STREAM_NONE)
        if (tuple(codes_s.shape) != tuple(codes_w.shape)
                or tuple(recon_s.shape) != C5_SHAPE
                or not bool(torch.isfinite(recon_s).all())):
            fail(f'config 5 {path} stream: codes {tuple(codes_s.shape)}, '
                 f'recon {tuple(recon_s.shape)}')
        same = (codes_s == codes_w).float().mean().item()
        out[path] = dict(
            launches=counts, stream_launches=stream_counts,
            whole_fps=frames / whole_s, stream_fps=frames / stream_s,
            whole_s=whole_s, stream_s=stream_s, whole_memory=whole_mem,
            stream_memory=stream_mem, codes_equal_bf16=same,
            stream_peak_share=(stream_mem['peak_above_bytes']
                               / whole_mem['peak_above_bytes']))
        log(f'[config 5 {path}] bf16 {C5_SHAPE}: whole-clip tokenize + '
            f'decode {frames / whole_s:.2f} frames/s ({whole_s:.4f} s), '
            f'peak {whole_mem["peak_above_bytes"] / 2 ** 30:.3f} GiB above '
            f'the weights and input ({whole_mem["peak_bytes"] / 2 ** 30:.3f} '
            f'GiB in all); streamed (chunks {C5_CHUNK_FRAMES} frames, '
            f'{C5_CHUNK_LATENTS} latents) {frames / stream_s:.2f} frames/s '
            f'({stream_s:.4f} s), peak '
            f'{stream_mem["peak_above_bytes"] / 2 ** 30:.3f} GiB above '
            f'({out[path]["stream_peak_share"]:.1%} of whole-clip); stream '
            f'launches {stream_counts}; bf16 codes equal to whole-clip '
            f'{same:.4%} (median of 3 warm runs, host clock) on {smi}')
        del tok
        torch.cuda.empty_cache()
    set_tf32(False)
    tok = config_tokenizer(torch, 'streaming_video_tokenizer_kwargs', dev,
                           torch.float32)
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(11))
    clip = video.float()
    codes_s, _ = stream_roundtrip(tok, clip, C5_CHUNK_FRAMES,
                                  C5_CHUNK_LATENTS)
    whole, frac, worst = bits_against(torch, tok, clip, codes_s)
    from magvit2_pytorch_tpu_torch.models.streaming import decode_streaming
    err = (decode_streaming(tok, whole, chunk_latents=C5_CHUNK_LATENTS)
           - tok.decode_from_code_indices(whole)).abs().max().item()
    out['float32_stream_vs_whole'] = dict(digits_flipped=frac,
                                          worst_flip_margin=worst,
                                          recon_max_abs_err=err)
    log(f'[config 5 fp32] streamed against whole-clip on the card, TF32 off, '
        f'live SE gates: code digits flipped {frac:.4%} (worst margin '
        f'{worst:.3e}), recon from the same codes max abs err {err:.3e} '
        f'(tol {MARGIN_TOL:g} / {DIGITS_TOL:g} / {RECON_TOL:g})')
    check_bits('config 5 float32 stream', frac, worst, MARGIN_TOL)
    if not err <= RECON_TOL:
        fail(f'config 5 float32 stream: recon differs by {err} > {RECON_TOL}')
    del tok, video, clip
    torch.cuda.empty_cache()
    return out


def phase_readme_stream(torch, dev, smi):
    """The README stack, bf16 batch 8, streamed (chunks of 5, 4, 4, 4
    frames; one latent frame a decode chunk after the first two) on the
    default path: its launches (README_STREAM), frames/s and peak memory
    beside whole-clip, its codes against the whole clip's (bf16: at most
    1% of bits, each where |z| <= 5e-2 of the largest, as the in-situ
    check; float32 batch 1, TF32 off: MARGIN_TOL and DIGITS_TOL), then the
    kv-cache bounded by ``streaming_kv_window=2``: the caches hold at most 2
    latent frames and the first chunk's codes equal the unbounded
    stream's. Returns the readings and the tokenizer and video, which the
    ``.pt`` check reuses."""
    from magvit2_pytorch_tpu_torch.models.streaming import StreamingSession
    from magvit2_pytorch_tpu_torch.ops.attention import Attention
    tok = flagship_tokenizer(torch, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    video = torch.rand(BATCH, 17, 128, 128, 3, generator=gen, device=dev)
    frames = BATCH * 17
    (codes_s, recon_s), counts = counted(torch, lambda: stream_roundtrip(
        tok, video, README_CHUNK_FRAMES, README_CHUNK_LATENTS))
    check_launches('README stream', counts, README_STREAM)
    if (tuple(codes_s.shape) != (BATCH, 5, 16, 16)
            or tuple(recon_s.shape) != tuple(video.shape)
            or not bool(torch.isfinite(recon_s).all())):
        fail(f'README stream: codes {tuple(codes_s.shape)}, recon '
             f'{tuple(recon_s.shape)}')
    _, whole_s, whole_mem = peak_run(torch, lambda: whole_roundtrip(tok,
                                                                    video))
    _, stream_s, stream_mem = peak_run(torch, lambda: stream_roundtrip(
        tok, video, README_CHUNK_FRAMES, README_CHUNK_LATENTS))
    _, frac, worst = bits_against(torch, tok, video, codes_s, relative=True)
    check_bits('README bf16 stream', frac, worst,
               IN_SITU_TOL['worst_flip_margin'])
    out = dict(launches=counts, whole_fps=frames / whole_s,
               stream_fps=frames / stream_s, whole_memory=whole_mem,
               stream_memory=stream_mem, bf16_digits_flipped=frac,
               bf16_worst_flip_margin=worst)
    set_tf32(False)
    tok32 = flagship_tokenizer(torch, dev, torch.float32)
    clip = video[:1]
    codes32, _ = stream_roundtrip(tok32, clip, README_CHUNK_FRAMES,
                                  README_CHUNK_LATENTS)
    _, frac32, worst32 = bits_against(torch, tok32, clip, codes32)
    check_bits('README float32 stream', frac32, worst32, MARGIN_TOL)
    del tok32
    out.update(fp32_digits_flipped=frac32, fp32_worst_flip_margin=worst32)
    # the same seed, so the same weights
    windowed = flagship_tokenizer(torch, dev, torch.bfloat16,
                                  streaming_kv_window=2)
    session = StreamingSession(windowed)
    chunks = [session.encode_chunk(video[:, :5])]
    chunks += [session.encode_chunk(video[:, i:i + 4]) for i in (5, 9, 13)]
    cached = [v['k'].shape[1] for m, v in session._enc_state.items()
              if isinstance(m, Attention)]
    first_same = torch.equal(chunks[0], codes_s[:, :2])
    windowed_same = (torch.cat(chunks, dim=1) == codes_s).float().mean().item()
    out.update(kv_window_cached=cached, kv_window_first_chunk_equal=first_same,
               kv_window_codes_equal=windowed_same)
    log(f'[README stream] bf16 batch {BATCH}, chunks of 5, 4, 4, 4 frames and '
        f'2, 1, 1, 1 latents: launches {counts}; whole-clip '
        f'{out["whole_fps"]:.2f} frames/s, peak '
        f'{whole_mem["peak_above_bytes"] / 2 ** 30:.3f} GiB above the weights '
        f'and input; streamed {out["stream_fps"]:.2f} frames/s, peak '
        f'{stream_mem["peak_above_bytes"] / 2 ** 30:.3f} GiB; bf16 code '
        f'digits flipped against whole-clip {frac:.4%} (worst margin '
        f'{worst:.3e} of the largest |z|); float32 batch 1 {frac32:.4%} '
        f'(worst margin {worst32:.3e}); streaming_kv_window=2: cached latent '
        f'frames {cached}, first chunk equal {first_same}, codes equal to '
        f'the unbounded stream {windowed_same:.4%} (on {smi})')
    if not cached or max(cached) > 2 or not first_same:
        fail(f'README stream with streaming_kv_window=2: cached {cached}, '
             f'first chunk equal {first_same}')
    del windowed, session
    torch.cuda.empty_cache()
    return out, tok, video


def phase_cond_stack(torch, dev, smi, profile_dir):
    """The conditioned stack (COND_LAYERS) at README width, bf16 batch 8,
    dim_cond 32 from a seeded generator, at each head shape of COND_HEADS:
    a roundtrip on the default and the fused path (``phase_roundtrip``,
    COND_LAUNCHES: at 8 x 16 B3 twice on its no-norm route, no norm, B1 or
    B2; at 32 x 8 no attention kernel; B4 for the plain units on the fused
    path), frames/s on each; at 8 x 16 the stream on the fused tokenizer
    with cond fixed for the session (B3 no-norm per chunk, no B4 or B5),
    its codes against the whole clip's; then a small form (32 px, 5 frames,
    batch 1) float32 card against CPU, at 8 x 16 on both paths, at 32 x 8
    on the default path."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    gen = torch.Generator(device=dev).manual_seed(6)
    video = torch.rand(BATCH, 17, 128, 128, 3, generator=gen, device=dev)
    cond = torch.randn(BATCH, COND_DIM, generator=gen, device=dev)
    out = {}
    for heads in COND_HEADS:
        got = out.setdefault(heads, {})
        for path, env in (('default', {}), ('fused', FUSED_ENV)):
            what = f'cond stack {heads} {path}'
            with environment(env):
                tok = VideoTokenizer(seed=0, device=dev, dtype=torch.bfloat16,
                                     **cond_stack_kwargs(
                                         heads, lane_pack=path == 'fused'))
                ru = {k: n for k, n in ru_calls_expected(path).items()
                      if k != ('residual_unit_wide', (BATCH, 5, 16, 16, 512))}
                counts, _ = phase_roundtrip(
                    torch, what, tok, video, (BATCH, 5, 16, 16),
                    COND_LAUNCHES[heads][path], ru, cond=cond)
                tp = phase_throughput(torch, tok, video, cond=cond)
                got[path] = dict(launches=counts, **tp)
                log(f'[throughput {what}] bf16 batch {BATCH} roundtrip, '
                    f'dim_cond {COND_DIM}, attention heads {heads}: '
                    f'{tp["fps"]:.2f} frames/s ({tp["ms_per_roundtrip"]:.2f} '
                    f'ms per roundtrip; slope of 2 vs 10 chained runs) on '
                    f'{smi}')
                if profile_dir:
                    profile_roundtrip(torch, tok, video, os.path.join(
                        profile_dir, f'profile_cond_{heads}_{path}.txt'),
                        tp['ms_per_roundtrip'], cond=cond)
                if heads == '8x16' and path == 'fused':
                    got['stream'] = cond_stream(torch, tok, video, cond)
            del tok
            torch.cuda.empty_cache()
    clip = torch.rand(1, 5, 32, 32, 3,
                      generator=torch.Generator().manual_seed(13))
    cond1 = torch.randn(1, COND_DIM, generator=torch.Generator().manual_seed(14))
    for heads, paths in (('8x16', (('default', {}), ('fused', FUSED_ENV))),
                         ('32x8', (('default', {}),))):
        small = cond_stack_kwargs(heads, image_size=32)
        out[heads]['card_vs_cpu'], counts = card_against_cpu(
            torch, dev, f'cond stack {heads}',
            lambda device, path: VideoTokenizer(
                seed=0, device=device,
                **dict(small, lane_pack=path == 'fused')),
            clip, paths=paths, cond=cond1)
        for path, c in counts.items():
            taylor = c['taylor_attention_block']
            if (c['taylor_attention_block_no_norm'] != taylor
                    or (taylor > 0) != (heads == '8x16')):
                fail(f'cond stack {heads} float32 {path}: Taylor blocks '
                     f'{taylor}, {c["taylor_attention_block_no_norm"]} on the '
                     f'no-norm route')
    return out


def cond_stream(torch, tok, video, cond):
    """The conditioned stack streamed with cond fixed for the session: its
    launches (COND_STREAM) and its codes against the whole clip's (bf16,
    the in-situ margin rule)."""
    (codes_s, recon_s), counts = counted(torch, lambda: stream_roundtrip(
        tok, video, README_CHUNK_FRAMES, README_CHUNK_LATENTS, cond=cond))
    check_launches('cond stack stream', counts, COND_STREAM)
    _, frac, worst = bits_against(torch, tok, video, codes_s, cond=cond,
                                  relative=True)
    log(f'[cond stack stream] bf16 batch {BATCH}, cond fixed for the '
        f'session: launches {counts}; code digits flipped against whole-clip '
        f'{frac:.4%} (worst margin {worst:.3e} of the largest |z|)')
    check_bits('cond stack bf16 stream', frac, worst,
               IN_SITU_TOL['worst_flip_margin'])
    if (tuple(recon_s.shape) != tuple(video.shape)
            or not bool(torch.isfinite(recon_s).all())):
        fail(f'cond stack stream: recon {tuple(recon_s.shape)}')
    return dict(launches=counts, digits_flipped=frac, worst_flip_margin=worst)


def phase_taylor_no_norm(torch, dev, reps):
    """B3's no-norm route (``gamma=None``, the conditioned linear
    attention's) at the flagship shape (160, 1024, 256), 16 heads x 8, the
    shape the conditioned stack gives it too: float32 and bf16 against its
    plain version (relative, the tolerances of phase 3), times, and the
    bound without the norm's bytes."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts, taylor_attention as ta)
    gen = torch.Generator().manual_seed(44)
    g, n, c, heads, dh = BATCH * 20, 1024, 256, 16, 8
    x, _, wqkv, wout = taylor_inputs(torch, gen, g, n)
    flops, nbytes = taylor_cost(g, n, c, heads, dh)
    case = dict(
        name='taylor_attention_block (no norm)',
        fn=lambda x, wqkv, wout, **kw: ta.taylor_attention(x, None, wqkv,
                                                           wout, **kw),
        ref=lambda x, wqkv, wout, **kw: ta.taylor_attention_ref(
            x, None, wqkv, wout, **kw),
        args=[t.to(dev) for t in (x, wqkv, wout)],
        kw=dict(heads=heads, dim_head=dh),
        cost=(flops, nbytes - 2 * c),        # no gamma to read
        library=None, library_call=None, relative=True)
    with torch.inference_mode():
        reset_launch_counts()
        ta.taylor_attention(case['args'][0].bfloat16(), None,
                            case['args'][1].bfloat16(),
                            case['args'][2].bfloat16(), heads, dh)
        counts = launch_counts()
        check_launches('taylor no-norm route', counts, {
            'taylor_attention_block': 1, 'taylor_attention_block_no_norm': 1,
            'rmsnorm': 0, 'gemm_wgmma': 2, 'taylor_core_mma': 1})
        row = dict(check_case(torch, case, reps), per='launch',
                   launches_alone=counts)
    torch.cuda.empty_cache()
    return row


def phase_pt_import(torch, dev, tok, video):
    """The reference's ``.pt`` package at README width: ``torch.save`` of the
    pickled kwargs and the reference-named state_dict of ``tok`` (bf16, on
    the card) to a temporary file, ``init_and_load_from_torch`` in bf16 on
    the card: weights, codes and reconstruction bit-identical to ``tok``'s."""
    import pickle
    import tempfile
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    codes, recon = whole_roundtrip(tok, video)
    kwargs = readme_video_tokenizer_kwargs(use_gan=False,
                                           perceptual_loss_weight=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'tokenizer.pt')
        torch.save({'model_state_dict': tok.state_dict(),
                    'config': pickle.dumps(kwargs), 'version': '0.0.0'}, path)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = VideoTokenizer.init_and_load_from_torch(
            path, device=dev, dtype=tok.dtype)
        load_s = time.perf_counter() - t0
    codes2, recon2 = whole_roundtrip(loaded, video)
    same = dict(weights=all(torch.equal(v, loaded.state_dict()[k])
                            for k, v in tok.state_dict().items()),
                codes=torch.equal(codes, codes2),
                recon=torch.equal(recon, recon2))
    log(f'[.pt import] README width {tok.dtype}: {size / 2 ** 20:.1f} MiB, '
        f'init_and_load_from_torch on {loaded.device} {load_s:.1f} s; '
        f'bit-identical {same}')
    if not all(same.values()):
        fail(f'.pt import on the card is not bit-identical: {same}')
    del loaded
    torch.cuda.empty_cache()
    return dict(same, load_s=load_s, bytes=size)


def phase_rest_of_serving(torch, dev, smi, profile_dir, reps):
    """Phase 9: config 5 whole-clip and streamed, the README stack
    streamed, the ``.pt`` import, the conditioned stack, B3's no-norm
    route. Returns the readings, the launches of each path it drove (each
    counted from 0) and B3's no-norm row."""
    out = dict(config5=phase_config5(torch, dev, smi))
    out['readme_stream'], tok, video = phase_readme_stream(torch, dev, smi)
    out['pt_import'] = phase_pt_import(torch, dev, tok, video)
    del tok, video
    torch.cuda.empty_cache()
    out['cond_stack'] = phase_cond_stack(torch, dev, smi, profile_dir)
    no_norm = phase_taylor_no_norm(torch, dev, reps)
    c5, cs, cs32 = (out['config5'], out['cond_stack']['8x16'],
                    out['cond_stack']['32x8'])
    paths = {'readme_stream': out['readme_stream']['launches'],
             'cond_stack_stream': cs['stream']['launches']}
    for path in ('default', 'fused'):
        paths[f'config5_{path}'] = c5[path]['launches']
        paths[f'config5_{path}_stream'] = c5[path]['stream_launches']
        paths[f'cond_stack_{path}'] = cs[path]['launches']
        paths[f'cond_stack_32x8_{path}'] = cs32[path]['launches']
    log(f'[rest of serving] on {smi}: config 5 bf16 frames/s whole-clip '
        f'default {c5["default"]["whole_fps"]:.2f}, fused '
        f'{c5["fused"]["whole_fps"]:.2f}; streamed default '
        f'{c5["default"]["stream_fps"]:.2f}, fused '
        f'{c5["fused"]["stream_fps"]:.2f}; streamed peak memory '
        f'{c5["default"]["stream_peak_share"]:.1%} of whole-clip (default); '
        f'cond stack (default / fused) {cs["default"]["fps"]:.2f} / '
        f'{cs["fused"]["fps"]:.2f} frames/s at heads 8 x 16 (B3), '
        f'{cs32["default"]["fps"]:.2f} / {cs32["fused"]["fps"]:.2f} at the '
        f"README's 32 x 8 (plain Taylor attention)")
    return out, paths, no_norm


# ---- phase 10: training -------------------------------------------------------

# the backward of each block: (kernels-line row, wrapper's backward counter)
BACKWARD_ROWS = {'space_attention_block': 'space_attention_block_backward',
                 'time_attention_block_fused': 'time_attention_block_backward',
                 'taylor_attention_block': 'taylor_attention_block_backward',
                 'residual_unit_wide': 'residual_unit_wide_backward',
                 'residual_unit_packed': 'residual_unit_packed_backward'}
# a backward on the card recomputes the function its reference
# differentiates, so the two agree to the order of their sums: float32
# within 1e-5 of each gradient's largest value; bf16 within 1e-2 (one bf16
# step is 2^-8 of a value, and the recompute's cuDNN and cuBLAS calls may
# pick other algorithms, with other sums, than the reference's)
BACKWARD_TOL = {'float32': 1e-5, 'bfloat16': 1e-2}
BACKWARD_REPS = 10
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4, 2, 8
TRAIN_LR = 1e-4
# the EMA decays from the first step on, so the EMA checks read a decayed
# update (the default waits 100 steps and copies until then)
TRAIN_EMA = dict(update_after_step=0, update_every=1)
# R1 at steps 2, 4, 6 (the discriminator from step 1): steps 4 and 6 are
# warm R1 steps, 3, 5 and 7 warm steps without it; the JAX package's default
# cadence, 4, costs (one R1 step + three others) / 4 a step
TRAIN_R1_EVERY = 2
R1_DEFAULT_EVERY = 4
# the tiny configuration of the tests (tests/fixtures/generate.py:152) with
# the space, time and Taylor layers, for the card against the CPU
TINY_TRAIN = dict(image_size=16, init_dim=8, codebook_size=64,
                  layers=('residual', ('compress_space', 16),
                          'linear_attend_space', ('compress_time', 16),
                          'attend_space', 'attend_time'),
                  attn_heads=2, linear_attn_heads=4,
                  discr_kwargs=dict(dim=4, image_size=16, channels=3,
                                    max_dim=16))
# float32 card against CPU, the same step: losses and gradients within 1e-4
# of their largest value (a gradient zero by its math, as the
# SqueezeExcite logit bias's, against 1e-3 of the largest gradient)
TRAIN_CPU_TOL = 1e-4
# the parameters' per-leaf bound holds the leaves whose first gradient
# reaches this share of the largest one in their network
TRAIN_GRAD_FLOOR = 1e-3


def backward_cases(torch, dev):
    """The five blocks at the flagship shapes (batch 8): each wrapper, the
    plain function its backward differentiates on the card (the counterpart
    of the JAX custom VJP's XLA twin), the inputs, and the counters a call
    must move."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        axial_attention as ax, residual_unit as ru, taylor_attention as ta)
    gen = torch.Generator().manual_seed(4321)

    def u(shape, fan_in):
        return uniform(torch, gen, shape, fan_in)

    packed = lambda fn: (lambda xb, *p: fn(
        xb.reshape(*xb.shape[:3], -1, 64), *p).reshape(xb.shape))
    c, t, hw = 256, 20, 32
    taylor = [torch.randn(BATCH * t, hw * hw, c, generator=gen),
              1 + 0.1 * torch.randn(c, generator=gen),
              u((3 * 128, c), c), u((c, 128), 128)]
    cases = [
        dict(name='space_attention_block', counter='space_attention_block',
             fn=lambda *a: ax.attention_block(*a, 8, 32, False),
             twin=lambda *a: ax.attention_block_ref(*a, 8, 32, False),
             args=[torch.randn(BATCH * 20, 256, 512, generator=gen),
                   *attn_params(torch, gen, 512, 8, 32)]),
        dict(name='time_attention_block_fused',
             counter='time_attention_block',
             fn=lambda *a: ax.time_attention_block(*a, 8, 32, True),
             twin=lambda *a: ax.time_attention_block_twin(*a, 8, 32, True),
             args=[torch.randn(*TIME_SHAPE, generator=gen),
                   *attn_params(torch, gen, 512, 8, 32)]),
        dict(name='taylor_attention_block', counter='taylor_attention_block',
             fn=lambda *a: ta.taylor_attention(*a, 16, 8),
             twin=lambda *a: ta.taylor_attention_twin(*a, 16, 8),
             args=taylor),
        dict(name='taylor_attention_block', counter='taylor_attention_block',
             variant='no_norm',
             fn=lambda x, q, o: ta.taylor_attention(x, None, q, o, 16, 8),
             twin=lambda x, q, o: ta.taylor_attention_twin(x, None, q, o, 16,
                                                           8),
             args=[taylor[0], taylor[2], taylor[3]]),
        dict(name='residual_unit_wide', counter='residual_unit_wide',
             fn=ru.fused_residual_unit_wide, twin=ru.residual_unit_ref,
             args=[torch.randn(B4_ROW_SHAPE, generator=gen),
                   *ru_params(torch, 512, gen)]),
        dict(name='residual_unit_packed', counter='residual_unit_packed',
             fn=lambda xb, *p: ru.fused_residual_unit(xb, *p, packed_io=True),
             twin=packed(ru.residual_unit_ref),
             args=[torch.randn(BATCH, *PACKED_STEM, PACKED_STEM[1] // 2, 128,
                               generator=gen), *ru_params(torch, 64, gen)]),
    ]
    for case in cases:
        case['args'] = [a.to(dev) for a in case['args']]
    return cases


def grads_of(torch, fn, leaves, g):
    return torch.autograd.grad(fn(*leaves), leaves, g)


def relative_grad_error(got, want):
    """The largest of each gradient's max abs error over its reference's
    largest value."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def check_backward(torch, case, reps):
    """One block forward + backward on the card in float32 (TF32 off) and
    bf16: the wrapper's gradients of x and of every parameter against
    ``torch.autograd.grad`` of its twin on the same inputs and upstream
    gradient; the forward and ``_backward`` counters; forward + backward
    times against the twin's."""
    from magvit2_pytorch_tpu_torch.ops.kernels import launch_counts
    name = case['name'] + (f' ({case["variant"]})' if 'variant' in case
                           else '')
    set_tf32(False)
    row, errs = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        key = 'float32' if dt == torch.float32 else 'bfloat16'
        leaves = [a.to(dt).requires_grad_(True) for a in case['args']]
        out = case['fn'](*leaves)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            7), dtype=torch.float32).to(out.device, dt)
        del out
        (got, counts) = counted(torch, lambda: grads_of(torch, case['fn'],
                                                        leaves, g))
        want = grads_of(torch, case['twin'], leaves, g)
        errs[key] = relative_grad_error(got, want)
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        fwd, bwd = case['counter'], BACKWARD_ROWS[case['name']]
        if counts[fwd] != 1 or counts[bwd] != 1 or not finite:
            fail(f'{name} backward {key}: counts {fwd} {counts[fwd]}, {bwd} '
                 f'{counts[bwd]}; finite {finite}')
        if case['name'] == 'time_attention_block_fused':
            route = 'fused' if dt == torch.bfloat16 else 'launches'
            if counts[f'time_attention_block_{route}'] != 1:
                fail(f'{name} {key}: not on the {route!r} route: {counts}')
        if not errs[key] <= BACKWARD_TOL[key]:
            fail(f'{name} backward {key}: gradient error {errs[key]:.3e} of '
                 f'the largest value > {BACKWARD_TOL[key]:g}')
        del got, want
        if dt == torch.bfloat16:
            row['ms'] = median_ms(lambda: grads_of(torch, case['fn'],
                                                   leaves, g), reps)
            row['plain_ms'] = median_ms(lambda: grads_of(
                torch, case['twin'], leaves, g), reps)
        del leaves, g
        torch.cuda.empty_cache()
    row.update(max_rel_err=errs['bfloat16'], max_rel_err_fp32=errs['float32'],
               shape=list(case['args'][0].shape),
               how='recompute through the plain version, as the JAX custom '
                   'VJP does')
    log(f'[backward] {name} {tuple(case["args"][0].shape)}: gradients of x '
        f'and every parameter against autograd of the twin, of the largest '
        f'value: fp32 {errs["float32"]:.3e} (tol '
        f'{BACKWARD_TOL["float32"]:g}), bf16 {errs["bfloat16"]:.3e} (tol '
        f'{BACKWARD_TOL["bfloat16"]:g}); bf16 forward + backward '
        f'{row["ms"]:.3f} ms, the twin\'s {row["plain_ms"]:.3f} ms (medians '
        f'of {reps}, one call a timing)')
    return row


class TrainVideos:
    """An in-memory dataset of uint8 clips from a seed, as a decoder gives
    them (the JAX package's tests feed its trainer the same way)."""

    def __init__(self, torch, n, frames, size, seed=0):
        gen = torch.Generator().manual_seed(seed)
        self.items = torch.randint(0, 256, (n, frames, size, size, 3),
                                   generator=gen, dtype=torch.uint8).numpy()

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def train_tokenizer(torch, dev, **overrides):
    """The README flagship with its GAN side as a user builds it: the
    default discriminator and VGG16 with the orthogonal fallback (no VGG
    weights are in the repo), seeded weights, float32 parameters, live
    SqueezeExcite gates."""
    import warnings
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)      # the VGG fallback
        tok = VideoTokenizer(seed=0, device=dev,
                             **readme_video_tokenizer_kwargs(**overrides))
    return live_gates(torch, tok)


def live_gates(torch, tok):
    """Live SqueezeExcite gates (``live_squeeze_excite_``, seeded): under
    the users' init every unit adds ~1e-4 of its branch, and no check could
    see a unit's weights."""
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(3))
    return tok


def make_trainer(torch, tok, tmp, **kw):
    from magvit2_pytorch_tpu_torch.training import VideoTokenizerTrainer
    args = dict(batch_size=TRAIN_BATCH, grad_accum_every=TRAIN_ACCUM,
                num_train_steps=TRAIN_STEPS, learning_rate=TRAIN_LR,
                warmup_steps=2, discr_start_after_step=1,
                apply_gradient_penalty_every=TRAIN_R1_EVERY,
                dataset=TrainVideos(torch, 16, 17, tok.image_size),
                valid_frac=0.0,
                checkpoints_folder=os.path.join(tmp, 'checkpoints'),
                results_folder=os.path.join(tmp, 'results'))
    args.update(kw)
    with contextlib.redirect_stdout(open(os.devnull, 'w')):
        return VideoTokenizerTrainer(tok, **args)


def record_first_grads(trainer):
    """The generator's gradients that step 0 hands its optimizer, copied to
    the host so that no later peak of device memory holds them (the
    returned dict fills when that step runs). The recorder then removes
    itself: the optimizer's own ``step`` takes the later steps, and no
    reference cycle keeps a deleted trainer's memory on the card."""
    first, opt = {}, trainer.optimizer

    def record(grads):
        del opt.step
        first.update({k: g.detach().cpu() for k, g in grads.items()})
        return opt.step(grads)

    opt.step = record
    return first


def leaf_errors(got, want):
    """Each leaf's largest difference over its own largest value (at least
    1e-3 of the largest value of any leaf)."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    return {k: ((got[k] - w).abs().max() / max(w.abs().max().item(), floor))
            .item() for k, w in want.items()}


def quiet_step(trainer, it):
    with contextlib.redirect_stdout(open(os.devnull, 'w')):
        return trainer.train_step(it)


def train_steps(torch, trainer, steps):
    """``steps`` train_steps from the trainer's loader: each step's metrics
    (floats) and host seconds (ending in a synchronize), the peak device
    memory of step 0 and of the rest, and the launches of all of them
    (counted from 0)."""
    from magvit2_pytorch_tpu_torch.data import cycle
    it = cycle(trainer.dataloader)
    metrics, seconds, peaks = [], [], []

    def run():
        for i in range(steps):
            if i in (0, 1):
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = quiet_step(trainer, it)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            if i in (0, steps - 1):
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    _, counts = counted(torch, run)
    return metrics, seconds, peaks, counts


def median(values):
    return sorted(values)[len(values) // 2]


def check_finite(what, metrics):
    bad = {k: v for m in metrics for k, v in m.items()
           if not (v == v and abs(v) != float('inf'))}
    if bad:
        fail(f'{what}: non-finite metrics {bad}')


# launches a training run takes on each path: every block forward and
# backward at least once; B4 and B5 on the fused path only; no flash
TRAIN_FORWARD = ('space_attention_block', 'time_attention_block',
                 'time_attention_block_fused', 'taylor_attention_block')


def check_train_launches(path, counts):
    need = [*TRAIN_FORWARD, *(BACKWARD_ROWS[k] for k in BACKWARD_ROWS
                              if not k.startswith('residual_unit'))]
    ru = ['residual_unit_wide', 'residual_unit_packed',
          'residual_unit_wide_backward', 'residual_unit_packed_backward']
    if path == 'fused':
        need += ru
    missing = [k for k in need if not counts[k] >= 1]
    extra = [k for k in (*FLASH_KERNELS, *([] if path == 'fused' else ru))
             if counts[k]]
    if missing or extra:
        fail(f'training {path}: launched none of {missing}, or some of '
             f'{extra}: {counts}')


def phase_train_flagship(torch, dev, smi, tmp, profile_dir):
    """The README flagship trained for TRAIN_STEPS steps on each path (the
    default one with monolithic accumulation, the fused one with split
    accumulation), then one step each with remat=True and remat='dots'
    against the default path's first step; the fused unit and the EMA's
    fused unit after an update against the plain version; the EMA
    tokenizer's roundtrip contract. Returns the readings and the launches
    of each path."""
    out, counts = {}, {}
    for path, env, split in (('default', {}, False), ('fused', FUSED_ENV,
                                                        True)):
        with environment(env):
            tok = train_tokenizer(torch, dev, lane_pack=path == 'fused')
            tr = make_trainer(torch, tok, os.path.join(tmp, path),
                              grad_accum_split=split, ema_kwargs=TRAIN_EMA)
            if path == 'default':
                base_grads = record_first_grads(tr)
            metrics, seconds, peaks, counts[path] = train_steps(
                torch, tr, TRAIN_STEPS)
            check_finite(f'training {path}', metrics)
            check_train_launches(path, counts[path])
            r1 = median([seconds[i] for i in (4, 6)])
            gan = median([seconds[i] for i in (3, 5, 7)])
            warm = (r1 + (R1_DEFAULT_EVERY - 1) * gan) / R1_DEFAULT_EVERY
            out[path] = dict(
                metrics=metrics, seconds=seconds, s_per_step=warm,
                s_r1_step=r1, s_gan_step=gan,
                samples_per_s=TRAIN_BATCH * TRAIN_ACCUM / warm,
                peak_gib_step0=peaks[0], peak_gib=max(peaks),
                accumulation='split' if split else 'monolithic',
                launches=counts[path],
                launches_per_step={k: v / TRAIN_STEPS
                                   for k, v in counts[path].items() if v})
            log(f'[train {path}] README flagship, bf16 policy, batch '
                f'{TRAIN_BATCH} x accum {TRAIN_ACCUM} '
                f'({out[path]["accumulation"]}), GAN from step 1, R1 every '
                f'{TRAIN_R1_EVERY}, VGG16 perceptual (orthogonal fallback): '
                f'seconds per step {[round(s, 4) for s in seconds]}: warm '
                f'with R1 {r1:.4f} s, without {gan:.4f} s, so {warm:.4f} '
                f's a step at R1 every {R1_DEFAULT_EVERY} (the default), '
                f'{out[path]["samples_per_s"]:.2f} samples/s; peak '
                f'{max(peaks):.2f} GiB (step 0 {peaks[0]:.2f}) on {smi}; '
                f'losses step 0 {metrics[0]["total_loss"]:.4f}, step '
                f'{TRAIN_STEPS - 1} {metrics[-1]["total_loss"]:.4f}, discr '
                f'{metrics[-1]["discr_loss"]:.4f}, R1 at step 2 '
                f'{metrics[2]["gradient_penalty"]:.4e}, adaptive weight '
                f'{metrics[-1]["adaptive_adversarial_weight"]:.4e}; launches '
                f'{ {k: v for k, v in counts[path].items() if v} }')
            if profile_dir:
                out[path]['profile'] = profile_train_step(
                    torch, tr, os.path.join(profile_dir,
                                            f'profile_train_{path}.txt'))
            if path == 'fused':
                out['after_update'] = check_units_after_update(torch, tr)
            else:
                out['roundtrip_contract'] = check_ema_roundtrip(torch, tr)
            del tok, tr
            torch.cuda.empty_cache()
    base = out['default']
    for remat in (True, 'dots'):
        tok = train_tokenizer(torch, dev, remat=remat)
        tr = make_trainer(torch, tok, os.path.join(tmp, f'remat_{remat}'))
        first = record_first_grads(tr)
        metrics, seconds, peaks, _ = train_steps(torch, tr, 1)
        errs = {k: abs(v - base['metrics'][0][k]) / max(
                    abs(base['metrics'][0][k]), 1e-6)
                for k, v in metrics[0].items()
                if k in ('total_loss', 'recon_loss', 'perceptual_loss',
                         'lfq_aux_loss')}
        # the losses come from the forward; the gradients from the backward,
        # where the checkpoints recompute
        grad_errs = leaf_errors(first, base_grads)
        worst = max(grad_errs, key=grad_errs.get)
        out[f'remat_{remat}'] = dict(
            metrics=metrics[0], seconds=seconds[0], peak_gib=peaks[0],
            rel_err=errs, grad_rel_err=grad_errs[worst], grad_worst=worst)
        log(f'[train remat={remat!r}] step 0 against no remat: losses '
            f'relative {errs}, the generator\'s gradients per leaf relative '
            f'to its largest value at most {grad_errs[worst]:.3e} ({worst}, '
            f'{len(grad_errs)} leaves; tol {STEP_TOL["bfloat16"]:g}); peak '
            f'{peaks[0]:.2f} GiB against {base["peak_gib_step0"]:.2f}; '
            f'{seconds[0]:.3f} s (cold)')
        if max(errs.values()) > STEP_TOL['bfloat16']:
            fail(f'remat={remat!r}: step 0 losses differ {errs}')
        if grad_errs[worst] > STEP_TOL['bfloat16']:
            fail(f'remat={remat!r}: step 0 gradients differ: {worst} '
                 f'{grad_errs[worst]:.3e}')
        if not peaks[0] < base['peak_gib_step0']:
            fail(f'remat={remat!r}: peak {peaks[0]:.2f} GiB not below '
                 f'{base["peak_gib_step0"]:.2f}')
        del tok, tr, first
        torch.cuda.empty_cache()
    return out, counts


def unit_at_512(module):
    """The decoder's first ResidualUnit at C = 512 (a B4 stage)."""
    from magvit2_pytorch_tpu_torch.ops.resample import ResidualUnit
    return next(m for n, m in module.named_modules()
                if isinstance(m, ResidualUnit) and m.dim == 512
                and n.startswith('decoder_layers'))


def check_units_after_update(torch, trainer):
    """Trouble spot of the weight re-lay cache: a B4 unit of the trained
    module and of the EMA module, float32 on the card (the f32 route, its
    own re-laid weights), run before and after one more train_step; after
    it, each output equals the plain version's on the updated weights, and
    the update is visible (the outputs moved by more than the tolerance).
    The step's EMA update is a decayed one (TRAIN_EMA): the EMA unit's
    weights are ``e * decay + p * (1 - decay)`` of its weights before and
    the trained ones after, with 0 < decay < 1, and its output is not the
    trained unit's."""
    from magvit2_pytorch_tpu_torch.data import cycle
    from magvit2_pytorch_tpu_torch.ops.kernels import residual_unit as ru
    from magvit2_pytorch_tpu_torch.training.ema import effective_decay
    set_tf32(False)
    units = {'trained': unit_at_512(trainer.module),
             'ema': unit_at_512(trainer.ema_module)}
    x = torch.randn(2, 5, 16, 16, units['ema'].dim, generator=torch
                    .Generator().manual_seed(5)).to(trainer.device)
    with torch.no_grad():
        before = {k: u(x) for k, u in units.items()}
    ema_before = [p.detach().clone() for p in units['ema'].parameters()]
    decay = effective_decay(trainer.step, trainer.ema_config)
    if not 0 < decay < 1:
        fail(f'EMA after an update: step {trainer.step} decays by {decay}, '
             f'not a decayed update ({trainer.ema_config})')
    quiet_step(trainer, cycle(trainer.dataloader))
    keep = 1.0 - decay
    ema_err = max((e - (b * decay + p * keep)).abs().max().item()
                  for e, b, p in zip(units['ema'].parameters(), ema_before,
                                     units['trained'].parameters()))
    out, after = {'ema_decay': decay, 'ema_weights_err': ema_err}, {}
    with torch.no_grad():
        for k, u in units.items():
            (got, counts) = counted(torch, lambda: u(x))
            after[k] = got
            want = ru.residual_unit_ref(x, *u._fused_params())
            err = (got - want).abs().max().item()
            moved = (got - before[k]).abs().max().item()
            out[k] = dict(max_abs_err=err, moved=moved,
                          launches=counts['residual_unit_wide'])
            if counts['residual_unit_wide'] != 1:
                fail(f'{k} unit after an update: not on B4 ({counts})')
            if not (err <= RU_TOL['float32'] < moved):
                fail(f'{k} unit after an update: error {err:.3e} against the '
                     f'plain version on the updated weights (tol '
                     f'{RU_TOL["float32"]:g}), moved {moved:.3e}')
    apart = (after['ema'] - after['trained']).abs().max().item()
    out['ema_apart'] = apart
    log(f'[train fused unit after an update] float32 B4 at '
        f'{tuple(x.shape)}, against the plain version on the new weights: '
        f'{out}')
    if not ema_err <= 1e-6:
        fail(f'EMA after an update: its weights are {ema_err:.3e} from '
             f'e * {decay} + p * {keep}')
    if not apart > RU_TOL['float32']:
        fail(f'EMA after an update: its unit computes the trained one '
             f'({apart:.3e})')
    return out


def check_ema_roundtrip(torch, trainer):
    """README: ``decode_from_code_indices(tokenize(v))`` within 1e-4 of
    ``forward(v, return_recon=True)``, on the EMA tokenizer."""
    ema = trainer.ema_tokenizer
    size = ema.image_size
    v = torch.rand(2, 17, size, size, 3, generator=torch.Generator()
                   .manual_seed(6)).to(trainer.device)
    codes, recon = ema.forward(v, return_codes=True, return_recon=True)
    back = ema.decode_from_code_indices(codes.reshape(codes.shape[0], -1))
    err = (back - recon).abs().max().item()
    log(f'[train EMA roundtrip] decode_from_code_indices(tokenize(v)) '
        f'against forward(v, return_recon=True): {err:.3e} (tol 1e-4)')
    if not err <= 1e-4:
        fail(f'EMA tokenizer roundtrip contract: {err}')
    return err


def profile_train_step(torch, trainer, path):
    """One warm train_step (the discriminator's, with R1 off the cadence
    or on it as the step falls) under ``torch.profiler``: device time by
    kernel into ``path``, and the share of device time under the blocks'
    backward recompute (the autograd nodes of ``_Block``, ``_TaylorBlock``
    and ``_Unit``)."""
    from torch.profiler import ProfilerActivity, profile
    from magvit2_pytorch_tpu_torch.data import cycle
    it = cycle(trainer.dataloader)
    quiet_step(trainer, it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        quiet_step(trainer, it)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    # the autograd nodes themselves (their evaluate_function wrappers hold
    # the same kernels): the device time of everything they launch
    recompute = sum(e.device_time_total for e in events
                    if e.key in ('_BlockBackward', '_TaylorBlockBackward',
                                 '_UnitBackward')) / 1e3
    with open(path, 'w') as f:
        f.write(events.table(sort_by='self_device_time_total',
                             row_limit=60))
    log(f'[train profile] one warm step (no R1) {total:.2f} device ms, '
        f'{recompute:.2f} under the blocks\' backward recompute '
        f'({recompute / max(total, 1e-9):.1%}); table in {path}')
    return dict(device_ms=total, recompute_ms=recompute,
                recompute_share=recompute / max(total, 1e-9))


def tiny_vgg_file(torch, path):
    """VGG16 weights at the fan-in scale from a seed, in torchvision's
    names, for both tokenizers of the card-against-CPU check (the
    orthogonal fallback's QR would take the CPU tens of seconds)."""
    from magvit2_pytorch_tpu_torch.models.vgg import (
        VGG16Features, conv_and_linear_names)
    gen = torch.Generator().manual_seed(21)
    vgg = VGG16Features()
    state = {}
    for prefix, _ in conv_and_linear_names():
        w = vgg.get_submodule(prefix).weight
        state[f'{prefix}.weight'] = torch.randn(
            w.shape, generator=gen) * (2 / w[0].numel()) ** 0.5
        state[f'{prefix}.bias'] = torch.randn(w.shape[0], generator=gen) * 0.01
    torch.save(state, path)


def first_step_grads(torch, trainer, batch):
    """Micro-step 0 of step 0 as the trainer computes it: the generator's
    loss and gradients (its draws), then the discriminator's with R1."""
    from magvit2_pytorch_tpu_torch.training import losses
    cfg = trainer.model.config
    b, t = batch.shape[:2]
    gen = trainer._generator(0, 0, 0)
    total, _, _ = losses.tokenizer_loss(
        trainer.module, batch, losses.draw_tokenizer_loss(b, t, gen),
        discr=trainer.discr, vgg=trainer.vgg, train=True, use_vgg=True,
        has_gan=True, perceptual_loss_weight=cfg.perceptual_loss_weight,
        generator=gen)
    params = list(trainer.module.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    dtotal, _ = losses.discriminator_loss(
        trainer.module, trainer.discr, batch,
        losses.draw_frames(b, t, trainer._generator(0, 1, 0)),
        apply_gradient_penalty=True)
    dgrads = torch.autograd.grad(dtotal, list(trainer.discr.parameters()))
    return [total, dtotal], [*grads, *dgrads]


def phase_train_card_vs_cpu(torch, dev, tmp):
    """The tiny configuration in float32 (TF32 off) on the card and the
    CPU with the same weights, data and draws: the first step's losses and
    gradients (generator with the perceptual and adaptive terms,
    discriminator with R1) within TRAIN_CPU_TOL of their largest value; two
    train_steps each; the generator's and the discriminator's parameters
    after the second step within 2 lr a step of each other (Adam moves a
    weight by about lr in the sign of its gradient; one near 0 may take
    either sign), and in each leaf 99% of them within 1e-2 lr, for each
    leaf whose first gradient on the CPU reaches TRAIN_GRAD_FLOOR of the
    largest one in its network (below that, as for the SqueezeExcite logit
    bias whose gradient is zero by its math, float32's order of sums
    decides Adam's step)."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.data import cycle
    from magvit2_pytorch_tpu_torch.utils.precision import Policy
    set_tf32(False)
    vgg = os.path.join(tmp, 'vgg16.pth')
    tiny_vgg_file(torch, vgg)
    threads = torch.get_num_threads()
    # the CPU's intra-op threads race in R1's double backward (heap
    # corruption seen with several threads on the CPU build); one thread
    torch.set_num_threads(1)
    try:
        runs = {}
        for device in (dev, 'cpu'):
            tok = live_gates(torch, VideoTokenizer(
                seed=0, device=device, vgg_weights=vgg, **TINY_TRAIN))
            tr = make_trainer(torch, tok, os.path.join(tmp, f'tiny_{device}'),
                              batch_size=2, discr_start_after_step=0,
                              apply_gradient_penalty_every=1,
                              dataset=TrainVideos(torch, 8, 5, 16, seed=3),
                              policy=Policy())
            batch = tr._to_device(tr.dataset.items[:2], torch.float32)
            losses, grads = first_step_grads(torch, tr, batch)
            it = cycle(tr.dataloader)
            metrics = [quiet_step(tr, it) for _ in range(2)]
            params = [(f'{prefix}.{n}', p.detach().cpu())
                      for prefix, net in (('module', tr.module),
                                          ('discr', tr.discr))
                      for n, p in net.named_parameters()]
            runs[str(device)] = ([l.detach().cpu() for l in losses],
                                 [g.cpu() for g in grads], metrics, params)
    finally:
        torch.set_num_threads(threads)
    (lc, gc, mc, pc), (lh, gh, mh, ph) = runs[str(dev)], runs['cpu']
    loss_err = max(((a - b).abs() / b.abs()).item() for a, b in zip(lc, lh))
    floor = 1e-3 * max(g.abs().max().item() for g in gh)
    grad_err = max(((a - b).abs().max() / max(b.abs().max().item(), floor))
                   .item() for a, b in zip(gc, gh))
    # gh holds the generator's gradients, then the discriminator's: the
    # parameters' order
    if len(gh) != len(ph):
        fail(f'training card vs CPU: {len(gh)} gradients for {len(ph)} '
             f'parameters')
    largest = {}
    for (name, _), g in zip(ph, gh):
        net = name.split('.')[0]
        largest[net] = max(largest.get(net, 0.0), g.abs().max().item())
    max_diff, q99 = 0.0, {}
    for (name, a), (_, b), g in zip(pc, ph, gh):
        diff = (a - b).abs().flatten()
        max_diff = max(max_diff, diff.max().item())
        if g.abs().max() >= TRAIN_GRAD_FLOOR * largest[name.split('.')[0]]:
            q99[name] = diff.quantile(0.99).item()
    worst = max(q99, key=q99.get)
    out = dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
               param_max_diff=max_diff, param_q99_diff=q99[worst],
               param_q99_worst=worst, leaves=len(pc), leaves_held=len(q99),
               leaves_not_held=sorted(set(n for n, _ in pc) - set(q99)),
               metrics_card=mc[-1], metrics_cpu=mh[-1])
    log(f'[train card vs CPU] tiny float32 (TF32 off): step 0 losses '
        f'{loss_err:.3e}, gradients {grad_err:.3e} of the largest value (tol '
        f'{TRAIN_CPU_TOL:g}); generator and discriminator parameters after 2 '
        f'steps: max |diff| {max_diff:.3e} (bound {4 * TRAIN_LR:g}), each '
        f'leaf\'s 99% within at most {q99[worst]:.3e} ({worst}; bound '
        f'{1e-2 * TRAIN_LR:g}; the {len(q99)} of {len(pc)} leaves whose '
        f'first gradient reaches {TRAIN_GRAD_FLOOR:g} of the largest, not '
        f'{out["leaves_not_held"]})')
    if not (loss_err <= TRAIN_CPU_TOL and grad_err <= TRAIN_CPU_TOL):
        fail(f'training card vs CPU: step 0 losses {loss_err}, gradients '
             f'{grad_err}')
    if not (max_diff <= 4 * TRAIN_LR and q99[worst] <= 1e-2 * TRAIN_LR):
        fail(f'training card vs CPU: parameters after 2 steps {out}')
    return out


def phase_train_resume(torch, dev, tmp):
    """save -> load -> one more step on the card, bit for bit the step
    without the reload (the tiny configuration, bf16 policy, deterministic
    cuDNN algorithms, no VGG: its pooling's backward adds with atomics)."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    data = TrainVideos(torch, 8, 5, 16, seed=4)
    batches = [(data.items[i:i + 2],) for i in (0, 2, 4, 6)] * 3
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kw = dict(TINY_TRAIN, perceptual_loss_weight=0.0)
        a = make_trainer(torch, VideoTokenizer(seed=0, device=dev, **kw),
                         os.path.join(tmp, 'resume_a'), batch_size=2,
                         dataset=data)
        it = iter(batches)
        for _ in range(2):
            quiet_step(a, it)
        path = os.path.join(tmp, 'checkpoint.resume')
        a.save(path)
        rest = list(it)
        want = quiet_step(a, iter(rest))
        b = make_trainer(torch, VideoTokenizer(seed=9, device=dev, **kw),
                         os.path.join(tmp, 'resume_b'), batch_size=2,
                         dataset=data)
        b.load(path)
        got = quiet_step(b, iter(rest))
    finally:
        torch.backends.cudnn.deterministic = det
    same = dict(metrics=got == want, **{
        name: all(torch.equal(x, y) for x, y in zip(
            getattr(a, name).state_dict().values(),
            getattr(b, name).state_dict().values()))
        for name in ('module', 'ema_module', 'discr')})
    log(f'[train resume] save -> load -> one step against the same step '
        f'without the reload: bit-identical {same}')
    if not all(same.values()):
        fail(f'resume is not bit-identical: {same}')
    return same


def phase_training(torch, dev, smi, profile_dir, reps=BACKWARD_REPS):
    """Phase 10. Returns the readings, each block's backward row (for the
    kernels line) and the launches of each training path."""
    import tempfile
    t0 = time.perf_counter()
    rows = {}
    for case in backward_cases(torch, dev):
        row = check_backward(torch, case, reps)
        if 'variant' in case:
            rows[case['name']][case['variant']] = row
        else:
            rows[case['name']] = row
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out, counts = phase_train_flagship(torch, dev, smi, tmp, profile_dir)
        out['card_vs_cpu'] = phase_train_card_vs_cpu(torch, dev, tmp)
        out['resume'] = phase_train_resume(torch, dev, tmp)
    for name, row in rows.items():
        row['launches_per_step'] = {
            p: counts[p][BACKWARD_ROWS[name]] / TRAIN_STEPS for p in counts}
    out['seconds'] = time.perf_counter() - t0
    log(f'[training] on {smi}: s/step default {out["default"]["s_per_step"]:.4f}'
        f', fused {out["fused"]["s_per_step"]:.4f}; samples/s '
        f'{out["default"]["samples_per_s"]:.2f} / '
        f'{out["fused"]["samples_per_s"]:.2f}; peak GiB '
        f'{out["default"]["peak_gib"]:.2f} / {out["fused"]["peak_gib"]:.2f}; '
        f'the phase took {out["seconds"]:.1f} s')
    return out, rows, {f'train_{p}': c for p, c in counts.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None,
                        help='directory for the compiler log, a copy of '
                             'the log lines and the kernels line')
    parser.add_argument('--profile', action='store_true',
                        help='also profile one roundtrip of each path '
                             '(needs --out)')
    args = parser.parse_args()
    if args.profile and not args.out:
        parser.error('--profile needs --out')

    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this check needs a GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import magvit2_pytorch_tpu_torch  # noqa: F401
        from magvit2_pytorch_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f'the port package is not beside this script: {e}')
    for name in (*FUSED_ENV, 'MAGVIT2_TPU_NO_FUSED_RU',
                 'MAGVIT2_TPU_NO_FUSED_RU_WIDE', 'MAGVIT2_TPU_NO_FUSED_RU_W64',
                 'MAGVIT2_TPU_NO_FUSED_ATTN'):
        os.environ.pop(name, None)        # the default path is the default
    dev = torch.device('cuda', 0)
    torch.manual_seed(0)

    smi = nvidia_smi()
    log(f'[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; '
        f'torch {torch.__version__}, CUDA {torch.version.cuda}')

    t0 = time.perf_counter()
    _build.load_library()
    log(f'[build] {_build.build_info["path"]} in '
        f'{time.perf_counter() - t0:.1f} s (nvcc '
        f'{_build.build_info["seconds"]:.1f} s)')
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'nvcc.log'), 'w') as f:
            f.write(_build.build_info.get('log', ''))
        LOG_FILES.append(open(os.path.join(args.out, 'chip_smoke.log'), 'w'))

    with torch.inference_mode():
        kernel_rows = phase_kernels(torch, dev, REPS)
        torch.cuda.empty_cache()
        split, kernel_rows['ru_conv_wgmma'], extra = phase_ru_launches(
            torch, dev, REPS, smi)
        b4 = kernel_rows['residual_unit_wide']
        b4.update(split_ms=split, extra_cases=extra)
        for stage, conv in zip(b4['stages'],
                               kernel_rows['ru_conv_wgmma']['stages']):
            stage['conv'] = conv
        torch.cuda.empty_cache()
        kernel_rows['gemm_wgmma'] = phase_gemm(torch, dev, REPS, smi)
        torch.cuda.empty_cache()
        kernel_rows['space_attention_core_mma'], split = phase_space_block(
            torch, dev, REPS, smi)
        kernel_rows['space_attention_block']['split_ms'] = split
        torch.cuda.empty_cache()
        kernel_rows['time_attention_block_fused'] = phase_time_block(
            torch, dev, REPS, smi)
        torch.cuda.empty_cache()
        kernel_rows['taylor_core_mma'], split = phase_taylor_block(
            torch, dev, REPS, smi)
        kernel_rows['taylor_attention_block']['split_ms'] = split
        torch.cuda.empty_cache()
        for name, rows in phase_config4_kernels(torch, dev, REPS).items():
            kernel_rows[name]['config4_shapes'] = rows
    torch.cuda.empty_cache()
    kernel_rows.update(phase_flash_kernels(torch, dev, REPS, smi))
    torch.cuda.empty_cache()
    profile_dir = args.out if args.profile else None
    counts, tp = {}, {}
    counts['default'], tp['default'] = drive_path(torch, dev, 'default', smi,
                                                  profile_dir)
    with environment(FUSED_ENV):
        counts['fused'], tp['fused'] = drive_path(torch, dev, 'fused', smi,
                                                  profile_dir)
    log(f'[throughput] frames/s, bf16 batch {BATCH}: default '
        f'{tp["default"]["fps"]:.2f}, fused {tp["fused"]["fps"]:.2f} on {smi}')
    phase_card_vs_cpu(torch, dev)
    phase_taylor_roundtrip(torch, dev)
    configs = dict(config4=phase_config4(torch, dev, smi, profile_dir),
                   config3=phase_config3(torch, dev, smi),
                   **phase_small_configs(torch, dev))
    log(f'[throughput configs] bf16 on {smi}: config 4 default '
        f'{configs["config4"]["default"]["fps"]:.2f} images/s, fused '
        f'{configs["config4"]["fused"]["fps"]:.2f}; config 3 (FSQ) '
        f'{configs["config3"]["fps"]:.2f} frames/s')
    configs['rest_of_serving'], paths, no_norm = phase_rest_of_serving(
        torch, dev, smi, profile_dir, REPS)
    counts.update(paths)
    kernel_rows['taylor_attention_block']['no_norm'] = no_norm
    counts['attention_step'] = phase_attention_step(torch, dev, REPS, smi)
    training, backward, train_paths = phase_training(torch, dev, smi,
                                                     profile_dir)
    counts.update(train_paths)
    for name, row in backward.items():
        kernel_rows[name]['backward'] = row
    configs['training'] = training

    if 'jax' in sys.modules:
        fail('JAX was imported')
    # the contract's keys last: a row's own 'route' (the GEMM's) gives way
    kernels = [{**kernel_rows[name], 'name': name, 'route': 'cuda',
                'source': source, 'replaces': replaces,
                # on the path that runs the kernel: a fused roundtrip, or
                # one step of the general Attention path
                'launches': counts['attention_step' if name in FLASH_KERNELS
                                   else 'fused'][name],
                'launches_by_path': {p: counts[p][name] for p in counts},
                # all of this kernel's calls in one warm fused roundtrip
                'fused_roundtrip_ms': tp['fused']['ru_ms'].get(name)}
               for name, (source, replaces) in KERNELS.items()]
    for row in kernels:
        missing = [k for k in KERNEL_KEYS if k not in row]
        if missing:
            fail(f'kernels line: {row["name"]} lacks {missing}')
        if not row['launches'] >= 1:
            fail(f'{row["name"]} was not launched on its path')
    if args.out:     # the whole line, which the end of the output may cut
        with open(os.path.join(args.out, 'kernels.json'), 'w') as f:
            json.dump({'kernels': kernels}, f)
        with open(os.path.join(args.out, 'configs.json'), 'w') as f:
            json.dump(configs, f)
    for f in LOG_FILES:
        f.close()
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
