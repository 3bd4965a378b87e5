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
                # (..., codebook, bits) -> the one codebook's bits
                z = tok.module.quantizers.sign_values(lat)[..., 0, :]
            codes_plain = runs['plain']['codes'] if runs else codes
            recon = tok.decode_from_code_indices(codes_plain)
            torch.cuda.synchronize()
            counts = launch_counts()
        runs[name] = dict(lat=lat, codes=codes, z=z, recon=recon)
        if any(counts[key] != n for key, n in want.items()):
            fail(f'in-situ check, {name}: encode + decode launched {counts}, '
                 f'expected {want}')
    plain, blocks = runs['plain'], runs['blocks']
    mask = 2 ** torch.arange(9, -1, -1, device=video.device)
    flipped = (((plain['codes'][..., None] & mask) != 0)
               != ((blocks['codes'][..., None] & mask) != 0))
    zmax = plain['z'].abs().max().item()
    worst = (plain['z'].abs()[flipped].max().item() / zmax
             if flipped.any() else 0.0)
    got = dict(latents=relative_error(blocks['lat'], plain['lat']),
               bits_flipped=flipped.float().mean().item(),
               worst_flip_margin=worst,
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


def phase_roundtrip(torch, what, tok, video, codes_shape, launches,
                    ru_shapes):
    """One bf16 roundtrip of ``video`` (a batch of clips, or of images)
    through the user's entry points, ``tokenize`` and
    ``decode_from_code_indices``, the launch counts set to 0 just before and
    read just after, and the ResidualUnit kernels' calls by shape; then a
    second, warm roundtrip times each of those calls with CUDA events. Fails
    unless the codes are integers of ``codes_shape`` in the codebook, the
    reconstruction is finite and of the input's shape (a frame axis added
    for images), the launches are ``launches`` and the calls by shape
    ``ru_shapes``. Returns the counts and each RU kernel's summed ms in the
    warm run."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    n = video.shape[0]
    recon_shape = (tuple(video.shape) if video.dim() == 5
                   else (n, 1, *video.shape[1:]))

    def roundtrip():
        codes = tok.tokenize(video)
        return codes, tok.decode_from_code_indices(codes.reshape(n, -1))

    torch.cuda.synchronize()
    with timed_ru_calls(torch) as calls:
        reset_launch_counts()
        t0 = time.perf_counter()
        codes, recon = roundtrip()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    by_shape = {k: c for k, (c, _) in ru_calls_by_shape(calls).items()}
    with timed_ru_calls(torch) as calls:
        roundtrip()
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


def phase_throughput(torch, tok, video, n_short=2, n_long=10):
    """Frames (images, for a one-frame clip) per second of chained bf16
    roundtrips, by the slope of ``n_long`` against ``n_short`` runs."""
    module = tok.module
    x0 = video.to(torch.bfloat16)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            v = x0
            for i in range(n):
                recon, _ = module(v)
                v = recon + 1e-6 * i      # data dependency across iterations
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(n_short)                          # warm up
    t_short, t_long = run(n_short), run(n_long)
    per_iter = (t_long - t_short) / (n_long - n_short)
    fps = video.shape[0] * video.shape[1] / per_iter
    return dict(fps=fps, ms_per_roundtrip=per_iter * 1e3,
                t_short=t_short, t_long=t_long)


def profile_roundtrip(torch, tok, video, path, slope_ms):
    """One bf16 roundtrip under torch.profiler: the device time of its
    kernels (device events only, so no operator row counts its kernels a
    second time), their share of ``slope_ms`` (the unprofiled roundtrip time
    from the throughput phase), and a table by kernel in ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = video.to(torch.bfloat16)
    with torch.inference_mode():
        tok.module(x)                     # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tok.module(x)
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


def config_tokenizer(torch, name, device, dtype):
    """A tokenizer of ``configs.<name>()`` with seeded random weights, for
    serving (no GAN, no perceptual loss)."""
    import warnings
    from magvit2_pytorch_tpu_torch import VideoTokenizer, configs
    kwargs = getattr(configs, name)(use_gan=False, perceptual_loss_weight=0.0)
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


def card_against_cpu(torch, dev, what, make, clip, paths=(('default', {}),)):
    """float32, TF32 off, live SqueezeExcite gates: the card's codes and its
    reconstruction from the CPU's codes against the CPU, on the same
    weights, under the contract of MARGIN_TOL, DIGITS_TOL and RECON_TOL.
    ``make(device, path)`` builds the tokenizer (``path`` None for the
    CPU); each of ``paths`` is run with its environment. Returns the
    readings and the launches of each path."""
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    set_tf32(False)
    live = lambda tok: live_squeeze_excite_(
        tok.module, torch.Generator().manual_seed(11))
    cpu = make('cpu', None)
    live(cpu)
    t0 = time.perf_counter()
    lat_cpu = cpu.encode(clip)
    with torch.inference_mode():
        codes_cpu = cpu.module.quantize(lat_cpu).indices     # as tokenize
    margins = decision_margins(torch, cpu.module.quantizers, lat_cpu)
    recon_cpu = cpu.decode_from_code_indices(codes_cpu)
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
            codes_card = card.tokenize(clip).cpu()
            lat_card = card.encode(clip).cpu()
            recon_card = card.decode_from_code_indices(
                codes_cpu.to(dev)).cpu()
            counts[path] = launch_counts()
        del card
        torch.cuda.empty_cache()
        flipped = digits_cpu != code_digits(torch, quantizer, codes_card)
        frac = flipped.float().mean().item()
        worst = margins[flipped].max().item() if flipped.any() else 0.0
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
        if frac > DIGITS_TOL:
            fail(f'{what} {path}: {frac:.2%} of code digits flipped '
                 f'(> {DIGITS_TOL:.0%})')
        if worst > MARGIN_TOL:
            fail(f'{what} {path}: a code digit flipped at CPU margin {worst} '
                 f'> {MARGIN_TOL}')
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
    counts['attention_step'] = phase_attention_step(torch, dev, REPS, smi)

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
