#!/usr/bin/env python3
"""Where a block of the fused time block (``csrc/time_attention.cu``) spends
its clocks, on one NVIDIA GPU.

    python3 tools/time_block_phases.py                 # the flagship shape
    python3 tools/time_block_phases.py --pixels 8 12 --no-stream

Builds a copy of ``csrc/time_attention.cu`` in which thread 0 of block (0, 0)
reads ``clock64()`` at the kernel's phase boundaries (set-up, the wait for
x, the norm, the qkv GEMM, the attention, the out GEMM) and sums its waits
for the weight ring's tiles, into
``magvit2_pytorch_tpu_torch/_build/variants/`` (git-ignored). With
``--no-stream`` it also builds a variant whose producer loads only the
ring's first tiles and whose consumers reuse them without waiting: its
GEMM phases show what the consumers take without the weight stream (its
output is wrong, and its error is printed as such). Runs the flagship's
time block, (8, 5, 256, 512) bf16 causal, 8 heads x 32, 4 memory keys,
at each pixel count a block (``--pixels``; the wrapper's choice by
default), checks the output of the real variant against the bf16 plain
version, and prints the clocks by phase and the median of 20 CUDA-event
timings of 20 back-to-back launches, with the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

from variant_build import build, card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ('set-up', 'x wait', 'norm', 'qkv GEMM', 'attention', 'out GEMM')
HERE = 'if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)'
# (text of the kernel, what it becomes): the clock at each phase boundary
# (slots 0..6), thread 0's waits on the ring in slot 15, and a C entry
# point that reads the slots back
PROBES = (
    ('namespace mv2 {\n',
     'namespace mv2 {\n__device__ long long tb_clock[16];\n'
     'constexpr int kTbNoStream = 0;\n'
     f'#define CLOCK(i) {HERE} tb_clock[i] = clock64();\n'),
    ('    mbar_wait(&full[s], (tile / stages) & 1);\n',
     '    const long long w0 = clock64();\n'
     '    if (!kTbNoStream || tile < stages)\n'
     '      mbar_wait(&full[s], (tile / stages) & 1);\n'
     f'    {HERE} tb_clock[15] += clock64() - w0;\n'),
    ('      for (int i = 0; i < total; ++i) {',
     '      for (int i = 0; i < (kTbNoStream ? stages : total); ++i) {'),
    ('  const int pchunks = (C > inner ? C : inner) / kSw128Cols;\n',
     '  const int pchunks = (C > inner ? C : inner) / kSw128Cols;\n'
     f'  CLOCK(0)\n  {HERE} tb_clock[15] = 0;\n'),
    ('  __syncthreads();  // the barriers are initialised: the last block '
     'barrier\n', '  __syncthreads();\n  CLOCK(1)\n'),
    ('  mbar_wait(&xbar, 0);\n\n', '  mbar_wait(&xbar, 0);\n  CLOCK(2)\n\n'),
    ("  fence_proxy_async();  // the normed panel is wgmma's A\n"
     '  bar_sync(1, kTbWorkThreads);\n',
     "  fence_proxy_async();\n  bar_sync(1, kTbWorkThreads);\n  CLOCK(3)\n"),
    ('  bar_sync(1, kTbWorkThreads);\n\n  // ---- attention',
     '  bar_sync(1, kTbWorkThreads);\n  CLOCK(4)\n\n  // ---- attention'),
    ("  fence_proxy_async();  // the attn panel is wgmma's A\n"
     '  bar_sync(1, kTbWorkThreads);\n',
     '  fence_proxy_async();\n  bar_sync(1, kTbWorkThreads);\n  CLOCK(5)\n'),
    ('    bar_sync(2, kTbMmaThreads);  // the stage is rewritten by the next '
     'chunk\n  }\n}',
     '    bar_sync(2, kTbMmaThreads);\n  }\n  CLOCK(6)\n}'),
    ('extern "C" {\n',
     'extern "C" {\nint mv2_tb_clock(void* out) {\n  return '
     'cudaMemcpyFromSymbol(out, mv2::tb_clock, sizeof(long long) * 16);\n}\n'),
)


def probed_source(out_dir: str) -> str:
    """A copy of ``csrc`` in ``out_dir`` with the probes in
    ``time_attention.cu``; exits when a probe's text is no longer there."""
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.SOURCE_DIR, out_dir)
    path = os.path.join(out_dir, 'time_attention.cu')
    text = open(path).read()
    for old, new in PROBES:
        if old not in text:
            sys.exit(f'{old!r} not in csrc/time_attention.cu: update PROBES')
        text = text.replace(old, new, 1)
    with open(path, 'w') as f:
        f.write(text)
    return out_dir


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--pixels', nargs='+', type=int, default=None,
                        help='pixels a block (default: the wrapper\'s)')
    parser.add_argument('--no-stream', action='store_true',
                        help='also the variant without the weight stream')
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernel: no GPU')
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, axial_attention as ax)
    src = probed_source(str(_build.BUILD_DIR / 'variants' / 'csrc_clock'))
    variants = [(0,), (1,)] if args.no_stream else [(0,)]
    libs = build('time_attention.cu', {'constexpr int kTbNoStream = 0;':
                                       'TB_NO_STREAM'}, variants,
                 ('mv2_time_attention_block', 'mv2_time_block_plan'),
                 source_dir=src, tag='clock')
    dev = torch.device('cuda', 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t, s, c, heads, dh, m = 8, 5, 256, 512, 8, 32, 4
    gen = torch.Generator().manual_seed(0)
    inner = heads * dh
    x = torch.randn(b, t, s, c, generator=gen).to(dev).bfloat16()
    params = [1 + 0.1 * torch.randn(c, generator=gen),
              (torch.rand(3 * inner, c, generator=gen) * 2 - 1) * c ** -0.5,
              torch.randn(2, heads, m, dh, generator=gen),
              (torch.rand(c, inner, generator=gen) * 2 - 1) * inner ** -0.5]
    gamma, wqkv, mem_kv, wout = (p.to(dev).bfloat16() for p in params)
    out = torch.empty_like(x)
    stream = _build.stream_handle(dev)
    pixels = args.pixels or [ax.time_block_pixels(b, t, s, sms)]
    print(f'{card()}; {sms} SMs; shape {(b, t, s, c)}, {heads} heads x {dh}, '
          f'{m} memory keys, causal')
    with torch.inference_mode():
        want = ax.time_attention_block_ref(x, gamma, wqkv, mem_kv, wout,
                                           heads, dh, True).float()
        for (no_stream,), (lib, log) in libs.items():
            lib.mv2_tb_clock.argtypes = [ctypes.c_void_p]
            used = [ln.strip() for ln in log.splitlines() if 'Used' in ln]
            print(f'no stream {bool(no_stream)}: ptxas {used}')
            for p in pixels:
                plan = (ctypes.c_int * 2)()     # ring stages, shared memory
                if lib.mv2_time_block_plan(t, p, c, heads, dh, m, plan) != 0:
                    sys.exit(f'the kernel does not take {p} pixels')

                def call():
                    return lib.mv2_time_attention_block(
                        x.data_ptr(), gamma.data_ptr(), wqkv.data_ptr(),
                        mem_kv[0].data_ptr(), mem_kv[1].data_ptr(),
                        wout.data_ptr(), out.data_ptr(),
                        _build.dtype_code(x), b, t, s, c, heads, dh, m, p, 1,
                        ax.TIME_ROUTES['fused'], stream)

                if call() != 0:
                    sys.exit(f'launch failed at {p} pixels')
                torch.cuda.synchronize()
                err = ((out.float() - want).abs().max()
                       / want.abs().max()).item()
                clocks = (ctypes.c_longlong * 16)()
                lib.mv2_tb_clock(ctypes.cast(clocks, ctypes.c_void_p))
                by = {name: clocks[i + 1] - clocks[i]
                      for i, name in enumerate(PHASES)}
                print(f'  {p} pixels a block ({-(-s // p) * b} blocks; ring '
                      f'{plan[0]} x 256 rows, {plan[1]} B of shared memory): '
                      f'clocks of block (0, 0) '
                      f'{by}, total {clocks[6] - clocks[0]}, thread 0 waiting '
                      f'on the ring {clocks[15]}; {median_ms(torch, call, 20):.4f} '
                      f'ms a launch; error over the largest value against the '
                      f'bf16 plain version {err:.3e}'
                      + (' (no stream: wrong by design)' if no_stream else ''))


if __name__ == '__main__':
    main()
