#!/usr/bin/env python3
"""Time the int8 conv kernel K2 (``csrc/int8_conv.cu`` ``conv_s8``) with
other block tiles and cp.async rings on one NVIDIA GPU.

    python3 tools/int8_conv_variants.py              # the default grid
    python3 tools/int8_conv_variants.py --variants 128x128x128x3 256x128x64x4

A variant is BMxBNxBKxSTAGES (``kS8BM``, ``kS8BN``, ``kS8BK``,
``kS8Stages``; warps of 64 x 32, BK bytes of K a stage). Builds the source
once per variant (one nvcc each, all started together) into
``magvit2_pytorch_tpu_torch/_build/variants/``, then in a process for each
variant checks its raw int32 accumulators against the plain version
(``conv_s8_ref``, exact) and times the bf16 output at the flagship's int8
site shapes (batch 8): the median of 20 CUDA-event timings of 10
back-to-back calls, with TOP/s of real taps. Prints ptxas's registers and
spills, and the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from variant_build import build, card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = {'constexpr int kS8BM = 128;': 'S8_BM',
             'constexpr int kS8BN = 128;': 'S8_BN',
             'constexpr int kS8BK = 64;': 'S8_BK',
             'constexpr int kS8Stages = 4;': 'S8_STAGES'}
# (what, x (B, T, H, W, C), weight (N, C, kt, kh, kw), stride, mode)
SHAPES = (
    ('unit conv C=128', (8, 20, 64, 64, 128), (128, 128, 3, 3, 3), 1, 0),
    ('unit conv C=512', (8, 20, 16, 16, 512), (512, 512, 3, 3, 3), 1, 0),
    ('unit 1x1 C=128', (8, 20, 64, 64, 128), (128, 128, 1, 1, 1), 1, 0),
    ('downsampler 128 -> 256', (8, 20, 64, 64, 128), (256, 128, 1, 3, 3), 2,
     0),
    ('upsampler 256 -> 128', (8, 20, 32, 32, 256), (512, 256, 1, 1, 1), 1,
     1),
)


def time_variant(path: str) -> dict:
    """Check and time the library at ``path`` at every shape: ms per shape,
    or the CUDA error a shape was refused with."""
    import ctypes

    import torch
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    from magvit2_pytorch_tpu_torch.ops.kernels import int8 as k8
    lib = ctypes.CDLL(path)
    lib.mv2_conv_s8.argtypes = _build.SIGNATURES['mv2_conv_s8']
    lib.mv2_conv_s8.restype = ctypes.c_int
    dev = torch.device('cuda', 0)
    stream = _build.stream_handle(dev)
    out_ms = {}
    with torch.inference_mode():
        for what, x_shape, w_shape, stride, mode in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            xq = torch.randint(-127, 128, x_shape, generator=gen, device=dev,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, w_shape, generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = k8.int8_weight(wq, torch.rand(w_shape[0], device=dev,
                                               generator=gen) * 1e-3)
            xs = torch.tensor(0.02, device=dev)
            bias = torch.randn(w_shape[0], device=dev,
                               generator=gen).bfloat16()
            want = k8.conv_s8_ref(xq, wq, stride)
            b, t, h, w, c = x_shape
            n, _, kt, kh, kw = w_shape
            dims = (b, t, h, w, c, n, kt, kh, kw, stride)
            out = torch.empty(
                (b, t, 2 * h, 2 * w, n // 4) if mode == 1
                else tuple(want.shape), dtype=torch.bfloat16, device=dev)

            def call(dst, mode_):
                return lib.mv2_conv_s8(
                    xq.data_ptr(), w8.gemm.data_ptr(), xs.data_ptr(),
                    w8.scale.data_ptr(), bias.data_ptr(), dst.data_ptr(),
                    _build.DTYPE_CODES[torch.bfloat16], *dims, mode_,
                    stream)

            acc = torch.empty_like(want)
            code = call(acc, 2)
            torch.cuda.synchronize()
            if code:
                out_ms[what] = f'CUDA error {code}'
                continue
            if not torch.equal(acc, want):
                sys.exit(f'{path} {what}: the accumulators differ from '
                         'conv_s8_ref')
            out_ms[what] = median_ms(torch, lambda: call(out, mode), 10)
            del xq, want, out, acc
            torch.cuda.empty_cache()
    return out_ms


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--variants', nargs='+',
                        default=['128x128x64x4', '128x128x128x3',
                                 '128x128x64x5', '256x128x128x3',
                                 '256x128x64x4', '128x256x128x3',
                                 '128x128x64x4'],
                        help='BMxBNxBKxSTAGES, each timed in a process of '
                             'its own (the first and the last the same: '
                             'the drift between them)')
    parser.add_argument('--time', help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    if args.time:
        print(json.dumps(time_variant(args.time)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernel: no GPU')
    from magvit2_pytorch_tpu_torch.ops.kernels import int8 as k8
    variants = [tuple(int(v) for v in s.split('x')) for s in args.variants]
    built = build('int8_conv.cu', CONSTANTS, dict.fromkeys(variants),
                  ('mv2_conv_s8',))
    for key, (lib, log) in built.items():
        kernel, lines = None, []
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                kernel = 'conv_s8_kernel' in line
            elif kernel and ('Used' in line or 'spill' in line):
                lines.append(line.split(':', 1)[-1].strip())
        print('x'.join(map(str, key)) + ': ' + ' | '.join(lines))
    for key in variants:
        # one process a library: two of these libraries in one process
        # refuse their launches
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--time', built[key][0]._name],
                             capture_output=True, text=True)
        if run.returncode:
            sys.exit(run.stdout + run.stderr)
        for what, ms in json.loads(run.stdout.splitlines()[-1]).items():
            shape = next(s for s in SHAPES if s[0] == what)
            macs = k8.conv_macs(shape[1], shape[2], shape[3])
            rate = (f' ({2 * macs / ms / 1e9:.1f} TOP/s)'
                    if isinstance(ms, float) else '')
            print(f'{"x".join(map(str, key))} {what} {shape[1]}: {ms}'
                  f'{" ms" if isinstance(ms, float) else ""}{rate}')
    print(f'card: {card()}')


if __name__ == '__main__':
    main()
