#!/usr/bin/env python3
"""Time the Taylor block's tensor-core moment core at other ring depths and
chunk sizes on one NVIDIA GPU.

    python3 tools/taylor_core_variants.py            # stages x chunk grid
    python3 tools/taylor_core_variants.py --variants 2x64 2x128

Builds ``csrc/taylor_attention.cu`` once per variant (``kTcStages`` and
``kTcChunk`` replaced, one nvcc each, all started together) into
``magvit2_pytorch_tpu_torch/_build/variants/``, checks every variant against
the bf16 plain version (``taylor_core_ref``) at the flagship shape (160
frames x 1024 tokens, 16 heads x 8) and at N = 1000 and 4096, then times
each at the flagship shape: the median of 20 CUDA-event timings of 10
back-to-back calls, in two rounds (the second in reverse order). Prints
ptxas's registers, the errors and the times with the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

from variant_build import build, card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = {'constexpr int kTcStages = 3;': 'TC_STAGES',
             'constexpr int kTcChunk = 128;': 'TC_CHUNK'}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--variants', nargs='+',
                        default=['2x64', '3x64', '4x64', '2x128', '3x128'],
                        help='STAGESxCHUNK, chunk a multiple of 16')
    args = parser.parse_args()
    variants = [tuple(int(v) for v in s.split('x')) for s in args.variants]
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernel: no GPU')
    from magvit2_pytorch_tpu_torch.ops.kernels import taylor_attention as ta
    libs = {}
    for key, (lib, log) in build('taylor_attention.cu', CONSTANTS, variants,
                                 ('mv2_taylor_core',)).items():
        used = [line.strip() for line in log.splitlines() if 'Used' in line]
        print(f'{key[0]}x{key[1]}: {used[-1] if used else "(no ptxas line)"}')
        libs[key] = lib
    dev = torch.device('cuda', 0)
    heads, dh = 16, 8
    times = {}
    with torch.inference_mode():
        for frames, n in ((160, 1024), (3, 1000), (2, 4096)):
            gen = torch.Generator(device=dev).manual_seed(0)
            qkv = torch.randn(frames * n, 3 * heads * dh, device=dev,
                              generator=gen) * 0.5
            qkv[:, :heads * dh] *= dh ** -0.5
            qkv = qkv.bfloat16()
            want = ta.taylor_core_ref(qkv, frames, heads, dh).float()

            def run(key):
                out = torch.empty(frames * n, heads * dh, device=dev,
                                  dtype=torch.bfloat16)
                code = libs[key].mv2_taylor_core(
                    qkv.data_ptr(), out.data_ptr(), None, None, 1, frames,
                    n, heads, dh, 0, 1e-5, ta.CORES['mma'],
                    torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    sys.exit(f'variant {key}: CUDA error {code}')
                return out

            for key in variants:
                got = run(key).float()
                err = ((got - want).abs().max() / want.abs().max()).item()
                share = (got != want).float().mean().item()
                print(f'({frames}, {n}) {key[0]}x{key[1]}: error over the '
                      f'largest value of the bf16 plain version {err:.3e}, '
                      f'{share:.4%} of values differ')
            if frames != 160:
                continue
            for order in (variants, variants[::-1]):
                for key in order:
                    times.setdefault(key, []).append(
                        median_ms(torch, lambda: run(key), calls=10))
    smi = card()
    for (stages, chunk), ms in times.items():
        print(f'stages {stages}, chunk {chunk}: {ms[0]:.4f} / {ms[1]:.4f} '
              f'ms (rounds 1 / 2) at (160, 1024, 16 x 8) on {smi}')


if __name__ == '__main__':
    main()
