#!/usr/bin/env python3
"""Time the flash-attention backward's tensor-core kernels (dQ and dK/dV, the
'mma' route) at other block sizes, ring depths and chunks on one NVIDIA GPU.

    python3 tools/flash_bwd_variants.py                 # a default grid
    python3 tools/flash_bwd_variants.py --variants 4x2x32 8x3x16

Builds ``csrc/flash_attention.cu`` once per variant (``kBwdWarps``, the warps
of a block, 16 output rows each, ``kBwdStages``, the streamed tiles in
flight, and ``kDqChunk`` and ``kDkvChunk``, the rows of a streamed tile the
products take at a time, both set to the variant's chunk, replaced; one nvcc
each, all started together) into
``magvit2_pytorch_tpu_torch/_build/variants/``, checks every variant's dq,
dk and dv against the package's own kernels (built as they are) at
(2, 2, 130, d) / 134 keys, d in 16, 32, 64, causal, and at full width, then
times each kernel of each variant at the attention step's shape,
(17, 8, 4096, 32) / 4100 keys bf16, causal and not: the median of 20
CUDA-event timings, in two rounds (the second in reverse order). Prints
ptxas's registers and spills, the errors and the times with the card's name
and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

from variant_build import build, card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = {'constexpr int kBwdWarps = 4;': 'BWD_WARPS',
             'constexpr int kBwdStages = 2;': 'BWD_STAGES',
             'constexpr int kDqChunk = 32;': 'BWD_CHUNK',
             'constexpr int kDkvChunk = 16;': 'BWD_CHUNK'}
ENTRIES = ('mv2_flash_attention_bwd_dq', 'mv2_flash_attention_bwd_dkv')


def ptxas(name, log):
    """ptxas's registers and spills of each 'mma' backward kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry function' in line and 'bwd_d' in line \
                and '_mma_kernel' in line:
            kernel = line.split("'")[1]
            which = 'dq' if 'bwd_dq_' in kernel else 'dkv'
            d = kernel.split('ILi')[1].split('E')[0]
            print(f'{name} {which}<{d}>: {lines[i + 2].strip()}; '
                  f'{lines[i + 3].strip()}')


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--variants', nargs='+',
                        default=['4x2x32', '4x3x32', '8x2x32', '4x2x16',
                                 '8x3x16'],
                        help='WARPSxSTAGESxCHUNK: warps a block (4 or 8), '
                             'tiles in flight (2 or more), rows of a tile '
                             'the products take at a time (16, 32 or 64)')
    args = parser.parse_args()
    variants = [tuple(int(v) for v in s.split('x')) for s in args.variants]
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernels: no GPU')
    from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
    libs = {}
    for key, (lib, log) in build('flash_attention.cu', CONSTANTS, variants,
                                 ENTRIES).items():
        ptxas('x'.join(map(str, key)), log)
        libs[key] = lib
    dev = torch.device('cuda', 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}

    def run(lib, kernel, q, k, v, dout, lse, delta, causal):
        b, h, n, d = q.shape
        m = k.shape[2]
        outs = ((torch.empty_like(q), None) if kernel == 'dq'
                else (torch.empty_like(k), torch.empty_like(v)))
        code = getattr(lib, f'mv2_flash_attention_bwd_{kernel}')(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), outs[0].data_ptr(),
            None if outs[1] is None else outs[1].data_ptr(), 1, b * h, n, m,
            d, 1, int(causal), d ** -0.5, fa.ROUTES['mma'], stream)
        if code:
            sys.exit(f'{kernel}: CUDA error {code}')
        return outs

    shapes = [(2, 2, 130, 134, d, True) for d in (16, 32, 64)]
    shapes += [(17, 8, 4096, 4100, 32, causal) for causal in (False, True)]
    with torch.inference_mode():
        for b, h, n, m, d, causal in shapes:
            gen = torch.Generator(device=dev).manual_seed(0)
            q, k, v, dout = (torch.randn(b, h, s, d, device=dev,
                                         generator=gen).bfloat16()
                             for s in (n, m, m, n))
            out, lse = fa.flash_forward(q, k, v, None, causal, d ** -0.5)
            delta = fa.row_delta(dout, out)
            args = (q, k, v, dout, lse, delta, causal)
            want = (fa.flash_backward_dq(q, k, v, None, dout, lse, delta,
                                         causal, d ** -0.5)[0],
                    *fa.flash_backward_dkv(q, k, v, None, dout, lse, delta,
                                           causal, d ** -0.5))
            for key, lib in libs.items():
                got = (run(lib, 'dq', *args)[0], *run(lib, 'dkv', *args))
                errs = [((g.float() - w.float()).abs().max()
                         / w.float().abs().max()).item()
                        for g, w in zip(got, want)]
                print(f'({b}, {h}, {n}, {d}) / {m} causal={causal} '
                      f'{"x".join(map(str, key))}: dq, dk, dv against the '
                      f'package\'s kernels over their largest value '
                      f'{", ".join(f"{e:.3e}" for e in errs)}')
            if n != 4096:
                continue
            for order in (list(libs), list(libs)[::-1]):
                for key in order:
                    for kernel in ('dq', 'dkv'):
                        times.setdefault((key, kernel, causal), []).append(
                            median_ms(torch, lambda: run(libs[key], kernel,
                                                         *args)))
            del q, k, v, dout, out, lse, delta, want
    smi = card()
    for ((warps, stages, chunk), kernel, causal), ms in times.items():
        print(f'warps {warps}, stages {stages}, chunk {chunk}, {kernel}'
              f'{" causal" if causal else ""}: {ms[0]:.4f} / {ms[1]:.4f} ms '
              f'(rounds 1 / 2) at (17, 8, 4096, 32) / 4100 keys bf16 on '
              f'{smi}')


if __name__ == '__main__':
    main()
