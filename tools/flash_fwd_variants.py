#!/usr/bin/env python3
"""Time the flash-attention forward's tensor-core kernel (the 'mma' route)
at other tile geometries on one NVIDIA GPU.

    python3 tools/flash_fwd_variants.py                  # a default grid
    python3 tools/flash_fwd_variants.py --variants 4x2x64 8x3x128
    python3 tools/flash_fwd_variants.py --baseline OLD   # and OLD's forward

Builds ``csrc/flash_attention.cu`` once per variant (``kFwdWarps``, the
warps of a block, 16 query rows each, ``kFwdStages``, the key tiles in
flight, and ``kFwdTile``, the keys of a streamed tile, replaced; one nvcc
each, all started together) into
``magvit2_pytorch_tpu_torch/_build/variants/``; with ``--baseline`` also
the forward of another checkout of this repository, unchanged (its entry
point with or without the route argument). Checks every variant's output
and lse against the package's own kernel (built as it is) at
(2, 2, 130, d) / 134 keys, d in 16, 32, 64, causal and not, and at full
width, then times each at the attention step's shape, (17, 8, 4096, 32) /
4100 keys bf16, causal and not, beside the baseline and
``F.scaled_dot_product_attention`` (``is_causal`` for causal, whose mask is
aligned to the top left): the median of 20 CUDA-event timings, in two
rounds (the second in reverse order). Prints ptxas's registers and spills,
the errors and the times with the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

from variant_build import build, card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = {'constexpr int kFwdWarps = 4;': 'FWD_WARPS',
             'constexpr int kFwdStages = 2;': 'FWD_STAGES',
             'constexpr int kFwdTile = 128;': 'FWD_TILE'}
ENTRY = 'mv2_flash_attention_fwd'


def ptxas(name, log, kernel):
    """ptxas's registers and spills of each instantiation of ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry function' in line and f'{kernel}I' in line:
            args = line.split(f'{kernel}I')[1].split('EEEv')[0]
            print(f'{name} {kernel}<{args}>: {lines[i + 2].strip()}; '
                  f'{lines[i + 3].strip()}')


def baseline_library(checkout):
    """Another checkout's flash_attention.cu built as it is: (library,
    whether its forward takes the route, nvcc's log)."""
    src_dir = os.path.join(checkout, 'magvit2_pytorch_tpu_torch', 'csrc')
    text = open(os.path.join(src_dir, 'flash_attention.cu')).read()
    params = re.search(r'int ' + ENTRY + r'\(([^)]*)\)', text)[1]
    lib, log = build('flash_attention.cu', {}, [()], (), source_dir=src_dir,
                     tag='baseline')[()]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    routed = 'int route' in params
    fn = getattr(lib, ENTRY)
    fn.argtypes = [p] * 6 + [i] * 7 + [f] + ([i] if routed else []) + [p]
    fn.restype = ctypes.c_int
    return lib, routed, log


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--variants', nargs='+',
                        default=['4x2x64', '8x2x64', '4x3x64', '8x3x64',
                                 '4x2x128', '8x2x128', '4x3x128', '8x3x128'],
                        help='WARPSxSTAGESxTILE: warps a block (4 or 8), key '
                             'tiles in flight (2 or more), keys a tile (64 '
                             'or 128)')
    parser.add_argument('--baseline', default=None,
                        help='another checkout of this repository whose '
                             'forward to time beside the variants')
    args = parser.parse_args()
    variants = [tuple(int(v) for v in s.split('x')) for s in args.variants]
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernels: no GPU')
    from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
    with ThreadPoolExecutor(2) as pool:
        built = pool.submit(build, 'flash_attention.cu', CONSTANTS, variants,
                            (ENTRY,))
        base = (pool.submit(baseline_library, args.baseline)
                if args.baseline else None)
        calls = {}     # name: (library, whether its forward takes the route)
        for key, (lib, log) in built.result().items():
            name = 'x'.join(map(str, key))
            ptxas(name, log, 'fwd_mma_kernel')
            calls[name] = (lib, True)
        if base:
            lib, routed, log = base.result()
            ptxas('baseline', log, 'fwd_kernel')
            ptxas('baseline', log, 'fwd_mma_kernel')
            calls['baseline'] = (lib, routed)
    dev = torch.device('cuda', 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(call, q, k, v, causal):
        lib, routed = call
        b, h, n, d = q.shape
        m = k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        route = (fa.ROUTES['mma'],) if routed else ()
        code = getattr(lib, ENTRY)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            lse.data_ptr(), 1, b * h, n, m, d, 1, int(causal), d ** -0.5,
            *route, stream)
        if code:
            sys.exit(f'forward: CUDA error {code}')
        return out, lse

    shapes = [(2, 2, 130, 134, d, causal) for d in (16, 32, 64)
              for causal in (False, True)]
    shapes += [(17, 8, 4096, 4100, 32, causal) for causal in (False, True)]
    times = {}
    with torch.inference_mode():
        for b, h, n, m, d, causal in shapes:
            gen = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, h, s, d, device=dev,
                                   generator=gen).bfloat16()
                       for s in (n, m, m))
            want = fa.flash_forward(q, k, v, None, causal, d ** -0.5)
            for name, call in calls.items():
                out, lse = run(call, q, k, v, causal)
                err = ((out.float() - want[0].float()).abs().max()
                       / want[0].float().abs().max()).item()
                err_lse = (lse - want[1]).abs().max().item()
                print(f'({b}, {h}, {n}, {d}) / {m} causal={causal} {name}: '
                      f'out against the package\'s kernel over its largest '
                      f'value {err:.3e}, lse max abs {err_lse:.3e}')
            if n != 4096:
                continue
            timed = {**{name: (lambda call=call: run(call, q, k, v, causal))
                        for name, call in calls.items()},
                     'sdpa': lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=causal)}
            for order in (list(timed), list(timed)[::-1]):
                for name in order:
                    times.setdefault((name, causal), []).append(
                        median_ms(torch, timed[name]))
            del q, k, v, want
    smi = card()
    for (name, causal), ms in times.items():
        print(f'{name} forward{" causal" if causal else ""}: {ms[0]:.4f} / '
              f'{ms[1]:.4f} ms (rounds 1 / 2) at (17, 8, 4096, 32) / 4100 '
              f'keys bf16 on {smi}')


if __name__ == '__main__':
    main()
