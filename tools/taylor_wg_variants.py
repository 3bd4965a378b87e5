#!/usr/bin/env python3
"""Time the Taylor block's bf16 wgmma moment core (B3 at every head but 8,
``csrc/taylor_attention.cu`` WgTc) at other tile counts, occupancies and
ring depths on one NVIDIA GPU, launch by launch.

    python3 tools/taylor_wg_variants.py --width 64 \\
        --variants 2.1.2.2.3.2.64 2.1.2.2.3.4.64

A variant is MT.B1.MTA.B2.BS.RS.TOK at the chosen width (the others keep
the source's values): kMt (64-row tiles a warpgroup of the moments launch),
kBlocks1 (its blocks an SM, the launch bounds), kMta (64-token tiles a
warpgroup of the apply launch), kBlocks2, kBStages (the apply launch's ring
stages), kRawStages (the moments launch's ring stages), kTok (its tokens a
chunk, 64 or 128); '_' keeps the source's value. Builds one library per variant (one
nvcc each, all started together) into
``magvit2_pytorch_tpu_torch/_build/variants/``, checks each against the
bf16 plain version (``taylor_core_ref``) at the width's shape, then times
the core on random bf16 qkv at the width's shape (SHAPES: the conditioned
stack's 160 frames x 1024 tokens at 8 x 16, 8 x 32 and 4 x 64): the median
of 20 CUDA-event timings of 10 back-to-back calls in two rounds (the second
in reverse order), and each launch's device time from torch.profiler.
Prints ptxas's registers and spills and the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from variant_build import card, median_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shape each width is timed at: (frames, N, heads)
SHAPES = {16: (160, 1024, 8), 32: (160, 1024, 8), 64: (160, 1024, 4),
          128: (16, 1024, 2), 256: (16, 256, 1)}
NAMES = ('kMt', 'kBlocks1', 'kMta', 'kBlocks2', 'kBStages', 'kRawStages',
         'kTok')
KERNELS = ('taylor_moments_wg_kernel', 'taylor_apply_wg_kernel')


def variant_source(text: str, width: int) -> str:
    """The source with each tunable of WgTc taken from a macro at
    ``width`` (V_<name>) and left as it is at the other widths."""
    for name in NAMES:
        pattern = re.compile(rf'static constexpr int {name} = (.*?);',
                             re.S)
        match = pattern.search(text)
        if match is None:
            sys.exit(f'{name} is no longer a constexpr of WgTc: update '
                     'NAMES')
        text = text.replace(match.group(0), (
            f'static constexpr int {name} = D == {width} ? V_{name} : '
            f'({match.group(1)});'), 1)
    return text


def c_value(expr: str, width: int) -> int:
    """A right-nested chain of C conditionals on D (``D == 16 ? 2 : D <= 64
    ? 3 : 1``) at D = ``width``."""
    expr = ' '.join(expr.split())
    while '?' in expr:
        cond, rest = expr.split('?', 1)
        yes, expr = rest.split(':', 1)
        left, op, right = cond.split()
        ops = {'==': int.__eq__, '<=': int.__le__, '<': int.__lt__}
        if ops[op](width if left == 'D' else int(left), int(right)):
            return c_value(yes, width)
    return int(expr)


def defaults(text: str, width: int) -> dict:
    """The source's value of each tunable at ``width``."""
    return {name: c_value(re.search(
        rf'static constexpr int {name} = (.*?);', text, re.S).group(1), width)
        for name in NAMES}


def build(variants, width):
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    out_dir = _build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    src_dir = out_dir / 'taylor_wg_src'
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.SOURCE_DIR, src_dir)
    src = src_dir / 'taylor_attention.cu'
    src.write_text(variant_source(src.read_text(), width))
    procs = {}
    for values in variants:
        tag = '_'.join(map(str, values))
        lib = out_dir / f'taylor_wg_{width}_{tag}.so'
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, '-shared', '-I',
               str(src_dir), *(f'-DV_{n}={v}' for n, v in zip(NAMES, values)),
               '-o', str(lib), str(src)]
        procs[values] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for values, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {values}:\n{log}')
        lib = ctypes.CDLL(str(path))
        lib.mv2_taylor_core.argtypes = _build.SIGNATURES['mv2_taylor_core']
        lib.mv2_taylor_core.restype = ctypes.c_int
        lines = [ln.strip() for ln in log.splitlines()
                 if 'ptxas' in ln and ('Used' in ln or 'spill' in ln)]
        built[values] = (lib, lines)
    return built


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--width', type=int, default=64,
                        choices=sorted(SHAPES))
    parser.add_argument('--variants', nargs='+', default=['_._._._._._._'])
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit('this script times the CUDA kernel: no GPU')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from magvit2_pytorch_tpu_torch.ops.kernels import taylor_attention as ta
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    width = args.width
    base = defaults((_build.SOURCE_DIR / 'taylor_attention.cu').read_text(),
                    width)
    variants = [tuple(base[n] if v == '_' else int(v)
                      for n, v in zip(NAMES, s.split('.')))
                for s in args.variants]
    libs = build(variants, width)
    for key, (_, lines) in libs.items():
        print(f'{dict(zip(NAMES, key))}: ' + ' | '.join(
            ln for ln in lines if 'taylor_' in ln or 'Used' in ln)[-600:])
    frames, n, heads = SHAPES[width]
    d = width
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(frames * n, 3 * heads * d, device=dev, generator=gen)
    qkv[:, :heads * d] *= d ** -0.5
    qkv = qkv.bfloat16()
    table = torch.tensor(ta.pair_table(d), dtype=torch.int32, device=dev)
    scratch = torch.empty(ta.wide_scratch_bytes(frames, heads, d),
                          dtype=torch.uint8, device=dev)
    out = torch.empty(frames * n, heads * d, device=dev,
                      dtype=torch.bfloat16)
    want = torch.cat([ta.taylor_core_ref(qkv[i * n:(i + 8) * n],
                                         min(8, frames - i), heads, d)
                      for i in range(0, frames, 8)]).float()

    def run(key):
        code = libs[key][0].mv2_taylor_core(
            qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            table.data_ptr(), 1, frames, n, heads, d, table.numel(), 1e-5,
            ta.CORES['mma'], torch.cuda.current_stream(dev).cuda_stream)
        if code:
            sys.exit(f'variant {key}: CUDA error {code}')
        return out

    times, launches = {}, {}
    for key in variants:
        err = ((run(key).float() - want).abs().max()
               / want.abs().max()).item()
        print(f'{dict(zip(NAMES, key))}: error over the largest value of '
              f'the bf16 plain version {err:.3e}')
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run(key)
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = next((k for k in KERNELS if k in e.name), None)
                if name:
                    by[name] = by.get(name, 0.0) + e.time_range.elapsed_us()
        launches[key] = {k: v / 10 / 1e3 for k, v in by.items()}
    for order in (variants, variants[::-1]):
        for key in order:
            times.setdefault(key, []).append(
                median_ms(torch, lambda: run(key), calls=10))
    smi = card()
    for key, ms in times.items():
        split = ', '.join(f'{k.split("_")[1]} {v:.4f}'
                          for k, v in launches[key].items())
        print(f'{dict(zip(NAMES, key))}: {ms[0]:.4f} / {ms[1]:.4f} ms '
              f'(rounds 1 / 2; profiler {split} ms) at ({frames}, {n}, '
              f'{heads} x {d}) on {smi}')


if __name__ == '__main__':
    main()
