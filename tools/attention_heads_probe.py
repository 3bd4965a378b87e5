#!/usr/bin/env python3
"""B1's attention cores and B2 at every head size their kernels take, and
against another checkout's kernels, on one NVIDIA GPU.

    python3 tools/attention_heads_probe.py [--baseline DIR] [--out DIR]

1. Every d that is a multiple of 8 from 8 to 128 (256 // d heads, 4 memory
   keys): B1's core on each route that takes the call (``'mma'`` where
   the keys fit in shared memory, ``'mma_ring'``, and ``'scalar'`` in bf16
   and float32) at 3 frames of 100 tokens (causal) and of 1024, against
   ``attention_core_ref`` in float32; B2 at (2, 5, 100, C) causal in bf16
   and float32, at inner 256 (C = 256) and 384 (C = 512), on the route
   ``time_block_route`` picks, against ``time_attention_block_ref``.
   Fails on an error over ``chip_smoke.TOL``.
2. B2's fused launch and B1's ``'mma'`` core at the flagship shapes
   ((8, 5, 256, 512) and 160 frames of 256 tokens) at 32 x 8 and 64 x 4
   (d x heads): medians of 20 CUDA-event timings of 10 calls and the
   profiler's device time. With ``--baseline DIR`` (a ``csrc`` folder of
   another checkout, e.g. the parent commit unpacked by ``git archive``
   into a git-ignored folder) its two kernels run at 32 x 8 too, in turns
   baseline, this tree, this tree, baseline.

Prints each reading with the card's name and power limit; ``--out`` also
writes them to ``attention_heads_probe.txt``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402


def sweep(torch, dev, lib):
    """Part 1: the worst error over the largest value by route."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, axial_attention as ax)
    gen = torch.Generator().manual_seed(3)
    worst = {}

    def hold(key, err, dtype, what):
        worst[key] = max(worst.get(key, 0.0), err)
        tol = cs.TOL['float32' if dtype == torch.float32 else 'bfloat16']
        if not err <= tol:
            cs.fail(f'{what}: error {err} of the largest value > {tol}')

    for d in range(8, 129, 8):
        heads, m = max(1, 256 // d), 4
        for g, L, causal in ((3, 100, True), (3, 1024, False)):
            qkv = torch.randn(g * L, 3 * heads * d, generator=gen).to(dev)
            mk, mv = (torch.randn(heads, m, d, generator=gen).to(dev)
                      for _ in range(2))
            want = ax.attention_core_ref(
                qkv.bfloat16().float(), mk.bfloat16().float(),
                mv.bfloat16().float(), heads, d, causal, groups=g, L=L,
                inner_groups=1, outer_stride=L, pos_stride=1)
            for route, dtype in (('mma', torch.bfloat16),
                                 ('mma_ring', torch.bfloat16),
                                 ('scalar', torch.bfloat16),
                                 ('scalar', torch.float32)):
                if route == 'mma' and not ax.space_core_fits(m + L, d):
                    continue
                q, k, v = (t.bfloat16().to(dtype).contiguous()
                           for t in (qkv, mk, mv))
                attn = torch.empty(g * L, heads * d, dtype=dtype, device=dev)
                _build.check(lib, lib.mv2_attention_core(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), attn.data_ptr(),
                    _build.dtype_code(q), g, L, heads, d, m, 1, L, 1,
                    int(causal), ax.CORES[route], _build.stream_handle(dev)),
                    f'core {route} d={d}')
                torch.cuda.synchronize()
                hold(f'core {route} {str(dtype)[6:]}',
                     cs.relative_error(attn, want), dtype,
                     f'core {route} {dtype} d={d} L={L}')
        for c, h in ((256, max(1, 256 // d)), (512, max(1, 384 // d))):
            x = torch.randn(2, 5, 100, c, generator=gen)
            p = cs.attn_params(torch, gen, c, h, d)
            for dtype in (torch.bfloat16, torch.float32):
                args = [a.to(dev, dtype) for a in (x, *p)]
                out, counts = cs.counted(torch, lambda: ax.time_attention_block(
                    *args, h, d, True))
                route = ('fused' if counts['time_attention_block_fused']
                         else 'launches')
                hold(f'time {route} {str(dtype)[6:]}',
                     cs.relative_error(out, ax.time_attention_block_ref(
                         *(a.float() for a in args), h, d, True)),
                     dtype, f'time block {route} {dtype} d={d} C={c}')
    return worst


def timings(torch, dev, lib, baseline):
    """Part 2: {(what, d x heads): [(who, event-pair ms, device ms)]}."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, axial_attention as ax, gemm)
    gen = torch.Generator().manual_seed(5)
    stream = _build.stream_handle(dev)
    out = {}
    for heads, dh in ((8, 32), (4, 64)):
        b, t, s, c, m = cs.BATCH, 5, 256, 512, 4
        x = torch.randn(b, t, s, c, generator=gen).to(dev).bfloat16()
        p = [a.to(dev).bfloat16()
             for a in cs.attn_params(torch, gen, c, heads, dh)]
        y = torch.empty_like(x)
        pix = ax.time_block_pixels(
            b, t, s, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        g, L = cs.BATCH * 20, 256
        xs = torch.randn(g * L, c, generator=gen).to(dev).bfloat16()
        ps = [a.to(dev).bfloat16()
              for a in cs.attn_params(torch, gen, c, heads, dh)]
        qkv = gemm.gemm_nt(gemm.rmsnorm(xs, ps[0]), ps[1])
        mk, mv = ps[2][0].contiguous(), ps[2][1].contiguous()
        attn = torch.empty(g * L, heads * dh, dtype=qkv.dtype, device=dev)
        calls = {
            'B2 fused': ('mv2_time_attention_block', lambda l: lambda: (
                l.mv2_time_attention_block(
                    x.data_ptr(), p[0].data_ptr(), p[1].data_ptr(),
                    p[2][0].data_ptr(), p[2][1].data_ptr(), p[3].data_ptr(),
                    y.data_ptr(), 1, b, t, s, c, heads, dh, m, pix, 1,
                    ax.TIME_ROUTES['fused'], stream))),
            'B1 mma core': ('mv2_attention_core', lambda l: lambda: (
                l.mv2_attention_core(
                    qkv.data_ptr(), mk.data_ptr(), mv.data_ptr(),
                    attn.data_ptr(), 1, g, L, heads, dh, m, 1, L, 1, 0,
                    ax.CORES['mma'], stream)))}
        for what, (entry, call) in calls.items():
            order = (('baseline', 'tree', 'tree', 'baseline')
                     if baseline and dh == 32 else ('tree',))
            runs = []
            for who in order:
                fn = call(baseline[entry] if who == 'baseline' else lib)
                code = fn()
                if code != 0:
                    cs.fail(f'{what} ({who}): launch refused ({code})')
                runs.append((who, cs.median_ms(fn, 20, inner=10),
                             cs.device_ms(torch, fn)[0]))
            out[(what, f'{dh} x {heads}')] = runs
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--baseline', default=None,
                        help="another checkout's csrc folder")
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('this probe runs on the card: no GPU')
    from variant_build import build
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    dev = torch.device('cuda', 0)
    smi = cs.nvidia_smi()
    lib = _build.load_library()
    baseline = {entry: build(src, {}, [()], (entry,),
                             source_dir=args.baseline, tag='baseline')[()][0]
                for src, entry in (
                    ('time_attention.cu', 'mv2_time_attention_block'),
                    ('attention_block.cu', 'mv2_attention_core'))
                } if args.baseline else None
    cs.set_tf32(False)
    lines = []
    with torch.inference_mode():
        lines.append(f'[sweep] d = 8..128, worst error over the largest '
                     f'value by route (tol {cs.TOL}): {sweep(torch, dev, lib)}')
        for (what, shape), runs in timings(torch, dev, lib, baseline).items():
            lines.append(f'[timing] {what} at {shape} (who, event-pair ms of '
                         f'10 calls, profiler device ms): {runs}')
    for line in lines:
        print(f'{line} on {smi}', flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'attention_heads_probe.txt'),
                  'w') as f:
            f.write('\n'.join(f'{line} on {smi}' for line in lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
