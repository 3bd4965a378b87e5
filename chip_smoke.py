#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py                    # all phases, as a user would run it
    python3 chip_smoke.py --out DIR          # also write the compiler log there
    python3 chip_smoke.py --out DIR --profile   # and a device-time profile

Phases, in order; any failure exits non-zero and prints no result line:

1. device: require CUDA; print ``nvidia-smi`` name and power limit.
2. build: compile ``magvit2_pytorch_tpu_torch/csrc`` with nvcc for sm_90a.
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes (README config, batch 8): float32 with TF32 off, and
   bfloat16 against the plain version computed in float32 on the same
   inputs; median times over 20 runs with CUDA events.
4. flagship roundtrip, bfloat16, batch 8, seeded random weights, through
   ``VideoTokenizer.tokenize`` then ``decode_from_code_indices``: shapes,
   finite output, and every kernel launched exactly twice (encoder and
   decoder) per the launch counters.
5. float32 roundtrip at batch 1, TF32 off, card (kernels) against CPU (plain
   versions) with the same weights: code bits may flip only where the CPU's
   decision margin |z| <= 5e-3 and for <= 1% of bits; decoding the same
   codes must agree within 1e-3.
6. roundtrip throughput, bfloat16, frames/sec by the slope of chained runs
   (as ``bench.py``), beside the card's name and power limit.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def fail(msg: str):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# kernel name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    'space_attention_block': (
        'magvit2_pytorch_tpu_torch/csrc/attention_block.cu',
        'magvit2_pytorch_tpu/ops/pallas/axial_attention.py:49'),
    'time_attention_block': (
        'magvit2_pytorch_tpu_torch/csrc/attention_block.cu',
        'magvit2_pytorch_tpu/ops/pallas/axial_attention.py:224'),
    'taylor_attention_block': (
        'magvit2_pytorch_tpu_torch/csrc/taylor_attention.cu',
        'magvit2_pytorch_tpu/ops/pallas/taylor_attention.py:35'),
}

# kernel vs plain tolerances (max abs error), with their reasons:
# - float32: the same float32 math summed in another order (K = 256..512
#   projections, 260 softmax keys, 1024-token moments); observed error is
#   ~1e-6 of values of magnitude ~1, so 1e-4 leaves room for accumulation.
# - bfloat16: the kernel rounds to bf16 where the JAX kernel does (normed
#   input, qkv, attention output, block output: 2^-9 relative each) while
#   the plain reference runs in float32 on the same bf16 inputs; on outputs
#   of magnitude <= ~2 four such roundings give errors of ~1e-2 at most.
TOL = {'float32': 1e-4, 'bfloat16': 5e-2}
BATCH = 8
REPS = 20           # timed runs per kernel, after warm-up


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


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_cases(torch, dev):
    """Inputs at the flagship shapes: README config, batch 8, 20 padded
    frames at the encoder's attention stages."""
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        axial_attention as ax, taylor_attention as ta)
    gen = torch.Generator(device='cpu').manual_seed(1234)

    def u(shape, fan_in):
        b = fan_in ** -0.5
        return (torch.rand(shape, generator=gen) * 2 - 1) * b

    def attn_params(c, heads, dh):
        inner = heads * dh
        return [1 + 0.1 * torch.randn(c, generator=gen),
                u((3 * inner, c), c),
                torch.randn(2, heads, 4, dh, generator=gen),
                u((c, inner), inner)]

    cases = {}
    c, heads, dh = 512, 8, 32
    x = torch.randn(BATCH * 20, 16 * 16, c, generator=gen)
    cases['space_attention_block'] = (
        ax.attention_block, ax.attention_block_ref,
        [x, *attn_params(c, heads, dh)], dict(heads=heads, dim_head=dh,
                                              causal=False))
    x = torch.randn(BATCH, 5, 16 * 16, c, generator=gen)
    cases['time_attention_block'] = (
        ax.time_attention_block, ax.time_attention_block_ref,
        [x, *attn_params(c, heads, dh)], dict(heads=heads, dim_head=dh,
                                              causal=True))
    c, heads, dh = 256, 16, 8
    x = torch.randn(BATCH * 20, 32 * 32, c, generator=gen)
    cases['taylor_attention_block'] = (
        ta.taylor_attention, ta.taylor_attention_ref,
        [x, 1 + 0.1 * torch.randn(c, generator=gen),
         u((3 * heads * dh, c), c), u((c, heads * dh), heads * dh)],
        dict(heads=heads, dim_head=dh))
    return {k: (fn, ref, [t.to(dev) for t in args], kw)
            for k, (fn, ref, args, kw) in cases.items()}


def phase_kernels(torch, dev, reps):
    results = {}
    for name, (fn, ref, args, kw) in kernel_cases(torch, dev).items():
        row = {}
        set_tf32(False)
        got = fn(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        err32 = (got - want).abs().max().item()
        args16 = [a.to(torch.bfloat16) for a in args]
        got16 = fn(*args16, **kw)
        want16 = ref(*[a.float() for a in args16], **kw)
        torch.cuda.synchronize()
        err16 = (got16.float() - want16).abs().max().item()
        finite = bool(torch.isfinite(got).all() and torch.isfinite(got16).all())
        row['ms'] = median_ms(lambda: fn(*args16, **kw), reps)
        row['plain_ms'] = median_ms(lambda: ref(*args16, **kw), reps)
        row['ms_fp32'] = median_ms(lambda: fn(*args, **kw), reps)
        row['plain_ms_fp32'] = median_ms(lambda: ref(*args, **kw), reps)
        row.update(max_abs_err=err16, max_abs_err_fp32=err32,
                   shape=list(args[0].shape))
        log(f'[kernel] {name} {tuple(args[0].shape)}: fp32 max_abs_err '
            f'{err32:.3e} (tol {TOL["float32"]:g}), bf16 max_abs_err '
            f'{err16:.3e} (tol {TOL["bfloat16"]:g}); bf16 kernel '
            f'{row["ms"]:.4f} ms vs plain {row["plain_ms"]:.4f} ms; fp32 '
            f'kernel {row["ms_fp32"]:.4f} ms vs plain '
            f'{row["plain_ms_fp32"]:.4f} ms (median of {reps})')
        if not finite:
            fail(f'{name}: non-finite kernel output')
        if not err32 <= TOL['float32']:
            fail(f'{name}: float32 error {err32} > {TOL["float32"]}')
        if not err16 <= TOL['bfloat16']:
            fail(f'{name}: bfloat16 error {err16} > {TOL["bfloat16"]}')
        results[name] = row
    return results


def flagship_tokenizer(torch, device, dtype):
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    return VideoTokenizer(seed=0, device=device, dtype=dtype,
                          **readme_video_tokenizer_kwargs(
                              use_gan=False, perceptual_loss_weight=0.0))


def phase_roundtrip(torch, dev):
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts)
    tok = flagship_tokenizer(torch, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    video = torch.rand(BATCH, 17, 128, 128, 3, generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    codes = tok.tokenize(video)
    recon = tok.decode_from_code_indices(codes.reshape(BATCH, -1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    log(f'[roundtrip] bf16 batch {BATCH}: codes {tuple(codes.shape)} '
        f'{codes.dtype}, recon {tuple(recon.shape)} {recon.dtype}, '
        f'{seconds:.3f} s (first call), launches {counts}')
    if tuple(codes.shape) != (BATCH, 5, 16, 16) or codes.is_floating_point():
        fail(f'codes {tuple(codes.shape)} {codes.dtype}')
    if tuple(recon.shape) != (BATCH, 17, 128, 128, 3):
        fail(f'recon shape {tuple(recon.shape)}')
    if not bool(torch.isfinite(recon).all()):
        fail('recon has non-finite values')
    codes_in_range = bool(((codes >= 0) & (codes < 1024)).all())
    if not codes_in_range:
        fail('codes outside [0, 1024)')
    for name in KERNELS:
        if counts.get(name) != 2:
            fail(f'{name} launched {counts.get(name)} times in one '
                 'roundtrip, expected 2 (encoder + decoder)')
    return tok, video, counts


def phase_card_vs_cpu(torch, dev):
    set_tf32(False)
    card = flagship_tokenizer(torch, dev, torch.float32)
    cpu = flagship_tokenizer(torch, 'cpu', torch.float32)
    video = torch.rand(1, 17, 128, 128, 3,
                       generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    codes_cpu = cpu.tokenize(video)
    lat_cpu = cpu.encode(video)
    recon_cpu = cpu.decode_from_code_indices(codes_cpu)
    cpu_s = time.perf_counter() - t0
    codes_card = card.tokenize(video).cpu()
    lat_card = card.encode(video).cpu()
    recon_card = card.decode_from_code_indices(codes_cpu.to(dev)).cpu()
    with torch.inference_mode():
        z = cpu.module.quantizers.sign_values(lat_cpu)      # (1,5,16,16,10)
    nbits = 10
    mask = 2 ** torch.arange(nbits - 1, -1, -1)
    bits_cpu = (codes_cpu[..., None] & mask) != 0
    bits_card = (codes_card[..., None] & mask) != 0
    flipped = bits_cpu != bits_card
    frac = flipped.float().mean().item()
    worst = z.abs()[flipped].max().item() if flipped.any() else 0.0
    lat_err = (lat_card - lat_cpu).abs().max().item()
    recon_err = (recon_card - recon_cpu).abs().max().item()
    log(f'[card vs cpu] fp32 batch 1, TF32 off: latents max_abs_err '
        f'{lat_err:.3e}, code bits flipped {frac:.4%} (worst margin '
        f'{worst:.3e}), recon from the same codes max_abs_err '
        f'{recon_err:.3e}; CPU roundtrip {cpu_s:.1f} s')
    if frac > 0.01:
        fail(f'{frac:.2%} of code bits flipped (> 1%)')
    if worst > 5e-3:
        fail(f'a code bit flipped at margin {worst} > 5e-3')
    if not recon_err <= 1e-3:
        fail(f'recon differs by {recon_err} > 1e-3')
    return dict(latents_max_abs_err=lat_err, bits_flipped=frac,
                worst_flip_margin=worst, recon_max_abs_err=recon_err)


def phase_throughput(torch, tok, video, n_short=2, n_long=10):
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
    fps = BATCH * 17 / per_iter
    return dict(fps=fps, ms_per_roundtrip=per_iter * 1e3,
                t_short=t_short, t_long=t_long)


def profile_roundtrip(torch, tok, video, out_dir, slope_ms):
    """One bf16 roundtrip under torch.profiler: the device time of its
    kernels (device events only, so no operator row counts its kernels a
    second time), their share of ``slope_ms`` (the unprofiled roundtrip time
    from the throughput phase), and a table by kernel in ``out_dir``."""
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
    with open(os.path.join(out_dir, 'profile.txt'), 'w') as f:
        f.write(f'device events {device_us / 1e3:.3f} ms per roundtrip, '
                f'{busy:.1%} of the {slope_ms:.3f} ms slope time\n{table}\n')
    log(f'[profile] one bf16 roundtrip: device events {device_us / 1e3:.2f} '
        f'ms, {busy:.1%} of the unprofiled {slope_ms:.2f} ms per roundtrip; '
        f'table in {out_dir}/profile.txt')


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None,
                        help='directory for the compiler log')
    parser.add_argument('--profile', action='store_true',
                        help='also profile one roundtrip (needs --out)')
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

    with torch.inference_mode():
        kernel_rows = phase_kernels(torch, dev, REPS)
    tok, video, counts = phase_roundtrip(torch, dev)
    tp = phase_throughput(torch, tok, video)
    log(f'[throughput] bf16 batch {BATCH} roundtrip: {tp["fps"]:.2f} '
        f'frames/s ({tp["ms_per_roundtrip"]:.2f} ms per roundtrip; slope of '
        f'2 vs 10 chained runs) on {smi}')
    if args.profile:
        profile_roundtrip(torch, tok, video, args.out, tp['ms_per_roundtrip'])
    del tok, video
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch, dev)

    if 'jax' in sys.modules:
        fail('JAX was imported')
    kernels = [{'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': counts[name],
                **kernel_rows[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
