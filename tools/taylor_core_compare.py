#!/usr/bin/env python3
"""Time the Taylor block's bf16 two-launch cores of an earlier checkout
against this checkout's on one NVIDIA GPU, in turns: earlier, new, new,
earlier.

    mkdir -p _proof/parent
    git archive <commit> | tar -x -C _proof/parent
    python3 tools/taylor_core_compare.py _proof/parent

The earlier checkout's package is imported from its own folder and its own
``taylor_core`` wrapper is called, so that its C signature, its scratch size
and its build (into its own ``_build/``) are its own; then that package is
dropped from ``sys.modules`` and this checkout's is imported. At the
conditioned stack's B3 shapes (160 frames x 1024 tokens at 8 x 16, 8 x 32
and 4 x 64), random bf16 qkv: the median of 20 CUDA-event timings of 10
back-to-back calls of each, the two outputs against each other, the card's
name and power limit. Imports nothing of JAX.
"""
import importlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = 'magvit2_pytorch_tpu_torch'
CORE = f'{PACKAGE}.ops.kernels.taylor_attention'
import torch  # noqa: E402

sys.path.insert(0, os.path.join(REPO, 'tools'))
from variant_build import card, median_ms  # noqa: E402


def import_core(root):
    """``taylor_attention`` of the checkout at ``root``, its library built
    and loaded; leaves no module of the package in ``sys.modules``, so that
    another checkout's may be imported next (the functions keep theirs)."""
    sys.path.insert(0, root)
    try:
        ta = importlib.import_module(CORE)
        ta._build.load_library()
    finally:
        sys.path.remove(root)
        for name in [m for m in sys.modules
                     if m == PACKAGE or m.startswith(PACKAGE + '.')]:
            del sys.modules[name]
    return ta


if len(sys.argv) != 2 or not torch.cuda.is_available():
    sys.exit('usage: taylor_core_compare.py EARLIER_CHECKOUT (needs a GPU)')
parent = import_core(os.path.abspath(sys.argv[1]))
new = import_core(REPO)
dev = torch.device('cuda', 0)
for frames, n, heads, d in ((160, 1024, 8, 16), (160, 1024, 8, 32),
                            (160, 1024, 4, 64)):
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(frames * n, 3 * heads * d, device=dev, generator=g)
    qkv[:, :heads * d] *= d ** -0.5
    qkv = qkv.bfloat16()
    runs = {name: (lambda ta=ta: ta.taylor_core(qkv, frames, heads, d))
            for name, ta in (('parent', parent), ('new', new))}
    o_p, o_n = runs['parent'](), runs['new']()
    torch.cuda.synchronize()
    diff = ((o_n.float() - o_p.float()).abs().max()
            / o_p.float().abs().max()).item()
    del o_p, o_n
    t = {}
    for name in ('parent', 'new', 'new', 'parent'):
        t.setdefault(name, []).append(median_ms(torch, runs[name], calls=10))
    print(f'({frames}, {n}, {heads} x {d}): parent {t["parent"][0]:.4f} / '
          f'{t["parent"][1]:.4f} ms, new core {t["new"][0]:.4f} / '
          f'{t["new"][1]:.4f} ms (turns parent, new, new, parent); new '
          f'against parent {diff:.3e} of the largest value; {card()}',
          flush=True)
