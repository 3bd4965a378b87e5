#!/usr/bin/env python3
"""The flash-attention kernels (B6) at the wide heads, their geometry
variants, and against another checkout's kernels, on one NVIDIA GPU.

    python3 tools/flash_heads_probe.py [--baseline DIR] [--variants]
                                       [--wide-row DH] [--out DIR]

1. This tree's three 'mma' kernels alone at the attention step's shape,
   (17, heads, 4096, d) / 4100 keys bf16 not causal, at d x heads 32 x 8,
   64 x 4, 128 x 4, 256 x 2, 512 x 1 and 1024 x 1, causal too at 32 and 64:
   medians of 20
   CUDA-event timings. With ``--baseline DIR`` (the root of another
   checkout, e.g. the parent commit unpacked by ``git archive`` into a
   git-ignored folder) its kernels run at every shape too, each checkout in
   its own process, in turns baseline, this tree, this tree, baseline.
2. ``--variants``: copies of this tree's package with other geometries of
   the wide widths (``VARIANTS``: ``WgFwdGeo``, ``WgDqGeo`` and
   ``WgDkvGeo`` in ``csrc/flash_attention.cu``, the Hopper forward, dQ and
   dK/dV at 128 and 256, ``WgWideFwdGeo`` / ``WgWideDqGeo`` /
   ``WgWideDkvGeo``, the Hopper wide kernels at heads of 257 to 512, and
   the wide forward's geometry again at the paired forward's head of 1024),
   built
   together into git-ignored folders under ``_proof/``, each checked
   against the plain versions at small shapes (bf16, ``chip_smoke``'s
   ``FLASH_TOL``) and timed in its own process, in turns, with ptxas's
   registers and spills: a variant of the widths 128 and 256 at 128 x 4
   and 256 x 2, one of the heads past 256 at 512 x 1 (``WIDE_SHAPES``), one
   of the paired kernels at 1024 x 1 (``PAIR_SHAPES``).
   ``--only NAME[,NAME]`` keeps those variants.
3. ``--wide-row DH``: ``chip_smoke.flash_width_rows`` at (17, 1, 4096, DH)
   / 4100 keys bf16, in a process of its own: the three kernels a head of
   DH runs, checked against the plain versions through the wrapper (one
   launch of each), each timed beside its bound, the plain versions' and
   SDPA's times (the backend that takes the head), printed as one JSON
   line of rows (for a head over 512, the wide kernels' table row).

Prints each reading with the card's name and power limit; ``--out`` also
writes them to ``flash_heads_probe.txt``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = 'magvit2_pytorch_tpu_torch/csrc/flash_attention.cu'
SHAPES = ((8, 32), (4, 64), (4, 128), (2, 256), (1, 512),       # heads, d
          (1, 1024))
WG_SHAPES = SHAPES[2:4]      # the variants of the widths 128 and 256
WIDE_SHAPES = SHAPES[4:5]    # of the heads of 257 to 512
PAIR_SHAPES = SHAPES[5:]     # and of the heads of 513 to 1024
B, N, M = 17, 4096, 4100


def struct_sub(text, struct, old, new):
    """``old`` replaced by ``new`` inside ``struct <struct> { ... };`` or
    ``struct <struct> : <base> { ... };`` (in the whole file when struct is
    None)."""
    i = 0 if struct is None else re.search(
        rf'struct {struct}( : \w+)? {{', text).start()
    j = len(text) if struct is None else text.index('};', i)
    if old not in text[i:j]:
        sys.exit(f'{old!r} not in {struct}: update VARIANTS')
    return text[:i] + text[i:j].replace(old, new) + text[j:]


# geometry variants of the wide widths against this tree's: (struct, old,
# new) substitutions in csrc/flash_attention.cu
VARIANTS = {
    # the forward at D = 128 on tiles of 64 keys
    'fwd_tile64': (('WgFwdGeo', 'tile = D == 128 ? 128 : 64;', 'tile = 64;'),),
    # dK/dV at D = 128 with three query tiles in flight
    'dkv_stages3': (('WgDkvGeo', 'stages = 2;', 'stages = D == 128 ? 3 : 2;'),),
    # dQ with three key tiles of K and of V in flight (224 KB at D = 256)
    'dq_stages3': (('WgDqGeo', 'stages = 2;', 'stages = 3;'),),
    # dQ at D = 128 on tiles of 32 keys, and of 128 (S and dP 64 floats a
    # thread each beside dQ's 64)
    'dq_tile32': (('WgDqGeo', 'tile = D == 128 ? 64 : 32;', 'tile = 32;'),),
    'dq_tile128': (('WgDqGeo', 'tile = D == 128 ? 64 : 32;',
                    'tile = D == 128 ? 128 : 32;'),),
    # the wide forward with S from the two warpgroups' partial sums, and
    # on 16-key tiles, four of K and of V in flight
    'wide_fwd_exchange': (('WgWideFwdGeo', 'exchange = false;',
                           'exchange = true;'),),
    'wide_fwd_tile16': (('WgWideFwdGeo', 'tile = 32;', 'tile = 16;'),
                        ('WgWideFwdGeo', 'stages = 2;', 'stages = 4;')),
    # the wide dQ with each warpgroup forming the whole S and dP (two commit
    # groups, P formed while dP runs); with one stage of K, or one of K and
    # two of V; on 16-key tiles with two stages of each, or four of K
    'wide_dq_redundant': (('WgWideDqGeo', 'exchange = true;',
                           'exchange = false;'),),
    'wide_dq_k1': (('WgWideDqGeo', 'k_stages = 2;', 'k_stages = 1;'),),
    'wide_dq_v2': (('WgWideDqGeo', 'k_stages = 2;', 'k_stages = 1;'),
                   ('WgWideDqGeo', 'v_stages = 1;', 'v_stages = 2;')),
    'wide_dq_tile16': (('WgWideDqGeo', 'tile = 32;', 'tile = 16;'),
                       ('WgWideDqGeo', 'v_stages = 1;', 'v_stages = 2;')),
    'wide_dq_tile16_k4': (('WgWideDqGeo', 'tile = 32;', 'tile = 16;'),
                          ('WgWideDqGeo', 'k_stages = 2;', 'k_stages = 4;'),
                          ('WgWideDqGeo', 'v_stages = 1;', 'v_stages = 2;')),
    # the wide dK/dV with each warpgroup forming the whole S (and dP), and
    # so on 32-query tiles, one stage (the partial sums' buffers would not
    # fit beside it)
    'wide_dkv_redundant': (('WgWideDkvGeo', 'exchange = true;',
                            'exchange = false;'),),
    'wide_dkv_tile32': (('WgWideDkvGeo', 'exchange = true;',
                         'exchange = false;'),
                        ('WgWideDkvGeo', 'tile = 16;', 'tile = 32;'),
                        ('WgWideDkvGeo', 'stages = 2;', 'stages = 1;')),
    # a paired block takes the wide block's geometry: the wide forward's two
    # variants above, timed at the pair's head
    'pair_fwd_exchange': (('WgWideFwdGeo', 'exchange = false;',
                           'exchange = true;'),),
    'pair_fwd_tile16': (('WgWideFwdGeo', 'tile = 32;', 'tile = 16;'),
                        ('WgWideFwdGeo', 'stages = 2;', 'stages = 4;')),
    # timing only (UNCHECKED): the paired kernels without the hand-off, each
    # block on its own partial scores (wrong results), for what the hand-off
    # costs
    'pair_fwd_nohandoff': (
        (None, '      if constexpr (pair) box.send(t, acc, wg, tid);\n', ''),
        (None, '        box.receive(t, sc, tid);               '
         '// S = own + peer\n', '')),
    'pair_dkv_nohandoff': (
        (None, 'box.send(i, sc, dp, wg, tid), box.receive(i, sc, dp, tid);',
         ';'),
        (None, 'box.send(i, sc, wg, tid), box.receive(i, sc, tid);', ';')),
}
# the paired dQ's layouts: WgPairDqGeo as committed is (A), 32-key tiles,
# one stage of K and one of V, two inbox buffers, V's stage taken and
# multiplied first, S and dP sent and added in step. (B) 16-key tiles,
# three stages of K and two of V; (A) with one inbox buffer, and with K
# first; (timing only, UNCHECKED) (A) and (B) without the hand-off
PAIR_DQ_TILE16 = (('WgPairDqGeo', 'tile = 32;', 'tile = 16;'),
                  ('WgPairDqGeo', 'k_stages = 1;', 'k_stages = 3;'),
                  ('WgPairDqGeo', 'v_stages = 1;', 'v_stages = 2;'))
PAIR_DQ_NOHANDOFF = ((None, """        box.send(t, sc, dp, wg, tid);
        box.receive(t, sc, dp, tid);
""", ''),)
VARIANTS.update({
    'pair_dq_tile16': PAIR_DQ_TILE16,
    'pair_dq_one_buffer': (('WgPairDqGeo', 'buffers = 2;', 'buffers = 1;'),),
    'pair_dq_k_first': (('WgPairDqGeo', 'v_first = true;',
                         'v_first = false;'),),
    'pair_dq_nohandoff': PAIR_DQ_NOHANDOFF,
    'pair_dq_tile16_nohandoff': PAIR_DQ_TILE16 + PAIR_DQ_NOHANDOFF,
})
UNCHECKED = {'pair_fwd_nohandoff', 'pair_dkv_nohandoff', 'pair_dq_nohandoff',
             'pair_dq_tile16_nohandoff'}


def variant_kind(name: str) -> str:
    """The shapes a variant is timed at: 'wg_pair', 'wg_wide' or 'wg'."""
    return ('wg_pair' if name.startswith('pair_') else
            'wg_wide' if name.startswith('wide_') else 'wg')


OUT = []


def say(line: str):
    print(line, flush=True)
    OUT.append(line)


def run(root: str, *args) -> str:
    """This script's ``--child`` mode in a checkout rooted at ``root``;
    returns its last line."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          '--child', root, *args], capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        sys.exit(f'{root} {args}: {out.stdout[-2000:]}{out.stderr[-4000:]}')
    return out.stdout.strip().splitlines()[-1]


def child(root: str, shapes, check: bool):
    """In a process of its own: the checkout's kernels alone (and with
    ``check`` its errors at small shapes), printed as one JSON line."""
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import torch
    import chip_smoke as cs
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, flash_attention as fa)
    _build.load_library()
    dev = torch.device('cuda', 0)
    res = {}
    if check:
        worst = 0.0
        for b, h, n, m, d, causal, bias in (
                (2, 2, 130, 134, 96, True, 'hnm'),
                (2, 2, 130, 134, 128, False, None),
                (2, 2, 130, 70, 128, True, None),
                (2, 2, 130, 134, 160, True, None),
                (2, 2, 130, 134, 256, False, 'bhnm'),
                (2, 2, 130, 70, 256, True, None),
                (2, 2, 130, 134, 264, True, 'hnm'),
                (2, 2, 300, 260, 512, False, 'bhnm'),
                (2, 2, 130, 70, 512, True, None),
                (2, 2, 300, 260, 776, True, 'bhnm'),
                (2, 2, 130, 70, 1024, True, 'hnm')):
            *qkvo, bb = cs.flash_inputs(torch, dev, torch.bfloat16, b, h, n,
                                        m, d, bias, 3)
            errs, peaks, finite, _ = cs.flash_errors(torch, fa, *qkvo, bb,
                                                     causal)
            rel = cs.flash_relative(errs, peaks)
            worst = max(worst, *(v for k, v in rel.items() if k != 'lse'))
            if not finite or worst > cs.FLASH_TOL['bfloat16']:
                sys.exit(f'{root}: error {worst} at {(b, h, n, m, d)}')
        res['worst_rel_err'] = worst
        res['resources'] = {
            f'{fa.mma_kernel(k, w)}<{w}>': fa.mma_attributes(k, w, False)
            for k in fa.MMA_KERNELS for w in (128, 256)}
        if hasattr(fa, 'WG_WIDE_MAX'):
            res['resources'].update({
                fa.mma_kernel(k, 512): fa.mma_attributes(k, 512)
                for k in fa.MMA_KERNELS})
        if hasattr(fa, 'WG_PAIR_MAX'):
            res['resources'].update({
                fa.mma_kernel(k, 1024): fa.mma_attributes(k, 1024)
                for k in fa.MMA_KERNELS})
    for heads, d in shapes:
        q, k, v, dout, _ = cs.flash_inputs(torch, dev, torch.bfloat16, B,
                                           heads, N, M, d, None, 99)
        scale = d ** -0.5
        for causal in (False, True) if d <= 64 else (False,):
            out, lse = fa.flash_forward(q, k, v, None, causal, scale)
            delta = fa.row_delta(dout, out)
            res[f'{d}x{heads}{" causal" if causal else ""}'] = [
                round(cs.median_ms(f, 20), 4) for f in (
                    lambda: fa.flash_forward(q, k, v, None, causal, scale),
                    lambda: fa.flash_backward_dq(q, k, v, None, dout, lse,
                                                 delta, causal, scale),
                    lambda: fa.flash_backward_dkv(q, k, v, None, dout, lse,
                                                  delta, causal, scale))]
        del q, k, v, dout
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def wide_row(dh: int):
    """In a process of its own: flash_width_rows at one head of dh, as one
    JSON line."""
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from magvit2_pytorch_tpu_torch.ops.kernels import (
        _build, flash_attention as fa)
    _build.load_library()
    cs.set_tf32(False)
    rows = cs.flash_width_rows(torch, fa, torch.device('cuda', 0), cs.REPS,
                               cs.nvidia_smi(), dh, 1)
    print(json.dumps(rows), flush=True)


def ptxas_summary(log: str):
    """{kernel<width>: 'N regs, spill stores/loads'} of the 'mma' kernels
    at the wide widths (the Hopper wide kernels as <512>, the paired ones
    as <1024>)."""
    out, current = {}, None
    for line in log.splitlines():
        hit = re.search(r'Function properties for _ZN3mv25flash\d+(\w+?_mma_'
                        r'(?:padded_)?kernel)ILi(\d+)E', line)
        wide = re.search(r'Function properties for _ZN3mv25flash\d+(\w+?'
                         r'_wg_(wide|pair)_kernel)E', line)
        if hit and int(hit[2]) >= 128:
            current = f'{hit[1]}<{hit[2]}>'
        elif wide:
            current = f'{wide[1]}<{512 if wide[2] == "wide" else 1024}>'
        elif current and 'spill' in line:
            spill = re.findall(r'(\d+) bytes spill', line)
        elif current and 'Used' in line:
            regs = re.search(r'Used (\d+)', line)[1]
            out[current] = f'{regs} regs, spill {"/".join(spill)} B'
            current = None
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--baseline', default=None,
                        help='root of another checkout whose kernels run '
                             'at every shape beside this tree\'s')
    parser.add_argument('--variants', action='store_true',
                        help='also time VARIANTS at the wide widths')
    parser.add_argument('--only', default=None,
                        help='comma-separated VARIANTS to build and time')
    parser.add_argument('--wide-row', type=int, default=None,
                        help='also time the kernels of one head of this '
                             'size at (17, 1, 4096, DH)')
    parser.add_argument('--out', default=None)
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--shapes', default='all', help=argparse.SUPPRESS)
    parser.add_argument('--check', action='store_true',
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    pick = {'all': SHAPES, 'narrow': SHAPES[:2], 'wg': WG_SHAPES,
            'wg_wide': WIDE_SHAPES, 'wg_pair': PAIR_SHAPES}
    if args.child:
        if args.wide_row:
            return wide_row(args.wide_row)
        return child(args.child, pick[args.shapes], args.check)

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    smi = cs.nvidia_smi()
    say(f'[flash heads] this tree: {run(REPO)} ms (forward, dQ, dK/dV) at '
        f'(17, heads, 4096, d) / 4100 keys bf16, medians of 20, on {smi}')
    if args.baseline:
        for who in ('baseline', 'this tree', 'this tree', 'baseline'):
            root = os.path.abspath(args.baseline if who == 'baseline'
                                   else REPO)
            say(f'[flash heads] {who}: {run(root)} ms on {smi}')
    if args.variants:
        base = open(os.path.join(REPO, SRC)).read()
        trees, builds = {'this tree': REPO}, {}
        chosen = args.only.split(',') if args.only else list(VARIANTS)
        for name in chosen:
            subs = VARIANTS[name]
            text = base
            for sub in subs:
                text = struct_sub(text, *sub)
            tree = os.path.join(REPO, '_proof', f'flash_variant_{name}')
            shutil.rmtree(tree, ignore_errors=True)
            shutil.copytree(
                os.path.join(REPO, 'magvit2_pytorch_tpu_torch'),
                os.path.join(tree, 'magvit2_pytorch_tpu_torch'),
                ignore=shutil.ignore_patterns('_build', '__pycache__'))
            with open(os.path.join(tree, SRC), 'w') as f:
                f.write(text)
            trees[name] = tree
            builds[name] = subprocess.Popen(
                [sys.executable, '-c', 'from magvit2_pytorch_tpu_torch.ops.'
                 'kernels import _build; _build.load_library(); '
                 'print(_build.build_info["log"])'], cwd=tree,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                sys.exit(f'{name}: the build failed\n{log[-4000:]}')
            say(f'[flash variants] {name} ptxas: {ptxas_summary(log)}')
        order = list(trees)
        kinds = {variant_kind(name) for name in chosen}
        for kind in sorted(kinds):
            for name in order + order[::-1]:
                if name != 'this tree' and variant_kind(name) != kind:
                    continue
                check = () if name in UNCHECKED else ('--check',)
                say(f'[flash variants] {name} at {kind}: '
                    f'{run(trees[name], "--shapes", kind, *check)} on '
                    f'{smi}')
    if args.wide_row:
        say(f'[flash heads] head of {args.wide_row}: '
            f'{run(REPO, "--wide-row", str(args.wide_row))} on {smi}')
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'flash_heads_probe.txt'), 'w') as f:
            f.write('\n'.join(OUT) + '\n')


if __name__ == '__main__':
    main()
