#!/usr/bin/env python3
"""Why two ranks on one card differ from one process at the global batch
(ROADMAP C8), on one NVIDIA GPU.

    python3 tools/split_batch_probe.py [--out DIR]

Runs the float32 side of ``chip_smoke.py``'s phase 12(b) (the README
flagship, TF32 off, default path, ``DIST_F32_RANK_BATCH`` clips x accum
``TRAIN_ACCUM`` a rank, ``DIST_STEPS`` steps, the discriminator from step 1,
R1 at step 2) with ``torch.backends.cudnn.deterministic = True`` four ways:

- ``one``, ``one_again``: one process at the global batch, twice (what is
  left of run-to-run noise);
- ``split``: one process at the global batch with every ``F.conv2d``,
  ``F.conv3d`` and ``F.linear`` whose leading (batch) axis is even cut in
  two along it, each half run alone and the results concatenated: the
  ranks' conv and GEMM shapes, with one process's losses, sums and no
  all-reduce;
- ``ranks``: two ranks of this script over gloo (the phase's ranks, float32
  part only), rank 0's readings.

For each pair it prints step 0's reduced generator gradients, each leaf
against its largest value (``chip_smoke.leaf_errors``: worst and median
leaf), every loss at each step relative to its value, and the parameters'
largest difference after the steps, with the card's name and power limit.
If ``split`` sits as close to ``ranks`` as ``one`` sits to ``one_again``,
while ``one`` and ``ranks`` differ, the gap is the algorithms cuDNN and
cuBLAS take at half the batch; if ``split`` stays as far from ``ranks`` as
``one`` is, it comes from what the ranks compute apart (``parallel/batch.py``,
the trainer's flat all-reduce). ``--out`` also writes the readings as JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def split_batch(torch):
    """Within the block every conv and linear with an even leading axis runs
    as two calls on its halves, concatenated."""
    F = torch.nn.functional
    real = {name: getattr(F, name) for name in ('conv2d', 'conv3d', 'linear')}

    def cut(fn):
        def call(x, *args, **kw):
            if x.dim() >= 2 and x.shape[0] >= 2 and x.shape[0] % 2 == 0:
                return torch.cat([fn(h, *args, **kw) for h in x.chunk(2)])
            return fn(x, *args, **kw)
        return call

    for name, fn in real.items():
        setattr(F, name, cut(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(F, name, fn)


def one_process(torch, dev, tmp, name, split=False):
    with split_batch(torch) if split else contextlib.nullcontext():
        tr, run = cs.flagship_run(torch, dev, os.path.join(tmp, name),
                                  cs.DIST_WORLD, float32=True)
    del tr
    torch.cuda.empty_cache()
    return run


def rank_main(args):
    import torch
    import torch.distributed as dist
    from magvit2_pytorch_tpu_torch.parallel import make_mesh
    torch.backends.cudnn.deterministic = True
    dist.init_process_group(
        'gloo', init_method=f'tcp://localhost:{args.port}',
        world_size=cs.DIST_WORLD, rank=args.rank,
        timeout=datetime.timedelta(seconds=cs.DIST_TIMEOUT))
    tr, run = cs.flagship_run(
        torch, torch.device('cuda', 0),
        os.path.join(args.workdir, f'f{args.rank}'), cs.DIST_WORLD,
        make_mesh(), float32=True)
    del tr
    if args.rank == 0:
        torch.save(run, os.path.join(args.workdir, 'ranks.pt'))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_ranks(work):
    import subprocess
    port = cs.free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--rank', str(r),
         '--port', str(port), '--workdir', work],
        stdout=open(os.path.join(work, f'rank{r}.log'), 'w'),
        stderr=subprocess.STDOUT) for r in range(cs.DIST_WORLD)]
    try:
        for r, p in enumerate(procs):
            if p.wait(timeout=cs.DIST_TIMEOUT) != 0:
                with open(os.path.join(work, f'rank{r}.log')) as f:
                    sys.exit(f'rank {r} failed:\n{f.read()[-3000:]}')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def compare(got, want):
    e = cs.flagship_errors(got, want)
    grads = sorted(e['grads'].values())
    return dict(grad_worst=cs.worst(e['grads']),
                grad_median=grads[len(grads) // 2],
                loss_worst=cs.worst(e['losses']),
                param_max_diff=e['max_diff'])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None)
    for name in ('--rank', '--port'):
        parser.add_argument(name, type=int, default=None,
                            help=argparse.SUPPRESS)
    parser.add_argument('--workdir', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('this probe runs on the card: no GPU')
    if args.rank is not None:
        return rank_main(args)
    torch.backends.cudnn.deterministic = True
    dev = torch.device('cuda', 0)
    smi = cs.nvidia_smi()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, split in (('one', False), ('one_again', False),
                            ('split', True)):
            runs[name] = one_process(torch, dev, tmp, name, split)
        work = os.path.join(tmp, 'ranks')
        os.makedirs(work)
        spawn_ranks(work)
        runs['ranks'] = torch.load(os.path.join(work, 'ranks.pt'))
    pairs = {f'{a} vs {b}': compare(runs[a], runs[b])
             for a, b in (('one_again', 'one'), ('ranks', 'one'),
                          ('ranks', 'split'), ('split', 'one'))}
    print(f'{smi}; float32, TF32 off, cudnn.deterministic; README flagship, '
          f'default path, {cs.DIST_F32_RANK_BATCH} x accum {cs.TRAIN_ACCUM} a '
          f'rank, {cs.DIST_WORLD} ranks, {cs.DIST_STEPS} steps')
    for pair, r in pairs.items():
        (gk, gv), (lk, lv) = r['grad_worst'], r['loss_worst']
        print(f'{pair}: step 0 gradients worst leaf {gv:.3e} ({gk}), median '
              f'{r["grad_median"]:.3e}; losses worst {lv:.3e} ({lk}); '
              f'parameters max |diff| {r["param_max_diff"]:.3e}')
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'split_batch_probe.json'), 'w') as f:
            json.dump(dict(card=smi, pairs=pairs), f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
