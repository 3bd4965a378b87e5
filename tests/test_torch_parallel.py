"""The port's ``parallel/`` and its trainer over several processes, on the
CPU (gloo).

- The mesh helpers against the JAX package's: axes and extents, the
  assertion, each rank's rows of a batch against the JAX placement's shard
  on the same device, and the leaves ``tensor_parallel_shardings`` cuts on
  the README configuration, by name through the bridge (shapes only: no
  weights, no JAX compile).
- Two ranks, started from this file's ``__main__`` (one intra-op thread
  each, a timeout each), after ``tests/test_multiprocess.py``: the tiny
  configuration of ``tests/mp_worker.py`` with a multiscale discriminator
  and a stand-in perceptual net (so the adaptive weights are live), global
  batch 4 x accumulation 2, two GAN steps with R1. Both ranks end bit for bit
  alike, and within 1e-5 of the one-process run at the global batch (which
  this process runs meanwhile); ``save`` on rank 0, ``load`` on both;
  validation across the ranks against the one-process validation. The
  one-process run's step 0 (losses and reduced gradients) against the JAX
  package's ``tokenizer_loss`` on the same weights, micro-batches and
  frame picks, so the two ranks reach JAX in one hop.
- The global-batch terms over two ranks against the whole batch in one
  process: the LFQ codebook entropy (all three forms) and its gradient, the
  adaptive weights and every gradient of ``tokenizer_loss``, and the
  dropout rows.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WORLD = 2
BATCH, ACCUM, STEPS = 4, 2, 2          # global batch
TIMEOUT = 120                          # seconds, each rank
TOL = 1e-5
# the one-process run against the JAX package (float32, as
# tests/test_torch_train_losses.py holds the loss)
JAX_TOL = 1e-4
# tests/mp_worker.py:45-54, with a multiscale discriminator and a
# perceptual loss on a stand-in net (the adaptive weights then are live)
TINY = dict(image_size=16, init_dim=8, codebook_size=64,
            layers=('residual', ('compress_space', 12)), use_gan=True,
            discr_kwargs=dict(dim=8, image_size=16, channels=3, max_dim=16),
            multiscale_discrs=(dict(dim=4, max_dim=16),),
            perceptual_loss_weight=0.1)


class Videos:
    """Seeded uint8 clips."""

    def __init__(self, n=8):
        rng = np.random.default_rng(0)
        self.items = rng.integers(0, 256, size=(n, 3, 16, 16, 3),
                                  dtype=np.uint8)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class Features(torch.nn.Module):
    """A stand-in for VGG16 (the perceptual loss needs only a function of
    the frame): a seeded per-pixel layer."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.proj = torch.nn.Linear(3, 8)
        with torch.no_grad():
            self.proj.weight.copy_(torch.randn(8, 3, generator=gen))
            self.proj.bias.copy_(torch.randn(8, generator=gen) * 0.1)

    def forward(self, x):
        return torch.tanh(self.proj(x))


def tokenizer():
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    tok = VideoTokenizer(device='cpu', seed=0, **TINY)
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(1))
    tok._vgg = tok._frozen(Features())
    return tok


def trainer(workdir, **kw):
    from magvit2_pytorch_tpu_torch.training import VideoTokenizerTrainer
    args = dict(batch_size=BATCH, grad_accum_every=ACCUM,
                num_train_steps=STEPS, learning_rate=1e-4, warmup_steps=1,
                dataset=Videos(), valid_frac=0.0, discr_start_after_step=0,
                max_grad_norm=1.0, validate_every_step=1,
                ema_kwargs=dict(update_after_step=0, update_every=1),
                checkpoints_folder=f'{workdir}/ckpts',
                results_folder=f'{workdir}/results')
    args.update(kw)
    return VideoTokenizerTrainer(tokenizer(), **args)


def run_trainer(tr):
    """The steps' float metrics, the generator's reduced gradients at step
    0, step 0's micro-batches and frame picks, the validation and the end
    state."""
    from magvit2_pytorch_tpu_torch.data import cycle
    from magvit2_pytorch_tpu_torch.training import trainer as trainer_module
    first, opt, seen, drawn = {}, tr.optimizer, [], []
    draw = trainer_module.draw_tokenizer_loss

    def record(grads):
        del opt.step
        first.update({k: g.clone() for k, g in grads.items()})
        return opt.step(grads)

    def recorded(it):
        for item in it:
            seen.append(np.asarray(item[0]))
            yield item

    def recorded_draw(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    opt.step = record
    it = recorded(cycle(tr.dataloader))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module, 'draw_tokenizer_loss', recorded_draw)
        metrics = [{k: float(v) for k, v in tr.train_step(it).items()}
                   for _ in range(STEPS)]
    valid = tr.valid_step(cycle(tr.valid_dataloader))
    state = {f'{name}.{k}': v.detach().clone()
             for name in ('module', 'ema_module', 'discr')
             for k, v in getattr(tr, name).state_dict().items()}
    state.update({f'multiscale.{k}': v.detach().clone()
                  for k, v in tr.multiscale[0].state_dict().items()})
    return dict(metrics=metrics, valid=valid, state=state, grads=first,
                batches=seen[:ACCUM], picks=drawn[:ACCUM])


class JaxFeatures:
    """``Features`` for the JAX package's ``vgg_module``."""

    @staticmethod
    def apply(params, x):
        import jax.numpy as jnp
        return jnp.tanh(x @ params['w'].T + params['b'])


def jax_first_grads(batches, picks):
    """The JAX package's step 0 at the global batch from the trainer's
    starting weights, on its micro-batches and frame picks: the mean over
    the micro-batches of ``jax.grad`` of its ``tokenizer_loss`` (GAN,
    multiscale and perceptual terms), and its losses."""
    import jax
    import jax.numpy as jnp
    from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
    from magvit2_pytorch_tpu.training import losses as jl
    from magvit2_pytorch_tpu_torch.models.jax_import import (
        discr_bridge_entries, jax_params_from_state_dict,
        multiscale_bridge_entries, tree_from_state_dict)
    tok = tokenizer()
    jtok = JaxTokenizer(
        params=jax_params_from_state_dict(tok.config, tok.state_dict()),
        discr_params=tree_from_state_dict(discr_bridge_entries(tok.discr),
                                          tok.discr.state_dict()),
        multiscale_params=[tree_from_state_dict(
            multiscale_bridge_entries(ms), ms.state_dict())
            for ms in tok.multiscale_discrs],
        **{**TINY, 'perceptual_loss_weight': 0.0})   # no VGG16 to build
    proj = tok.vgg.proj
    vgg = {'w': jnp.asarray(proj.weight.detach().numpy()),
           'b': jnp.asarray(proj.bias.detach().numpy())}
    cfg = tok.config

    @jax.jit
    def grad(params, batch, perceptual, gen):
        def f(p):
            # the port's picks in place of the loss's two draws
            # (losses.py:204, 248)
            draws = iter((perceptual, gen))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, 'randint',
                           lambda *args, **kw: next(draws))
                total, bd, _ = jl.tokenizer_loss(
                    jtok.module, p, batch, jax.random.PRNGKey(0),
                    discr_module=jtok.discr, discr_params=jtok.discr_params,
                    multiscale_modules=tuple(jtok.multiscale_discrs),
                    multiscale_params=tuple(jtok.multiscale_params),
                    vgg_module=JaxFeatures, vgg_params=vgg, train=True,
                    use_vgg=True, has_gan=True, has_multiscale_gan=True,
                    perceptual_loss_weight=cfg.perceptual_loss_weight,
                    quantizer_aux_loss_weight=cfg.quantizer_aux_loss_weight,
                    adversarial_loss_weight=cfg.adversarial_loss_weight,
                    multiscale_adversarial_loss_weight=(
                        cfg.multiscale_adversarial_loss_weight))
            assert next(draws, None) is None
            return total, bd
        return jax.value_and_grad(f, has_aux=True)(params)

    grads, losses = None, []
    for batch, drawn in zip(batches, picks):
        (total, bd), g = grad(jtok.params,
                              jnp.asarray(batch, jnp.float32) / 255.0,
                              *(jnp.asarray(drawn[k].numpy())
                                for k in ('perceptual', 'gen')))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        losses.append(dict(total_loss=float(total),
                           recon_loss=float(bd.recon_loss),
                           lfq_aux_loss=float(bd.lfq_aux_loss),
                           perceptual_loss=float(bd.perceptual_loss)))
    return dict(grads=jax.tree.map(lambda g: g / len(batches), grads),
                losses={k: sum(m[k] for m in losses) / len(losses)
                        for k in losses[0]}, config=cfg)


# tests/test_trainer.py:233's configuration: leaves big enough for the
# JAX package's tensor-parallel rule (2^14 elements) to cut
TP_KW = dict(image_size=16, init_dim=32, codebook_size=64,
             layers=('residual', ('compress_space', 64)), use_gan=False,
             perceptual_loss_weight=0.0)


def tp_run(workdir, mesh=None, tensor_parallel=False):
    """Two steps of TP_KW's generator; its end state, the parameters cut,
    and (with a mesh) a save -> load round trip."""
    from magvit2_pytorch_tpu_torch import VideoTokenizer
    from magvit2_pytorch_tpu_torch.data import cycle
    from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
    from magvit2_pytorch_tpu_torch.training import VideoTokenizerTrainer
    tok = VideoTokenizer(device='cpu', seed=0, **TP_KW)
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(1))
    tr = VideoTokenizerTrainer(
        tok, batch_size=BATCH, grad_accum_every=ACCUM, num_train_steps=STEPS,
        learning_rate=1e-4, warmup_steps=1, dataset=Videos(), valid_frac=0.0,
        max_grad_norm=1.0, ema_kwargs=dict(update_after_step=0,
                                           update_every=1),
        checkpoints_folder=f'{workdir}/ckpts', mesh=mesh,
        results_folder=f'{workdir}/results', tensor_parallel=tensor_parallel)
    it = cycle(tr.dataloader)
    for _ in range(STEPS):
        tr.train_step(it)
    out = dict(state={f'{name}.{k}': v.detach().clone()
                      for name in ('module', 'ema_module')
                      for k, v in getattr(tr, name).state_dict().items()})
    # Adam's moments carry the gradients' scale, which its step hides
    mu = tr._tp.whole(tr.optimizer.mu) if tr._tp else tr.optimizer.mu
    out['state'].update({f'mu.{n}': m.clone() for n, m in mu.items()})
    if tr._tp:
        full = dict(tr.module.named_parameters())
        out['cut'] = {n: (tuple(tr.optimizer.mu[n].shape),
                          tuple(full[n].shape)) for n in tr._tp.dims}
        path = f'{workdir}/ckpts/checkpoint.tp'
        tr.save(path)
        saved = torch.load(path, weights_only=True)
        mu = {n: m.clone() for n, m in tr.optimizer.mu.items()}
        with torch.no_grad():
            for m in [*tr.optimizer.mu.values(), *tr._tp.master.values()]:
                m.zero_()
        tr.load(path)
        out['saved_whole'] = all(
            saved['opt_state']['mu'][n].shape == full[n].shape for n in full)
        out['reloaded'] = all(torch.equal(tr.optimizer.mu[n], m)
                              for n, m in mu.items())
    return out


def rel(got, want):
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-12))


# -- what each rank runs -------------------------------------------------------

def lfq_checks(shard):
    """The LFQ codebook entropy (full, per-bit and chunked exact forms) on
    this rank's rows against all rows: the entropy equal, and the rank's
    gradient ``count`` times the global one on its rows (its own terms are
    means over a ``count``-th of the rows, and the entropy's backward sums
    the ranks' gradients)."""
    from magvit2_pytorch_tpu_torch.ops.quantizers import LFQ
    from magvit2_pytorch_tpu_torch.parallel import sharded_batch
    out = {}
    for name, kw in (('full', dict(codebook_size=64)),
                     ('per_bit', dict(codebook_size=2 ** 13)),
                     ('chunked', dict(codebook_size=2 ** 13,
                                      exact_codebook_entropy=True,
                                      entropy_chunk_size=2048))):
        lfq = LFQ(dim=int(np.log2(kw['codebook_size'])), **kw)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (4 * shard.count, 6, lfq.dim)).astype(np.float32) * 0.05)
        whole = x.clone().requires_grad_(True)
        want = lfq(whole, train=True)
        (g_want,) = torch.autograd.grad(want.aux_loss, whole)
        rows = slice(4 * shard.index, 4 * (shard.index + 1))
        mine = x[rows].clone().requires_grad_(True)
        with sharded_batch(shard):
            got = lfq(mine, train=True)
            (g_got,) = torch.autograd.grad(got.aux_loss, mine)
        out[name] = dict(
            entropy=rel(got.breakdown.codebook_entropy,
                        want.breakdown.codebook_entropy),
            grad=rel(g_got / shard.count, g_want[rows]))
    return out


def loss_checks(shard, tr):
    """``tokenizer_loss`` with the GAN, multiscale and perceptual terms on
    this rank's rows (picks drawn for the global batch and cut) against the
    whole batch: the adaptive weights, the codebook entropy, the entropy
    canary, and the ranks' averaged gradients against the global ones."""
    import torch.distributed as dist
    from magvit2_pytorch_tpu_torch.parallel import rand_rows, sharded_batch
    from magvit2_pytorch_tpu_torch.training.losses import (
        draw_tokenizer_loss, tokenizer_loss)
    video = torch.from_numpy(Videos().items[:BATCH]).float() / 255
    picks = draw_tokenizer_loss(BATCH, video.shape[1],
                                torch.Generator().manual_seed(3))
    per = BATCH // shard.count
    rows = slice(per * shard.index, per * (shard.index + 1))
    params = list(tr.module.parameters())

    def loss(v, p):
        total, bd, _ = tokenizer_loss(
            tr.module, v, p, discr=tr.discr, multiscale=tuple(tr.multiscale),
            vgg=tr.vgg, use_vgg=True, has_gan=True, has_multiscale_gan=True,
            perceptual_loss_weight=0.1)
        return bd, torch.autograd.grad(total, params, allow_unused=True)

    want, g_want = loss(video, picks)
    with sharded_batch(shard):
        got, g_got = loss(video[rows], {k: v[rows] for k, v in picks.items()})
    # each leaf against its largest value, at least 1e-3 of the largest
    # gradient (the SqueezeExcite logit biases' are zero by their math)
    floor = 1e-3 * max(float(b.abs().max()) for b in g_want if b is not None)
    grads = []
    for a, b in zip(g_got, g_want):
        if a is None:
            continue
        a = a.clone()
        dist.all_reduce(a, group=shard.group)
        grads.append(float((a / shard.count - b).abs().max())
                     / max(float(b.abs().max()), floor))
    gen = [torch.Generator().manual_seed(4) for _ in range(2)]
    with sharded_batch(shard):
        drawn = rand_rows((per * 3, 5), gen[0], 'cpu')
    full = torch.rand((BATCH * 3, 5), generator=gen[1])
    return dict(
        adaptive=rel(got.adaptive_adversarial_weight,
                     want.adaptive_adversarial_weight),
        adaptive_value=float(want.adaptive_adversarial_weight),
        multiscale_adaptive=rel(got.multiscale_gen_adaptive_weights[0],
                                want.multiscale_gen_adaptive_weights[0]),
        multiscale_adaptive_value=float(
            want.multiscale_gen_adaptive_weights[0]),
        codebook_entropy=rel(got.quantizer_loss_breakdown.codebook_entropy,
                             want.quantizer_loss_breakdown.codebook_entropy),
        mean_bit_entropy=rel(got.mean_bit_entropy, want.mean_bit_entropy),
        grads=max(grads), n_grads=len(grads),
        dropout_rows=bool(torch.equal(drawn, full[per * 3 * shard.index:
                                                  per * 3 * (shard.index
                                                             + 1)])))


def mesh_checks(rank, world):
    """A ('dcn', 'data') mesh's batch group, and ``replicate``."""
    import torch.distributed as dist
    from magvit2_pytorch_tpu_torch import parallel as tp
    mesh = tp.make_mesh(dcn=world)
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total, group=mesh.group(tp.batch_axes(mesh)))
    tree = {'w': torch.full((3,), float(rank)), 'b': [torch.ones(2) * rank]}
    tp.replicate(tree, mesh)
    return dict(axes=mesh.axis_names, extent=tp.data_parallel_extent(mesh),
                index=tp.batch_index(mesh), total=float(total),
                replicated=float(tree['w'].sum() + tree['b'][0].sum()))


def rank_main(rank, world, port, workdir):
    torch.set_num_threads(1)
    from magvit2_pytorch_tpu_torch.parallel import (
        BatchShard, initialize_distributed, make_mesh, process_count)
    initialize_distributed(f'localhost:{port}', world, rank, device='cpu',
                           timeout=TIMEOUT)
    initialize_distributed(f'localhost:{port}', world, rank, device='cpu')
    assert process_count() == world
    mesh = make_mesh()
    out = dict(mesh=mesh_checks(rank, world))
    tr = trainer(workdir, mesh=mesh)
    shard = BatchShard(mesh.group(('data',)), rank, world)
    out.update(lfq=lfq_checks(shard), loss=loss_checks(shard, tr))
    out.update(run_trainer(tr))
    path = f'{workdir}/ckpts/checkpoint.final'
    tr.save(path)
    out['saved_by'] = sorted(os.listdir(f'{workdir}/ckpts'))
    before = {k: v.clone() for k, v in tr.module.state_dict().items()}
    step = tr.step
    tr.step = 0
    with torch.no_grad():
        for p in tr.module.parameters():
            p.zero_()
    tr.load(path)
    out['load'] = dict(step=tr.step == step, params=all(
        torch.equal(v, before[k]) for k, v in tr.module.state_dict().items()))
    out['gifs'] = sorted(p.name for p in Path(workdir, 'results').glob('*'))
    out['tp'] = tp_run(f'{workdir}/tp', make_mesh(data=1, tensor=world),
                       tensor_parallel=True)
    out['dp'] = tp_run(f'{workdir}/dp', mesh)
    torch.save(out, f'{workdir}/rank{rank}.pt')
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# -- the tests -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Two ranks' results, and the one-process run at the global batch
    (made here while the ranks run)."""
    work = tmp_path_factory.mktemp('parallel')
    port = _free_port()
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, 'PYTHONPATH': str(root), 'OMP_NUM_THREADS': '1'}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port),
         str(work / 'ranks')], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(root), env=env)
        for r in range(WORLD)]
    try:
        single = run_trainer(trainer(work / 'single'))
        single_tp_kw = tp_run(work / 'tp_single')
        jax_step0 = jax_first_grads(single['batches'], single['picks'])
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} failed:\n{out[-4000:]}'
    got = [torch.load(str(work / 'ranks' / f'rank{r}.pt'), weights_only=False)
           for r in range(WORLD)]
    return dict(ranks=got, single=single, single_tp_kw=single_tp_kw,
                jax_step0=jax_step0)


def test_two_ranks_end_alike(ranks):
    a, b = ranks['ranks']
    assert a['metrics'] == b['metrics']
    assert a['state'].keys() == b['state'].keys()
    for k, v in a['state'].items():
        assert torch.equal(v, b['state'][k]), k


def test_two_ranks_match_one_process_at_the_global_batch(ranks):
    got, want = ranks['ranks'][0], ranks['single']
    for step, (g, w) in enumerate(zip(got['metrics'], want['metrics'])):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1.0), (step, k)
    # the adaptive weights are live, so their global form is checked
    assert got['metrics'][0]['adaptive_adversarial_weight'] != 1.0
    errs = {k: rel(v, want['state'][k]) for k, v in got['state'].items()
            if v.is_floating_point()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
    # Adam's step hides a gradient's scale: the reduced gradients of step 0
    # against the one process's, each leaf against its largest value (at
    # least 1e-3 of the largest gradient)
    floor = 1e-3 * max(float(g.abs().max()) for g in want['grads'].values())
    for k, g in want['grads'].items():
        err = float((got['grads'][k] - g).abs().max())
        assert err <= TOL * max(float(g.abs().max()), floor), k


def test_one_process_step_0_matches_jax(ranks):
    """The one-process run's step 0 at the global batch (which the ranks
    match within TOL) against the JAX package's on the same weights,
    micro-batches and frame picks: the losses and the reduced gradients, each
    leaf within JAX_TOL of its largest value (at least 1e-3 of the largest
    gradient: the SqueezeExcite logit biases' are zero by their math)."""
    import jax
    from magvit2_pytorch_tpu_torch.models.jax_import import (
        bridge_entries, tree_from_state_dict)
    single, want = ranks['single'], ranks['jax_step0']
    for k, w in want['losses'].items():
        assert abs(single['metrics'][0][k] - w) <= JAX_TOL * abs(w), k
    grads = single['grads']
    got = dict(jax.tree_util.tree_leaves_with_path(tree_from_state_dict(
        [e for e in bridge_entries(want['config']) if e[0] in grads],
        grads)))
    leaves = dict(jax.tree_util.tree_leaves_with_path(want['grads']))
    assert got.keys() == leaves.keys()
    floor = 1e-3 * max(float(np.abs(w).max()) for w in leaves.values())
    for path, w in leaves.items():
        w = np.asarray(w)
        err = float(np.abs(np.asarray(got[path]) - w).max())
        assert err <= JAX_TOL * max(float(np.abs(w).max()), floor), (
            jax.tree_util.keystr(path), err)


def test_a_dcn_mesh_and_replicate_over_two_ranks(ranks):
    for r, got in enumerate(ranks['ranks']):
        assert got['mesh'] == dict(axes=('dcn', 'data', 'tensor'),
                                   extent=WORLD, index=r, total=3.0,
                                   replicated=0.0)


def test_save_on_rank_0_load_on_both(ranks):
    for r in ranks['ranks']:
        assert r['saved_by'] == ['checkpoint.final']
        assert r['load'] == dict(step=True, params=True)


def test_validation_across_ranks(ranks):
    a, b = ranks['ranks']
    assert a['valid'] == b['valid']
    for g, w in zip(a['valid'], ranks['single']['valid']):
        assert abs(g - w) <= TOL * abs(w)
    # one GIF, of the step validated (the ranks share the folder)
    assert a['gifs'] == b['gifs'] == [f'sampled.{STEPS}.gif']


@pytest.mark.parametrize('form', ['full', 'per_bit', 'chunked'])
def test_lfq_codebook_entropy_over_two_ranks(ranks, form):
    for r in ranks['ranks']:
        assert r['lfq'][form]['entropy'] <= TOL
        assert r['lfq'][form]['grad'] <= TOL


def test_adaptive_weights_over_two_ranks(ranks):
    for r in ranks['ranks']:
        loss = r['loss']
        assert loss['adaptive_value'] != 1.0
        assert loss['multiscale_adaptive_value'] != 1.0
        assert loss['adaptive'] <= TOL
        assert loss['multiscale_adaptive'] <= TOL


def test_loss_gradients_over_two_ranks(ranks):
    for r in ranks['ranks']:
        loss = r['loss']
        assert loss['codebook_entropy'] <= TOL
        assert loss['mean_bit_entropy'] <= TOL
        assert loss['n_grads'] > 10 and loss['grads'] <= TOL
        assert loss['dropout_rows']


def test_tensor_parallel_matches_data_parallel(ranks):
    """Tensor 2 x data 1 against data 2 (and one process): the same update,
    as ``tests/test_trainer.py:233`` asserts for the JAX package, with each
    rank holding half of every cut parameter's Adam moments."""
    want = ranks['single_tp_kw']['state']
    # each moment against its largest value, at least 1e-3 of the largest
    # (the SqueezeExcite logit biases' gradients are zero by their math)
    floor = 1e-3 * max(float(v.abs().max()) for k, v in want.items()
                       if k.startswith('mu.'))

    def err(got, w):
        return float((got - w).abs().max()) / max(float(w.abs().max()),
                                                   floor)
    for r in ranks['ranks']:
        tp, dp = r['tp'], r['dp']
        assert len(tp['cut']) >= 4
        for n, (part, whole) in tp['cut'].items():
            assert part[0] * WORLD == whole[0] or part[-1] * WORLD == whole[
                -1], n
            assert np.prod(part) * WORLD == np.prod(whole), n
        for k, v in want.items():
            if v.is_floating_point():
                assert err(tp['state'][k], v) <= TOL, k
                assert err(dp['state'][k], v) <= TOL, k
        assert tp['saved_whole'] and tp['reloaded']
    for k, v in ranks['ranks'][0]['tp']['state'].items():
        assert torch.equal(v, ranks['ranks'][1]['tp']['state'][k]), k


# -- the mesh helpers against the JAX package's --------------------------------

MESHES = [dict(), dict(data=4, tensor=2), dict(tensor=2, dcn=2),
          dict(data=2, tensor=2, dcn=2), dict(dcn=4), dict(tensor=8)]


def _port_mesh(n, rank=0, **kw):
    """The port's mesh of ``n`` ranks as ``make_mesh`` lays it out, seen
    from ``rank``."""
    from magvit2_pytorch_tpu_torch.parallel.mesh import Mesh, mesh_layout
    names, sizes = mesh_layout(n, **kw)
    return Mesh(names, sizes, 'cpu', rank=rank)


@pytest.mark.parametrize('kw', MESHES, ids=str)
def test_mesh_axes_and_extents_match_jax(kw):
    import jax
    from magvit2_pytorch_tpu import parallel as jp
    from magvit2_pytorch_tpu_torch import parallel as tp
    want = jp.make_mesh(**kw, devices=jax.devices()[:8])
    got = _port_mesh(8, **kw)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert tp.batch_axes(got) == jp.batch_axes(want)
    assert tp.data_parallel_extent(got) == jp.data_parallel_extent(want)


def test_mesh_assertion_matches_jax():
    import jax
    from magvit2_pytorch_tpu import parallel as jp
    for kw in (dict(data=3), dict(data=2, tensor=2)):
        with pytest.raises(AssertionError, match='does not cover 8'):
            jp.make_mesh(**kw, devices=jax.devices()[:8])
        with pytest.raises(AssertionError, match='does not cover 8'):
            _port_mesh(8, **kw)


@pytest.mark.parametrize('kw', MESHES[1:4], ids=str)
def test_shard_batch_matches_the_jax_placement(kw):
    """Rank r's rows (after an accumulation axis) are the rows the JAX
    package's ``shard_batch`` puts on device r."""
    import jax
    from magvit2_pytorch_tpu import parallel as jp
    from magvit2_pytorch_tpu_torch import parallel as tp
    batch = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    placed = jp.shard_batch(batch, jp.make_mesh(
        **kw, devices=jax.devices()[:8]), leading_none=1)
    on_device = {s.device.id: np.asarray(s.data)
                 for s in placed.addressable_shards}
    for rank, device in enumerate(jax.devices()[:8]):
        got = tp.shard_batch(batch, _port_mesh(8, rank, **kw),
                             leading_none=1)
        np.testing.assert_array_equal(got, on_device[device.id])
        assert torch.equal(tp.shard_batch(torch.from_numpy(batch), _port_mesh(
            8, rank, **kw), leading_none=1), torch.from_numpy(got))


@pytest.mark.parametrize('tensor', [2, 4])
def test_tensor_parallel_cuts_the_jax_leaves(tensor):
    """On the README configuration's weights (shapes only, on the meta
    device): the port cuts, by the bridge's names, the leaves the JAX
    package's ``tensor_parallel_shardings`` cuts, each along the JAX
    trailing dim."""
    import jax
    from magvit2_pytorch_tpu import parallel as jp
    from magvit2_pytorch_tpu_torch import parallel as tp
    from magvit2_pytorch_tpu_torch.configs import readme_video_tokenizer_kwargs
    from magvit2_pytorch_tpu_torch.models.jax_import import (
        TRANSFORMS, bridge_entries)
    from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
        TokenizerConfig, TokenizerModule)
    cfg = TokenizerConfig(**readme_video_tokenizer_kwargs())
    with torch.device('meta'):
        params = dict(TokenizerModule(cfg).named_parameters())
    entries = bridge_entries(cfg)
    tree = {}
    for key, path, kind in entries:
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = TRANSFORMS[kind][1](
            np.broadcast_to(np.float32(0), tuple(params[key].shape)))
    want = jp.tensor_parallel_shardings(tree, jp.make_mesh(
        tensor=tensor, devices=jax.devices()[:8]))
    got = tp.tensor_parallel_shardings(
        params, _port_mesh(8, tensor=tensor), entries=entries)
    assert set(got) == {key for key, _, _ in entries}
    cut = 0
    for key, path, kind in entries:
        spec = want
        for name in path:
            spec = spec[name]
        jax_cut = 'tensor' in tuple(spec.spec)
        assert (got[key] is not None) == jax_cut, key
        if jax_cut:
            cut += 1
            # the port's cut dim holds the JAX trailing (output) channels
            assert params[key].shape[got[key]] == TRANSFORMS[kind][1](
                np.broadcast_to(np.float32(0), tuple(params[key].shape))
            ).shape[-1]
    assert cut > 10


def test_one_process_needs_no_group():
    from magvit2_pytorch_tpu_torch import parallel as tp
    tp.initialize_distributed()
    assert tp.process_count() == 1 and tp.process_index() == 0
    mesh = tp.make_mesh()
    assert mesh.shape == {'data': 1, 'tensor': 1} and mesh.device_mesh is None
    assert tp.replicate({'w': torch.ones(2)}, mesh)['w'].sum() == 2


if __name__ == '__main__':
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
