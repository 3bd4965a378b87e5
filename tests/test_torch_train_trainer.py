"""The port's ``VideoTokenizerTrainer`` on the CPU: three GAN steps with R1
and grad accumulation against the JAX package's same steps (its losses,
optax and EMA run as its trainer runs them, on the batches and frame picks
the port's steps took), monolithic against split accumulation, ``remat`` in
all three modes against none, save / load / resume, the EMA tokenizer's
roundtrip contract, a step with the perceptual loss on given VGG weights,
and what the trainer refuses.

Tiny config (image_size 16, init_dim 8, as tests/fixtures/generate.py:152)
with live SqueezeExcite gates, float32. Losses and metrics agree within
1e-4 of their value at the first step (the same weights) and 1e-3 after (the
weights then differ by float32 noise); parameters after three steps differ
by at most 2 lr a step (Adam moves a weight by about lr in the sign of its
gradient, and a gradient near 0 may take either sign), and in every leaf
99% of the elements by at most 1e-2 lr (5.7e-4 lr at most on these draws),
so a fault confined to one small leaf (a norm gain, a bias, a
discriminator head) fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.training import losses as jl
from magvit2_pytorch_tpu.training.ema import (
    EMAConfig as JaxEMAConfig, ema_update as jax_ema_update)
from magvit2_pytorch_tpu.training.optimizer import (
    get_optimizer as jax_get_optimizer)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.data import cycle
from magvit2_pytorch_tpu_torch.models.jax_import import (
    discr_bridge_entries, jax_params_from_state_dict, tree_from_state_dict)
from magvit2_pytorch_tpu_torch.models.vgg import conv_and_linear_names
from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
from magvit2_pytorch_tpu_torch.training import trainer as trainer_module
from magvit2_pytorch_tpu_torch.training import VideoTokenizerTrainer

from test_torch_train_modules import _random_vgg

torch.set_num_threads(1)
LR = 1e-3
KW = dict(image_size=16, init_dim=8, codebook_size=64,
          layers=('residual', ('compress_space', 16), 'linear_attend_space',
                  ('compress_time', 16), 'attend_time'),
          attn_heads=2, linear_attn_heads=4,
          discr_kwargs=dict(dim=4, image_size=16, channels=3, max_dim=16),
          perceptual_loss_weight=0.0)
EMA = dict(update_after_step=0, update_every=1, beta=0.5)


class Videos:
    """An in-memory dataset of uint8 clips, as a decoder would give them."""

    def __init__(self, n=8, t=5, size=16, seed=0):
        rng = np.random.default_rng(seed)
        self.items = rng.integers(0, 256, size=(n, t, size, size, 3),
                                  dtype=np.uint8)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _tokenizer(seed=0, **kw):
    tok = VideoTokenizer(device='cpu', seed=seed, **{**KW, **kw})
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(seed + 1))
    return tok


def _trainer(tok, tmp_path, **kw):
    args = dict(batch_size=2, num_train_steps=3, learning_rate=LR,
                grad_accum_every=2, dataset=Videos(), valid_frac=0.0,
                warmup_steps=2, discr_start_after_step=1,
                apply_gradient_penalty_every=2, max_grad_norm=1.0,
                ema_kwargs=EMA, checkpoints_folder=str(tmp_path / 'ck'),
                results_folder=str(tmp_path / 'res'), log_every=1)
    args.update(kw)
    return VideoTokenizerTrainer(tok, **args)


class Recorder:
    """A batch iterator that keeps what it gave."""

    def __init__(self, it):
        self.it, self.seen = it, []

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.it)
        self.seen.append(np.asarray(item[0]))
        return item


def _jax_keys(seed, step, accum):
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    rng_gen, rng_discr = jax.random.split(rng)
    return (jax.random.split(rng_gen, accum),
            jax.random.split(rng_discr, accum))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Three port steps (the frame picks JAX's, for each micro-step), and
    the batches they took."""
    tmp = tmp_path_factory.mktemp('trainer')
    tok = _tokenizer()
    jax_start = {
        'params': jax_params_from_state_dict(tok.config, tok.state_dict()),
        'discr': tree_from_state_dict(discr_bridge_entries(tok.discr),
                                      tok.discr.state_dict())}
    tr = _trainer(tok, tmp)
    calls = {'gen': [], 'discr': []}

    def gen_picks(b, frames, gen):
        step, i = tr.step, len(calls['gen']) % 2
        calls['gen'].append((step, i))
        key = _jax_keys(0, step, 2)[0][i]
        key, _, _ = jax.random.split(key, 3)
        kp, kg = jax.random.split(key)
        return {'perceptual': torch.from_numpy(np.array(
                    jax.random.randint(kp, (b,), 0, frames))),
                'gen': torch.from_numpy(np.array(
                    jax.random.randint(kg, (b,), 0, frames)))}

    def discr_picks(b, frames, gen):
        step, i = tr.step, len(calls['discr']) % 2
        calls['discr'].append((step, i))
        key = _jax_keys(0, step, 2)[1][i]
        return torch.from_numpy(np.array(
            jax.random.randint(key, (b,), 0, frames)))

    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_module, 'draw_tokenizer_loss', gen_picks)
    mp.setattr(trainer_module, 'draw_frames', discr_picks)
    it = Recorder(cycle(tr.dataloader))
    metrics = [tr.train_step(it) for _ in range(3)]
    mp.undo()
    return tok, tr, jax_start, it.seen, metrics


def _jax_steps(tok, start, batches):
    """The JAX trainer's generator and discriminator steps
    (``trainer.py:517-552, 688-721``), eagerly over jitted micro-losses."""
    jtok = JaxTokenizer(params=start['params'], discr_params=start['discr'],
                        **KW)
    cfg = jtok.config
    tx = jax_get_optimizer(lr=LR, warmup_steps=2, max_grad_norm=1.0)
    dtx = jax_get_optimizer(lr=LR, warmup_steps=2, max_grad_norm=1.0)
    params, discr = jtok.params, jtok.discr_params
    opt, dopt = tx.init(params), dtx.init(discr)
    ema = jax.tree.map(jnp.copy, params)
    batches = iter(batches)
    out = []

    @jax.jit
    def gen_grad(params, discr, batch, key, adv):
        def f(p):
            total, bd, _ = jl.tokenizer_loss(
                jtok.module, p, batch, key, discr_module=jtok.discr,
                discr_params=discr, train=True, use_vgg=False,
                has_gan=True, adversarial_loss_weight=adv)
            return total, bd
        return jax.value_and_grad(f, has_aux=True)(params)

    def discr_grad(discr, params, batch, key, gp):
        def f(d):
            return jl.discriminator_loss(
                jtok.module, params, jtok.discr, d, batch, key,
                apply_gradient_penalty=gp,
                grad_penalty_loss_weight=cfg.grad_penalty_loss_weight)
        return jax.value_and_grad(f, has_aux=True)(discr)

    discr_grad = jax.jit(discr_grad, static_argnums=4)
    for step in range(3):
        adv = step + 1 > 1
        gkeys, dkeys = _jax_keys(0, step, 2)
        grads, total, recon = None, 0.0, 0.0
        for i in range(2):
            batch = jnp.asarray(next(batches), jnp.float32) / 255.0
            (t, bd), g = gen_grad(params, discr, batch, gkeys[i],
                                  1.0 if adv else 0.0)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            total, recon = total + t, recon + bd.recon_loss
        grads = jax.tree.map(lambda g: g / 2, grads)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        ema = jax_ema_update(ema, params, step, JaxEMAConfig(**EMA))
        metrics = {'total_loss': total / 2, 'recon_loss': recon / 2}
        if adv:
            dgrads, dtotal = None, 0.0
            for i in range(2):
                batch = jnp.asarray(next(batches), jnp.float32) / 255.0
                (t, bd), g = discr_grad(discr, params, batch, dkeys[i],
                                        step % 2 == 0)
                dgrads = g if dgrads is None else jax.tree.map(
                    jnp.add, dgrads, g)
                dtotal = dtotal + t
            dgrads = jax.tree.map(lambda g: g / 2, dgrads)
            updates, dopt = dtx.update(dgrads, dopt, discr)
            discr = optax.apply_updates(discr, updates)
            metrics['total_discr_loss'] = dtotal / 2
        out.append(metrics)
    return params, discr, ema, out


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _params_close(got, want, steps):
    """Within 2 lr a step everywhere, and in each leaf 99% of the elements
    within 1e-2 lr."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        diffs = np.abs(np.asarray(got[k]) - np.asarray(want[k])).ravel()
        assert diffs.max() <= 2 * LR * steps, jax.tree_util.keystr(k)
        assert np.quantile(diffs, 0.99) <= 1e-2 * LR, jax.tree_util.keystr(k)


def test_three_gan_steps_match_jax(run):
    tok, tr, start, batches, metrics = run
    assert len(batches) == 2 + 4 + 4      # gen only, then gen + discr
    params, discr, ema, jmetrics = _jax_steps(tok, start, batches)
    _params_close(jax_params_from_state_dict(tok.config,
                                             tr.module.state_dict()),
                  params, 3)
    _params_close(tree_from_state_dict(discr_bridge_entries(tr.discr),
                                       tr.discr.state_dict()), discr, 2)
    _params_close(jax_params_from_state_dict(tok.config,
                                             tr.ema_module.state_dict()),
                  ema, 3)
    for step, (m, w) in enumerate(zip(metrics, jmetrics)):
        rel = 1e-4 if step == 0 else 1e-3
        for k, v in w.items():
            assert abs(m[k] - float(v)) <= rel * abs(float(v)), (step, k)
    assert set(metrics[2]) >= {'gradient_penalty', 'discr_loss',
                               'mean_bit_entropy', 'codebook_unique_codes',
                               'adaptive_adversarial_weight'}
    assert metrics[2]['gradient_penalty'] > 0 == metrics[1]['gradient_penalty']
    # the trainer wrote its weights back into the tokenizer it was given
    for a, b in zip(tok.module.parameters(), tr.module.parameters()):
        assert torch.equal(a, b)


def test_split_accumulation_matches_monolithic(run, tmp_path):
    """The same three steps with ``grad_accum_split=True`` (one upload a
    micro-step) give the same numbers, bit for bit."""
    _, _, _, batches, _ = run
    out = []
    for split in (False, True):
        tr = _trainer(_tokenizer(), tmp_path / str(split),
                      grad_accum_split=split)
        it = iter([(b,) for b in batches])
        out.append(([tr.train_step(it) for _ in range(3)], tr))
    (ma, a), (mb, b) = out
    assert ma == mb
    for x, y in zip(a.module.state_dict().values(),
                    b.module.state_dict().values()):
        assert torch.equal(x, y)


@pytest.mark.parametrize('remat', [True, 'full', 'dots'])
def test_remat_gives_the_same_loss_and_gradients(remat):
    from magvit2_pytorch_tpu_torch.training.losses import tokenizer_loss
    video = torch.rand(2, 5, 16, 16, 3, generator=torch.Generator()
                       .manual_seed(4))
    picks = {'perceptual': torch.tensor([0, 1]), 'gen': torch.tensor([2, 3])}
    out = []
    for r in (False, remat):
        tok = _tokenizer(remat=r)
        tok.module.requires_grad_(True)
        tok.discr.requires_grad_(True)
        total, bd, _ = tokenizer_loss(tok.module, video, picks,
                                      discr=tok.discr, has_gan=True)
        params = list(tok.module.parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        out.append((total, [g for g in grads if g is not None]))
    (a, ga), (b, gb) = out
    assert torch.allclose(a, b, rtol=1e-6, atol=0)
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert torch.allclose(x, y, rtol=0, atol=1e-6 * x.abs().max())


def test_resume_is_bit_identical(tmp_path):
    data = Videos(seed=5)
    batches = [(data.items[i:i + 2],) for i in (0, 2, 4, 6)] * 3
    a = _trainer(_tokenizer(), tmp_path / 'a', dataset=data)
    it = iter(batches)
    a.train_step(it)
    a.train_step(it)
    a.save(tmp_path / 'checkpoint.7')
    rest = list(it)
    want = a.train_step(iter(rest))
    b = _trainer(_tokenizer(seed=9), tmp_path / 'b', dataset=data)
    b.load(tmp_path / 'checkpoint.7')
    assert b.step == 2
    got = b.train_step(iter(rest))
    assert got == want
    for net_a, net_b in ((a.module, b.module), (a.discr, b.discr),
                         (a.ema_module, b.ema_module)):
        for x, y in zip(net_a.state_dict().values(),
                        net_b.state_dict().values()):
            assert torch.equal(x, y)
    # maybe_auto_resume finds the newest checkpoint in its folder
    c = _trainer(_tokenizer(), tmp_path / 'c', dataset=data,
                 checkpoints_folder=str(tmp_path))
    assert c.maybe_auto_resume() and c.step == 2


def test_ema_tokenizer_keeps_the_roundtrip_contract(run):
    """README: ``decode_from_code_indices(tokenize(v))`` equals the
    roundtrip's recon (within 1e-4), on the EMA weights."""
    _, tr, _, _, _ = run
    ema = tr.ema_tokenizer
    assert ema.module is tr.ema_module and ema.discr is None
    v = torch.rand(2, 5, 16, 16, 3, generator=torch.Generator()
                   .manual_seed(6))
    codes, recon = ema.forward(v, return_codes=True, return_recon=True)
    assert torch.equal(tr.tokenize(v), codes)
    back = ema.decode_from_code_indices(codes.reshape(2, -1))
    assert (back - recon).abs().max() <= 1e-4


def test_a_step_with_the_perceptual_loss(tmp_path):
    """VGG weights given as a torchvision state_dict file: the perceptual
    loss and the adaptive weight are live, and the trainer holds VGG once,
    in the compute dtype, with no gradient."""
    vgg = _random_vgg(2)
    path = tmp_path / 'vgg16.pth'
    torch.save({f'{p}.{leaf}': getattr(vgg.get_submodule(p), leaf).detach()
                for p, _ in conv_and_linear_names()
                for leaf in ('weight', 'bias')}, str(path))
    tok = _tokenizer(perceptual_loss_weight=0.1, vgg_weights=str(path))
    assert tok.vgg_pretrained
    tr = _trainer(tok, tmp_path, discr_start_after_step=0,
                  grad_accum_every=1)
    m = tr.train_step(cycle(tr.dataloader))
    assert m['perceptual_loss'] > 0
    assert np.isfinite(m['adaptive_adversarial_weight'])
    assert m['adaptive_adversarial_weight'] != 1.0
    assert not any(p.requires_grad for p in tr.vgg.parameters())


def test_train_loop_validates_and_checkpoints(tmp_path):
    tr = _trainer(_tokenizer(), tmp_path, num_train_steps=2,
                  validate_every_step=1, checkpoint_every_step=1,
                  valid_frac=0.25, dataset=Videos(n=8))
    tr.train()
    assert tr.step == 2
    assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == [
        'checkpoint.0', 'checkpoint.1']
    assert (tmp_path / 'res' / 'sampled.1.gif').exists()


def test_what_the_trainer_refuses(tmp_path, monkeypatch):
    tok = _tokenizer()
    for kw in (dict(mesh=object()), dict(tensor_parallel=True)):
        with pytest.raises(NotImplementedError, match='item 13'):
            _trainer(tok, tmp_path, **kw)
    with pytest.raises(NotImplementedError, match='item 12'):
        _trainer(tok, tmp_path).load_torch_checkpoint('trainer.pt')
    monkeypatch.setenv('MAGVIT2_TPU_INT8_CONV', '1')
    with pytest.raises(RuntimeError, match='inference-only'):
        _trainer(tok, tmp_path)


def test_each_discriminator_has_its_own_optimizer(tmp_path):
    """With a multiscale discriminator the discriminator step updates the
    main and the multiscale one, each with its own optimizer (so each is
    clipped by its own norm, as the JAX package's ``multi_transform``), and
    the multiscale terms reach the metrics."""
    tok = _tokenizer(multiscale_discrs=(dict(dim=4, max_dim=16),))
    tr = _trainer(tok, tmp_path, discr_start_after_step=0,
                  grad_accum_every=1)
    assert len(tr.discr_optimizers) == 2
    before = [p.detach().clone() for p in tr.multiscale[0].parameters()]
    m = tr.train_step(cycle(tr.dataloader))
    assert m['multiscale_discr_loss'] > 0 and m['multiscale_gen_loss'] != 0
    assert all(o.count == 1 for o in tr.discr_optimizers)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tr.multiscale[0].parameters()))
    for a, b in zip(tok.multiscale_discrs[0].parameters(),
                    tr.multiscale[0].parameters()):
        assert torch.equal(a, b)        # written back into the tokenizer


@pytest.mark.parametrize('remat', [True, 'dots'])
def test_remat_recomputes_the_same_dropout(remat):
    """With attention dropout a layer's recompute draws the masks its
    forward drew (the generator is set back for the recompute and restored
    after it), so the gradients equal those without remat, and the
    generator ends where it would."""
    from magvit2_pytorch_tpu_torch.training.losses import tokenizer_loss
    video = torch.rand(1, 5, 16, 16, 3, generator=torch.Generator()
                       .manual_seed(7))
    picks = {'perceptual': torch.tensor([0]), 'gen': torch.tensor([1])}
    out = []
    for r in (False, remat):
        tok = _tokenizer(remat=r, attn_dropout=0.5,
                         layers=('residual', ('compress_space', 16),
                                 'attend_space', ('compress_time', 16),
                                 'attend_time'))
        tok.module.requires_grad_(True)
        gen = torch.Generator().manual_seed(11)
        total, _, _ = tokenizer_loss(tok.module, video, picks,
                                     generator=gen)
        params = [p for p in tok.module.parameters()]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        out.append((total, grads, torch.rand(1, generator=gen)))
    (a, ga, na), (b, gb, nb) = out
    assert torch.equal(a, b) and torch.equal(na, nb)
    for x, y in zip(ga, gb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.allclose(x, y, rtol=0, atol=1e-6 * x.abs().max())
