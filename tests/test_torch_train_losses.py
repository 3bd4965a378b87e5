"""The loss side through the port on the CPU, against the JAX package's
``training/losses.py`` on the same weights (a tiny tokenizer with live
SqueezeExcite gates, its discriminator and one multiscale discriminator,
and a random VGG16 given to both): every term of ``tokenizer_loss`` (recon,
the LFQ aux loss, perceptual, the adversarial loss with its adaptive weight
from the two grad norms at the last conv, the multiscale terms and their
weights, the codebook canaries) and its gradients for every generator
weight, against ``jax.value_and_grad``; ``discriminator_loss`` with and
without R1 and its gradients for every discriminator weight; the clip and
NaN rules of the adaptive weight; the small helpers; and the metrics.

The frame picks are JAX's, recomputed from the same key splits
(``losses.py:171, 202-204, 248``) and handed to the port's math. Values and
gradients agree within 1e-4 of their largest value (float32; a gradient
zero by its math, as the SqueezeExcite logit bias's, within 1e-4 of 1e-3 of
the largest gradient), but for the gradients of a loss with the perceptual
term, held within 1e-3: through VGG16 the gradient of the decoder's spatial
upsampler cancels badly, and the port and the JAX package in float32 lie
3.5e-4 and 5.4e-4 (relative) from the port in float64 there (measured on
this test's inputs); every other leaf agrees within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.vgg import VGG16Features as JaxVGG
from magvit2_pytorch_tpu.training import losses as jl
from magvit2_pytorch_tpu.training import metrics as jm
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    bridge_entries, discr_bridge_entries, jax_params_from_state_dict,
    multiscale_bridge_entries, tree_from_state_dict, vgg_bridge_entries)
from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
from magvit2_pytorch_tpu_torch.training import losses, metrics

from test_torch_train_modules import _random_vgg

torch.set_num_threads(1)
REL = 1e-4
KW = dict(image_size=16, init_dim=8, codebook_size=64,
          layers=('residual', ('compress_space', 16), 'linear_attend_space',
                  ('compress_time', 16), 'attend_space', 'attend_time'),
          attn_heads=2, linear_attn_heads=4,
          discr_kwargs=dict(dim=4, image_size=16, channels=3, max_dim=16),
          multiscale_discrs=(dict(dim=4, max_dim=16),),
          perceptual_loss_weight=0.0)
WEIGHTS = dict(perceptual_loss_weight=0.1, quantizer_aux_loss_weight=1.0,
               adversarial_loss_weight=1.0,
               multiscale_adversarial_loss_weight=1.0)


def assert_rel(got, want, rel=REL, floor=1e-30):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert np.shape(got) == np.shape(want)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), floor), err


@pytest.fixture(scope='module')
def pair():
    """The port's tokenizer (live gates), its modules made trainable, the
    JAX package's on the same weights, a random VGG16 in both, a video."""
    tok = VideoTokenizer(device='cpu', seed=1, **KW)
    live_squeeze_excite_(tok.module, torch.Generator().manual_seed(2))
    for m in tok._modules():
        m.requires_grad_(True)
    vgg = _random_vgg(1).requires_grad_(False)
    jtok = JaxTokenizer(
        params=jax_params_from_state_dict(tok.config, tok.state_dict()),
        discr_params=tree_from_state_dict(discr_bridge_entries(tok.discr),
                                          tok.discr.state_dict()),
        multiscale_params=[tree_from_state_dict(
            multiscale_bridge_entries(ms), ms.state_dict())
            for ms in tok.multiscale_discrs], **KW)
    jvgg = tree_from_state_dict(vgg_bridge_entries(), vgg.state_dict())
    video = np.random.default_rng(3).uniform(
        size=(2, 5, 16, 16, 3)).astype(np.float32)
    return tok, vgg, jtok, jvgg, video


def _jax_picks(key, b, frames):
    """The frame picks ``tokenizer_loss`` draws from ``key``."""
    key, _, _ = jax.random.split(key, 3)
    k_percep, k_gen = jax.random.split(key)
    return {'perceptual': np.asarray(jax.random.randint(k_percep, (b,), 0,
                                                        frames)),
            'gen': np.asarray(jax.random.randint(k_gen, (b,), 0, frames))}


def _grad_tree(module, entries, grads):
    named = dict(zip([n for n, _ in module.named_parameters()], grads))
    return tree_from_state_dict(
        [e for e in entries if e[0] in named], named)


def _check_tree(got, want, rel=REL):
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_d = dict(jax.tree_util.tree_leaves_with_path(want))
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in want_d.values())
    assert len(got_l) == len(want_d)
    for path, g in got_l:
        assert_rel(g, want_d[path], rel=rel, floor=floor)


@pytest.mark.parametrize('use_vgg,has_gan,has_ms', [
    (True, True, True), (False, True, True), (True, False, False)],
    ids=['all', 'no_vgg', 'no_gan'])
def test_tokenizer_loss_matches_jax(pair, use_vgg, has_gan, has_ms):
    tok, vgg, jtok, jvgg, video = pair
    key = jax.random.PRNGKey(11)
    b, frames = video.shape[:2]

    def jloss(params):
        total, bd, _ = jl.tokenizer_loss(
            jtok.module, params, jnp.asarray(video), key,
            discr_module=jtok.discr, discr_params=jtok.discr_params,
            multiscale_modules=tuple(jtok.multiscale_discrs),
            multiscale_params=tuple(jtok.multiscale_params),
            vgg_module=JaxVGG(), vgg_params=jvgg, train=True,
            use_vgg=use_vgg, has_gan=has_gan, has_multiscale_gan=has_ms,
            **WEIGHTS)
        return total, bd

    (jtotal, jbd), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jtok.params)
    picks = {k: torch.from_numpy(v.copy()) for k, v in
             _jax_picks(key, b, frames).items()}
    total, bd, _ = losses.tokenizer_loss(
        tok.module, torch.from_numpy(video), picks, discr=tok.discr,
        multiscale=tuple(tok.multiscale_discrs), vgg=vgg, train=True,
        use_vgg=use_vgg, has_gan=has_gan, has_multiscale_gan=has_ms,
        **WEIGHTS)
    params = list(tok.module.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]

    assert_rel(total, jtotal)
    for name in ('recon_loss', 'lfq_aux_loss', 'perceptual_loss',
                 'adversarial_gen_loss', 'adaptive_adversarial_weight',
                 'mean_bit_entropy'):
        assert_rel(getattr(bd, name), getattr(jbd, name))
    for name in ('multiscale_gen_losses', 'multiscale_gen_adaptive_weights'):
        assert len(getattr(bd, name)) == len(getattr(jbd, name))
        for a, w in zip(getattr(bd, name), getattr(jbd, name)):
            assert_rel(a, w)
    assert np.array_equal(bd.codes_seen.numpy(), np.asarray(jbd.codes_seen))
    if use_vgg and has_gan:
        assert float(bd.adaptive_adversarial_weight) != 1.0
    _check_tree(_grad_tree(tok.module, bridge_entries(tok.config), grads),
                jgrads, rel=1e-3 if use_vgg else REL)


@pytest.mark.parametrize('apply_gp', [True, False], ids=['r1', 'no_r1'])
def test_discriminator_loss_matches_jax(pair, apply_gp):
    tok, _, jtok, _, video = pair
    key = jax.random.PRNGKey(12)
    b, frames = video.shape[:2]

    def jloss(tree):
        return jl.discriminator_loss(
            jtok.module, jtok.params, jtok.discr, tree['discr'],
            jnp.asarray(video), key,
            multiscale_modules=tuple(jtok.multiscale_discrs),
            multiscale_params=tree['ms'],
            apply_gradient_penalty=apply_gp, grad_penalty_loss_weight=10.0)

    tree = {'discr': jtok.discr_params, 'ms': tuple(jtok.multiscale_params)}
    (jtotal, jbd), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree)
    idx = torch.from_numpy(np.array(
        jax.random.randint(key, (b,), 0, frames)))
    total, bd = losses.discriminator_loss(
        tok.module, tok.discr, torch.from_numpy(video), idx,
        multiscale=tuple(tok.multiscale_discrs),
        apply_gradient_penalty=apply_gp, grad_penalty_loss_weight=10.0)
    nets = [tok.discr, *tok.multiscale_discrs]
    flat = [p for n in nets for p in n.parameters()]
    grads = iter(torch.autograd.grad(total, flat))
    assert_rel(total, jtotal)
    assert_rel(bd.discr_loss, jbd.discr_loss)
    assert_rel(bd.gradient_penalty, jbd.gradient_penalty)
    assert_rel(bd.multiscale_discr_losses[0], jbd.multiscale_discr_losses[0])
    d_grads = [next(grads) for _ in tok.discr.parameters()]
    _check_tree(_grad_tree(tok.discr, discr_bridge_entries(tok.discr),
                           d_grads), jgrads['discr'])
    ms = tok.multiscale_discrs[0]
    ms_grads = [next(grads) for _ in ms.parameters()]
    _check_tree(_grad_tree(ms, multiscale_bridge_entries(ms), ms_grads),
                jgrads['ms'][0])


def test_gradient_penalty_matches_jax(pair):
    tok, _, jtok, _, _ = pair
    x = np.random.default_rng(4).uniform(size=(3, 16, 16, 3)).astype(
        np.float32)
    want = jax.jit(lambda im: jl.gradient_penalty(
        lambda i: jtok.discr.apply({'params': jtok.discr_params}, i),
        im, center=0.5))(jnp.asarray(x))
    got = losses.gradient_penalty(tok.discr, torch.from_numpy(x), center=0.5)
    assert_rel(got, want)


def test_forward_loss_modes_take_the_same_math(pair):
    """``VideoTokenizer.forward``'s loss modes call these functions with the
    tokenizer's own modules, its config's weights and draws from ``rng``."""
    tok, _, _, _, video = pair
    v = torch.from_numpy(video)
    total, bd = tok.forward(v, return_loss=True,
                            rng=torch.Generator().manual_seed(5))
    picks = losses.draw_tokenizer_loss(2, 5, torch.Generator().manual_seed(5))
    want, wbd, _ = losses.tokenizer_loss(
        tok.module, v, picks, discr=tok.discr,
        multiscale=tuple(tok.multiscale_discrs), has_gan=True,
        has_multiscale_gan=True, perceptual_loss_weight=0.0)
    assert torch.equal(total, want)
    dtotal, dbd = tok.forward(v, return_discr_loss=True,
                              apply_gradient_penalty=False,
                              rng=torch.Generator().manual_seed(6))
    assert float(dbd.gradient_penalty) == 0.0 and torch.isfinite(dtotal)
    loss, recon = tok.forward(v, return_recon_loss_only=True)
    assert torch.equal(loss, ((v - recon) ** 2).mean())


@pytest.mark.parametrize('case', ['nan', 'clip', 'ms_clip'])
def test_adaptive_weight_rules(monkeypatch, case):
    """The JAX package's rules: a NaN weight becomes 1; the weight is the
    perceptual norm over max(norm, 1e-3), at most 1e3; a multiscale weight
    over max(norm, 1e-5), at most 1e3, with no NaN rule."""
    norms = iter({'nan': [float('nan'), 1.0, 1.0],
                  'clip': [5.0, 1e-6, 1.0],
                  'ms_clip': [5.0, 1.0, 1e-9]}[case])
    monkeypatch.setattr(losses, '_grad_norm_wrt_conv_out',
                        lambda *a: torch.tensor(next(norms)))
    tok = VideoTokenizer(device='cpu', **KW)
    vgg = lambda x: x.reshape(x.shape[0], -1)[:, :4].float()
    _, bd, _ = losses.tokenizer_loss(
        tok.module, torch.rand(1, 1, 16, 16, 3),
        {'perceptual': torch.tensor([0]), 'gen': torch.tensor([0])},
        discr=tok.discr, multiscale=tuple(tok.multiscale_discrs), vgg=vgg,
        use_vgg=True, has_gan=True, has_multiscale_gan=True)
    weight, ms_weight = (float(bd.adaptive_adversarial_weight),
                         float(bd.multiscale_gen_adaptive_weights[0]))
    if case == 'nan':
        assert weight == 1.0 and np.isnan(ms_weight)
    elif case == 'clip':
        assert weight == 1e3 and ms_weight == 5.0
    else:
        assert weight == 5.0 and ms_weight == 1e3


def test_codebook_stats_match_jax():
    idx = np.random.default_rng(7).integers(0, 64, size=(2, 3, 4, 4))
    idx[0, 0] = 0                       # a bit rate of 0 or 1 somewhere
    h, seen = losses.codebook_stats(torch.from_numpy(idx), 64, True)
    jh, jseen = jl.codebook_stats(jnp.asarray(idx), 64, True)
    assert_rel(h, jh, rel=1e-6)
    assert np.array_equal(seen.numpy(), np.asarray(jseen))
    const = losses.codebook_stats(torch.zeros(10, dtype=torch.long), 64, True)
    assert float(const[0]) == 0.0       # xlogy: no NaN at a dead bit
    assert losses.codebook_stats(torch.from_numpy(idx), 64, False)[0] is None


def test_small_helpers_match_jax():
    rng = np.random.default_rng(8)
    fake, real = rng.normal(size=(2, 6)).astype(np.float32)
    assert_rel(losses.hinge_discr_loss(torch.from_numpy(fake),
                                       torch.from_numpy(real)),
               jl.hinge_discr_loss(jnp.asarray(fake), jnp.asarray(real)),
               rel=1e-6)
    assert_rel(losses.hinge_gen_loss(torch.from_numpy(fake)),
               jl.hinge_gen_loss(jnp.asarray(fake)), rel=1e-6)
    video = rng.normal(size=(3, 4, 2, 2, 1)).astype(np.float32)
    idx = np.array([3, 0, 2])
    assert np.array_equal(
        losses.pick_video_frame(torch.from_numpy(video),
                                torch.from_numpy(idx)).numpy(),
        np.asarray(jl.pick_video_frame(jnp.asarray(video), jnp.asarray(idx))))


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    a, b = rng.uniform(size=(2, 2, 3, 4, 4, 3)).astype(np.float32)
    assert_rel(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)),
               jm.psnr(jnp.asarray(a), jnp.asarray(b)), rel=1e-6)
    idx = rng.integers(0, 32, size=(5, 7))
    for fn, jfn in ((metrics.codebook_utilization, jm.codebook_utilization),
                    (metrics.code_entropy, jm.code_entropy)):
        assert_rel(fn(torch.from_numpy(idx), 32), jfn(jnp.asarray(idx), 32),
                   rel=1e-6)
