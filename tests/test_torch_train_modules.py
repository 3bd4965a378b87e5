"""The GAN side's modules through the port on the CPU, against the JAX
package on the same weights (``models/jax_import.py``'s discriminator and
VGG tables): ``Conv2d`` (strided, padded), ``blur`` on images and video,
the image ``Discriminator`` (with and without the anti-aliased downsample),
the ``MultiscaleDiscriminator`` on video and images, ``VGG16Features`` and
``adaptive_avg_pool_2d``; the bridge tables both ways; the orthogonal VGG
fallback's fill; and the tokenizer's checkpoints carrying the
discriminators' weights to the JAX package and back.

Inputs and weights are numpy draws from a seed; float32 outputs agree
within 1e-5 of their largest value (the same math summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.discriminator import (
    Discriminator as JaxDiscriminator,
    MultiscaleDiscriminator as JaxMultiscale)
from magvit2_pytorch_tpu.models.vgg import (
    VGG16Features as JaxVGG, adaptive_avg_pool_2d as jax_pool)
from magvit2_pytorch_tpu.ops.conv import Conv2d as JaxConv2d, blur as jax_blur
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.discriminator import (
    Discriminator, MultiscaleDiscriminator)
from magvit2_pytorch_tpu_torch.models.jax_import import (
    discr_bridge_entries, multiscale_bridge_entries, state_dict_from_tree,
    tree_from_state_dict, vgg_bridge_entries)
from magvit2_pytorch_tpu_torch.models.vgg import (
    VGG16Features, adaptive_avg_pool_2d, conv_and_linear_names, orthogonal_)
from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
from magvit2_pytorch_tpu_torch.ops.conv import Conv2d, blur

torch.set_num_threads(1)
REL = 1e-5
DISCR = dict(dim=4, image_size=16, channels=3, max_dim=16)


def assert_rel(got, want, rel=REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _init(module, seed=0):
    init_module_parameters(module, torch.Generator().manual_seed(seed))
    return module


@pytest.mark.parametrize('kernel,stride,padding', [(3, 1, 1), (1, 2, 0),
                                                   (3, 2, 1), (4, 1, 0)])
def test_conv2d_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(kernel + stride)
    x = rng.normal(size=(2, 9, 10, 5)).astype(np.float32)
    conv = _init(Conv2d(5, 7, kernel, stride=stride, padding=padding))
    jconv = JaxConv2d(7, kernel, stride=stride, padding=padding)
    params = {'kernel': conv.weight.detach().numpy().transpose(2, 3, 1, 0),
              'bias': conv.bias.detach().numpy()}
    want = jconv.apply({'params': params}, jnp.asarray(x))
    assert_rel(conv(torch.from_numpy(x)), want)


@pytest.mark.parametrize('shape,space_only,time_only', [
    ((2, 8, 6, 3), True, False), ((2, 8, 6, 3), False, False),
    ((1, 4, 8, 6, 3), False, False), ((1, 4, 8, 6, 3), True, False),
    ((1, 4, 8, 6, 3), False, True)])
def test_blur_matches_jax(shape, space_only, time_only):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    want = jax_blur(jnp.asarray(x), space_only=space_only,
                    time_only=time_only)
    got = blur(torch.from_numpy(x), space_only=space_only,
               time_only=time_only)
    assert_rel(got, want)


@pytest.mark.parametrize('antialiased', [False, True])
def test_discriminator_matches_jax(antialiased):
    discr = _init(Discriminator(**DISCR, antialiased_downsample=antialiased))
    params = tree_from_state_dict(discr_bridge_entries(discr),
                                  discr.state_dict())
    jdiscr = JaxDiscriminator(**DISCR, antialiased_downsample=antialiased)
    template = jdiscr.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    assert (jax.tree.map(np.shape, template['params'])
            == jax.tree.map(np.shape, params))
    x = np.random.default_rng(1).uniform(size=(3, 16, 16, 3)).astype(
        np.float32)
    want = jdiscr.apply({'params': params}, jnp.asarray(x))
    assert_rel(discr(torch.from_numpy(x)), want)
    # and the table's inverse gives back the same weights
    back = state_dict_from_tree(discr_bridge_entries(discr), params)
    for k, v in discr.state_dict().items():
        assert torch.equal(back[k], v)


@pytest.mark.parametrize('video', [True, False])
def test_multiscale_discriminator_matches_jax(video):
    kw = dict(dim=4, image_size=16, channels=3, max_dim=16)
    ms = _init(MultiscaleDiscriminator(**kw))
    params = tree_from_state_dict(multiscale_bridge_entries(ms),
                                  ms.state_dict())
    shape = (2, 3, 16, 16, 3) if video else (2, 16, 16, 3)
    x = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    want = JaxMultiscale(**kw).apply({'params': params}, jnp.asarray(x))
    assert_rel(ms(torch.from_numpy(x)), want)


def _random_vgg(seed=0):
    """VGG16 with normal weights at the fan-in scale (no orthogonal QR),
    made with numpy so both packages take the same."""
    rng = np.random.default_rng(seed)
    vgg = VGG16Features()
    with torch.no_grad():
        for prefix, _ in conv_and_linear_names():
            layer = vgg.get_submodule(prefix)
            fan_in = layer.weight[0].numel()
            layer.weight.copy_(torch.from_numpy(rng.standard_normal(
                tuple(layer.weight.shape), dtype=np.float32)
                * np.float32((2 / fan_in) ** 0.5)))
            layer.bias.copy_(torch.from_numpy(
                rng.normal(size=layer.bias.shape).astype(np.float32) * 0.01))
    return vgg


def test_vgg16_matches_jax():
    vgg = _random_vgg()
    params = tree_from_state_dict(vgg_bridge_entries(), vgg.state_dict())
    x = np.random.default_rng(3).uniform(size=(2, 40, 36, 3)).astype(
        np.float32)
    want = JaxVGG().apply(params, jnp.asarray(x))
    assert_rel(vgg(torch.from_numpy(x)), want, rel=1e-4)
    for name, p in params['params'].items():
        assert p['kernel'].ndim == (2 if name.startswith('fc') else 4)


@pytest.mark.parametrize('hw,out', [((9, 13), (7, 7)), ((3, 5), (7, 7)),
                                    ((14, 14), (7, 7))])
def test_adaptive_avg_pool_matches_jax(hw, out):
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    assert_rel(adaptive_avg_pool_2d(torch.from_numpy(x), out),
               jax_pool(jnp.asarray(x), out))


@pytest.mark.parametrize('shape', [(64, 3, 3, 3), (8, 40), (40, 8)])
def test_orthogonal_fill_is_orthogonal_and_seeded(shape):
    """The fallback's fill: gain sqrt(2) times orthonormal columns (fan_in
    >= out) or rows, the same from the same seed in any process (the JAX
    package's seeds come from the salted ``hash()``)."""
    a, b = torch.empty(shape), torch.empty(shape)
    orthogonal_(a, torch.Generator().manual_seed(7))
    orthogonal_(b, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    m = a.reshape(shape[0], -1).double() / 2 ** 0.5      # (out, fan_in)
    gram = m @ m.T if m.shape[1] >= m.shape[0] else m.T @ m
    torch.testing.assert_close(gram, torch.eye(gram.shape[0],
                                               dtype=torch.float64),
                               atol=1e-5, rtol=0)


KW = dict(image_size=16, init_dim=8, codebook_size=64,
          layers=('residual', ('compress_space', 16)),
          discr_kwargs=DISCR, perceptual_loss_weight=0.0,
          multiscale_discrs=(dict(dim=4, max_dim=16),))


def test_checkpoints_carry_the_discriminators(tmp_path):
    """``save`` writes ``discr_params`` and ``multiscale_params`` in the JAX
    package's layout: the JAX package loads them and its discriminators
    compute what the port's do; the JAX package's save loads back into the
    port bit for bit."""
    tok = VideoTokenizer(device='cpu', seed=3, **KW)
    path = tmp_path / 'tok.ckpt'
    tok.save(path)
    jtok = JaxTokenizer.init_and_load_from(path)
    x = np.random.default_rng(5).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    want = jtok.discr.apply({'params': jtok.discr_params}, jnp.asarray(x))
    assert_rel(tok.discr(torch.from_numpy(x)), want)
    video = np.random.default_rng(6).uniform(size=(1, 3, 16, 16, 3)).astype(
        np.float32)
    want = jtok.multiscale_discrs[0].apply(
        {'params': jtok.multiscale_params[0]}, jnp.asarray(video))
    assert_rel(tok.multiscale_discrs[0](torch.from_numpy(video)), want)

    jpath = tmp_path / 'jax.ckpt'
    jtok.save(jpath)
    back = VideoTokenizer.init_and_load_from(jpath, device='cpu')
    for mine, theirs in ((tok.discr, back.discr),
                         (tok.multiscale_discrs[0], back.multiscale_discrs[0])):
        for (k, a), b in zip(mine.state_dict().items(),
                             theirs.state_dict().values()):
            assert torch.equal(a, b), k


def test_copy_for_eval_drops_the_gan_side():
    tok = VideoTokenizer(device='cpu', **KW)
    ev = tok.copy_for_eval()
    assert ev.discr is None and ev.vgg is None and not ev.multiscale_discrs
    assert not ev.config.use_gan and ev.module is tok.module
    assert tok.discr is not None
    assert dataclasses.replace(tok.config, use_gan=False,
                               perceptual_loss_weight=0.0,
                               multiscale_discrs=()) == ev.config
