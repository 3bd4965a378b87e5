"""The public surface of the port's ``VideoTokenizer`` against the JAX
package's, on the CPU.

- The methods take the JAX package's parameters, names and order (``cond``
  third in ``encode``, second in ``decode``, ``decode_from_code_indices``
  and ``forward``), and a positional call in that order gives what the
  keyword call gives.
- The reference's ``.pt`` package (``torch.save`` of a pickled kwargs dict
  and the reference-named ``state_dict``): the port's
  ``init_and_load_from_torch`` and the JAX package's on the same file give
  equal codes and reconstructions within 1e-4 (float32).
- ``load_torch_state_dict`` from a mapping, an ``.npz`` and a ``.pth``;
  ``strict`` and a missing key.
- ``channels``, ``time_padding``, ``copy_for_eval`` and ``MagViT2``.
"""

import inspect
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import MagViT2 as JaxMagViT2
from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.torch_import import (
    torch_config_to_kwargs as jax_torch_config_to_kwargs)
import magvit2_pytorch_tpu_torch
from magvit2_pytorch_tpu_torch import MagViT2, VideoTokenizer
from magvit2_pytorch_tpu_torch.models.torch_import import (
    torch_config_to_kwargs)

torch.set_num_threads(1)
METHODS = ('encode', 'decode', 'decode_from_code_indices', 'tokenize',
           'forward')
# a conditioned stack with GateLoop, so that cond is live in every method
KWARGS = dict(image_size=16, init_dim=8, codebook_size=64, dim_cond=4,
              layers=('residual', 'cond_residual', ('compress_space', 12),
                      ('compress_time', 12), 'gateloop_time',
                      'cond_attend_space'),
              attn_heads=2, attn_dim_head=8, use_gan=False,
              perceptual_loss_weight=0.0)


@pytest.fixture(scope='module')
def tok():
    return VideoTokenizer(device='cpu', seed=1, **KWARGS)


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(0)
    return (rng.random((2, 5, 16, 16, 3), dtype=np.float32),
            rng.normal(size=(2, 4)).astype(np.float32))


@pytest.mark.parametrize('method', METHODS)
def test_signatures_match_the_jax_package(method):
    names = lambda cls: list(inspect.signature(
        getattr(cls, method)).parameters)
    assert names(VideoTokenizer) == names(JaxTokenizer)


def test_positional_calls_in_the_reference_order(tok, inputs):
    """Each method called positionally in the JAX package's order equals
    the keyword call (before the port took that order, ``decode(q, None)``
    bound None to ``video_contains_first_frame`` and returned one frame
    more)."""
    video, cond = inputs
    lat = tok.encode(video, cond=cond)
    assert torch.equal(tok.encode(video, False, cond), lat)
    assert torch.equal(tok.encode(video, True, cond, True),
                       tok.encode(video, quantize=True, cond=cond))
    codes, recon = tok.forward(video, cond=cond, return_codes=True,
                               return_recon=True)
    assert torch.equal(tok.forward(video, cond, False, True),
                       tok.tokenize(video, cond=cond))
    got_codes, got_recon = tok.forward(video, cond, False, True, True)
    assert torch.equal(got_codes, codes) and torch.equal(got_recon, recon)
    assert torch.equal(tok(video, cond, False, False, True), recon)
    q = tok.encode(video, quantize=True, cond=cond)
    assert torch.equal(tok.decode(q, cond, True),
                       tok.decode(q, cond=cond))
    assert tok.decode(q, cond).shape[1] == video.shape[1]
    assert torch.equal(tok.decode_from_code_indices(codes, cond, True),
                       tok.decode_from_code_indices(codes, cond=cond))
    plain = VideoTokenizer(device='cpu', seed=0, image_size=16, init_dim=8,
                           codebook_size=64,
                           layers=('residual', ('compress_time', 12)))
    q = plain.encode(video, True)
    assert plain.decode(q, None).shape == plain.decode(q).shape


def test_training_arguments_are_taken_and_refused(tok, inputs):
    """``apply_gradient_penalty``, the adversarial weights and ``rng`` (a
    ``torch.Generator``) sit where the JAX package has them; a serving call
    ignores them, a loss mode (which raised before the port trained) takes
    them: the same ``rng`` gives the same finite loss, by keyword or by
    position."""
    video, cond = inputs
    recon = tok.forward(video, cond=cond, return_recon=True)
    assert torch.equal(tok.forward(
        video, cond, False, False, True, False, False, False, True, 0.5,
        0.25, torch.Generator().manual_seed(0)), recon)
    total, _ = tok.forward(video, cond=cond, return_loss=True,
                           rng=torch.Generator().manual_seed(1))
    again, _ = tok.forward(video, cond, True, False, False, False, False,
                           True, True, 0.5, 0.25,
                           torch.Generator().manual_seed(1))
    assert torch.isfinite(total) and torch.equal(total, again)


def _pt_package(path, tok):
    """What the reference's ``save`` writes: its constructor kwargs
    pickled, and its state_dict under ``model_state_dict``."""
    torch.save({'model_state_dict': tok.state_dict(),
                'config': pickle.dumps(dict(KWARGS)),
                'version': '0.0.0'}, path)


def test_init_and_load_from_torch_matches_the_jax_package(tmp_path, tok,
                                                          inputs):
    path = tmp_path / 'tokenizer.pt'
    _pt_package(path, tok)
    port = VideoTokenizer.init_and_load_from_torch(path, device='cpu')
    jtok = JaxTokenizer.init_and_load_from_torch(path)
    assert port.config == tok.config
    video, cond = inputs
    codes, recon = port.forward(video, cond=cond, return_codes=True,
                                return_recon=True)
    codes_j, recon_j = jtok.forward(jnp.asarray(video),
                                    cond=jnp.asarray(cond),
                                    return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-4,
                               rtol=0)
    assert torch.equal(codes, tok.tokenize(video, cond=cond))
    # overrides go on top of the package's config
    again = VideoTokenizer.init_and_load_from_torch(
        path, device='cpu', dtype=torch.bfloat16, flash_attn=False)
    assert again.dtype == torch.bfloat16 and not again.config.flash_attn


def test_torch_config_to_kwargs_matches_the_jax_package():
    raw = dict(KWARGS, lfq_activation=torch.nn.Identity(), vgg=None,
               multiscale_discrs=[], layers=[list(l) if isinstance(l, tuple)
                                             else l for l in KWARGS['layers']])
    assert torch_config_to_kwargs(raw) == jax_torch_config_to_kwargs(raw)
    with pytest.raises(ValueError, match='lfq_activation'):
        torch_config_to_kwargs(dict(raw, lfq_activation=torch.nn.Tanh()))
    with pytest.warns(UserWarning, match='unknown'):
        assert 'no_such' not in torch_config_to_kwargs(dict(raw, no_such=1))


@pytest.mark.parametrize('form', ['mapping', 'npz', 'pth', 'pt_package'])
def test_load_torch_state_dict_forms(tmp_path, tok, inputs, form):
    state = {k: v.clone() for k, v in tok.state_dict().items()}
    # the reference's own shapes: its 1x1 convs keep their kernel dims
    key = 'encoder_layers.1.conv_out.weight'
    state[key] = state[key][..., None, None, None]
    state['quantizers.mask'] = torch.ones(6)        # a buffer: skipped
    if form == 'mapping':
        given = state
    elif form == 'npz':
        given = tmp_path / 'state.npz'
        np.savez(given, **{k: v.numpy() for k, v in state.items()})
    else:
        given = tmp_path / 'state.pth'
        torch.save(state if form == 'pth' else {'model_state_dict': state},
                   given)
    port = VideoTokenizer(device='cpu', seed=7, **KWARGS)
    port.load_torch_state_dict(given if form == 'mapping' else str(given))
    assert all(torch.equal(v, port.state_dict()[k])
               for k, v in tok.state_dict().items())
    video, cond = inputs
    assert torch.equal(port.tokenize(video, cond=cond),
                       tok.tokenize(video, cond=cond))


def test_load_torch_state_dict_strict(tok):
    state = dict(tok.state_dict())
    state['encoder_layers.99.bogus'] = torch.zeros(1)
    port = VideoTokenizer(device='cpu', seed=7, **KWARGS)
    with pytest.raises(ValueError, match='encoder_layers.99.bogus'):
        port.load_torch_state_dict(state, strict=True)
    port.load_torch_state_dict(state, strict=False)
    assert all(torch.equal(v, port.state_dict()[k])
               for k, v in tok.state_dict().items())
    state.pop('encoder_cond_in.0.weight')
    with pytest.raises(KeyError, match='encoder_cond_in'):
        port.load_torch_state_dict(state, strict=False)


def test_members_and_stub(tok, inputs):
    jtok_cls_attrs = ('channels', 'time_padding', 'copy_for_eval')
    assert all(hasattr(JaxTokenizer, a) for a in jtok_cls_attrs)
    assert tok.channels == 3
    assert tok.time_padding == tok.time_downsample_factor - 1 == 1
    assert VideoTokenizer(device='cpu', seed=0, image_size=8, init_dim=4,
                          codebook_size=16, channels=1,
                          layers=('residual',)).channels == 1
    gan = VideoTokenizer(device='cpu', seed=0, **dict(
        KWARGS, use_gan=True, perceptual_loss_weight=0.1))
    ev = gan.copy_for_eval()
    assert not ev.config.use_gan and ev.config.perceptual_loss_weight == 0
    assert ev.config.multiscale_discrs == ()
    assert gan.config.use_gan
    video, cond = inputs
    assert torch.equal(ev.tokenize(video, cond=cond),
                       gan.tokenize(video, cond=cond))
    assert ev.module is gan.module and ev.device == gan.device
    x = torch.randn(2, 3)
    assert MagViT2()(x) is x and MagViT2().forward(x) is x
    assert JaxMagViT2()(x) is x
    assert magvit2_pytorch_tpu_torch.MagViT2 is MagViT2
