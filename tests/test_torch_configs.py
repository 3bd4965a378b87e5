"""The JAX package's other configurations through the port on the CPU: tiny
roundtrips of BASELINE configs 1 (images mode), 3 (FSQ) and 4 (the 2^18-code
image tokenizer), separate first-frame encoding, the three explicit pad
modes (with a clip no longer than the causal pad, which falls back to
zeros), several codebooks and spherical codes, each against the JAX package
on the same weights; and the reference's ``tok_fsq`` / ``tok_sff`` golden
fixtures.

Widths are cut (image_size 16, init_dim 8, as tests/fixtures/generate.py:152)
and each config's layer pattern is kept. Every SqueezeExcite gets a live
output layer in both packages (the users' init, bias -10, would hide the
ResidualUnits' convs and so their padding); the JAX package takes the
port's weights through ``jax_params_from_state_dict``, whose tree
tests/test_torch_checkpoints.py holds against the JAX package's own init.
Codes must be exact; latents and
reconstructions agree within 1e-3 (the repo's parity contract,
BASELINE.md:17).
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu_torch import VideoTokenizer, configs
from magvit2_pytorch_tpu_torch.models.jax_import import (
    jax_params_from_state_dict)
from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_

torch.set_num_threads(1)
DATA = Path(__file__).parent / 'fixtures' / 'data'
TOL = 1e-3
SERVE = dict(use_gan=False, perceptual_loss_weight=0.0)
# a ResidualUnit at 8 channels (the JAX package unfolds its time taps, and
# pads only time with the mode) and at 16 (it pads h and w too)
PAD_LAYERS = ('residual', ('compress_space', 16), 'residual',
              ('compress_time', 16), 'residual')

CASES = {
    'config1_images': (configs.images_mode_tokenizer_kwargs(
        image_size=16, init_dim=8, codebook_size=64), (2, 16, 16, 3)),
    'config3_fsq': (configs.fsq_gan_tokenizer_kwargs(
        image_size=16, init_dim=8, max_dim=32, attn_heads=2,
        linear_attn_heads=4, **SERVE), (1, 5, 16, 16, 3)),
    'config4_2e18': (configs.open_magvit2_image_tokenizer_kwargs(
        image_size=16, init_dim=8, max_dim=32, attn_heads=2,
        linear_attn_heads=4, **SERVE), (2, 1, 16, 16, 3)),
    'sff': (dict(image_size=16, init_dim=8, codebook_size=64,
                 layers=('residual', ('compress_space', 16),
                         ('compress_time', 16), 'residual'),
                 separate_first_frame_encoding=True, **SERVE),
            (1, 5, 16, 16, 3)),
    'num_codebooks': (dict(image_size=16, init_dim=8, codebook_size=16,
                           num_codebooks=3, lfq_spherical=True,
                           layers=('residual', ('compress_space', 16)),
                           **SERVE), (1, 3, 16, 16, 3)),
    **{f'pad_{mode}': (dict(image_size=16, init_dim=8, codebook_size=64,
                            layers=PAD_LAYERS, pad_mode=mode, **SERVE),
                       (1, 9, 16, 16, 3))
       for mode in ('reflect', 'replicate', 'circular')},
    # one frame against conv_in's causal pad of 6: zeros whatever the mode
    'pad_reflect_short_clip': (dict(image_size=16, init_dim=8,
                                    codebook_size=64, layers=PAD_LAYERS,
                                    pad_mode='reflect', **SERVE),
                               (1, 1, 16, 16, 3)),
}


def _pair(kwargs, seed=0):
    """The port with live gates, and the JAX package on its weights (built
    on them, which spares the JAX package its init)."""
    with warnings.catch_warnings():
        # config 4's codebook warning, raised alike by both packages
        warnings.simplefilter('ignore', UserWarning)
        port = VideoTokenizer(device='cpu', seed=seed, **kwargs)
        live_squeeze_excite_(port.module, torch.Generator().manual_seed(seed))
        params = jax_params_from_state_dict(port.config, port.state_dict())
        jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, params),
                            **kwargs)
    return jtok, port


@pytest.mark.parametrize('case', list(CASES))
def test_config_roundtrip_matches_jax(case):
    kwargs, shape = CASES[case]
    jtok, port = _pair(kwargs)
    video = np.random.default_rng(1).random(shape, dtype=np.float32)
    jv = jnp.asarray(video)
    clip = video[:, None] if video.ndim == 4 else video   # encode takes 5-D
    np.testing.assert_allclose(port.encode(clip).numpy(),
                               np.asarray(jtok.encode(jnp.asarray(clip))),
                               atol=TOL, rtol=0)
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes, recon = port.forward(video, return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    assert codes.shape == tuple(codes_j.shape)
    assert recon.shape == shape
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=TOL,
                               rtol=0)
    # the codes decode as the forward's recon, through indices_to_codes
    if kwargs.get('num_codebooks', 1) == 1:
        codes = codes.reshape(codes.shape[0], -1)
    np.testing.assert_allclose(
        port.decode_from_code_indices(codes).reshape(recon.shape).numpy(),
        recon.numpy(), atol=1e-5, rtol=0)
    assert port.codebook_size == jtok.codebook_size


def test_config_kwargs_match_jax_package():
    from magvit2_pytorch_tpu import configs as jax_configs
    for name in ('images_mode_tokenizer_kwargs', 'fsq_gan_tokenizer_kwargs',
                 'open_magvit2_image_tokenizer_kwargs',
                 'streaming_video_tokenizer_kwargs',
                 'readme_video_tokenizer_kwargs'):
        assert getattr(configs, name)() == getattr(jax_configs, name)(), name


def test_large_codebook_warns_as_the_jax_package():
    kwargs = configs.open_magvit2_image_tokenizer_kwargs(
        image_size=16, init_dim=8, max_dim=32, **SERVE)
    with pytest.warns(UserWarning, match='2\\^14') as port_warning:
        VideoTokenizer(device='cpu', **kwargs)
    with pytest.warns(UserWarning, match='2\\^14') as jax_warning:
        from magvit2_pytorch_tpu.models.tokenizer_module import (
            TokenizerConfig as JaxConfig)
        JaxConfig(**kwargs)
    assert str(port_warning[0].message) == str(jax_warning[0].message)


def _cl(x):
    return np.moveaxis(x, 1, -1)


@pytest.mark.parametrize('name', ['tok_fsq', 'tok_sff'])
def test_golden_fixture(name):
    """The actual reference's checkpoint and outputs (tests/fixtures), under
    the tolerances of tests/test_torch_parity.py:166-183, as
    tests/test_torch_port_slice.py::test_golden_tok_lfq_fixture holds
    ``tok_lfq``."""
    f = np.load(DATA / f'{name}.npz')
    config = json.loads(bytes(f['config']).decode())
    state = {k[3:]: f[k] for k in f.files if k.startswith('sd.')}
    tok = VideoTokenizer(device='cpu', seed=0, **config)
    tok.load_reference_state_dict(state)
    video = _cl(f['video'])
    np.testing.assert_allclose(tok.encode(video).numpy(), _cl(f['latents']),
                               atol=2e-4, rtol=1e-3)
    codes = tok.tokenize(video)
    np.testing.assert_array_equal(codes.numpy(), f['codes'])
    np.testing.assert_allclose(tok.forward(video, return_recon=True).numpy(),
                               _cl(f['recon']), atol=1e-3, rtol=0)
    flat = codes.reshape(codes.shape[0], -1)
    np.testing.assert_allclose(tok.decode_from_code_indices(flat).numpy(),
                               _cl(f['recon_from_codes']), atol=1e-3, rtol=0)
