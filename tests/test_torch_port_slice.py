"""The port's serving slice end to end on the CPU: config and layer-spec
copies, the weight bridge with the JAX package, the golden ``tok_lfq``
fixture of the actual reference, a tiny roundtrip against the JAX package,
the options it once refused, the modes it refuses, and an import with JAX
blocked."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu import configs as jax_configs
from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.layerspec import parse_layers as jax_parse
from magvit2_pytorch_tpu.models.tokenizer_module import (
    TokenizerConfig as JaxConfig)
from magvit2_pytorch_tpu.models.torch_import import (
    load_torch_tokenizer_state_dict)
from magvit2_pytorch_tpu_torch import TokenizerConfig, VideoTokenizer
from magvit2_pytorch_tpu_torch import configs
from magvit2_pytorch_tpu_torch.models.jax_import import (
    jax_params_from_state_dict, p_flipped, state_dict_from_jax_params)
from magvit2_pytorch_tpu_torch.models.layerspec import parse_layers

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
DATA = REPO / 'tests' / 'fixtures' / 'data'

TINY = dict(image_size=16, init_dim=8, codebook_size=256,
            layers=('residual', ('consecutive_residual', 2),
                    ('compress_space', 12), 'attend_space',
                    ('compress_time', 16), 'attend_time',
                    'linear_attend_space'),
            use_gan=False, perceptual_loss_weight=0.0)
# the README layer stack at narrow widths
README_SMALL = dict(configs.readme_video_tokenizer_kwargs(
    image_size=16, init_dim=8, max_dim=32, codebook_size=64,
    linear_attn_heads=4, attn_heads=2), use_gan=False,
    perceptual_loss_weight=0.0)


def _cl(x):
    return np.moveaxis(x, 1, -1)


SEEDED = {'tiny': TINY, 'readme': README_SMALL}


@pytest.fixture(scope='module')
def seed2_tokenizer():
    """The JAX package's tokenizer of a ``SEEDED`` config initialised from
    seed 2, built once for the module (its init is one jitted program)."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = JaxTokenizer(seed=2, **SEEDED[name])
        return made[name]
    return get


@pytest.fixture(scope='module')
def tiny_pair():
    jtok = JaxTokenizer(seed=0, **TINY)
    port = VideoTokenizer(device='cpu', seed=1, **TINY)
    port.load_state_dict(state_dict_from_jax_params(
        jtok.config, jax.tree.map(np.asarray, jtok.params)))
    video = np.random.default_rng(0).random((2, 5, 16, 16, 3),
                                            dtype=np.float32)
    return jtok, port, video


def test_config_json_matches_jax_package():
    kw = configs.readme_video_tokenizer_kwargs()
    port_cfg = TokenizerConfig(**kw)
    jax_cfg = JaxConfig(**jax_configs.readme_video_tokenizer_kwargs())
    assert json.loads(port_cfg.to_json()) == json.loads(jax_cfg.to_json())
    assert JaxConfig.from_json(port_cfg.to_json()) == jax_cfg
    assert TokenizerConfig.from_json(jax_cfg.to_json()) == port_cfg
    assert ([f.name for f in dataclasses.fields(TokenizerConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert configs.README_LAYERS == jax_configs.README_LAYERS


@pytest.mark.parametrize('kwargs', [TINY, README_SMALL],
                         ids=['tiny', 'readme'])
def test_layerspec_copy_matches_jax_package(kwargs):
    args = dict(init_dim=kwargs['init_dim'], image_size=kwargs['image_size'],
                max_dim=kwargs.get('max_dim', float('inf')))
    assert (dataclasses.asdict(parse_layers(kwargs['layers'], **args))
            == dataclasses.asdict(jax_parse(kwargs['layers'], **args)))


@pytest.mark.parametrize('name', list(SEEDED))
def test_bridge_round_trip_is_exact(name, seed2_tokenizer):
    """JAX params -> port state_dict -> the JAX package's own importer gives
    back the same pytree, bit for bit, and the state_dict fits the port's
    modules exactly (strict load)."""
    kwargs = SEEDED[name]
    jtok = seed2_tokenizer(name)
    params = jax.tree.map(np.asarray, jtok.params)
    state = state_dict_from_jax_params(jtok.config, params)
    back = load_torch_tokenizer_state_dict(jtok.config, state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    port = VideoTokenizer(device='cpu', seed=0, **kwargs)
    port.load_state_dict(state, strict=True)
    assert set(port.state_dict()) == set(state)


def test_bridge_flips_trained_upsamplers(seed2_tokenizer):
    """Upsampler kernels that differ over the sub-pixel position p, as in a
    trained checkpoint: the port decodes with the bridged weights what the
    JAX package decodes, and the JAX importer gives back the params with
    exactly those kernels p-flipped."""
    jtok = seed2_tokenizer('tiny')
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.asarray, jtok.params)
    flipped = {}
    for spec in parse_layers(TINY['layers'], init_dim=TINY['init_dim'],
                             image_size=TINY['image_size']).specs:
        positions = {'compress_space': 2, 'compress_time': 1}.get(
            spec.layer_type)
        if positions:
            key = f'decoder_{spec.index}'
            k = params[key]['kernel']
            k = (k + 0.2 * rng.normal(size=k.shape)).astype(np.float32)
            params[key] = {**params[key], 'kernel': k}
            flipped[key] = p_flipped(k, positions)
    assert len(flipped) == 2
    state = state_dict_from_jax_params(jtok.config, params)
    back = load_torch_tokenizer_state_dict(jtok.config, state)
    for key, leaf in params.items():
        want = ({**leaf, 'kernel': flipped[key]} if key in flipped else leaf)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     want, back[key])
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, params), **TINY)
    port = VideoTokenizer(device='cpu', seed=0, **TINY)
    port.load_state_dict(state, strict=True)
    codes = np.random.default_rng(10).integers(0, 256, size=(1, 3 * 8 * 8))
    want = np.asarray(jtok.decode_from_code_indices(codes))
    np.testing.assert_allclose(
        port.decode_from_code_indices(torch.from_numpy(codes)).numpy(), want,
        atol=1e-5, rtol=0)
    # the same kernels unflipped decode differently: the flip is seen
    port.load_state_dict(state_dict_from_jax_params(
        jtok.config, {**params, **{k: {**params[k], 'kernel': v}
                                   for k, v in flipped.items()}}))
    assert np.abs(port.decode_from_code_indices(
        torch.from_numpy(codes)).numpy() - want).max() > 1e-3


def test_port_weights_import_into_jax_package(tiny_pair):
    """The port's own seeded weights go into the JAX package through
    ``load_torch_tokenizer_state_dict`` unchanged, and both then agree."""
    port = VideoTokenizer(device='cpu', seed=5, **TINY)
    jtok = JaxTokenizer(params=tiny_pair[0].params, **TINY)   # seed 0's
    jtok.load_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    video = np.random.default_rng(5).random((1, 5, 16, 16, 3),
                                            dtype=np.float32)
    np.testing.assert_array_equal(port.tokenize(video).numpy(),
                                  np.asarray(jtok.tokenize(jnp.asarray(video))))
    np.testing.assert_allclose(
        port.forward(video, return_recon=True).numpy(),
        np.asarray(jtok.forward(jnp.asarray(video), return_recon=True)),
        atol=1e-4, rtol=0)


def test_seeded_init_matches_reference_distributions():
    """Same seed, same weights; SE gates start at weight 0 / bias -10,
    upsamplers replicated, convs within torch's default bound."""
    a = VideoTokenizer(device='cpu', seed=3, **TINY).state_dict()
    b = VideoTokenizer(device='cpu', seed=3, **TINY).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a['encoder_layers.0.fn.4.net.2.weight'] == 0)
    assert torch.all(a['encoder_layers.0.fn.4.net.2.bias'] == -10)
    up = a['decoder_layers.4.net.0.weight']          # compress_space (4x)
    assert torch.equal(up[0::4], up[3::4])
    w = a['conv_in.conv.weight']
    assert w.abs().max() <= (3 * 7 ** 3) ** -0.5
    assert w.std() > 0.5 * (3 * 7 ** 3) ** -0.5 / 3 ** 0.5


def test_golden_tok_lfq_fixture():
    """The actual reference's checkpoint and outputs (tests/fixtures), under
    the tolerances of tests/test_torch_parity.py:166-183."""
    f = np.load(DATA / 'tok_lfq.npz')
    config = json.loads(bytes(f['config']).decode())
    state = {k[3:]: f[k] for k in f.files if k.startswith('sd.')}
    tok = VideoTokenizer(device='cpu', seed=0, **config)
    tok.load_torch_state_dict(state)
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


def test_reference_state_dict_rejects_a_misfit():
    f = np.load(DATA / 'tok_lfq.npz')
    config = json.loads(bytes(f['config']).decode())
    state = {k[3:]: f[k] for k in f.files if k.startswith('sd.')}
    state['conv_in.conv.weight'] = state['conv_in.conv.weight'][:, :2]
    with pytest.raises(ValueError, match='conv_in.conv.weight'):
        VideoTokenizer(device='cpu', seed=0,
                       **config).load_torch_state_dict(state)


def test_tiny_roundtrip_matches_jax(tiny_pair):
    """Same weights, same input: latents within 1e-5, codes exact, recon
    within 1e-5 (float32 on the CPU in both packages)."""
    jtok, port, video = tiny_pair
    jv = jnp.asarray(video)
    np.testing.assert_allclose(port.encode(video).numpy(),
                               np.asarray(jtok.encode(jv)), atol=1e-5, rtol=0)
    codes = port.tokenize(video)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jtok.tokenize(jv)))
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes_p, recon_p = port.forward(video, return_codes=True,
                                    return_recon=True)
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon_p.numpy(), np.asarray(recon_j),
                               atol=1e-5, rtol=0)
    flat = codes.reshape(codes.shape[0], -1)
    np.testing.assert_allclose(
        port.decode_from_code_indices(flat).numpy(),
        np.asarray(jtok.decode_from_code_indices(np.asarray(flat))),
        atol=1e-5, rtol=0)


def test_channel_first_image_and_no_first_frame_modes(tiny_pair):
    jtok, port, video = tiny_pair
    recon = port.forward(video, return_recon=True)
    recon_cf = port.forward(np.moveaxis(video, -1, 1), return_recon=True,
                            channel_first=True)
    assert torch.equal(recon_cf, recon.movedim(-1, 1))
    image = video[:, 0]
    np.testing.assert_allclose(
        port.forward(image, return_recon=True).numpy(),
        np.asarray(jtok.forward(jnp.asarray(image), return_recon=True)),
        atol=1e-5, rtol=0)
    rest = video[:, 1:]
    np.testing.assert_allclose(
        port.forward(rest, return_recon=True,
                     video_contains_first_frame=False).numpy(),
        np.asarray(jtok.forward(jnp.asarray(rest), return_recon=True,
                                video_contains_first_frame=False)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize('overrides', [
    dict(layers=('residual', 'cond_residual'), dim_cond=4),
    dict(layers=('residual', 'gateloop_time')),
    dict(dim_cond=4),
    dict(remat='dots'),
    dict(streaming_kv_window=4),
], ids=lambda d: next(iter(d)) if 'layers' not in d else d['layers'][1])
def test_outside_the_slice_raises(overrides):
    """Every option the port once refused, ``remat`` (training) the last,
    now builds and tokenizes and decodes as the JAX package does on the
    same weights (codes exact, recon within 1e-5), a cond vector given
    where the config has conditioned layers."""
    kwargs = {**TINY, **overrides}
    port = VideoTokenizer(device='cpu', seed=0, **kwargs)
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_params_from_state_dict(port.config, port.state_dict()))),
        **kwargs)
    rng = np.random.default_rng(6)
    video = rng.random((2, 5, 16, 16, 3), dtype=np.float32)
    cond = (rng.random((2, 4), dtype=np.float32)
            if port.config.parsed().has_cond else None)
    codes_j, recon_j = jtok.forward(
        jnp.asarray(video), cond=None if cond is None else jnp.asarray(cond),
        return_codes=True, return_recon=True)
    codes, recon = port.forward(video, cond=cond, return_codes=True,
                                return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('overrides', [
    dict(use_fsq=True, codebook_size=None, fsq_levels=(4, 4)),
    dict(separate_first_frame_encoding=True),
    dict(num_codebooks=2),
    dict(pad_mode='reflect'),
    dict(lfq_spherical=True),
], ids=lambda d: next(iter(d)))
def test_former_slice_limits_build_and_match_jax(overrides):
    """Options the port refused before it served the JAX package's other
    configurations: each builds, and tokenizes and decodes as the JAX
    package does on the same weights (codes exact, recon within 1e-5)."""
    kwargs = {**TINY, **overrides}
    port = VideoTokenizer(device='cpu', seed=4, **kwargs)
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_params_from_state_dict(port.config, port.state_dict()))),
        **kwargs)
    video = np.random.default_rng(4).random((1, 5, 16, 16, 3),
                                            dtype=np.float32)
    codes_j, recon_j = jtok.forward(jnp.asarray(video), return_codes=True,
                                    return_recon=True)
    codes, recon = port.forward(video, return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('mode', ['return_loss', 'return_discr_loss',
                                  'return_recon_loss_only', 'train'])
def test_training_modes_raise(tiny_pair, mode):
    """The loss modes, which raised before the port trained, now compute
    what the JAX package's do on the same weights (within 1e-5; this config
    has no GAN and no VGG, so no random frame pick enters), and a
    discriminator loss without a discriminator is refused in both."""
    jtok, port, video = tiny_pair
    if mode == 'return_discr_loss':
        for tok in (jtok, port):
            with pytest.raises(AssertionError):
                tok.forward(video, return_discr_loss=True)
        return
    want = jtok.forward(jnp.asarray(video), **{mode: True})
    got = port.forward(video, **{mode: True})
    if mode == 'return_loss':           # (total, LossBreakdown)
        pairs = [(got[0], want[0])] + [
            (getattr(got[1], k), getattr(want[1], k))
            for k in ('recon_loss', 'lfq_aux_loss')]
    elif mode == 'return_recon_loss_only':      # (recon_loss, recon)
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0)


def test_port_imports_and_runs_without_jax(tmp_path):
    """The port never imports JAX, flax, msgpack or the JAX package: with
    them blocked, tiny CPU roundtrips still run, FSQ included, and a
    checkpoint saves and loads."""
    code = f'''
import sys
sys.modules['jax'] = None
sys.modules['flax'] = None
sys.modules['msgpack'] = None
sys.modules['magvit2_pytorch_tpu'] = None
sys.path.insert(0, {str(REPO)!r})
import numpy as np, torch
torch.set_num_threads(1)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.ops import attend, attention, rotary
from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention
for rotary_on in (False, True):
    tok = VideoTokenizer(device='cpu', seed=0, image_size=8, init_dim=4, codebook_size=16,
                         layers=('residual', 'compress_space', 'attend_space',
                                 'compress_time', 'attend_time',
                                 'linear_attend_space'),
                         attn_heads=1, attn_dim_head=8, linear_attn_heads=2,
                         use_rotary_pos_emb=rotary_on)
    codes, recon = tok.forward(np.zeros((1, 3, 8, 8, 3), np.float32),
                               return_codes=True, return_recon=True)
    assert tuple(codes.shape) == (1, 2, 4, 4) and tuple(recon.shape) == (1, 3, 8, 8, 3)
    assert torch.isfinite(recon).all()
fsq = VideoTokenizer(device='cpu', seed=0, image_size=8, init_dim=4, use_fsq=True,
                     fsq_levels=(8, 5, 5), layers=('residual', 'compress_space'),
                     pad_mode='reflect', separate_first_frame_encoding=True)
video = np.random.default_rng(0).random((1, 3, 8, 8, 3), dtype=np.float32)
codes = fsq.tokenize(video)
assert tuple(codes.shape) == (1, 3, 4, 4) and int(codes.max()) < 200
path = {str(tmp_path / 'fsq.ckpt')!r}
fsq.save(path)
again = VideoTokenizer.init_and_load_from(path, device='cpu')
again.load(path)
assert torch.equal(again.tokenize(video), codes)
q = torch.ones(1, 1, 4, 16, requires_grad=True)
attend.attend(q, q, q, causal=True, backend='flash').sum().backward()
assert torch.isfinite(q.grad).all()
assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax', 'msgpack'))
               for m in sys.modules if sys.modules[m] is not None)
print('ok')
'''
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_no_jax_in_port_sources():
    for path in (REPO / 'magvit2_pytorch_tpu_torch').rglob('*.py'):
        text = path.read_text()
        for package in ('jax', 'flax', 'msgpack'):
            assert (f'import {package}' not in text
                    and f'from {package}' not in text), path
        assert 'magvit2_pytorch_tpu.' not in text.replace(
            'magvit2_pytorch_tpu/', ''), path
        assert 'from magvit2_pytorch_tpu import' not in text, path
