"""Checkpoints between the JAX package and the port on the CPU.

The port's msgpack codec (``utils/serialization.py``) against
``flax.serialization`` both ways, byte for byte; ``save`` /
``init_and_load_from`` across the two packages with trained upsamplers (their
kernels differ across sub-pixel positions, so the bridge's flip is seen) and
live SqueezeExcite gates: codes exact, reconstructions within 1e-3 (the
repo's parity contract, BASELINE.md:17); ``strict`` refusing a checkpoint of
another config; a GAN checkpoint whose discriminator params are skipped.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    jax_params_from_state_dict, p_flipped, state_dict_from_jax_params)
from magvit2_pytorch_tpu_torch.models.layerspec import parse_layers
from magvit2_pytorch_tpu_torch.utils import serialization

torch.set_num_threads(1)
TOL = 1e-3
SERVE = dict(use_gan=False, perceptual_loss_weight=0.0)
# every layer type the port serves, separate first-frame encoding and a
# spherical two-codebook LFQ with projections
TINY = dict(image_size=16, init_dim=8, codebook_size=64, num_codebooks=2,
            lfq_spherical=True, separate_first_frame_encoding=True,
            layers=('residual', ('consecutive_residual', 2),
                    ('compress_space', 12), 'attend_space',
                    ('compress_time', 16), 'attend_time',
                    'linear_attend_space'), **SERVE)
FSQ_SMALL = dict(image_size=16, init_dim=8, use_fsq=True,
                 fsq_levels=(8, 5, 5, 5),
                 layers=('residual', ('compress_space', 16),
                         ('compress_time', 16)), **SERVE)


def _tree():
    """What a checkpoint holds, and the rest of the codec's subset."""
    rng = np.random.default_rng(0)
    return {
        'version': '0.1.0', 'config': '{"image_size": 16}' * 20,
        'params': {
            'w': rng.normal(size=(3, 4, 5)).astype(np.float32),
            'i': rng.integers(-2 ** 31, 2 ** 31, size=(7,)).astype(np.int32),
            'b': rng.random(9) > 0.5,
            'empty': np.zeros((0, 3), np.float32),
            'scalar_array': np.asarray(2.5, np.float32),
            'nested': {f'k{i}': np.arange(i, dtype=np.int64)
                       for i in range(20)},
        },
        'list': [1, -1, 127, 128, -32, -33, 255, 256, 65536, -2 ** 40,
                 2 ** 63, 1.5, -0.0, True, False, None, 'x' * 300,
                 np.float32(3.25), np.int32(-7), np.bool_(True),
                 {'a': [np.ones(2, np.float32)]}],
        'many': list(range(70000)),
    }


def _assert_same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.generic)
                                  and isinstance(b, np.generic)), (a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_codec_writes_flax_bytes_and_reads_them():
    tree = _tree()
    ours = serialization.msgpack_serialize(tree)
    assert ours == flax_serialization.msgpack_serialize(tree)
    _assert_same(flax_serialization.msgpack_restore(ours),
                 serialization.msgpack_restore(ours))
    _assert_same(serialization.msgpack_restore(ours), tree)


def test_codec_chunked_arrays_both_ways(monkeypatch):
    """Arrays over the chunk limit (1 GiB in flax; 64 bytes here) are
    written as flax writes them, as flat chunks, and read back whole."""
    monkeypatch.setattr(flax_serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    tree = {'params': {'big': np.arange(60, dtype=np.float32).reshape(3, 20),
                       'small': np.ones(3, np.int32)}}
    ours = serialization.msgpack_serialize(tree)
    assert ours == flax_serialization.msgpack_serialize(tree)
    for data in (ours, flax_serialization.msgpack_serialize(tree)):
        _assert_same(serialization.msgpack_restore(data), tree)
    raw = {'params': {'big': {'__msgpack_chunked_array__': True,
                              'shape': {'0': 3, '1': 21},
                              'chunks': {'0': np.zeros(60, np.float32)}}}}
    with pytest.raises(ValueError, match='does not fill'):
        serialization.msgpack_restore(
            flax_serialization.msgpack.packb(
                raw, default=flax_serialization._msgpack_ext_pack))


@pytest.mark.parametrize('bad', ['bfloat16', 'ext', 'trailing', 'truncated'])
def test_codec_refuses_what_it_cannot_read(bad):
    data = serialization.msgpack_serialize({'a': np.ones(3, np.float32)})
    if bad == 'bfloat16':
        data = flax_serialization.msgpack_serialize(
            {'a': jnp.ones(3, jnp.bfloat16)})
    elif bad == 'ext':
        data = flax_serialization.msgpack_serialize({'a': 1 + 2j})
    elif bad == 'trailing':
        data += b'\xc0'
    else:
        data = data[:-1]
    with pytest.raises(ValueError, match='msgpack'):
        serialization.msgpack_restore(data)


def _trained(params, config, rng):
    """Upsampler kernels that differ across sub-pixel positions and live
    SqueezeExcite gates, as a trained checkpoint has them."""
    params = jax.tree.map(np.array, params)
    for spec in parse_layers(config.layers, init_dim=config.init_dim,
                             image_size=config.image_size).specs:
        if spec.layer_type in ('compress_space', 'compress_time'):
            up = params[f'decoder_{spec.index}']
            up['kernel'] = (up['kernel'] + 0.2 * rng.normal(
                size=up['kernel'].shape)).astype(np.float32)

    def walk(tree):
        if isinstance(tree, dict):
            if 'gate_out' in tree:
                k = tree['gate_out']['kernel']
                tree['gate_out']['kernel'] = rng.uniform(
                    -1, 1, k.shape).astype(np.float32) * np.sqrt(6 / k.shape[0])
                tree['gate_out']['bias'][:] = 0
            for v in tree.values():
                walk(v)
    walk(params)
    return params


def _video(seed, frames=5):
    return np.random.default_rng(seed).random((2, frames, 16, 16, 3),
                                              dtype=np.float32)


def _agree(jtok, port, video):
    """Codes exact and reconstructions within TOL, through tokenize and
    decode_from_code_indices of both packages."""
    codes = port.tokenize(video)
    codes_j = jtok.tokenize(jnp.asarray(video))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(
        port.decode_from_code_indices(codes).numpy(),
        np.asarray(jtok.decode_from_code_indices(codes_j)), atol=TOL, rtol=0)


@pytest.fixture(scope='module')
def jax_tokenizer():
    """The JAX package's own init of TINY, trained as ``_trained`` says."""
    jtok = JaxTokenizer(seed=3, **TINY)
    jtok.params = jax.tree.map(jnp.asarray, _trained(
        jtok.params, jtok.config, np.random.default_rng(4)))
    return jtok


def test_inverse_bridge_gives_the_jax_tree(jax_tokenizer):
    """``jax_params_from_state_dict`` inverts ``state_dict_from_jax_params``
    exactly, upsampler flip included, into the JAX package's own tree."""
    params = jax.tree.map(np.asarray, jax_tokenizer.params)
    port = VideoTokenizer(device='cpu', **TINY)
    back = jax_params_from_state_dict(
        port.config, state_dict_from_jax_params(port.config, params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # the port's own tree has the same paths and shapes
    own = jax_params_from_state_dict(port.config, port.state_dict())
    assert (jax.tree.map(np.shape, own) == jax.tree.map(np.shape, params))


def test_jax_save_loads_into_the_port(jax_tokenizer, tmp_path):
    path = tmp_path / 'jax.ckpt'
    jax_tokenizer.save(path)
    port = VideoTokenizer.init_and_load_from(path, device='cpu')
    assert (json.loads(port.config.to_json())
            == json.loads(jax_tokenizer.config.to_json()))
    assert port.device.type == 'cpu' and port.dtype == torch.float32
    _agree(jax_tokenizer, port, _video(5))
    # the flip is seen: the same kernels unflipped decode differently
    params = jax.tree.map(np.array, jax_tokenizer.params)
    for key in ('decoder_2', 'decoder_4'):
        params[key]['kernel'] = p_flipped(params[key]['kernel'],
                                          2 if key == 'decoder_2' else 1)
    port.load_state_dict(state_dict_from_jax_params(port.config, params))
    codes = port.tokenize(_video(5))
    assert np.abs(port.decode_from_code_indices(codes).numpy() - np.asarray(
        jax_tokenizer.decode_from_code_indices(codes.numpy()))).max() > TOL


@pytest.mark.parametrize('kwargs', [TINY, FSQ_SMALL], ids=['lfq_sff', 'fsq'])
def test_port_save_loads_into_the_jax_package(kwargs, tmp_path):
    port = VideoTokenizer(device='cpu', seed=6, **kwargs)
    port.load_state_dict(state_dict_from_jax_params(port.config, _trained(
        jax_params_from_state_dict(port.config, port.state_dict()),
        port.config, np.random.default_rng(7))))
    path = tmp_path / 'port.ckpt'
    port.save(path)
    jtok = JaxTokenizer.init_and_load_from(path)
    assert (json.loads(jtok.config.to_json())
            == json.loads(port.config.to_json()))
    _agree(jtok, port, _video(8))
    # and back into the port, bit for bit
    again = VideoTokenizer.init_and_load_from(path, device='cpu')
    for key, value in port.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key


def test_strict_refuses_a_misfit(tmp_path):
    path = tmp_path / 'small.ckpt'
    VideoTokenizer(device='cpu', **FSQ_SMALL).save(path)
    other = VideoTokenizer(device='cpu', **{**FSQ_SMALL, 'init_dim': 16})
    before = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(ValueError, match='does not fit'):
        other.load(path)
    extra = VideoTokenizer(device='cpu', **{
        **FSQ_SMALL, 'layers': FSQ_SMALL['layers'] + ('residual',)})
    with pytest.raises(ValueError, match='missing'):
        extra.load(path)
    # strict=False loads every leaf that fits and keeps the rest: here all
    # but the added residual (spec 3, stored first in the decoder)
    kept = {k: v.clone() for k, v in extra.state_dict().items()}
    extra.load(path, strict=False)
    saved = VideoTokenizer.init_and_load_from(path, device='cpu').state_dict()
    for key, value in extra.state_dict().items():
        new = key.startswith(('encoder_layers.3.', 'decoder_layers.0.'))
        want = kept[key] if new else saved[
            key.replace('encoder_layers.4.', 'encoder_layers.3.')
            if key.startswith('encoder_layers.4.') else
            'decoder_layers.' + str(int(key.split('.')[1]) - 1) + '.'
            + key.split('.', 2)[2] if key.startswith('decoder_layers.')
            else key]
        assert torch.equal(value, want), key
    assert all(torch.equal(before[k], v)
               for k, v in other.state_dict().items())


def test_gan_checkpoint_skips_the_discriminator(tmp_path):
    kwargs = dict(FSQ_SMALL, use_gan=True,
                  discr_kwargs=dict(dim=8, image_size=16, channels=3,
                                    max_dim=16))
    jtok = JaxTokenizer(seed=1, **kwargs)
    path = tmp_path / 'gan.ckpt'
    jtok.save(path)
    pkg = serialization.msgpack_restore(path.read_bytes())
    assert 'discr_params' in pkg
    port = VideoTokenizer.init_and_load_from(path, device='cpu')
    assert port.config.use_gan
    assert not any(k.startswith(('discr', 'multiscale')) for k in
                   port.state_dict())
    _agree(jtok, port, _video(9))


def test_reference_pt_import_is_not_ported_yet(tmp_path):
    """The reference's ``.pt`` package, once refused, now imports: the
    package ``save`` of the reference writes (a pickled kwargs dict and the
    reference-named state_dict) gives back the tokenizer it was written
    from, weights and outputs equal."""
    import pickle
    src = VideoTokenizer(device='cpu', seed=8, **FSQ_SMALL)
    path = tmp_path / 'ref.pt'
    torch.save({'model_state_dict': src.state_dict(),
                'config': pickle.dumps(dict(FSQ_SMALL)),
                'version': '0.0.0'}, path)
    tok = VideoTokenizer.init_and_load_from_torch(path, device='cpu')
    assert tok.config == src.config
    assert all(torch.equal(v, tok.state_dict()[k])
               for k, v in src.state_dict().items())
    video = _video(10)
    assert torch.equal(tok.tokenize(video), src.tokenize(video))
