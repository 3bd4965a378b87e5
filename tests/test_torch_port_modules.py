"""Each module of the port's slice against its JAX counterpart on the CPU.

Leaf modules get random JAX params (numpy seed) mapped by hand into the
port's names and layouts; whole encoder/decoder layers of a tiny tokenizer
get theirs through ``state_dict_from_jax_params``, and each layer runs alone
on the same numpy input in both packages. The params are random everywhere,
upsamplers included, so the bridge's sub-pixel flip is under test. Tolerance: 2e-5 absolute in
float32 — the same math summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.tokenizer_module import (
    TokenizerModule as JaxTokenizerModule)
from magvit2_pytorch_tpu.ops.attend import (
    attend_with_memory as jax_attend_with_memory)
from magvit2_pytorch_tpu.ops import basic as jbasic
from magvit2_pytorch_tpu.ops import conv as jconv
from magvit2_pytorch_tpu.ops import norms as jnorms
from magvit2_pytorch_tpu.ops import quantizers as jquant
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models import jax_import
from magvit2_pytorch_tpu_torch.ops import (
    attend, basic, conv, norms, quantizers, resample)

torch.set_num_threads(1)
ATOL = 2e-5


def _randomize(params, rng, scale=0.3):
    """Every leaf replaced by seeded normals (gammas around 1), so zero or
    constant inits (SE gate, norms) cannot hide a wiring error."""
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        r = rng.normal(size=np.shape(a))
        r = 1 + 0.1 * r if ('gamma' in name or 'beta' in name) else r * scale
        return r.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _check(jax_mod, jparams, port_mod, state, x, atol=ATOL, **jkw):
    port_mod.load_state_dict(state, strict=True)
    want = np.asarray(jax_mod.apply({'params': jparams}, jnp.asarray(x), **jkw))
    with torch.inference_mode():
        got = port_mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _init(mod, x, rng):
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    return _randomize(jax.tree.map(np.asarray, p), rng)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 4, 4, 16)).astype(np.float32)
    p = _init(jnorms.RMSNorm(16), x, rng)
    _check(jnorms.RMSNorm(16), p, norms.RMSNorm(16),
           {'gamma': _t(p['gamma'])}, x)
    p = _init(jnorms.LayerNorm(16), x, rng)
    _check(jnorms.LayerNorm(16), p, norms.LayerNorm(16),
           {'weight': _t(p['gamma']), 'bias': _t(p['beta'])}, x)


def test_feedforward_geglu_tanh_gelu():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 4, 24)).astype(np.float32)
    p = _init(jbasic.FeedForward(24), x, rng)
    state = {}
    jax_import._apply(state, jax_import._feedforward_entries('x', ()), p)
    _check(jbasic.FeedForward(24), p, basic.FeedForward(24),
           {k[2:]: v for k, v in state.items()}, x)


def test_squeeze_excite():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 6, 5, 32)).astype(np.float32)
    p = _init(jbasic.SqueezeExcite(32), x, rng)
    state = {}
    for name, key in (('to_k', 'to_k'), ('net.0', 'gate_in'),
                      ('net.2', 'gate_out')):
        jax_import._apply(state, jax_import._linear(name, (key,)), p)
    _check(jbasic.SqueezeExcite(32), p, basic.SqueezeExcite(32), state, x)


def test_token_shift():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 3, 3, 8)).astype(np.float32)
    out, variables = jbasic.TokenShift(
        jbasic.Residual(jbasic.Linear(8))).init_with_output(
            jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, variables['params'])['fn']['fn']
    port = basic.TokenShift(basic.Residual(basic.Linear(8, 8)))
    port.load_state_dict({'fn.fn.weight': _t(p['kernel'].T),
                          'fn.fn.bias': _t(p['bias'])})
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(out), atol=ATOL, rtol=0)
    # the shift itself: second half of the channels one frame later
    shifted = basic.TokenShift(torch.nn.Identity())(torch.from_numpy(x))
    assert shifted[:, 0, ..., 4:].abs().max() == 0
    assert torch.equal(shifted[:, 1:, ..., 4:],
                       torch.from_numpy(x)[:, :-1, ..., 4:])


@pytest.mark.parametrize('kernel_size', [(3, 3, 3), (7, 7, 7), (1, 3, 3)])
def test_causal_conv3d(kernel_size):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 5, 8, 8, 3)).astype(np.float32)
    mod = jconv.CausalConv3d(6, kernel_size)
    p = _init(mod, x, rng)
    state = {}
    jax_import._apply(state, jax_import._linear('conv', (), 'conv3d'), p)
    _check(mod, p, conv.CausalConv3d(3, 6, kernel_size), state, x)


@pytest.mark.parametrize('causal', [False, True])
def test_attend_with_memory(causal):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
               for _ in range(3))
    mk, mv = (rng.normal(size=(3, 4, 8)).astype(np.float32) for _ in range(2))
    want = jax_attend_with_memory(*map(jnp.asarray, (q, k, v, mk, mv)),
                                  causal=causal)
    got = attend.attend_with_memory(*map(torch.from_numpy, (q, k, v, mk, mv)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_lfq_eval_path():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 3, 4, 4, 32)) * 2).astype(np.float32)
    jmod = jquant.LFQ(dim=32, codebook_size=256)
    p = _init(jmod, x, rng)
    port = quantizers.LFQ(32, 256)
    state = {}
    for name in ('project_in', 'project_out'):
        jax_import._apply(state, jax_import._linear(name, (name,)), p)
    port.load_state_dict(state, strict=True)
    want = jmod.apply({'params': p}, jnp.asarray(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.quantized.numpy(),
                               np.asarray(want.quantized), atol=ATOL, rtol=0)
    want_codes = jmod.apply({'params': p}, want.indices,
                            method=jquant.LFQ.indices_to_codes)
    with torch.inference_mode():
        got_codes = port.indices_to_codes(got.indices)
    np.testing.assert_allclose(got_codes.numpy(), np.asarray(want_codes),
                               atol=ATOL, rtol=0)


# ---- whole encoder/decoder layers through the weight bridge ---------------

LAYERS = ('residual', ('consecutive_residual', 2), ('compress_space', 32),
          'linear_attend_space', 'attend_space', ('compress_time', 32),
          'attend_time')
CONFIG = dict(image_size=16, init_dim=16, codebook_size=64, layers=LAYERS,
              use_gan=False, perceptual_loss_weight=0.0,
              linear_attn_heads=4, attn_heads=2)


@pytest.fixture(scope='module')
def pair():
    jtok = JaxTokenizer(seed=0, **CONFIG)
    params = _randomize(jax.tree.map(np.asarray, jtok.params),
                        np.random.default_rng(7), scale=0.2)
    port = VideoTokenizer(device='cpu', seed=0, **CONFIG)
    port.load_state_dict(
        jax_import.state_dict_from_jax_params(jtok.config, params))
    return jtok, params, port


def _layer_inputs(port, rng):
    """Input shape of every encoder and decoder layer, from one pass."""
    shapes = {}
    hooks = []
    mod = port.module
    for where, layers in (('enc', mod.encoder_layers[:mod.num_layers]),
                          ('dec', mod.decoder_layers)):
        for i, layer in enumerate(layers):
            def hook(module, args, key=(where, i)):
                shapes.setdefault(key, tuple(args[0].shape))
            hooks.append(layer.register_forward_pre_hook(hook))
    port.forward(rng.random((1, 5, 16, 16, 3)).astype(np.float32))
    for h in hooks:
        h.remove()
    return shapes


@pytest.mark.parametrize('where', ['enc', 'dec'])
@pytest.mark.parametrize('index', range(len(LAYERS)))
def test_layer_matches_jax(pair, where, index):
    jtok, params, port = pair
    rng = np.random.default_rng(100 + index)
    n = len(LAYERS)
    shape = _layer_inputs(port, rng)[
        (where, index if where == 'enc' else n - 1 - index)]
    x = rng.normal(size=shape).astype(np.float32)
    method = (JaxTokenizerModule.apply_encoder_layer if where == 'enc'
              else JaxTokenizerModule.apply_decoder_layer)
    want = jtok.module.apply({'params': params}, jnp.asarray(x), index,
                             method=method)
    layer = (port.module.encoder_layers[index] if where == 'enc'
             else port.module.decoder_layers[n - 1 - index])
    with torch.inference_mode():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('space', [True, False])
def test_upsamplers_match_reference_shuffle(space):
    """Random (not replicated) weights and bias: 1x1 projection in the
    reference's (c, p1, p2) / (c, p) channel order, SiLU, then
    'b (c p1 p2) h w -> b c (h p1) (w p2)' (magvit2_pytorch.py:811-883)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 3, 4, 4, 6)).astype(np.float32)
    reps = 4 if space else 2
    w = rng.normal(size=(5 * reps, 6)).astype(np.float32)
    b = rng.normal(size=5 * reps).astype(np.float32)
    y = np.einsum('bthwi,oi->bthwo', x, w) + b
    y = y / (1 + np.exp(-y))
    bt, t, h, wd, _ = y.shape
    if space:
        want = y.reshape(bt, t, h, wd, 5, 2, 2).transpose(
            0, 1, 2, 5, 3, 6, 4).reshape(bt, t, h * 2, wd * 2, 5)
        mod = resample.SpatialUpsample2x(6, 5)
    else:
        want = y.reshape(bt, t, h, wd, 5, 2).transpose(
            0, 1, 5, 2, 3, 4).reshape(bt, t * 2, h, wd, 5)
        mod = resample.TimeUpsample2x(6, 5)
    mod.load_state_dict({'net.0.weight': _t(w), 'net.0.bias': _t(b)})
    with torch.inference_mode():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
