"""Conditioning and GateLoop in the port, against the JAX package on the CPU.

Each new module (``AdaptiveRMSNorm``, ``Conv3DMod``,
``CausalConvTranspose3d``, ``ResidualUnitMod``, ``gated_linear_recurrence``
/ ``SimpleGateLoopLayer``, the cond forms of ``FeedForward``, ``Attention``
and ``LinearAttention`` and their axial wrappers, and the Taylor block's
no-norm route) runs on the same seeded numpy input and random params as its
JAX counterpart, the params mapped by hand or through the bridge. Then tiny
tokenizers with every ``cond_*`` layer type and ``gateloop_time`` against
the JAX tokenizer on the same weights, the bridge round trip for them, and
the reference's own ``tok_cond`` / ``tok_gateloop`` checkpoints and outputs
through ``load_torch_state_dict``.

Tolerances, float32: modules 2e-5 of the larger of 1 and the largest
value (the same math summed in another order; the modulated conv and the
unit that holds it 1e-4, the demodulation's sums over 27 taps in another
order; the recurrence 1e-5, an associative scan against a loop);
tokenizers as tests/test_torch_port_slice.py holds the plain stack (latents
1e-5, codes exact, recon 1e-4); the fixtures as
tests/test_torch_parity.py:155-183 (latents 2e-4 / rtol 1e-3, codes exact,
recon and recon_from_codes 1e-3).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.torch_import import (
    load_torch_tokenizer_state_dict as jax_load_torch_state)
from magvit2_pytorch_tpu.ops import attention as jattention
from magvit2_pytorch_tpu.ops import basic as jbasic
from magvit2_pytorch_tpu.ops import conv as jconv
from magvit2_pytorch_tpu.ops import gateloop as jgateloop
from magvit2_pytorch_tpu.ops import norms as jnorms
from magvit2_pytorch_tpu.ops import resample as jresample
from magvit2_pytorch_tpu.ops.pallas.taylor_attention import (
    taylor_linear_attention)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models import jax_import
from magvit2_pytorch_tpu_torch.ops import (
    attention, basic, conv, gateloop, norms, resample)
from magvit2_pytorch_tpu_torch.ops.kernels import (
    launch_counts, reset_launch_counts, taylor_attention as ta)

torch.set_num_threads(1)
ATOL = 2e-5
DATA = Path(__file__).resolve().parent / 'fixtures' / 'data'
SERVE = dict(use_gan=False, perceptual_loss_weight=0.0)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _params(mod, seed, *args, **kwargs):
    """The JAX module's params, every leaf redrawn from a seed (gammas and
    biases of a gamma projection around 1), so no zero init hides a wire."""
    p = mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                 **kwargs)['params']
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        r = rng.normal(size=np.shape(a))
        if 'gamma' in name or ('to_gamma' in name and 'bias' in name):
            r = 1 + 0.1 * r
        else:
            r = 0.3 * r
        return r.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, p))


def _bridge(entries, params):
    state = {}
    jax_import._apply(state, entries, params)
    return {k[2:]: v for k, v in state.items()}


def _close(got, want, atol=ATOL):
    """Within ``atol`` of the larger of 1 and the largest |want| (random
    params at 0.3 give outputs up to ~50)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               rtol=0)


# ---- leaf modules -------------------------------------------------------------

@pytest.mark.parametrize('bias', [False, True])
def test_adaptive_rms_norm(bias):
    x, cond = _rand((2, 3, 4, 4, 16), 0), _rand((2, 6), 1)
    jmod = jnorms.AdaptiveRMSNorm(16, dim_cond=6, bias=bias)
    p = _params(jmod, 2, x, cond)
    port = norms.AdaptiveRMSNorm(16, 6, bias=bias)
    state = {'to_gamma.weight': _t(p['to_gamma']['kernel'].T),
             'to_gamma.bias': _t(p['to_gamma']['bias'])}
    if bias:
        state.update({'to_bias.weight': _t(p['to_bias']['kernel'].T),
                      'to_bias.bias': _t(p['to_bias']['bias'])})
    port.load_state_dict(state, strict=True)
    _close(port(torch.from_numpy(x), torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), jnp.asarray(cond)))


def test_adaptive_rms_norm_starts_as_the_plain_norm():
    """gamma projection weight 0, bias 1 (and beta 0): the l2 norm alone."""
    port = norms.AdaptiveRMSNorm(16, 6, bias=True)
    basic.init_module_parameters(port, torch.Generator().manual_seed(0))
    x, cond = torch.randn(2, 5, 16), torch.randn(2, 6)
    torch.testing.assert_close(port(x, cond), norms.RMSNorm(16)(x))


CONV3DMOD_CASES = {
    'causal': dict(causal=True),
    'causal_reflect': dict(causal=True, pad_mode='reflect'),
    'causal_replicate': dict(causal=True, pad_mode='replicate'),
    'symmetric': dict(causal=False),
    'no_demod': dict(causal=True, demod=False),
}


@pytest.mark.parametrize('case', list(CONV3DMOD_CASES))
def test_conv3dmod(case):
    kw = CONV3DMOD_CASES[case]
    x, cond = _rand((2, 5, 6, 6, 8), 3), _rand((2, 8), 4)
    jmod = jconv.Conv3DMod(dim=8, spatial_kernel=3, time_kernel=3,
                           dim_out=12, **kw)
    p = _params(jmod, 5, x, cond)
    port = conv.Conv3DMod(8, 3, 3, dim_out=12, **kw)
    port.load_state_dict(_bridge(
        [('x.weights', ('weights',), 'conv3d')], p), strict=True)
    _close(port(torch.from_numpy(x), torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), jnp.asarray(cond)),
           atol=1e-4)


def test_conv3dmod_init_is_kaiming_normal_for_selu():
    port = conv.Conv3DMod(32, 3, 3)
    basic.init_module_parameters(port, torch.Generator().manual_seed(1))
    std = 0.75 / (32 * 27) ** 0.5
    assert abs(port.weights.std().item() / std - 1) < 0.05
    assert abs(port.weights.mean().item()) < 0.05 * std


def test_causal_conv_transpose3d():
    x = _rand((2, 3, 5, 5, 6), 6)
    jmod = jconv.CausalConvTranspose3d(4, (3, 3, 3), time_stride=2)
    p = _params(jmod, 7, x)
    port = conv.CausalConvTranspose3d(6, 4, (3, 3, 3), time_stride=2)
    port.load_state_dict(_bridge(
        jax_import._linear('x.conv', (), 'conv3d'), p), strict=True)
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 5, 5, 4)
    _close(got, jmod.apply({'params': p}, jnp.asarray(x)))


def test_residual_unit_mod():
    x, cond = _rand((2, 5, 6, 6, 8), 8), _rand((2, 16), 9)
    jmod = jresample.ResidualUnitMod(8, 3, dim_cond=16)
    p = _params(jmod, 10, x, cond)
    port = resample.ResidualUnitMod(8, 3, dim_cond=16)
    port.load_state_dict(_bridge(
        jax_import._residual_unit_mod_entries('x', ()), p), strict=True)
    _close(port(torch.from_numpy(x), torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), jnp.asarray(cond)),
           atol=1e-4)


@pytest.mark.parametrize('carried', [False, True])
def test_gated_linear_recurrence(carried):
    """The port's loop against the JAX package's associative scan, with and
    without a carried first state: 1e-5 relative to the largest value."""
    rng = np.random.default_rng(11)
    a = rng.random((3, 9, 5)).astype(np.float32)
    x = rng.normal(size=(3, 9, 5)).astype(np.float32)
    s0 = rng.normal(size=(3, 5)).astype(np.float32) if carried else None
    want = np.asarray(jgateloop.gated_linear_recurrence(
        jnp.asarray(a), jnp.asarray(x),
        None if s0 is None else jnp.asarray(s0)))
    got = gateloop.gated_linear_recurrence(
        torch.from_numpy(a), torch.from_numpy(x),
        None if s0 is None else torch.from_numpy(s0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_gateloop_layer_over_time():
    """``ToTimeSequence(Residual(SimpleGateLoopLayer))``, the
    ``gateloop_time`` layer, on video; and its chunks, each from the state
    the previous one left, equal the whole clip to the bit."""
    x = _rand((2, 6, 3, 3, 8), 12)
    jmod = jgateloop.ToTimeSequence(jbasic.Residual(
        jgateloop.SimpleGateLoopLayer(dim=8)))
    p = _params(jmod, 13, x)
    port = gateloop.ToTimeSequence(basic.Residual(
        gateloop.SimpleGateLoopLayer(8)))
    port.load_state_dict(_bridge(jax_import._layer_entries(
        'gateloop_time', (), 'x', (), True), p), strict=True)
    whole = port(torch.from_numpy(x))
    _close(whole, jmod.apply({'params': p}, jnp.asarray(x)))
    state = {}
    chunks = [port(torch.from_numpy(x[:, lo:hi]), state=state)
              for lo, hi in ((0, 1), (1, 4), (4, 6))]
    assert torch.equal(torch.cat(chunks, dim=1), whole)


def test_cond_feedforward():
    x, cond = _rand((2, 3, 4, 4, 24), 14), _rand((2, 6), 15)
    jmod = jbasic.FeedForward(24, dim_cond=6)
    p = _params(jmod, 16, x, cond)
    port = basic.FeedForward(24, dim_cond=6)
    port.load_state_dict(_bridge(
        jax_import._feedforward_entries('x', (), cond=True), p), strict=True)
    _close(port(torch.from_numpy(x), cond=torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), cond=jnp.asarray(cond)))


@pytest.mark.parametrize('kind', ['SpaceAttention', 'TimeAttention'])
def test_cond_axial_attention(kind):
    """The cond vector repeated over frames (space) or pixels (time), the
    general path with an AdaptiveRMSNorm in both packages."""
    x, cond = _rand((2, 3, 4, 4, 32), 17), _rand((2, 6), 18)
    extra = dict(causal=True) if kind == 'TimeAttention' else {}
    jmod = getattr(jattention, kind)(dim=32, dim_cond=6, dim_head=8,
                                     heads=2, **extra)
    p = _params(jmod, 19, x, cond=cond)
    port = getattr(attention, kind)(32, dim_head=8, heads=2, dim_cond=6)
    port.load_state_dict(_bridge(
        jax_import._attention_entries('x', (), cond=True), p), strict=True)
    _close(port(torch.from_numpy(x), cond=torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), cond=jnp.asarray(cond)))


@pytest.mark.parametrize('dim_head', [8, 32])
def test_cond_linear_space_attention(dim_head):
    """``cond_linear_attend_space``'s attention: AdaptiveRMSNorm, then the
    Taylor block on its no-norm route (head size 8, the kernel's; 32, the
    tokenizer's, which the gate sends to the plain version)."""
    x, cond = _rand((2, 2, 4, 4, 32), 20), _rand((2, 6), 21)
    jmod = jattention.LinearSpaceAttention(dim=32, dim_cond=6,
                                           dim_head=dim_head, heads=2)
    p = _params(jmod, 22, x, cond=cond)
    port = attention.LinearSpaceAttention(32, dim_head=dim_head, heads=2,
                                          dim_cond=6)
    port.load_state_dict(_bridge(
        jax_import._linear_attention_entries('x', (), cond=True), p),
        strict=True)
    reset_launch_counts()
    _close(port(torch.from_numpy(x), cond=torch.from_numpy(cond)),
           jmod.apply({'params': p}, jnp.asarray(x), cond=jnp.asarray(cond)))
    assert launch_counts()['taylor_attention_block_no_norm'] == 0  # the CPU


@pytest.mark.parametrize('impl', ['reference', 'fused'])
def test_taylor_no_norm_route_matches_jax(impl):
    """B3's plain version with ``gamma=None`` against the JAX package's
    ``taylor_linear_attention(..., gamma=None)``: its XLA reference, and
    its Pallas kernel with ``apply_norm=False`` in interpret mode (N = 128,
    the least it takes). Then the route's launches composed on the CPU
    (qkv GEMM, core, out GEMM, no norm) equal the plain version."""
    heads, d, n, c = 4, 8, 128, 32
    x = _rand((2, n, c), 23)
    wqkv, wout = _rand((c, 3 * heads * d), 24, 0.1), _rand((heads * d, c),
                                                           25, 0.1)
    want = taylor_linear_attention(jnp.asarray(x), jnp.asarray(wqkv),
                                   jnp.asarray(wout), heads, d, impl=impl,
                                   interpret=True, gamma=None)
    got = ta.taylor_attention(torch.from_numpy(x), None, _t(wqkv.T),
                              _t(wout.T), heads, d)
    _close(got, want, atol=2e-4 if impl == 'fused' else ATOL)
    for dt in (torch.float32, torch.bfloat16):
        args = (torch.from_numpy(x).to(dt), None, _t(wqkv.T).to(dt),
                _t(wout.T).to(dt))
        assert torch.equal(ta.taylor_launches(*args, heads, d),
                           ta.taylor_attention_ref(*args, heads, d))


# ---- tokenizers ---------------------------------------------------------------

COND_STACKS = {
    'every_cond_type': dict(
        image_size=16, init_dim=8, codebook_size=64, dim_cond=4,
        layers=('residual', 'cond_residual', ('compress_space', 12),
                'cond_attend_space', 'cond_linear_attend_space',
                ('compress_time', 16), 'cond_attend_time', 'gateloop_time',
                'attend_time'),
        attn_heads=2, attn_dim_head=8, linear_attn_heads=2, **SERVE),
    'gateloop': dict(
        image_size=16, init_dim=8, codebook_size=64,
        layers=('residual', ('compress_time', 12), 'gateloop_time',
                'linear_attend_space'),
        linear_attn_heads=2, **SERVE),
    'cond_expansion_1_reflect': dict(
        image_size=16, init_dim=8, codebook_size=64, dim_cond=6,
        dim_cond_expansion_factor=1.0, pad_mode='reflect',
        layers=('cond_residual', ('compress_space', 16), 'cond_attend_space',
                ('compress_time', 16), 'cond_residual'),
        attn_heads=2, attn_dim_head=8, **SERVE),
}


def _pair(kwargs, seed):
    """A port tokenizer and the JAX one on its weights (through the
    bridge, which spares the JAX init)."""
    port = VideoTokenizer(device='cpu', seed=seed, **kwargs)
    basic.live_squeeze_excite_(port.module, torch.Generator().manual_seed(2))
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_import.jax_params_from_state_dict(port.config,
                                              port.state_dict()))), **kwargs)
    return port, jtok


@pytest.mark.parametrize('name', list(COND_STACKS))
def test_tiny_cond_tokenizers_match_jax(name):
    kwargs = COND_STACKS[name]
    port, jtok = _pair(kwargs, 3)
    rng = np.random.default_rng(26)
    video = rng.random((2, 5, 16, 16, 3), dtype=np.float32)
    cond = (rng.normal(size=(2, kwargs['dim_cond'])).astype(np.float32)
            if 'dim_cond' in kwargs else None)
    jcond = None if cond is None else jnp.asarray(cond)
    jv = jnp.asarray(video)
    np.testing.assert_allclose(port.encode(video, cond=cond).numpy(),
                               np.asarray(jtok.encode(jv, cond=jcond)),
                               atol=1e-5, rtol=0)
    codes_j, recon_j = jtok.forward(jv, cond=jcond, return_codes=True,
                                    return_recon=True)
    codes, recon = port.forward(video, cond=cond, return_codes=True,
                                return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-4,
                               rtol=0)
    flat = codes.reshape(2, -1)
    np.testing.assert_allclose(
        port.decode_from_code_indices(flat, cond=cond).numpy(),
        np.asarray(jtok.decode_from_code_indices(np.asarray(flat),
                                                 cond=jcond)),
        atol=1e-4, rtol=0)


def test_cond_is_required_and_checked():
    port = VideoTokenizer(device='cpu', seed=0,
                          **COND_STACKS['every_cond_type'])
    video = np.zeros((1, 5, 16, 16, 3), np.float32)
    with pytest.raises(AssertionError, match='cond'):
        port.tokenize(video)
    with pytest.raises(AssertionError, match='cond'):
        port.tokenize(video, cond=np.zeros((1, 5), np.float32))
    plain = VideoTokenizer(device='cpu', seed=0,
                           **COND_STACKS['gateloop'])
    with pytest.raises(ValueError, match='no layer'):
        plain.tokenize(video, cond=np.zeros((1, 4), np.float32))


@pytest.mark.parametrize('name', list(COND_STACKS))
def test_bridge_round_trip_is_exact_for_cond_layers(name):
    """JAX init params -> the port's state_dict -> the JAX package's own
    importer gives the same pytree bit for bit, and the state_dict fits
    the port exactly; the port's state_dict -> JAX params -> back is the
    identity."""
    kwargs = COND_STACKS[name]
    jtok = JaxTokenizer(seed=2, **kwargs)
    params = jax.tree.map(np.asarray, jtok.params)
    state = jax_import.state_dict_from_jax_params(jtok.config, params)
    back = jax_load_torch_state(jtok.config, state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    port = VideoTokenizer(device='cpu', seed=0, **kwargs)
    port.load_state_dict(state, strict=True)
    again = jax_import.state_dict_from_jax_params(
        port.config, jax_import.jax_params_from_state_dict(
            port.config, port.state_dict()))
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())


@pytest.mark.parametrize('name', ['tok_cond', 'tok_gateloop'])
def test_reference_fixtures(name):
    """The actual reference's checkpoint and outputs (tests/fixtures)
    through ``load_torch_state_dict``, at tests/test_torch_parity.py's
    tolerances."""
    f = np.load(DATA / f'{name}.npz')
    config = json.loads(bytes(f['config']).decode())
    state = {k[3:]: f[k] for k in f.files if k.startswith('sd.')}
    tok = VideoTokenizer(device='cpu', seed=0, **config)
    tok.load_torch_state_dict(state)
    video = np.moveaxis(f['video'], 1, -1)
    cond = f['cond'] if 'cond' in f.files else None
    cl = lambda a: np.moveaxis(a, 1, -1)
    np.testing.assert_allclose(tok.encode(video, cond=cond).numpy(),
                               cl(f['latents']), atol=2e-4, rtol=1e-3)
    codes = tok.tokenize(video, cond=cond)
    np.testing.assert_array_equal(codes.numpy(), f['codes'])
    np.testing.assert_allclose(
        tok.forward(video, cond=cond, return_recon=True).numpy(),
        cl(f['recon']), atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        tok.decode_from_code_indices(codes.reshape(codes.shape[0], -1),
                                     cond=cond).numpy(),
        cl(f['recon_from_codes']), atol=1e-3, rtol=0)
