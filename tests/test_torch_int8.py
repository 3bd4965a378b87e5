"""The port's int8 inference (``MAGVIT2_TPU_INT8_CONV=1``) against the JAX
package on the CPU, at ``tests/test_int8.py``'s sizes (image_size 16,
init_dim 128).

On the CPU the int8 kernels' wrappers run their plain versions
(``ops/kernels/int8.py``), which do what the kernels do: the per-tensor
quantizer, the exact int32 conv and the dequantizing epilogue. Held here:

- both quantizers equal to the JAX package's to the bit, .5 boundaries and
  an all-zero tensor included;
- each int8 site (the causal conv, the 1x1, the spatial down- and
  upsampler, the unfused ResidualUnit), dynamic and static on the same
  scales: float32 outputs equal to the bit, bf16 within one bf16 step;
- the gate (channel minimum, streaming, pad mode, the environment read at
  every call, ``MAGVIT2_TPU_INT8_PACKED`` under ``lane_pack``);
- ``calibrate_int8``: the site count, each site's scale, the percentile,
  several batches, a config without sites, the environment after it;
- the JAX collection bridge, ``copy_for_eval``, the trainer's refusal, and a
  tiny tokenizer's int8 codes against JAX's.

JAX's percentile calibration records the absmax at its ``Conv3d1x1`` sites
(its ``conv.py:609``, ROADMAP C5); the port records the percentile there,
as the JAX docstring says, so those sites' scales are at most JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.tokenizer import _build_int8_collection
from magvit2_pytorch_tpu.ops import conv as jconv
from magvit2_pytorch_tpu.ops import resample as jresample
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    TRANSFORMS, int8_state_from_jax, jax_int8_from_state,
    jax_params_from_state_dict)
from magvit2_pytorch_tpu_torch.models.streaming import tokenize_streaming
from magvit2_pytorch_tpu_torch.ops import conv as pconv
from magvit2_pytorch_tpu_torch.ops.basic import (
    Linear, init_module_parameters, live_squeeze_excite_)
from magvit2_pytorch_tpu_torch.ops.kernels import int8 as k8
from magvit2_pytorch_tpu_torch.ops.resample import (
    ResidualUnit, SpatialDownsample2x, SpatialUpsample2x)

torch.set_num_threads(1)

ENV = 'MAGVIT2_TPU_INT8_CONV'
KW = dict(image_size=16, init_dim=128, codebook_size=64,
          layers=(('residual', 128), ('compress_space', 128)),
          use_gan=False, perceptual_loss_weight=0.0)
# the 44-site stack in miniature: units at 128 and 256, a 128 -> 256
# downsampler and a 256 -> 128 upsampler
KW_TWO = dict(KW, layers=(('residual', 128), ('compress_space', 256),
                          ('residual', 256)))


@pytest.fixture
def int8_env(monkeypatch):
    monkeypatch.setenv(ENV, '1')
    monkeypatch.delenv('MAGVIT2_TPU_INT8_PACKED', raising=False)
    monkeypatch.delenv('MAGVIT2_TPU_INT8_CALIB_PCT', raising=False)
    monkeypatch.delenv('MAGVIT2_TPU_FUSED_RU_WIDE_DIMS', raising=False)


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_steps(a, b):
    """|a - b| in bf16 steps, elementwise (both hold bf16 values)."""
    def ordered(x):
        bits = torch.tensor(np.asarray(x, np.float32)).to(
            torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (ordered(a) - ordered(b)).abs()


def _same(got, want, dtype):
    """float32: equal to the bit; bf16: within one bf16 step."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_array_equal(got, want)
    else:
        assert int(_bf16_steps(got, want).max()) <= 1


# -- quantizers ---------------------------------------------------------------


def _half_boundaries():
    # s = 7.9375 / 127 = 2^-4 exactly, so x / s = k + 0.5 exactly
    k = np.arange(-127, 127, dtype=np.float32)
    return np.concatenate([(k + 0.5) * 0.0625, [7.9375, -7.9375]]).astype(
        np.float32)


@pytest.mark.parametrize('case', ['normal', 'half_boundaries', 'zeros',
                                  'normal_bf16'])
def test_quantize_per_tensor_is_jax_to_the_bit(case):
    if case == 'half_boundaries':
        x = _half_boundaries()
    elif case == 'zeros':
        x = np.zeros((4, 33), np.float32)
    else:
        x = (_rng(0).standard_normal((3, 5, 7, 11)) * 3).astype(np.float32)
    jx = jnp.asarray(x)
    px = torch.from_numpy(x)
    if case == 'normal_bf16':
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    jq, js = jconv._quantize_per_tensor(jx)
    pq, ps = pconv.quantize_per_tensor(px)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert ps.item() == float(js)
    if case == 'half_boundaries':       # round half to even: 0.5 -> 0 ...
        assert set(np.abs(pq.numpy()[:-2]) % 2) == {0}
    if case == 'zeros':
        assert not pq.any() and ps.item() == np.float32(1e-12) / np.float32(
            127)


def test_static_scale_quantize_clips_as_jax():
    """The static path: x / scale past +-127 saturates (the JAX package's
    ``jnp.clip(jnp.round(x / xs), -127, 127)``)."""
    x = _half_boundaries() * 3
    xs = np.float32(0.03125)
    want = np.clip(np.round(jnp.asarray(x) / xs), -127, 127).astype(np.int8)
    got, scale = pconv.quantize_per_tensor(torch.from_numpy(x),
                                           torch.tensor(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert scale.item() == xs and got.max() == 127 and got.min() == -127


@pytest.mark.parametrize('shape', [(3, 3, 3, 16, 8), (1, 3, 3, 8, 4),
                                   (16, 24)])
def test_quantize_per_channel_out_is_jax_to_the_bit(shape):
    k = (_rng(1).standard_normal(shape) * 0.2).astype(np.float32)
    k[..., 0] = 0.0                      # an all-zero output channel
    jq, js = jconv._quantize_per_channel_out(jnp.asarray(k))
    # the port's layout: the output channel first
    order = (k.ndim - 1, *range(k.ndim - 1))
    pq, ps = pconv.quantize_per_channel_out(
        torch.from_numpy(np.ascontiguousarray(k.transpose(order))))
    np.testing.assert_array_equal(pq.numpy(),
                                  np.asarray(jq).transpose(order))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_conv_accumulators_are_exact():
    """The plain version of K2's accumulators against an int64 sum of the
    taps, at the causal conv and the stride-2 downsampler."""
    xq = torch.from_numpy(_rng(2).integers(-127, 128, (1, 2, 5, 5, 16),
                                           dtype=np.int8))
    for wshape, stride in (((8, 16, 3, 3, 3), 1), ((8, 16, 1, 3, 3), 2)):
        wq = torch.from_numpy(_rng(3).integers(-127, 128, wshape,
                                               dtype=np.int8))
        acc = k8.conv_s8_ref(xq, wq, stride)
        kt, kh, kw = wshape[2:]
        x = torch.nn.functional.pad(
            xq.long(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0))
        b, t, ho, wo, n = acc.shape
        want = torch.zeros(acc.shape, dtype=torch.long)
        for dt in range(kt):
            for dh in range(kh):
                for dw in range(kw):
                    patch = x[:, dt:dt + t,
                              dh:dh + stride * (ho - 1) + 1:stride,
                              dw:dw + stride * (wo - 1) + 1:stride]
                    want += torch.einsum('bthwc,nc->bthwn', patch,
                                         wq[:, :, dt, dh, dw].long())
        assert acc.dtype == torch.int32
        assert torch.equal(acc.long(), want)


# -- sites --------------------------------------------------------------------


def _site(kind):
    """(JAX module, its params, the port module on the same weights, the
    input's channel count, whether JAX records a calibration there)."""
    jkey = jax.random.PRNGKey(0)
    if kind == 'causal_conv':
        jm = jconv.CausalConv3d(features=128, kernel_size=3)
        pm = pconv.CausalConv3d(128, 128, 3)
        c = 128
    elif kind == 'pointwise':
        jm, pm, c = jconv.Conv3d1x1(features=128), Linear(
            128, 128, int8_site=True), 128
    elif kind == 'downsample':
        jm = jresample.SpatialDownsample2x(dim=128, dim_out=256)
        pm, c = SpatialDownsample2x(128, 256), 128
    else:
        jm = jresample.SpatialUpsample2x(dim=256, dim_out=128)
        pm, c = SpatialUpsample2x(256, 128), 256
    x0 = jnp.zeros((1, 2, 8, 8, c))
    params = jax.tree.map(np.asarray, jm.init(jkey, x0))
    p = params['params']
    with torch.no_grad():
        if kind == 'causal_conv':
            pm.conv.weight.copy_(torch.from_numpy(
                TRANSFORMS['conv3d'][0](p['kernel']).copy()))
            pm.conv.bias.copy_(torch.from_numpy(p['bias'].copy()))
        elif kind == 'pointwise':
            pm.weight.copy_(torch.from_numpy(p['kernel'].T.copy()))
            pm.bias.copy_(torch.from_numpy(p['bias'].copy()))
        elif kind == 'downsample':
            pm.conv.weight.copy_(torch.from_numpy(
                TRANSFORMS['conv2d_from3d'][0](p['kernel']).copy()))
            pm.conv.bias.copy_(torch.from_numpy(p['bias'].copy()))
        else:
            # trained-looking weights, unequal across the 4 positions, so
            # the bridge's flip over p matters; a bias that is not zero
            kern = (_rng(4).standard_normal(p['kernel'].shape) * 0.05).astype(
                np.float32)
            bias = (_rng(5).standard_normal(p['bias'].shape) * 0.1).astype(
                np.float32)
            params = {'params': {'kernel': kern, 'bias': bias}}
            pm.net[0].weight.copy_(torch.from_numpy(
                TRANSFORMS['upsample_space'][0](kern).copy()))
            pm.net[0].bias.copy_(torch.from_numpy(bias))
    return jm, params, pm, c, kind != 'upsample'


def _x(c, dtype, seed=6):
    x = (_rng(seed).standard_normal((2, 3, 8, 8, c)) * 0.5).astype(
        np.float32)
    jx = jnp.asarray(x)
    px = torch.from_numpy(x)
    if dtype == torch.bfloat16:
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    return jx, px


def _port(pm, px, dtype, site_output=False):
    """The port module's output; with ``site_output`` the spatial
    upsampler's before its SiLU, with JAX's SiLU applied (the two
    packages' SiLU differ in the last bit of float32)."""
    with torch.inference_mode():
        pm = pm.to(dtype)
        if not (site_output and isinstance(pm, SpatialUpsample2x)):
            return pm(px)
        y = pm.project(px)
    silu = jax.nn.silu(jnp.asarray(y.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    return torch.from_numpy(np.array(silu.astype(jnp.float32)))


SITES = ['causal_conv', 'pointwise', 'downsample', 'upsample']


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', SITES)
def test_dynamic_site_matches_jax(int8_env, kind, dtype):
    jm, params, pm, c, _ = _site(kind)
    jx, px = _x(c, dtype)
    want = jm.apply(params, jx)
    got = _port(pm, px, dtype, site_output=True)
    _same(got, want, dtype)
    got = _port(pm, px, dtype)
    os.environ[ENV] = '0'                    # int8 engaged: bf16 differs
    assert not torch.equal(_port(pm, px, dtype), got)


def _site_of(coll, kind):
    """The port's ``Int8Site`` from a JAX module's own ``int8`` entry."""
    transform = {'causal_conv': 'conv3d', 'pointwise': 'dense',
                 'downsample': 'conv2d_from3d'}[kind]
    return pconv.Int8Site(
        torch.tensor(np.float32(coll['act_scale'])),
        torch.from_numpy(np.ascontiguousarray(
            TRANSFORMS[transform][0](np.asarray(coll['kernel_q'])))),
        torch.from_numpy(np.asarray(coll['kernel_scale'])))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', SITES[:3])
def test_static_site_matches_jax(int8_env, kind, dtype):
    """JAX calibrates the module on one input and runs another on the
    static scales; the port runs on the same scales (carried across), and
    its own record of the first input is JAX's."""
    jm, params, pm, c, _ = _site(kind)
    jx_cal, px_cal = _x(c, torch.float32, seed=7)
    _, mut = jm.apply(params, jx_cal, mutable=['int8_calib'])
    coll = _build_int8_collection(mut['int8_calib'], params['params'])
    jx, px = _x(c, dtype)
    want = jm.apply({'params': params['params'], 'int8': coll}, jx)
    with pconv.int8_scope(sites={pm: _site_of(coll, kind)}):
        got = _port(pm, px, dtype)
    _same(got, want, dtype)
    record = {}
    with pconv.int8_scope(record=record):
        _port(pm.float(), px_cal, torch.float32)
    assert record[pm].item() == float(mut['int8_calib']['absmax'])


def test_upsampler_has_no_calibration_site(int8_env):
    jm, params, pm, c, _ = _site('upsample')
    jx, px = _x(c, torch.float32)
    _, mut = jm.apply(params, jx, mutable=['int8_calib'])
    assert not mut.get('int8_calib')
    record = {}
    with pconv.int8_scope(record=record):
        _port(pm, px, torch.float32)
    assert record == {}


def _unit_pair(dim=128):
    jm = jresample.ResidualUnit(dim, 3)
    x0 = jnp.zeros((1, 3, 8, 8, dim))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x0))
    pm = ResidualUnit(dim, 3)
    fn = params['params']['fn']
    # a live SqueezeExcite gate, so the branch shows in the output
    fn['se']['gate_out']['kernel'] = (
        _rng(8).standard_normal(fn['se']['gate_out']['kernel'].shape)
        * 0.2).astype(np.float32)
    fn['se']['gate_out']['bias'] = np.zeros_like(fn['se']['gate_out']['bias'])
    state = {
        'fn.0.conv.weight': TRANSFORMS['conv3d'][0](fn['conv']['kernel']),
        'fn.0.conv.bias': fn['conv']['bias'],
        'fn.2.weight': fn['conv_pointwise']['kernel'].T,
        'fn.2.bias': fn['conv_pointwise']['bias'],
        'fn.4.to_k.weight': fn['se']['to_k']['kernel'].T,
        'fn.4.to_k.bias': fn['se']['to_k']['bias'],
        'fn.4.net.0.weight': fn['se']['gate_in']['kernel'].T,
        'fn.4.net.0.bias': fn['se']['gate_in']['bias'],
        'fn.4.net.2.weight': fn['se']['gate_out']['kernel'].T,
        'fn.4.net.2.bias': fn['se']['gate_out']['bias'],
    }
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in state.items()})
    return jm, params, pm


def test_residual_unit_dispatch_matches_jax(int8_env):
    """The unfused unit reaches both sites, dynamic and static; the fused
    unit (B4) ignores int8, as the JAX package's does. The unit's other
    ops (ELU, the SqueezeExcite) differ from JAX's in float32's last bit,
    so the unit is held within 1e-6 (its sites are equal to the bit)."""
    jm, params, pm = _unit_pair()
    jx, px = _x(128, torch.float32)
    record = {}
    with pconv.int8_scope(record=record):
        got = _port(pm, px, torch.float32)
    assert set(record) == {pm.fn[0], pm.fn[2]}
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jx)),
                               atol=1e-6, rtol=0)
    _, mut = jm.apply(params, jx, mutable=['int8_calib'])
    assert set(mut['int8_calib']['fn']) == {'conv', 'conv_pointwise'}
    coll = _build_int8_collection(mut['int8_calib'], params['params'])
    sites = {pm.fn[0]: _site_of(coll['fn']['conv'], 'causal_conv'),
             pm.fn[2]: _site_of(coll['fn']['conv_pointwise'], 'pointwise')}
    jx2, px2 = _x(128, torch.float32, seed=9)
    with pconv.int8_scope(sites=sites):
        got = _port(pm, px2, torch.float32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jm.apply(
            {'params': params['params'], 'int8': coll}, jx2)),
        atol=1e-6, rtol=0)
    os.environ['MAGVIT2_TPU_FUSED_RU_WIDE_DIMS'] = '128'
    try:
        fused_int8 = _port(pm, px, torch.float32)
        os.environ[ENV] = '0'
        assert torch.equal(fused_int8, _port(pm, px, torch.float32))
    finally:
        os.environ.pop('MAGVIT2_TPU_FUSED_RU_WIDE_DIMS')


# -- the gate -----------------------------------------------------------------


def test_gate_respects_channel_minimum(int8_env):
    assert pconv.int8_conv_enabled(128, 128)
    assert pconv.int8_conv_enabled() == jconv.int8_conv_enabled()
    for c_in, c_out in ((64, 128), (128, 64), (127, 512)):
        assert not pconv.int8_conv_enabled(c_in, c_out)
        assert not jconv.int8_conv_enabled(c_in, c_out)
    # a 64-channel conv stays in the working dtype
    conv = pconv.CausalConv3d(64, 128, 3)
    init_module_parameters(conv, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(64, torch.float32)[1].numpy())
    on = _port(conv, x, torch.float32)
    os.environ[ENV] = '0'
    assert torch.equal(on, _port(conv, x, torch.float32))


def test_gate_reads_the_environment_at_every_call(monkeypatch):
    """No cache keyed on the environment (ROADMAP C5): the same module
    turns int8 on and off between calls."""
    monkeypatch.delenv(ENV, raising=False)
    _, _, pm, c, _ = _site('causal_conv')
    _, px = _x(c, torch.float32)
    off = _port(pm, px, torch.float32)
    monkeypatch.setenv(ENV, '1')
    on = _port(pm, px, torch.float32)
    monkeypatch.setenv(ENV, '0')
    assert torch.equal(_port(pm, px, torch.float32), off)
    assert not torch.equal(on, off)


@pytest.mark.parametrize('pad_mode', ['reflect', 'replicate'])
def test_gate_refuses_other_pad_modes_as_jax(int8_env, pad_mode):
    conv = pconv.CausalConv3d(128, 128, 3, pad_mode=pad_mode)
    jconv_m = jconv.CausalConv3d(features=128, kernel_size=3,
                                 pad_mode=pad_mode)
    jx, px = _x(128, torch.float32)
    params = jconv_m.init(jax.random.PRNGKey(0), jx)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            TRANSFORMS['conv3d'][0](np.asarray(params['params']['kernel'])))))
        conv.conv.bias.copy_(torch.from_numpy(
            np.asarray(params['params']['bias'])))
    on = _port(conv, px, torch.float32)
    os.environ[ENV] = '0'
    assert torch.equal(on, _port(conv, px, torch.float32))
    np.testing.assert_allclose(on.numpy(),
                               np.asarray(jconv_m.apply(params, jx)),
                               atol=1e-4)


def test_gate_refuses_streaming(int8_env):
    """A causal conv with a stream's state runs in the working dtype, as
    the JAX gate refuses ``streaming``; inside a stream's scope no site
    quantizes."""
    _, _, pm, c, _ = _site('causal_conv')
    _, px = _x(c, torch.float32)
    with torch.inference_mode():
        streamed = pm(px, state={})
    _, _, pw, _, _ = _site('pointwise')
    with pconv.int8_scope(streaming=True):
        pw_streamed = _port(pw, px, torch.float32)
    os.environ[ENV] = '0'
    assert torch.equal(streamed, _port(pm, px, torch.float32))
    assert torch.equal(pw_streamed, _port(pw, px, torch.float32))


def test_packed_int8_under_lane_pack_is_not_ported(int8_env, monkeypatch):
    """The packed int8 stem unit against JAX's (the name is the one it had
    while the port raised there). ``MAGVIT2_TPU_INT8_PACKED=1``: the
    unfused stem unit (64 channels, ``w_blocked``) quantizes its causal
    conv at the packed widths (128 -> 128), as the JAX package's unit does
    on the w-blocked layout; its 1x1
    stays in the working dtype on both. Dynamic and static on JAX's scales,
    against JAX's unit on ``w_block(x)``, held within 1e-6 as the unfused
    unit above (the int8 site is equal to the bit: the blocked kernel's
    per-channel scales and int8 values are the unblocked kernel's). Without
    the variable, or not w-blocked, the unit runs in the working dtype."""
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_RU', '1')   # the unfused unit
    jm, params, pm = _unit_pair(64)
    jx, px = _x(64, torch.float32)
    plain = _port(pm, px, torch.float32)
    assert torch.equal(_port(pm, px, torch.float32), plain)
    with torch.inference_mode():
        assert torch.equal(pm(px, w_blocked=True), plain)   # PACKED unset
    monkeypatch.setenv('MAGVIT2_TPU_INT8_PACKED', '1')
    assert torch.equal(_port(pm, px, torch.float32), plain)   # not blocked
    record = {}
    with torch.inference_mode(), pconv.int8_scope(record=record):
        got = pm(px, w_blocked=True)
    assert set(record) == {pm.fn[0]}
    assert not torch.equal(got, plain)

    def jax_unit(variables, x):
        y = jm.apply(variables, jconv.w_block(x), w_blocked=True)
        return np.asarray(jconv.w_unblock(y))

    np.testing.assert_allclose(got.numpy(), jax_unit(params, jx), atol=1e-6,
                               rtol=0)
    _, mut = jm.apply(params, jconv.w_block(jx), w_blocked=True,
                      mutable=['int8_calib'])
    assert set(mut['int8_calib']['fn']) == {'conv'}
    assert record[pm.fn[0]].item() == float(
        mut['int8_calib']['fn']['conv']['absmax'])
    coll = _build_int8_collection(mut['int8_calib'], params['params'])
    site = _site_of(coll['fn']['conv'], 'causal_conv')
    jx2, px2 = _x(64, torch.float32, seed=9)
    with torch.inference_mode(), pconv.int8_scope(sites={pm.fn[0]: site}):
        got = pm(px2, w_blocked=True)
    np.testing.assert_allclose(
        got.numpy(), jax_unit({'params': params['params'], 'int8': coll}, jx2),
        atol=1e-6, rtol=0)


# -- the tokenizer ------------------------------------------------------------


def _pair(kwargs=KW, live=True):
    port = VideoTokenizer(device='cpu', seed=0, **kwargs)
    if live:
        live_squeeze_excite_(port.module, torch.Generator().manual_seed(0))
    params = jax_params_from_state_dict(port.config, port.state_dict())
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, params), **kwargs)
    return jtok, port


def _video(seed, b=2):
    return _rng(seed).uniform(size=(b, 2, 16, 16, 3)).astype(np.float32)


def _scales(state):
    return {name: site.act_scale.item() for name, site in state.items()}


def test_calibration_matches_jax(int8_env):
    """Site count, each site's scale and its pre-quantized weight, over an
    iterable of two batches; then the static roundtrip's codes."""
    jtok, port = _pair(KW_TWO)
    videos = [_video(10), _video(11)]
    n_jax = jtok.calibrate_int8([jnp.asarray(v) for v in videos])
    n_port = port.calibrate_int8(iter(videos))
    # units at 128 and 256 (conv + 1x1 each, encoder and decoder) and the
    # downsampler; the upsampler stays dynamic
    assert n_port == n_jax == 9
    want = int8_state_from_jax(port.config, jax.tree.map(
        np.asarray, jtok._int8_vars))
    assert set(want) == set(port._int8_vars)
    for name, site in port._int8_vars.items():
        ref = want[name]
        assert abs(site.act_scale.item() / ref.act_scale.item() - 1) < 1e-6
        assert torch.equal(site.kernel_q, ref.kernel_q), name
        assert torch.equal(site.kernel_scale, ref.kernel_scale), name
    v = _video(12)
    codes_j = np.asarray(jtok.forward(jnp.asarray(v), return_codes=True))
    np.testing.assert_array_equal(port.tokenize(v).numpy(), codes_j)


def test_percentile_calibration(int8_env):
    """With ``percentile`` the causal conv and downsampler sites equal
    JAX's; the 1x1 sites record the percentile (JAX: the absmax, ROADMAP
    C5), so theirs are at most JAX's, and below it here."""
    jtok, port = _pair(KW_TWO)
    v = _video(13)
    jtok.calibrate_int8(jnp.asarray(v), percentile=99.0)
    port.calibrate_int8(v, percentile=99.0)
    want = _scales(int8_state_from_jax(port.config, jax.tree.map(
        np.asarray, jtok._int8_vars)))
    got = _scales(port._int8_vars)
    modules = dict(port.module.named_modules())
    pointwise = [n for n in got if isinstance(modules[n], Linear)]
    assert len(pointwise) == 4
    for name, scale in got.items():
        if name in pointwise:
            assert scale < want[name]
        else:
            assert abs(scale / want[name] - 1) < 1e-6, name
    absmax = _scales({} if port.calibrate_int8(v) == 0 else port._int8_vars)
    assert all(got[n] <= absmax[n] for n in got)


def test_calibration_with_no_sites_keeps_the_dynamic_path(int8_env):
    kwargs = dict(KW, init_dim=8, layers=(('residual', 8),
                                          ('compress_space', 16)))
    jtok, port = _pair(kwargs, live=False)
    v = _video(14, b=1)
    assert port.calibrate_int8(v) == jtok.calibrate_int8(jnp.asarray(v)) == 0
    assert port._int8_vars is None and port._int8_active is None
    assert torch.isfinite(port.forward(v)).all()


def test_environment_after_calibration(monkeypatch):
    """calibrate_int8 turns the gate on for its own pass and restores the
    environment; with it off the calibrated tokenizer runs the plain
    path."""
    monkeypatch.delenv(ENV, raising=False)
    _, port = _pair()
    v = _video(15, b=1)
    plain = port.forward(v)
    assert port.calibrate_int8(v) == 5
    assert ENV not in os.environ and port._int8_active is None
    assert torch.equal(port.forward(v), plain)
    monkeypatch.setenv(ENV, '1')
    assert port._int8_active is port._int8_vars
    assert not torch.equal(port.forward(v), plain)


def test_int8_state_bridge_round_trip(int8_env):
    _, port = _pair()
    port.calibrate_int8(_video(16))
    coll = jax_int8_from_state(port.config, port._int8_vars)
    back = int8_state_from_jax(port.config, coll)
    assert set(back) == set(port._int8_vars)
    for name, site in port._int8_vars.items():
        for key in ('act_scale', 'kernel_q', 'kernel_scale'):
            assert torch.equal(getattr(back[name], key), getattr(site, key))
    # the JAX package runs on the carried scales as the port does
    jtok, _ = _pair()
    jtok._int8_vars = jax.tree.map(jnp.asarray, coll)
    v = _video(17)
    np.testing.assert_array_equal(
        port.tokenize(v).numpy(),
        np.asarray(jtok.forward(jnp.asarray(v), return_codes=True)))


def test_copy_for_eval_carries_the_calibration(int8_env):
    _, port = _pair()
    v = _video(18)
    port.calibrate_int8(v)
    clone = port.copy_for_eval()
    assert clone._int8_vars is port._int8_vars
    assert torch.equal(clone.forward(v), port.forward(v))


@pytest.mark.parametrize('mode', ['dynamic', 'static'])
def test_tiny_tokenizer_int8_codes_match_jax(int8_env, mode):
    jtok, port = _pair()
    v = _video(19)
    if mode == 'static':
        assert jtok.calibrate_int8(jnp.asarray(v)) == port.calibrate_int8(v)
    jv = jnp.asarray(v)
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes, recon = port.forward(v, return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(
        port.decode_from_code_indices(codes.reshape(2, -1)).numpy(),
        recon.numpy())
    # int8 engaged
    os.environ[ENV] = '0'
    assert not torch.equal(port.forward(v), recon)


# the lane-packed stem: a 64-channel unit before the first compress_space,
# then a unit at 128 (KW_TWO's 128 -> 256 in miniature one stage down)
KW_PACKED = dict(KW, init_dim=64, lane_pack=True,
                 layers=(('residual', 64), ('compress_space', 128),
                         ('residual', 128)))


@pytest.mark.parametrize('mode', ['dynamic', 'static'])
def test_packed_int8_tokenizer_matches_jax(int8_env, monkeypatch, mode):
    """``lane_pack=True`` with ``MAGVIT2_TPU_INT8_PACKED=1`` and the fused
    units off: the JAX package's int8 sites are the units at 128 (conv and
    1x1, encoder and decoder) and, packed, the stem units' causal convs
    (encoder and decoder): 6, against 4 without the variable, on both. The
    codes are JAX's and the reconstruction within the 1e-5 of the unpacked
    tokenizer's test above, dynamic and calibrated. (The JAX package reads
    the variable when it traces, so each setting gets its own JAX
    tokenizer.)"""
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_RU', '1')
    v = _video(21)
    jv = jnp.asarray(v)
    if mode == 'static':
        jtok, port = _pair(KW_PACKED)
        assert port.calibrate_int8(v) == jtok.calibrate_int8(jv) == 4
    monkeypatch.setenv('MAGVIT2_TPU_INT8_PACKED', '1')
    jtok, port = _pair(KW_PACKED)
    if mode == 'static':
        assert port.calibrate_int8(v) == jtok.calibrate_int8(jv) == 6
        stem = port.module.encoder_layers[0].fn[0]
        assert set(port._int8_vars) >= {'encoder_layers.0.fn.0'}
        assert stem.conv.weight.shape[:2] == (64, 64)
    v = _video(22)
    jv = jnp.asarray(v)
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes, recon = port.forward(v, return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-5,
                               rtol=0)
    monkeypatch.delenv('MAGVIT2_TPU_INT8_PACKED')     # the stem engaged
    assert not torch.equal(port.forward(v), recon)


def test_stream_runs_in_the_working_dtype(int8_env):
    """A stream with the environment on gives the codes of a whole clip
    without int8."""
    kwargs = dict(KW, layers=(('residual', 128), ('compress_space', 128),
                              ('compress_time', 128)))
    port = VideoTokenizer(device='cpu', seed=0, **kwargs)
    v = _rng(20).uniform(size=(1, 5, 16, 16, 3)).astype(np.float32)
    port.calibrate_int8(v)
    streamed = tokenize_streaming(port, torch.from_numpy(v), chunk_frames=2)
    os.environ[ENV] = '0'
    np.testing.assert_array_equal(streamed.numpy(), port.tokenize(v).numpy())


def test_trainer_refuses_int8_env(int8_env, tmp_path):
    from magvit2_pytorch_tpu_torch.training.trainer import (
        VideoTokenizerTrainer)
    port = VideoTokenizer(device='cpu', seed=0, **KW)

    class DS:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.zeros((2, 16, 16, 3), np.float32)

    with pytest.raises(RuntimeError, match='inference-only'):
        VideoTokenizerTrainer(
            port, batch_size=8, num_train_steps=1, dataset=DS(),
            valid_frac=0.0, warmup_steps=1,
            checkpoints_folder=str(tmp_path / 'ck'),
            results_folder=str(tmp_path / 'res'))
