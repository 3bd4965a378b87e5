"""The fused ResidualUnit of the port
(magvit2_pytorch_tpu_torch/ops/kernels/residual_unit.py) on the CPU.

- Its plain version against the JAX package's kernels B4
  (``residual_unit_wide.py``) and B5 (``residual_unit.py``) run in interpret
  mode, as tests/test_fused_residual_wide.py and tests/test_fused_residual.py
  run them, at those tests' tolerances.
- The module's dispatch: the environment gates, ``w_blocked``, and the
  outer residual added once.
- The lane-packed tokenizer against the JAX package's own ``lane_pack=True``
  path, with live SqueezeExcite gates (the init users get keeps every gate
  near 0, where no check would see the unit).

Inputs and weights come from numpy seeds; weights cross in each package's
layout. The CUDA kernel itself runs only on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.tokenizer_module import _compute_lane_pack_end
from magvit2_pytorch_tpu.models.torch_import import (
    load_torch_tokenizer_state_dict)
from magvit2_pytorch_tpu.ops.pallas.residual_unit import (
    fused_residual_unit as jax_fused_packed)
from magvit2_pytorch_tpu.ops.pallas.residual_unit_wide import (
    _residual_unit_xla_plain, fused_residual_unit_wide as jax_fused_wide)
from magvit2_pytorch_tpu.ops.resample import ResidualUnit as JaxResidualUnit
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    _apply, _residual_unit_entries, state_dict_from_jax_params)
from magvit2_pytorch_tpu_torch.ops.basic import live_squeeze_excite_
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, launch_counts, reset_launch_counts, residual_unit as ru)
from magvit2_pytorch_tpu_torch.ops.resample import ResidualUnit

torch.set_num_threads(1)

ENV = ('MAGVIT2_TPU_NO_FUSED_RU', 'MAGVIT2_TPU_NO_FUSED_RU_WIDE',
       'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS', 'MAGVIT2_TPU_NO_FUSED_RU_W64')
F32_ATOL = 2e-5      # the same float32 math summed in another order


@pytest.fixture(autouse=True)
def _no_fused_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _jax_params(rng, c):
    """Unit weights in the JAX layouts, at the JAX kernel tests' scales."""
    hidden = max(16, c // 2)
    n = lambda shape, s, shift=0.0: (rng.normal(size=shape) * s
                                     + shift).astype(np.float32)
    return (n((3, 3, 3, c, c), 0.05), n((c,), 0.1), n((c, c), 0.09),
            n((c,), 0.1), n((c, 1), 0.3), n((1,), 0.1), n((c, hidden), 0.15),
            n((hidden,), 0.1), n((hidden, c), 0.15), n((c,), 0.1, -2.0))


def _port_params(jp):
    """The same weights in the port's layouts (``residual_unit_ref``)."""
    conv_k, conv_b, pw_k, pw_b, tok_k, tok_b, gi_k, gi_b, go_k, go_b = jp
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(conv_k.transpose(4, 3, 0, 1, 2)), t(conv_b), t(pw_k.T),
            t(pw_b), t(tok_k.T), t(tok_b), t(gi_k.T), t(gi_b), t(go_k.T),
            t(go_b))


# test_fused_residual_wide.py:60,107 hold the Pallas kernel to its XLA twin
# at float32 1e-5 (1e-4 at C = 256) and bf16 rtol 3e-2 / atol 6e-2. Across
# the two frameworks each element may also differ by the spread between
# those two JAX versions: they sum the 27 C-term conv in other orders, and
# the kernel's bf16 sigmoid rounds three times where the twin rounds once
# (on these inputs 2 of 65536 bf16 elements lie outside 3e-2 / 6e-2 between
# the two JAX versions). float32 takes atol 2e-5, the port's tolerance for
# the same math summed in another order: at C = 128 the port and the twin
# each lie ~1.2e-5 from a float64 evaluation (measured).
TOL = {'float32': dict(rtol=1e-5, atol=2e-5),
       'bfloat16': dict(rtol=3e-2, atol=6e-2)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(2, 3, 16, 8, 128), (1, 4, 8, 16, 128),
                                   (2, 3, 16, 8, 64), (1, 3, 8, 8, 256)],
                         ids=['c128', 'c128_wide_w', 'c64', 'c256'])
def test_plain_b4_matches_jax_kernel(shape, dtype):
    """``residual_unit_ref`` and the B4 entry (CPU: the plain version)
    against the Pallas kernel in interpret mode and its XLA twin."""
    rng = np.random.default_rng(sum(shape))
    jp = _jax_params(rng, shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in jp]
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax_fused_wide(jx, *jargs, True), np.float32)
    twin = np.asarray(_residual_unit_xla_plain(jx, *jargs), np.float32)
    targs = [a.to(tdt) for a in _port_params(jp)]
    tx = torch.from_numpy(x).to(tdt)
    ref = ru.residual_unit_ref(tx, *targs)
    assert ref.dtype == tdt
    assert torch.equal(ru.fused_residual_unit_wide(tx, *targs), ref)
    tol = dict(TOL[dtype])
    if dtype == 'float32' and shape[-1] == 256:
        tol = dict(rtol=1e-4, atol=1e-4)
    spread = np.abs(want - twin)
    got = ref.float().numpy()
    for target in (want, twin):
        excess = (np.abs(got - target) - spread
                  - tol['atol'] - tol['rtol'] * np.abs(target))
        assert excess.max() <= 0, (
            f'{(excess > 0).sum()} elements beyond {tol} + the kernel-twin '
            f'spread, worst by {excess.max():.3g}')


@pytest.mark.parametrize('packed_io', [True, False], ids=['packed', 'unpacked'])
@pytest.mark.parametrize('shape', [(2, 3, 16, 4), (1, 4, 32, 8)])
def test_plain_b5_matches_jax_kernel(shape, packed_io):
    """The B5 entry on the lane-packed ``(B, T, H, W/2, 2C)`` view or the
    unpacked activation, against the Pallas kernel in interpret mode with
    the same ``packed_io`` (shapes of tests/test_fused_residual.py)."""
    b, t, h, w2 = shape
    c = 64
    rng = np.random.default_rng(7 + h)
    jp = _jax_params(rng, c)
    xb = rng.normal(size=(b, t, h, w2, 2 * c)).astype(np.float32)
    x = xb if packed_io else xb.reshape(b, t, h, 2 * w2, c)
    want = np.asarray(jax_fused_packed(jnp.asarray(x), *map(jnp.asarray, jp),
                                       True, packed_io))
    targs = _port_params(jp)
    got = ru.fused_residual_unit(torch.from_numpy(x), *targs,
                                 packed_io=packed_io)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the packed view is the same bytes as the unpacked activation
    unpacked = ru.fused_residual_unit_wide(
        torch.from_numpy(xb.reshape(b, t, h, 2 * w2, c)), *targs)
    assert torch.equal(got.reshape(unpacked.shape), unpacked)


@pytest.mark.parametrize('entry', ['wide', 'packed'])
def test_batch_boundary(entry):
    """No causal tap of batch element 1 reaches into element 0: a batch of
    two equals its second element alone (test_kernel_batch_ring_reset)."""
    rng = np.random.default_rng(11)
    targs = _port_params(_jax_params(rng, 64))
    both = torch.from_numpy(
        rng.normal(size=(2, 3, 16, 8, 64)).astype(np.float32))
    if entry == 'wide':
        fn = lambda v: ru.fused_residual_unit_wide(v, *targs)
    else:
        fn = lambda v: ru.fused_residual_unit(
            v.reshape(*v.shape[:3], 4, 128), *targs).reshape(v.shape)
    np.testing.assert_allclose(fn(both)[1:].numpy(), fn(both[1:]).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors both entries return the plain result, count no launch
    and never build the CUDA library."""
    rng = np.random.default_rng(12)
    targs = _port_params(_jax_params(rng, 64))
    x = torch.from_numpy(rng.normal(size=(1, 2, 8, 8, 64)).astype(np.float32))
    reset_launch_counts()
    ref = ru.residual_unit_ref(x, *targs)
    assert torch.equal(ru.fused_residual_unit_wide(x, *targs), ref)
    assert torch.equal(ru.fused_residual_unit(x, *targs, packed_io=False),
                       ref)
    counts = launch_counts()
    assert counts['residual_unit_wide'] == counts['residual_unit_packed'] == 0
    assert _build._lib is None


# ---- the module's dispatch ---------------------------------------------------


def _live_gate_out(params, rng):
    """Kaiming-uniform gate_out kernel, zero bias (numpy draws), so the SE
    gates sit near 0.5 (as ``live_squeeze_excite_`` does in the port)."""
    go = params['fn']['se']['gate_out']
    hidden, c = go['kernel'].shape
    bound = np.sqrt(6.0 / hidden)
    params['fn']['se']['gate_out'] = {
        'kernel': rng.uniform(-bound, bound, (hidden, c)).astype(np.float32),
        'bias': np.zeros(c, np.float32)}
    return params


@pytest.fixture(scope='module')
def unit64():
    """A JAX ResidualUnit(64) with live gates, the port's twin on bridged
    weights, an input, and the JAX module's output."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(1, 3, 16, 8, 64)).astype(np.float32)
    jmod = JaxResidualUnit(64, 3)
    params = jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    params = _live_gate_out(params, rng)
    want = np.asarray(jmod.apply({'params': params}, jnp.asarray(x)))
    state = {}
    _apply(state, _residual_unit_entries('u', ()), params)
    port = ResidualUnit(64, 3)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    return port, torch.from_numpy(x), want


ROUTES = [
    # (environment, w_blocked, the entry the module must call)
    ({}, False, None),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64'}, False, 'wide'),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '128,64'}, False, 'wide'),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '128'}, False, None),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64',
      'MAGVIT2_TPU_NO_FUSED_RU': '1'}, False, None),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64',
      'MAGVIT2_TPU_NO_FUSED_RU_WIDE': '1'}, False, None),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64',
      'MAGVIT2_TPU_NO_FUSED_RU_W64': '1'}, False, None),
    ({}, True, 'packed'),
    ({'MAGVIT2_TPU_FUSED_RU_WIDE_DIMS': '64'}, True, 'packed'),
    ({'MAGVIT2_TPU_NO_FUSED_RU': '1'}, True, None),
]


@pytest.mark.parametrize('env,w_blocked,route', ROUTES)
def test_module_dispatch(unit64, monkeypatch, env, w_blocked, route):
    """The JAX gates' conditions, read at call time: the module calls the
    entry the JAX module would engage, and every route gives the JAX
    module's output (a fused call adds x once, inside the entry)."""
    port, x, want = unit64
    calls = []
    for name, attr in (('wide', 'fused_residual_unit_wide'),
                       ('packed', 'fused_residual_unit')):
        real = getattr(ru, attr)
        monkeypatch.setattr(
            ru, attr, lambda *a, _r=real, _n=name, **k: (
                calls.append(_n), _r(*a, **k))[1])
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with torch.inference_mode():
        got = port(x, w_blocked=w_blocked)
    assert calls == ([route] if route else [])
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    if route:
        monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_RU', '1')
        with torch.inference_mode():
            unfused = port(x, w_blocked=w_blocked)
        np.testing.assert_allclose(got.numpy(), unfused.numpy(),
                                   atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize('case', ['kernel_size', 'pad_mode', 'streaming',
                                  'channels', 'dim', 'dtype'])
def test_gates_keep_the_kernel_limits(monkeypatch, case):
    """Whatever the environment asks, the gates refuse what the kernel does
    not take: a kernel other than (3, 3, 3), non-zero padding, streaming,
    C % 32 != 0, C != dim, a dtype other than float32 / bfloat16."""
    monkeypatch.setenv('MAGVIT2_TPU_FUSED_RU_WIDE_DIMS', '48,64')
    kw = dict(x=torch.zeros(1, 2, 4, 4, 64), dim=64, kernel_size=3,
              pad_mode='constant', streaming=False)
    assert ru.wide_eligible(**kw) and ru.fused_eligible(**kw, w_blocked=True)
    kw.update({
        'kernel_size': dict(kernel_size=(1, 3, 3)),
        'pad_mode': dict(pad_mode='reflect'),
        'streaming': dict(streaming=True),
        'channels': dict(x=torch.zeros(1, 2, 4, 4, 48), dim=48),
        'dim': dict(dim=32),
        'dtype': dict(x=torch.zeros(1, 2, 4, 4, 64, dtype=torch.float16)),
    }[case])
    assert not ru.wide_eligible(**kw)
    assert not ru.fused_eligible(**kw, w_blocked=True)


@pytest.mark.parametrize('c', [32, 128, 256])
def test_packed_gate_takes_only_the_64_channel_stem(monkeypatch, c):
    """B5 engages at C = 64 only, as the JAX gate (2 C == 128 lanes) does;
    a ``w_blocked`` unit of another width stays unfused."""
    x = torch.zeros(1, 2, 4, 4, c)
    assert not ru.fused_eligible(x, c, 3, w_blocked=True)
    assert ru.fused_eligible(torch.zeros(1, 2, 4, 4, 64), 64, 3,
                             w_blocked=True)
    calls = []
    real = ru.fused_residual_unit
    monkeypatch.setattr(ru, 'fused_residual_unit', lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    with torch.inference_mode():
        ResidualUnit(c, 3).eval()(x, w_blocked=True)
    assert calls == []


# ---- the lane-packed tokenizer -------------------------------------------------

LANE_PACK = dict(image_size=16, init_dim=64, codebook_size=64,
                 layers=('residual', 'compress_space', 'residual',
                         'attend_space'),
                 attn_heads=2, use_gan=False, perceptual_loss_weight=0.0,
                 lane_pack=True)


def test_lane_pack_tokenizer_matches_jax(monkeypatch):
    """``lane_pack=True`` with every ResidualUnit fused: the stem's units
    (encoder and decoder) take B5, the 128-channel ones B4, and the port on
    the CPU gives the JAX package's own lane-packed result with live gates:
    codes exact, recon within 1e-5."""
    monkeypatch.setenv('MAGVIT2_TPU_FUSED_RU_WIDE_DIMS', '64,128')
    port = VideoTokenizer(device='cpu', seed=0, **LANE_PACK)
    live_squeeze_excite_(port.module, torch.Generator().manual_seed(3))
    state = port.state_dict()
    assert state['encoder_layers.0.fn.4.net.2.bias'].abs().max() == 0
    assert state['encoder_layers.0.fn.4.net.2.weight'].std() > 0.1
    jtok = JaxTokenizer(seed=0, **LANE_PACK)
    assert _compute_lane_pack_end(jtok.config) == 1
    jtok.load_torch_state_dict({k: v.numpy() for k, v in state.items()})
    calls = []
    for name in ('fused_residual_unit_wide', 'fused_residual_unit'):
        real = getattr(ru, name)
        monkeypatch.setattr(ru, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    video = np.random.default_rng(14).random((1, 5, 16, 16, 3),
                                             dtype=np.float32)
    codes_p, recon_p = port.forward(video, return_codes=True,
                                    return_recon=True)
    assert sorted(calls) == ['fused_residual_unit'] * 2 + [
        'fused_residual_unit_wide'] * 2
    codes_j, recon_j = jtok.forward(jnp.asarray(video), return_codes=True,
                                    return_recon=True)
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon_p.numpy(), np.asarray(recon_j),
                               atol=1e-5, rtol=0)
    # the live gates are seen: the same weights with the users' SE init
    # decode to something else
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_RU', '1')
    plain = VideoTokenizer(device='cpu', seed=0, **LANE_PACK)
    assert (plain.forward(video, return_recon=True) - recon_p).abs().max() > 1e-3


def test_bridge_round_trips_the_lane_pack_config():
    """The JAX package's params do not depend on ``lane_pack``, and its
    lane-packed params cross to the port and back bit for bit."""
    jtok = JaxTokenizer(seed=2, **LANE_PACK)
    params = jax.tree.map(np.asarray, jtok.params)
    off = JaxTokenizer(seed=2, **{**LANE_PACK, 'lane_pack': False})
    jax.tree.map(np.testing.assert_array_equal, params,
                 jax.tree.map(np.asarray, off.params))
    state = state_dict_from_jax_params(jtok.config, params)
    back = load_torch_tokenizer_state_dict(jtok.config, state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b)
    port = VideoTokenizer(device='cpu', seed=0, **LANE_PACK)
    port.load_state_dict(state, strict=True)
    assert port.module.lane_pack_end == port.module.lane_pack_dec_end == 1


def test_default_device_is_the_card(monkeypatch):
    """``VideoTokenizer()`` without ``device`` runs on the card, and where
    there is none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VideoTokenizer(seed=0, image_size=8, init_dim=4, codebook_size=16,
                       layers=('residual',))


# ---- the five launches: routes, counters, the weight cache ---------------------


@pytest.mark.parametrize('c,dtype,route', [
    (64, torch.bfloat16, 'wgmma'), (128, torch.bfloat16, 'wgmma'),
    (256, torch.bfloat16, 'wgmma'), (512, torch.bfloat16, 'wgmma'),
    (96, torch.bfloat16, 'wmma'), (32, torch.bfloat16, 'wmma'),
    (128, torch.float32, 'f32'), (96, torch.float32, 'f32')])
def test_ru_conv_route(c, dtype, route):
    """Every flagship stage (C = 64 .. 512) takes TMA + wgmma in bf16; C %
    64 == 32 keeps WMMA; float32 the CUDA cores."""
    assert ru.ru_conv_route(c, dtype) == route


def test_ru_counters_name_the_routes_and_reset():
    names = {f'ru_{op}_{r}' for op in ('conv', 'pointwise')
             for r in ('wgmma', 'wmma', 'f32')}
    assert names <= set(launch_counts())
    ru.LAUNCHES['ru_conv_wgmma'] += 2
    ru.LAUNCHES['ru_pointwise_f32'] += 1
    assert launch_counts()['ru_conv_wgmma'] == 2
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


def test_relaid_conv_weight_is_cached_until_an_in_place_update():
    """The conv's B operand (C_out, 27 C_in), tap-major: cached per
    parameter and dtype; an in-place update (as an optimizer step or
    load_state_dict makes) re-lays it, and so does new storage."""
    c = 32
    conv = torch.nn.Parameter(torch.randn(c, c, 3, 3, 3), requires_grad=False)
    wr = ru.relaid_conv_weight(conv, torch.float32)
    tap = (2 * 3 + 0) * 3 + 1                     # dt = 2, dh = 0, dw = 1
    assert torch.equal(wr[:, tap * c:(tap + 1) * c], conv[:, :, 2, 0, 1])
    assert ru.relaid_conv_weight(conv, torch.float32) is wr
    wr16 = ru.relaid_conv_weight(conv, torch.bfloat16)
    assert wr16.dtype == torch.bfloat16 and wr16 is not wr
    with torch.no_grad():
        conv.mul_(2)
    again = ru.relaid_conv_weight(conv, torch.float32)
    assert again is not wr and torch.equal(again, 2 * wr)
    conv.data = torch.randn(c, c, 3, 3, 3)
    assert not torch.equal(ru.relaid_conv_weight(conv, torch.float32), again)
    with torch.inference_mode():              # no version counter: no cache
        frozen = torch.randn(c, c, 3, 3, 3)
        assert (ru.relaid_conv_weight(frozen, torch.float32)
                is not ru.relaid_conv_weight(frozen, torch.float32))


def test_relaid_conv_weight_after_a_data_update_needs_forgetting():
    """An update through ``param.data`` (as an EMA makes) leaves the
    parameter's version counter as it was; ``forget_relaid_weights``
    drops the cached re-lay, and the next call re-lays the new values."""
    c = 32
    conv = torch.nn.Parameter(torch.randn(c, c, 3, 3, 3))
    wr = ru.relaid_conv_weight(conv, torch.bfloat16)
    conv.data.mul_(0.5)
    ru.forget_relaid_weights()
    again = ru.relaid_conv_weight(conv, torch.bfloat16)
    assert again is not wr
    assert torch.equal(again, conv.detach().to(torch.bfloat16).permute(
        0, 2, 3, 4, 1).reshape(c, 27 * c))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(2, 3, 12, 12, 64), (1, 2, 8, 16, 96)],
                         ids=['ragged_c64', 'c96'])
def test_unit_launches_compose_to_the_plain_unit(shape, dtype):
    """The card's five launches (conv, 1x1, SE logits, SE reduction, gate +
    residual), each on its plain version, give ``residual_unit_ref``."""
    rng = np.random.default_rng(15)
    tdt = getattr(torch, dtype)
    targs = [a.to(tdt) for a in _port_params(_jax_params(rng, shape[-1]))]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
    got = ru.unit_launches(x, *targs)
    assert got.dtype == tdt
    assert torch.equal(got, ru.residual_unit_ref(x, *targs))


# the flagship's unit shapes (B, T, H, W): B4 at C = 128 .. 512, B5 at 64
@pytest.mark.parametrize('b,t,h,w', [(8, 20, 128, 128), (8, 20, 64, 64),
                                     (8, 20, 32, 32), (8, 20, 16, 16),
                                     (8, 10, 16, 16), (8, 5, 16, 16),
                                     (1, 3, 12, 12), (2, 1, 8, 8)])
def test_se_slices_cover_each_frame_once(b, t, h, w):
    """The partial contexts cut each frame into slices of equal size but
    the last, none empty, and at the flagship shapes into at least two
    blocks an SM of the H100 (264); their sums in order equal the frame's
    context. The cut depends on the frame alone, not on the batch."""
    frames, hw = b * t, h * w
    s = ru.se_slices(hw)
    per = -(-hw // s)
    assert 1 <= s <= hw and (s - 1) * per < hw <= s * per
    if b == 8:
        assert frames * s >= 2 * 132
    rng = np.random.default_rng(16)
    y = torch.from_numpy(rng.normal(size=(frames, hw, 8)).astype(np.float32))
    attn = torch.softmax(torch.from_numpy(
        rng.normal(size=(frames, hw)).astype(np.float32)), dim=-1)
    parts = [(attn[:, i * per:(i + 1) * per, None]
              * y[:, i * per:(i + 1) * per]).sum(1) for i in range(s)]
    np.testing.assert_allclose(sum(parts).numpy(),
                               (attn[..., None] * y).sum(1).numpy(),
                               rtol=1e-5, atol=1e-6)
