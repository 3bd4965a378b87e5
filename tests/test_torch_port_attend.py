"""The port's attention op and general ``Attention`` path on the CPU, against
the JAX package: the plain ``attend`` against ``attend(backend='xla')``, the
flash wrapper's plain forward and backward against the Pallas kernels in
interpret mode (as tests/test_flash_attention.py runs them), the autograd
wiring, rotary positions, the modules' general path (flash backend, rotary,
key-padding mask, a head size the block kernel does not take), attention
dropout, and a tokenizer with rotary positions. Inputs come from numpy
seeds. Tolerances are stated at each test: float32 differences are the same
math summed in another order. The CUDA kernels themselves run only on the
card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.torch_import import (
    load_torch_tokenizer_state_dict)
from magvit2_pytorch_tpu.ops import attention as jattention
from magvit2_pytorch_tpu.ops import rotary as jrotary
from magvit2_pytorch_tpu.ops.attend import attend as jax_attend
from magvit2_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_forward, flash_attention as jax_flash_attention)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    _apply, _attention_entries, state_dict_from_jax_params)
from magvit2_pytorch_tpu_torch.ops import attend as pattend
from magvit2_pytorch_tpu_torch.ops import attention as pattention
from magvit2_pytorch_tpu_torch.ops import rotary
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, axial_attention, flash_attention as fa, launch_counts)

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bhnd(a, layout):
    """A (b, h, n, d) array in ``layout``."""
    return a if layout == 'bhnd' else np.swapaxes(a, 1, 2)


# ---- the plain attend against the JAX package's XLA backend ---------------

def _attend_case(name):
    b, h, n, d = 2, 2, 7, 8
    m = n + 4 if name == 'causal_memory' else n
    if name == 'single_query_causal':
        n, m = 1, 5
    q, k, v = _rand((b, h, n, d), 0), _rand((b, h, m, d), 1), _rand(
        (b, h, m, d), 2)
    kw = {}
    if name in ('causal_memory', 'single_query_causal'):
        kw['causal'] = True
    if name == 'fully_masked_row':
        mask = np.random.default_rng(3).random((b, h, n, m)) > 0.3
        mask[0, 1, 2] = False
        kw['mask'] = mask
    if name == 'bias_hnm':
        kw['attn_bias'] = _rand((h, n, m), 4)
    if name == 'bias_bhnm':
        kw.update(attn_bias=_rand((b, h, n, m), 4), causal=True)
    if name == 'prev_attn':
        kw.update(prev_attn=_rand((b, h, n, m), 5),
                  attn_bias=_rand((h, n, m), 6))
    return q, k, v, kw


@pytest.mark.parametrize('layout', ['bhnd', 'bnhd'])
@pytest.mark.parametrize('name', [
    'causal_memory', 'fully_masked_row', 'bias_hnm', 'bias_bhnm', 'prev_attn',
    'single_query_causal'])
def test_plain_attend_matches_jax(name, layout):
    """float32, atol 2e-5; a fully masked row comes out exactly 0."""
    q, k, v, kw = _attend_case(name)
    args = [_bhnd(a, layout) for a in (q, k, v)]
    want = jax_attend(*map(jnp.asarray, args), backend='xla', layout=layout,
                      **{key: (jnp.asarray(val) if isinstance(val, np.ndarray)
                               else val) for key, val in kw.items()})
    got = pattend.attend(
        *map(torch.from_numpy, args), backend='plain', layout=layout,
        **{key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if name == 'fully_masked_row':
        row = _bhnd(got.numpy(), layout)[0, 1, 2]
        assert np.all(row == 0)


# ---- the flash wrapper's plain versions against the Pallas kernels --------

B, H, N, M, D = 2, 2, 130, 134, 32       # tests/test_flash_attention.py's


@pytest.mark.parametrize('b,h,n,m,d,causal', [
    pytest.param(1, H, N, M, D, False, id='False'),
    pytest.param(1, H, N, M, D, True, id='True'),
    # the shapes of the causal tile skip: memory keys over more than one
    # tile at the smallest and largest head sizes, fewer queries than a tile
    pytest.param(1, 2, 70, 150, 16, True, id='70x150-d16-causal'),
    pytest.param(1, 2, 70, 150, 64, True, id='70x150-d64-causal'),
    pytest.param(2, 2, 5, 9, 16, False, id='5x9-d16'),
    pytest.param(2, 2, 5, 9, 16, True, id='5x9-d16-causal'),
])
def test_flash_forward_ref_matches_pallas(b, h, n, m, d, causal):
    """Output and lse of the plain forward against ``_flash_forward`` in
    interpret mode. Output atol 2e-5, rtol 1e-4
    (tests/test_flash_attention.py's); lse atol 1e-5."""
    q, k, v = _rand((b, h, n, d), 0), _rand((b, h, m, d), 1), _rand(
        (b, h, m, d), 2)
    want, lse = _flash_forward(*map(jnp.asarray, (q, k, v)), None, causal,
                               d ** -0.5, 256, 256, True)      # interpret
    got, got_lse = fa.flash_attention_ref(*map(_t, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(
        got_lse.numpy().reshape(b * h, n), np.asarray(lse)[:, 0, :n],
        atol=1e-5, rtol=0)


@pytest.mark.parametrize('bias_shape', ['nm', 'hnm', 'bhnm'])
def test_flash_forward_ref_bias_matches_pallas(bias_shape):
    q, k, v = _rand((B, H, N, D), 0), _rand((B, H, M, D), 1), _rand(
        (B, H, M, D), 2)
    bias = _rand({'nm': (N, M), 'hnm': (H, N, M),
                  'bhnm': (B, H, N, M)}[bias_shape], 3)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               interpret=True, bias=jnp.asarray(bias))
    got = fa.flash_attention(*map(_t, (q, k, v)), causal=True, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def _pallas_grads(q, k, v, bias, g_out, causal):
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def loss(*a):
        return jnp.sum(jax_flash_attention(
            *a[:3], causal=causal, interpret=True,
            bias=a[3] if len(a) == 4 else None) * g_out)

    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_backward_ref_matches_pallas(causal):
    """``flash_attention_bwd_ref`` against ``jax.grad`` through the Pallas
    backward kernels, ragged n and m, memory-KV layout; atol 5e-4, rtol 1e-3
    (tests/test_flash_attention.py's)."""
    q, k, v = _rand((B, H, N, D), 6), _rand((B, H, M, D), 7), _rand(
        (B, H, M, D), 8)
    g_out = _rand((B, H, N, D), 9)
    want = _pallas_grads(q, k, v, None, g_out, causal)
    tq, tk, tv = map(_t, (q, k, v))
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal=causal)
    got = fa.flash_attention_bwd_ref(tq, tk, tv, None, out, lse, _t(g_out),
                                     causal, D ** -0.5)
    assert got[3] is None
    for a, b in zip(got[:3], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize('bias_shape', ['hnm', 'bhnm'])
def test_flash_backward_ref_bias_matches_pallas(bias_shape):
    """With a bias: all four gradients, d_bias with its group reduction."""
    d = 16
    q, k, v = _rand((B, H, N, d), 4), _rand((B, H, M, d), 5), _rand(
        (B, H, M, d), 6)
    bias = _rand((H, N, M) if bias_shape == 'hnm' else (B, H, N, M), 7)
    g_out = _rand((B, H, N, d), 9)
    want = _pallas_grads(q, k, v, bias, g_out, True)
    tq, tk, tv = map(_t, (q, k, v))
    groups = fa.bias_groups(_t(bias), B, H, N, M)
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal=True, bias=groups)
    got = fa.flash_attention_bwd_ref(tq, tk, tv, groups, out, lse, _t(g_out),
                                     True, d ** -0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(b)),
                                   np.asarray(b), atol=5e-4, rtol=1e-3)


# ---- the autograd wiring ---------------------------------------------------

def test_flash_attention_gradcheck_float64():
    """The Function's backward against finite differences: n = 5, m = 9,
    causal, with a per-head bias, at the smallest head size the wrapper
    takes."""
    rng = np.random.default_rng(10)
    q, k, v, bias = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
                     for s in ((1, 2, 5, 16), (1, 2, 9, 16), (1, 2, 9, 16),
                               (2, 5, 9)))
    assert torch.autograd.gradcheck(
        lambda q, k, v, bias: fa.flash_attention(q, k, v, causal=True,
                                                 bias=bias),
        (q, k, v, bias))


@pytest.mark.parametrize('bias_shape', [None, 'nm', 'bhnm'])
def test_flash_attention_gradients_match_plain_attend(bias_shape):
    """Gradients through the Function against autograd through the plain
    ``attend``, float32, atol 1e-5."""
    b, h, n, m, d = 2, 2, 9, 13, 16
    shapes = [(b, h, n, d), (b, h, m, d), (b, h, m, d)]
    if bias_shape:
        shapes.append({'nm': (n, m), 'bhnm': (b, h, n, m)}[bias_shape])
    g_out = _t(_rand((b, h, n, d), 20))

    def grads(fn):
        ins = [_t(_rand(s, 11 + i)).requires_grad_()
               for i, s in enumerate(shapes)]
        bias = ins[3] if bias_shape else None
        return torch.autograd.grad(fn(*ins[:3], bias), ins, g_out)

    def plain(q, k, v, bias):
        if bias is not None and bias.ndim == 2:
            bias = bias[None]
        return pattend.attend(q, k, v, causal=True, backend='plain',
                              attn_bias=bias)

    got = grads(lambda q, k, v, bias: fa.flash_attention(
        q, k, v, causal=True, bias=bias))
    for a, b_ in zip(got, grads(plain)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5, rtol=0)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q, k = torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 6, 8)
    with pytest.raises(ValueError, match=r'\(16, 32, 64\)'):
        fa.flash_attention(q, k, k)
    q, k = torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, 3, 16)
    with pytest.raises(ValueError, match='keys'):
        fa.flash_attention(q, k, k)
    q, k = torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 6, 16)
    with pytest.raises(ValueError, match='bias'):
        fa.flash_attention(q, k, k, bias=torch.zeros(3, 4, 6))


# ---- attend's dispatch -----------------------------------------------------

@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls of the flash wrapper (the real one still runs)."""
    calls = []
    real = fa.flash_attention

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(fa, 'flash_attention', spy)
    return calls


@pytest.mark.parametrize('layout', ['bhnd', 'bnhd'])
@pytest.mark.parametrize('with_bias', [False, True])
def test_attend_flash_backend_equals_plain(with_bias, layout, flash_calls):
    q, k, v = (torch.from_numpy(_bhnd(_rand((1, 2, 40, 32), s), layout))
               for s in (8, 9, 10))
    bias = _t(_rand((2, 40, 40), 11)) if with_bias else None
    out = pattend.attend(q, k, v, backend='flash', attn_bias=bias,
                         layout=layout)
    ref = pattend.attend(q, k, v, backend='plain', attn_bias=bias,
                         layout=layout)
    assert flash_calls == [(1, 2, 40, 32)]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_attend_dispatch_rules(flash_calls):
    q, k, v = (_t(_rand((1, 2, 6, 16), s)) for s in (0, 1, 2))
    mask = torch.ones(1, 2, 6, 6, dtype=torch.bool)
    # flash with a mask falls to the plain backend
    out = pattend.attend(q, k, v, backend='flash', mask=mask)
    assert flash_calls == []
    assert torch.equal(out, pattend.attend(q, k, v, backend='plain'))
    # 'xla' is the plain backend's alias; 'auto' on a CPU tensor is plain
    assert torch.equal(out, pattend.attend(q, k, v, backend='xla'))
    big = torch.zeros(1, 1, 1024, 32)
    pattend.attend(big, big, big, backend='auto')
    assert flash_calls == []
    with pytest.raises(AssertionError, match='residual attention'):
        pattend.attend(q, k, v, backend='flash',
                       prev_attn=torch.zeros(1, 2, 6, 6))
    with pytest.raises(ValueError, match='head size'):
        pattend.attend(*(t[..., :8] for t in (q, k, v)), backend='flash')


def test_auto_keeps_calls_the_kernel_refuses_off_flash(monkeypatch):
    """On the card ``'auto'`` picks flash at n, m >= 1024, but not with fewer
    keys than queries, which the kernel refuses (the plain backend and the
    JAX package take such a call). A tensor subclass that says it lies on
    the card stands in for one, and the spy stands in for the kernel."""
    class OnCard(torch.Tensor):
        is_cuda = True

    with pytest.raises(ValueError, match='keys < n'):
        fa.flash_attention(torch.zeros(1, 1, 8, 32), torch.zeros(1, 1, 4, 32),
                           torch.zeros(1, 1, 4, 32))

    calls = []

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, 'flash_attention', spy)

    def auto(n, m):
        q = torch.zeros(1, 1, n, 32).as_subclass(OnCard)
        k = torch.zeros(1, 1, m, 32).as_subclass(OnCard)
        return pattend.attend(q, k, k, backend='auto')

    auto(1024, 1028)
    assert calls == [(1024, 1028)]
    out = auto(2048, 1024)
    assert calls == [(1024, 1028)]
    assert out.shape == (1, 1, 2048, 32)


def test_default_backend_and_flash_friendly_rule():
    assert pattend.get_default_attend_backend() == 'auto'
    pattend.set_default_attend_backend('xla')
    try:
        assert pattend.get_default_attend_backend() == 'xla'
    finally:
        pattend.set_default_attend_backend('auto')
    with pytest.raises(AssertionError):
        pattend.set_default_attend_backend('cudnn')
    friendly = pattend._flash_friendly_nm
    assert friendly(1024, 1028, 32) and friendly(4096, 4100, 64)
    assert not friendly(1023, 1028, 32) and not friendly(1024, 1020, 32)
    assert not friendly(4096, 2048, 32)      # fewer keys than queries
    assert not friendly(4096, 4100, 16) and not friendly(4096, 4100, 128)


# ---- rotary positions ------------------------------------------------------

def test_rope_angles_match_jax():
    pos = np.arange(12)
    for got, want in zip(rotary.rope_angles(torch.from_numpy(pos), 16),
                         jrotary.rope_angles(jnp.asarray(pos), 16)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_rope_angles_2d_match_jax():
    for got, want in zip(rotary.rope_angles_2d(3, 5, 16),
                         jrotary.rope_angles_2d(3, 5, 16)):
        assert tuple(got.shape) == (15, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_apply_rope_matches_jax(dtype):
    """float32 atol 1e-6; bfloat16 input: both rotate in float32 and round
    once, so they agree to one bf16 step (2^-8 relative of values <= 4)."""
    t = _rand((2, 6, 3, 8), 12)
    cos, sin = jrotary.rope_angles(jnp.arange(6), 8)
    want = jrotary.apply_rope(jnp.asarray(t).astype(dtype), cos, sin)
    got = rotary.apply_rope(_t(t, getattr(torch, dtype)),
                            _t(cos), _t(sin))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=1e-6 if dtype == 'float32' else 2 ** -6, rtol=0)
    # norm-preserving
    np.testing.assert_allclose(
        rotary.apply_rope(_t(t), _t(cos), _t(sin)).norm(dim=-1).numpy(),
        np.linalg.norm(t, axis=-1), atol=1e-5, rtol=0)


# ---- the general Attention path against the JAX modules -------------------

DIM, HEADS = 32, 2
CASES = {           # name -> (module kwargs, dim_head, needs a mask)
    'flash': (dict(backend='flash'), 16, False),
    'rotary': (dict(use_rotary=True), 32, False),
    'mask': ({}, 32, True),
    'dim_head_16': ({}, 16, False),
}


def _attention_params(dim_head, seed):
    rng = np.random.default_rng(seed)
    inner = HEADS * dim_head
    f = lambda a: a.astype(np.float32)
    return {'norm': {'gamma': f(1 + 0.1 * rng.normal(size=DIM))},
            'to_qkv': {'kernel': f(rng.normal(size=(DIM, 3 * inner)) * 0.2)},
            'mem_kv': f(rng.normal(size=(2, HEADS, 4, dim_head))),
            'to_out': {'kernel': f(rng.normal(size=(inner, DIM)) * 0.2)}}


def _module_pair(kind, name, dtype=torch.float32):
    kw, dim_head, _ = CASES[name]
    params = _attention_params(dim_head, 30)
    jcls = getattr(jattention, kind)
    extra = dict(causal=True) if kind == 'TimeAttention' else {}
    jmod = jcls(dim=DIM, dim_head=dim_head, heads=HEADS, **kw, **extra)
    port = getattr(pattention, kind)(DIM, dim_head=dim_head, heads=HEADS, **kw)
    state = {}
    _apply(state, _attention_entries('x', ()), params)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    return jmod, params, port.to(dtype)


def _module_inputs(kind, name, dtype='float32'):
    x = _rand((1, 3, 4, 4, DIM), 31)
    mask = None
    if CASES[name][2]:
        # key padding over the module's sequences: (b t, h w) or (b h w, t)
        shape = (3, 16) if kind == 'SpaceAttention' else (16, 3)
        mask = np.random.default_rng(32).random(shape) > 0.3
        mask[:, 0] = True
    return x, mask


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the calls of the fused block wrappers from the modules."""
    calls = []
    for fn in ('attention_block', 'time_attention_block'):
        real = getattr(pattention, fn)

        def spy(*args, _real=real, _fn=fn, **kw):
            calls.append(_fn)
            return _real(*args, **kw)

        monkeypatch.setattr(pattention, fn, spy)
    return calls


@pytest.mark.parametrize('name', list(CASES))
@pytest.mark.parametrize('kind', ['SpaceAttention', 'TimeAttention'])
def test_general_attention_path_matches_jax(kind, name, monkeypatch,
                                            block_calls, flash_calls):
    """float32, atol 1e-4; the module takes the general path (no block
    wrapper call), and the flash case reaches the flash wrapper."""
    if name == 'flash':     # the gate comes before ``backend``, as in JAX
        monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_ATTN', '1')
    jmod, params, port = _module_pair(kind, name)
    x, mask = _module_inputs(kind, name)
    jkw = {} if mask is None else {'mask': jnp.asarray(mask)}
    pkw = {} if mask is None else {'mask': torch.from_numpy(mask)}
    want = jmod.apply({'params': params}, jnp.asarray(x), **jkw)
    got = port(torch.from_numpy(x), **pkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    assert block_calls == []
    assert bool(flash_calls) == (name == 'flash')


@pytest.mark.parametrize('kind', ['SpaceAttention', 'TimeAttention'])
def test_general_attention_path_bf16_tracks_jax(kind):
    """bfloat16 in both packages, rotary positions: 5e-2 absolute, the bf16
    tolerance of the port's attention kernels (both round qkv, the
    probabilities and the output to bf16, at slightly different places)."""
    jmod, params, port = _module_pair(kind, 'rotary', torch.bfloat16)
    x, _ = _module_inputs(kind, 'rotary')
    want = jmod.apply({'params': params}, jnp.asarray(x).astype(jnp.bfloat16))
    got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=5e-2, rtol=0)


@pytest.mark.parametrize('kind', ['SpaceAttention', 'TimeAttention'])
def test_flagship_like_module_takes_the_block(kind, block_calls, flash_calls):
    """dim_head 32, no rotary, mask or dropout, short sequences: the fused
    block, even with ``backend='flash'`` (the gate comes first)."""
    port = getattr(pattention, kind)(DIM, dim_head=32, heads=HEADS,
                                     backend='flash')
    for mod in port.modules():
        if hasattr(mod, 'init_parameters'):
            mod.init_parameters(torch.Generator().manual_seed(0))
    port(torch.from_numpy(_rand((1, 3, 4, 4, DIM), 33)))
    assert block_calls == [
        'attention_block' if kind == 'SpaceAttention'
        else 'time_attention_block']
    assert flash_calls == []


def test_gates_keep_the_semantic_conditions(monkeypatch):
    ok = dict(dropout=0.0, use_rotary=False)
    space, time = (axial_attention.fused_eligible,
                   axial_attention.fused_time_eligible)
    assert space(1024, 512, 8, 32, **ok) and time(16, 7, 512, 8, 32, **ok)
    assert not space(1025, 512, 8, 32, **ok)
    assert not time(17, 16, 512, 8, 32, **ok)
    for dim_head in (16, 64):
        assert not space(256, 512, 8, dim_head, **ok)
        assert not time(5, 256, 512, 8, dim_head, **ok)
    for bad in (dict(ok, dropout=0.1), dict(ok, use_rotary=True),
                dict(ok, has_mask=True)):
        assert not space(256, 512, 8, 32, **bad)
        assert not time(5, 256, 512, 8, 32, **bad)
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_ATTN', '1')
    assert not space(256, 512, 8, 32, **ok)
    assert not time(5, 256, 512, 8, 32, **ok)


def test_unported_attention_modes_name_their_roadmap_item():
    """The two modes that once raised, ``dim_cond`` and a stream's kv-cache,
    against the JAX package (float32, atol 1e-5): ``Attention(dim_cond=4)``
    on a cond vector, and a causal ``TimeAttention`` fed two chunks
    against JAX's ``streaming=True`` with its ``cache`` collection."""
    rng = np.random.default_rng(33)
    params = _attention_params(32, 34)
    params['norm'] = {'to_gamma': {
        'kernel': (rng.normal(size=(4, DIM)) * 0.3).astype(np.float32),
        'bias': (1 + 0.1 * rng.normal(size=DIM)).astype(np.float32)}}
    port = pattention.Attention(DIM, heads=HEADS, dim_cond=4)
    state = {}
    _apply(state, _attention_entries('x', (), cond=True), params)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    x, cond = _rand((2, 6, DIM), 35), _rand((2, 4), 36)
    want = jattention.Attention(dim=DIM, heads=HEADS, dim_cond=4).apply(
        {'params': params}, jnp.asarray(x), cond=jnp.asarray(cond))
    np.testing.assert_allclose(
        port(torch.from_numpy(x), cond=torch.from_numpy(cond)).detach()
        .numpy(), np.asarray(want), atol=1e-5, rtol=0)

    params = _attention_params(32, 37)
    jmod = jattention.TimeAttention(dim=DIM, heads=HEADS, causal=True)
    port = pattention.TimeAttention(DIM, heads=HEADS)
    state = {}
    _apply(state, _attention_entries('x', ()), params)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    video = _rand((1, 5, 2, 2, DIM), 38)
    stream, cache = {}, None
    for lo, hi in ((0, 2), (2, 5)):
        chunk = video[:, lo:hi]
        variables = {'params': params}
        if cache is not None:
            variables['cache'] = cache
        want, mutated = jmod.apply(variables, jnp.asarray(chunk),
                                   streaming=True, mutable=['cache'])
        cache = mutated['cache']
        got = port(torch.from_numpy(chunk), state=stream)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_general_path_backward_reaches_every_parameter(monkeypatch):
    """One step of the general path at a small size: gradients for x and the
    four parameters through the flash Function equal those through the
    plain backend (atol 1e-5)."""
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_ATTN', '1')
    g_out = _t(_rand((1, 2, 4, 4, DIM), 35))
    grads = {}
    for backend in ('flash', 'plain'):
        _, _, port = _module_pair('SpaceAttention', 'flash')
        port.backend = backend
        x = _t(_rand((1, 2, 4, 4, DIM), 34)).requires_grad_()
        (port(x) * g_out).sum().backward()
        grads[backend] = [x.grad] + [p.grad for p in port.parameters()]
        assert len(grads[backend]) == 5
    for a, b in zip(grads['flash'], grads['plain']):
        assert a is not None and a.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


# ---- attention dropout -----------------------------------------------------

def test_dropout_needs_a_generator():
    """Without a random source no dropout is applied, as the JAX module
    without a 'dropout' rng: both equal the JAX no-dropout output."""
    jmod, params, port = _module_pair('SpaceAttention', 'dim_head_16')
    port.dropout = 0.5
    x, _ = _module_inputs('SpaceAttention', 'dim_head_16')
    jdrop = jattention.SpaceAttention(dim=DIM, dim_head=16, heads=HEADS,
                                      dropout=0.5)
    want = jdrop.apply({'params': params}, jnp.asarray(x))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        np.asarray(want),
        np.asarray(jmod.apply({'params': params}, jnp.asarray(x))), atol=1e-6)


def test_dropout_is_seeded_and_scales_the_kept_probabilities():
    """JAX's random bits cannot be matched, so the dropout itself is held to
    its definition: reproducible from the generator's seed, different from
    the no-dropout output, and with value rows of ones in place of v the
    block's pre-projection output is sum(kept probs) / (1 - p): multiples of
    nothing but the kept mass, mean 1 over many draws."""
    _, _, port = _module_pair('TimeAttention', 'dim_head_16')
    x = torch.from_numpy(_module_inputs('TimeAttention', 'dim_head_16')[0])
    base = port(x)
    port.dropout = 0.5
    gen = lambda: torch.Generator().manual_seed(5)
    a, b = port(x, generator=gen()), port(x, generator=gen())
    assert torch.equal(a, b)
    assert (a - base).abs().max() > 1e-3
    assert (a - port(x, generator=torch.Generator().manual_seed(6))
            ).abs().max() > 1e-3

    # kept probabilities are probs / (1 - p): with every value equal to one
    # the attention output is the kept mass, which averages to 1
    class Ones(torch.nn.Module):
        def forward(self, xn):
            out = torch.ones(*xn.shape[:-1], 3 * HEADS * 16)
            return out
    with torch.no_grad():
        port.mem_kv.fill_(1.0)
    port.to_qkv = torch.nn.Sequential(Ones())
    port.to_out = torch.nn.Sequential(torch.nn.Identity())
    with torch.no_grad():
        mass = port(torch.zeros(4, 6, 8, 8, DIM),
                    generator=torch.Generator().manual_seed(7))
    # causal over t with 4 memory keys: query i sees 5 + i equal logits, so
    # its kept mass is (kept count) * 2 / (5 + i)
    first = mass[:, 0].reshape(-1)
    np.testing.assert_allclose((first * 5 / 2).round().numpy(),
                               (first * 5 / 2).numpy(), atol=1e-5)
    assert abs(mass.mean().item() - 1.0) < 0.02


# ---- the tokenizer's knobs -------------------------------------------------

ROTARY = dict(image_size=16, init_dim=8, codebook_size=64,
              layers=('residual', ('compress_space', 12), 'attend_space',
                      ('compress_time', 16), 'attend_time'),
              attn_heads=2, attn_dim_head=16, use_gan=False,
              perceptual_loss_weight=0.0, use_rotary_pos_emb=True)


def test_rotary_tokenizer_matches_jax_and_bridges_exactly():
    """Rotary positions have no parameters: the strict state_dict round trip
    is exact, and latents, codes and recon match the JAX tokenizer under
    test_tiny_roundtrip_matches_jax's tolerances (1e-5)."""
    jtok = JaxTokenizer(seed=0, **ROTARY)
    params = jax.tree.map(np.asarray, jtok.params)
    state = state_dict_from_jax_params(jtok.config, params)
    back = load_torch_tokenizer_state_dict(jtok.config, state)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    port = VideoTokenizer(device='cpu', seed=1, **ROTARY)
    port.load_state_dict(state, strict=True)
    video = np.random.default_rng(0).random((1, 5, 16, 16, 3),
                                            dtype=np.float32)
    jv = jnp.asarray(video)
    np.testing.assert_allclose(port.encode(video).numpy(),
                               np.asarray(jtok.encode(jv)), atol=1e-5, rtol=0)
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes_p, recon_p = port.forward(video, return_codes=True,
                                    return_recon=True)
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon_p.numpy(), np.asarray(recon_j),
                               atol=1e-5, rtol=0)
    # without the rotation the same weights give other latents
    plain = VideoTokenizer(device='cpu', seed=1,
                           **{**ROTARY, 'use_rotary_pos_emb': False})
    plain.load_state_dict(state, strict=True)
    assert (plain.encode(video) - port.encode(video)).abs().max() > 1e-4


@pytest.mark.parametrize('knobs', [dict(use_rotary_pos_emb=True),
                                   dict(attn_dropout=0.1), {}],
                         ids=['rotary', 'dropout', 'default'])
def test_flash_attn_flag_does_not_change_the_graph(knobs):
    """``flash_attn`` only picks the backend the layers are built with; no
    layer of the tokenizer reaches ``attend`` without a mask, so True and
    False give identical outputs (and attention dropout without a generator
    is no dropout)."""
    config = {**ROTARY, 'use_rotary_pos_emb': False, **knobs}
    video = np.random.default_rng(1).random((1, 5, 16, 16, 3),
                                            dtype=np.float32)
    outs = []
    for flash_attn in (True, False):
        tok = VideoTokenizer(device='cpu', seed=2, flash_attn=flash_attn,
                             **config)
        backends = {m.backend for m in tok.module.modules()
                    if isinstance(m, pattention.Attention)}
        assert backends == ({None} if flash_attn else {'plain'})
        outs.append(tok.forward(video, return_recon=True))
    assert torch.equal(*outs)


def test_cpu_path_builds_nothing_and_counts_no_launch():
    q = torch.zeros(1, 1, 4, 16)
    fa.flash_attention(q, q, q)
    assert _build._lib is None
    counts = launch_counts()
    assert {'flash_attention_fwd', 'flash_attention_bwd_dq',
            'flash_attention_bwd_dkv'} <= set(counts)
    assert all(counts[k] == 0 for k in counts if k.startswith('flash'))
    for name in ('mv2_flash_attention_fwd', 'mv2_flash_attention_bwd_dq',
                 'mv2_flash_attention_bwd_dkv'):
        assert name in _build.SIGNATURES
