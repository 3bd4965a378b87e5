"""The flash-attention wrapper at every head size up to 256 and with fewer
keys than queries, on the CPU, against the JAX package: the plain forward
against ``_flash_forward`` in interpret mode, the gradients against the
JAX custom VJP (the Pallas backward kernels in interpret mode), a causal
call with fewer keys than queries against JAX's plain ``attend`` and its
``jax.grad`` on every row and against JAX's flash kernel on the rows that
see a key, a head of 12 through the wrapper's zero padding, the general
``SpaceAttention`` / ``TimeAttention`` path at heads of 128 and 96, and the
``'auto'`` rule against the JAX package's. Inputs come from numpy seeds; the
tolerances are stated at each test (float32: the same math summed in
another order). The CUDA kernels run only on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops import attention as jattention
from magvit2_pytorch_tpu.ops.attend import (
    _flash_friendly_nm as jax_flash_friendly, attend as jax_attend)
from magvit2_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_forward, _round_up, flash_attention as jax_flash_attention)
from magvit2_pytorch_tpu_torch.models.jax_import import (
    _apply, _attention_entries)
from magvit2_pytorch_tpu_torch.ops import attend as pattend
from magvit2_pytorch_tpu_torch.ops import attention as pattention
from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv(b, h, n, m, d, seed):
    return (_rand((b, h, n, d), seed), _rand((b, h, m, d), seed + 1),
            _rand((b, h, m, d), seed + 2))


# ---- the plain forward against the JAX kernel ------------------------------

@pytest.mark.parametrize('d', [8, 24, 128, 256])
@pytest.mark.parametrize('n,m,causal', [(70, 150, True), (130, 134, False)])
def test_plain_forward_matches_the_jax_kernel(d, n, m, causal):
    """``flash_attention_ref`` (out, lse) against ``_flash_forward`` in
    interpret mode with the JAX wrapper's blocks: out atol 2e-5 rtol 1e-4,
    lse atol 1e-5."""
    q, k, v = _qkv(1, 2, n, m, d, 3)
    scale = d ** -0.5
    want_out, want_lse = _flash_forward(
        *map(jnp.asarray, (q, k, v)), None, causal, scale,
        min(512, _round_up(n, 128)), min(512, _round_up(m, 128)), True)
    out, lse = fa.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(
        lse.numpy().reshape(2, n), np.asarray(want_lse)[:, 0, :n], atol=1e-5,
        rtol=0)


# ---- gradients against the JAX custom VJP ---------------------------------

def _jax_flash_grads(q, k, v, bias, g_out, causal):
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    @jax.jit
    def grads(*a):
        def loss(*a):
            return jnp.sum(jax_flash_attention(
                *a[:3], causal=causal, interpret=True,
                bias=a[3] if len(a) == 4 else None) * g_out)
        return jax.grad(loss, argnums=tuple(range(len(a))))(*a)

    return grads(*args)


def _port_grads(q, k, v, bias, g_out, causal):
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if bias is not None:
        ins.append(torch.from_numpy(bias).requires_grad_())
    out = fa.flash_attention(*ins[:3], causal=causal,
                             bias=ins[3] if bias is not None else None)
    return out, torch.autograd.grad(out, ins, torch.from_numpy(g_out))


def _close_to_largest(got, want, rel):
    """max |got - want| within ``rel`` of the largest |want|."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got).reshape(want.shape) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize('d,bias', [(128, False), (256, False), (128, True)])
def test_gradients_match_the_jax_custom_vjp(d, bias):
    """dq, dk, dv (and d_bias) through the port's Function against
    ``jax.grad`` through the Pallas backward kernels in interpret mode:
    (1, 2, 70) / 150 keys causal, within 1e-5 of each gradient's largest
    value."""
    n, m = 70, 150
    q, k, v = _qkv(1, 2, n, m, d, 5)
    b = _rand((2, n, m), 8) if bias else None
    g_out = _rand((1, 2, n, d), 9)
    _, got = _port_grads(q, k, v, b, g_out, True)
    want = _jax_flash_grads(q, k, v, b, g_out, True)
    assert len(got) == len(want) == 3 + bias
    for a, w in zip(got, want):
        _close_to_largest(a.numpy(), w, 1e-5)


# ---- fewer keys than queries -----------------------------------------------

def _jax_plain(q, k, v, g_out, causal):
    """JAX's plain ``attend`` and its ``jax.grad``."""
    def f(q, k, v):
        return jax_attend(q, k, v, causal=causal, backend='xla')

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(g_out))


@pytest.mark.parametrize('m', [128, 70])
@pytest.mark.parametrize('causal', [False, True])
def test_fewer_keys_than_queries(m, causal):
    """(1, 2, 150, 32) against m < n keys. The port (out and its three
    gradients) equals JAX's plain ``attend`` and its ``jax.grad`` on every
    row, atol 1e-5 of the largest value, and JAX's flash kernel on the
    rows that see a key. With causal, rows i < n - m see no key: the plain
    paths give them the mean of v; JAX's flash kernel does too at m = 128
    (a whole block of keys), but at the ragged m = 70 it averages its
    zero-padded keys in (ROADMAP item C9), which the test asserts."""
    n, d = 150, 32
    q, k, v = _qkv(1, 2, n, m, d, 11)
    g_out = _rand((1, 2, n, d), 14)
    out, grads = _port_grads(q, k, v, None, g_out, causal)
    want_out, want_grads = _jax_plain(q, k, v, g_out, causal)
    _close_to_largest(out.detach().numpy(), want_out, 1e-5)
    for a, w in zip(grads, want_grads):
        _close_to_largest(a.numpy(), w, 1e-5)
    # the port's own plain attend, on every row
    plain = pattend.attend(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           backend='plain')
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(),
                               atol=1e-5, rtol=0)

    jax_flash = np.asarray(jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    blind = n - m if causal else 0
    np.testing.assert_allclose(out.detach().numpy()[:, :, blind:],
                               jax_flash[:, :, blind:], atol=1e-5, rtol=0)
    if blind:
        mean_v = v.mean(axis=2, keepdims=True)
        np.testing.assert_allclose(out.detach().numpy()[:, :, :blind],
                                   np.broadcast_to(mean_v, (1, 2, blind, d)),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(grads[0].numpy()[:, :, :blind], 0.0)
        off = np.abs(jax_flash[:, :, :blind] - mean_v).max()
        assert (off > 1e-2) == (m % 128 != 0), off


def test_rows_that_see_no_key_in_the_plain_backward():
    """The plain backward alone: such a row adds dO / m to every dv row and
    nothing to dq, dk or d_bias, and its lse is the masking constant."""
    b, h, n, m, d = 1, 2, 9, 4, 8
    q, k, v = map(torch.from_numpy, _qkv(b, h, n, m, d, 20))
    bias = torch.from_numpy(_rand((1, n, m), 23))
    g_out = torch.from_numpy(_rand((b, h, n, d), 24))
    out, lse = fa.flash_attention_ref(q, k, v, True, d ** -0.5, bias)
    assert fa.no_key_rows(n, m, True) == 5 and fa.no_key_rows(n, m, False) == 0
    np.testing.assert_array_equal(lse[..., :5].numpy(), np.float32(-1e30))
    dq, dk, dv, dbias = fa.flash_attention_bwd_ref(q, k, v, bias, out, lse,
                                                   g_out, True, d ** -0.5)
    np.testing.assert_array_equal(dq[..., :5, :].numpy(), 0.0)
    np.testing.assert_array_equal(dbias[:, :5].numpy(), 0.0)
    # the same call without the blind rows: dk is unchanged, dv differs by
    # their dO summed over m
    rest = fa.flash_attention_bwd_ref(
        q[..., 5:, :], k, v, bias[:, 5:], out[..., 5:, :], lse[..., 5:],
        g_out[..., 5:, :], True, d ** -0.5)
    np.testing.assert_allclose(dk.numpy(), rest[1].numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        (dv - rest[2]).numpy(),
        np.broadcast_to(g_out[..., :5, :].sum(-2, keepdim=True).numpy() / m,
                        dv.shape), atol=1e-6, rtol=0)


# ---- a head that is no multiple of 8 ---------------------------------------

@pytest.mark.parametrize('causal', [False, True])
def test_head_of_12_through_the_zero_padding(causal):
    """d = 12 runs padded to 16 and sliced back, its scale from 12: out
    and gradients against JAX's flash kernel (which takes any head) in
    interpret mode, within 1e-5 of the largest value; (2, 2, 70) / 74
    keys."""
    n, m, d = 70, 74, 12
    q, k, v = _qkv(2, 2, n, m, d, 30)
    g_out = _rand((2, 2, n, d), 33)
    out, got = _port_grads(q, k, v, None, g_out, causal)
    assert out.shape == (2, 2, n, d)
    assert all(g.shape == t.shape for g, t in zip(got, (q, k, v)))
    want_out = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, interpret=True)
    _close_to_largest(out.detach().numpy(), want_out, 1e-5)
    for a, w in zip(got, _jax_flash_grads(q, k, v, None, g_out, causal)):
        _close_to_largest(a.numpy(), w, 1e-5)


def test_head_rule():
    """Every head of at least one value takes a route, as the JAX kernel
    takes any head: over 256 the wide launches (257 zero-padded to 264);
    a head of 0 raises."""
    for d in (1, 12, 96, 256, 257, 264, 512):
        assert fa.flash_route(torch.bfloat16, d) == 'mma'
        assert fa.flash_route(torch.float32, d) == 'f32'
    with pytest.raises(ValueError, match='< 1'):
        fa.flash_route(torch.float32, 0)
    z = torch.zeros(1, 1, 4, 264)
    assert fa.flash_attention(z, z, z).shape == (1, 1, 4, 264)


# ---- the general Attention path at large heads ----------------------------

DIM, HEADS = 32, 2


def _attention_params(dim_head, seed):
    rng = np.random.default_rng(seed)
    inner = HEADS * dim_head
    f = lambda a: a.astype(np.float32)
    return {'norm': {'gamma': f(1 + 0.1 * rng.normal(size=DIM))},
            'to_qkv': {'kernel': f(rng.normal(size=(DIM, 3 * inner)) * 0.2)},
            'mem_kv': f(rng.normal(size=(2, HEADS, 4, dim_head))),
            'to_out': {'kernel': f(rng.normal(size=(inner, DIM)) * 0.2)}}


@pytest.mark.parametrize('kind,dim_head,shape', [
    ('SpaceAttention', 128, (1, 2, 4, 4, DIM)),
    ('TimeAttention', 96, (1, 5, 2, 2, DIM))])
def test_module_at_large_heads_matches_jax(kind, dim_head, shape,
                                           monkeypatch):
    """``SpaceAttention(32, dim_head=128, heads=2, backend='flash')`` and a
    causal ``TimeAttention`` at dim_head 96 through the flash wrapper (the
    block gate switched off, as on the JAX package's CPU path), against the
    JAX modules on the same parameters: the output atol 1e-5; the gradients
    of the input and of every parameter, each non-zero, within 1e-5 of its
    largest value."""
    monkeypatch.setenv('MAGVIT2_TPU_NO_FUSED_ATTN', '1')
    calls = []
    real = fa.flash_attention

    def spy(q, *args, **kw):
        calls.append(q.shape[-1])
        return real(q, *args, **kw)

    monkeypatch.setattr(fa, 'flash_attention', spy)
    params = _attention_params(dim_head, 40)
    extra = dict(causal=True) if kind == 'TimeAttention' else {}
    jmod = getattr(jattention, kind)(dim=DIM, dim_head=dim_head, heads=HEADS,
                                     backend='flash', **extra)
    port = getattr(pattention, kind)(DIM, dim_head=dim_head, heads=HEADS,
                                     backend='flash')
    state = {}
    _apply(state, _attention_entries('x', ()), params)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    x, g = _rand(shape, 41), _rand(shape, 42)

    def loss(params, x):
        out = jmod.apply({'params': params}, x)
        return jnp.sum(out * g), out

    (_, want), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == [dim_head]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    _close_to_largest(xt.grad.numpy(), jdx, 1e-5)
    want_grads = {}
    _apply(want_grads, _attention_entries('x', ()),
           jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close_to_largest(p.grad.numpy(), want_grads[f'x.{name}'], 1e-5)


# ---- 'auto' ----------------------------------------------------------------

def test_flash_friendly_rule_equals_the_jax_package():
    """Where ``'auto'`` picks flash: the port's rule is the JAX package's
    over a grid of (n, m, d), fewer keys than queries included."""
    sizes = (1, 256, 1023, 1024, 1028, 4096)
    for n in sizes:
        for m in sizes:
            for d in (8, 16, 31, 32, 64, 96, 128, 256, 257):
                assert pattend._flash_friendly_nm(n, m, d) == (
                    jax_flash_friendly(n, m, d)), (n, m, d)
