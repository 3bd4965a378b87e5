"""The flash-attention wrapper at heads over 256, on the CPU, against the JAX
package, whose flash kernel takes any head (its block is the whole head).

The port's kernels take such a head on their wide launches (the output in
column chunks of 256, csrc/flash_attention.cu); on the CPU the wrapper runs
the plain versions, zero-padding a head that is no multiple of 8. Here: the
forward against ``_flash_forward`` in interpret mode at d = 264, 300 and
512, a causal call with fewer keys than queries against JAX's plain
``attend`` on every row and its flash kernel on the rows that see a key,
the gradients (with a bias at 512) against the JAX custom VJP, and
``SpaceAttention`` at a head of 320 against the JAX module with every
parameter's gradient. Inputs come from numpy seeds; float32, the same math
summed in another order, within 1e-5 of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops import attention as jattention
from magvit2_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_forward, _round_up, flash_attention as jax_flash_attention)
from magvit2_pytorch_tpu_torch.models.jax_import import (
    _apply, _attention_entries)
from magvit2_pytorch_tpu_torch.ops import attention as pattention
from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_flash_heads import (
    _close_to_largest, _jax_flash_grads, _jax_plain, _port_grads, _qkv,
    _rand)

torch.set_num_threads(1)


@pytest.mark.parametrize('d', [264, 300, 512])
def test_forward_past_256_matches_the_jax_kernel(d):
    """The wrapper's output (d = 300 zero-padded to 304, its scale from
    300) and the plain lse against ``_flash_forward`` in interpret mode,
    (1, 1, 130) / 134 keys: out within 1e-5 of its largest value, lse
    atol 1e-5."""
    n, m = 130, 134
    q, k, v = _qkv(1, 1, n, m, d, 50 + d)
    want_out, want_lse = _flash_forward(
        *map(jnp.asarray, (q, k, v)), None, False, d ** -0.5,
        _round_up(n, 128), _round_up(m, 128), True)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    _close_to_largest(fa.flash_attention(*ts).numpy(), want_out, 1e-5)
    _, lse = fa.flash_attention_ref(*ts)
    np.testing.assert_allclose(lse.numpy().reshape(n),
                               np.asarray(want_lse)[0, 0, :n], atol=1e-5,
                               rtol=0)


def test_fewer_keys_than_queries_past_256():
    """(1, 1, 130, 264) against 70 keys, causal: the first 60 rows see no
    key. The port (out and gradients) equals JAX's plain ``attend`` and its
    ``jax.grad`` on every row (those rows take the mean of v, dq 0), and
    JAX's flash kernel on the rows that see a key (ROADMAP item C9: on the
    others it averages its zero-padded keys in)."""
    n, m, d = 130, 70, 264
    q, k, v = _qkv(1, 1, n, m, d, 60)
    g_out = _rand((1, 1, n, d), 63)
    out, grads = _port_grads(q, k, v, None, g_out, True)
    want_out, want_grads = _jax_plain(q, k, v, g_out, True)
    _close_to_largest(out.detach().numpy(), want_out, 1e-5)
    for a, w in zip(grads, want_grads):
        _close_to_largest(a.numpy(), w, 1e-5)
    blind = n - m
    jax_flash = np.asarray(jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, interpret=True))
    _close_to_largest(out.detach().numpy()[:, :, blind:],
                      jax_flash[:, :, blind:], 1e-5)
    np.testing.assert_allclose(
        out.detach().numpy()[:, :, :blind],
        np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 1, blind, d)),
        atol=1e-5, rtol=0)
    np.testing.assert_array_equal(grads[0].numpy()[:, :, :blind], 0.0)


@pytest.mark.parametrize('d,bias', [(300, False), (512, False), (512, True)])
def test_gradients_past_256_match_the_jax_custom_vjp(d, bias):
    """dq, dk, dv (and d_bias, an (h, n, m) bias) through the port's
    Function against ``jax.grad`` through the Pallas backward kernels in
    interpret mode, (1, 1, 70) / 74 keys causal: the output and each
    gradient within 1e-5 of its largest value."""
    n, m = 70, 74
    q, k, v = _qkv(1, 1, n, m, d, 70 + d)
    b = _rand((1, n, m), 74) if bias else None
    g_out = _rand((1, 1, n, d), 75)
    out, got = _port_grads(q, k, v, b, g_out, True)
    want = _jax_flash_grads(q, k, v, b, g_out, True)
    assert len(got) == len(want) == 3 + bias
    _close_to_largest(out.detach().numpy(), jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, interpret=True,
        bias=None if b is None else jnp.asarray(b)), 1e-5)
    for a, w in zip(got, want):
        _close_to_largest(a.numpy(), w, 1e-5)


def test_space_attention_at_head_320_matches_jax(monkeypatch):
    """``SpaceAttention(32, dim_head=320, heads=1, backend='flash')`` (no
    block kernel takes the head) through the flash wrapper, against the JAX
    module on the same parameters: the output atol 1e-5; the gradients of
    the input and of every parameter, each non-zero, within 1e-5 of its
    largest value."""
    dim, dim_head, shape = 32, 320, (1, 2, 4, 4, 32)
    calls = []
    real = fa.flash_attention

    def spy(q, *args, **kw):
        calls.append(q.shape[-1])
        return real(q, *args, **kw)

    monkeypatch.setattr(fa, 'flash_attention', spy)
    rng = np.random.default_rng(80)
    f = lambda a: a.astype(np.float32)
    params = {'norm': {'gamma': f(1 + 0.1 * rng.normal(size=dim))},
              'to_qkv': {'kernel': f(rng.normal(size=(dim, 3 * dim_head))
                                     * 0.2)},
              'mem_kv': f(rng.normal(size=(2, 1, 4, dim_head))),
              'to_out': {'kernel': f(rng.normal(size=(dim_head, dim)) * 0.2)}}
    jmod = jattention.SpaceAttention(dim=dim, dim_head=dim_head, heads=1,
                                     backend='flash')
    port = pattention.SpaceAttention(dim, dim_head=dim_head, heads=1,
                                     backend='flash')
    state = {}
    _apply(state, _attention_entries('x', ()), params)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    x, g = _rand(shape, 81), _rand(shape, 82)

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
