"""The Taylor block (B3) at the head sizes its wide core takes (d = 16, 32),
against the JAX package on the CPU.

The conditioned stack builds its linear attention with the full attention's
heads (32 x 8 by default), and the port's CUDA core takes heads of 16 and
32 beside 8. Here the plain versions that stand in for the core on the CPU
are held to the JAX package at those sizes: the block in float32 against
``_taylor_fused`` in interpret mode and ``_taylor_reference`` (1e-5, the
same float32 math summed in another order), the no-norm route against
``apply_norm=False``, the twin's gradients against ``jax.grad`` /
``jax.vjp`` of ``_taylor_reference`` in float32 and in bf16 (the tolerances
of tests/test_torch_train_kernels.py), the card's ``autograd.Function`` with
its plain launch, and a small conditioned tokenizer at 32 x 8 heads (codes
exact, recon within 1e-3). Inputs are numpy draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.ops.pallas.taylor_attention import (
    _taylor_fused, _taylor_reference, taylor_linear_attention)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models import jax_import
from magvit2_pytorch_tpu_torch.ops import attention, basic
from magvit2_pytorch_tpu_torch.ops.kernels import (
    launch_counts, reset_launch_counts, taylor_attention as ta)
from test_torch_train_kernels import (
    BF16_FORWARD_REL, BF16_REL, REL, _F32Dots, _jax_grads, _rel_l1)

torch.set_num_threads(1)
TOL = 1e-5
HEADS = [(2, 32), (4, 16)]


def _block(heads, d, seed, n=128, c=64):
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    return (f(rng.normal(size=(2, n, c))), f(rng.uniform(0.5, 1.5, size=c)),
            f(rng.normal(size=(c, 3 * heads * d)) * 0.1),
            f(rng.normal(size=(heads * d, c)) * 0.1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('heads,d', HEADS)
def test_wide_heads_are_eligible(heads, d):
    assert ta.taylor_eligible(d)
    assert ta.taylor_core_route(torch.bfloat16, d) == 'mma'
    assert ta.taylor_core_route(torch.float32, d) == 'f32'
    assert ta.core_counter('mma', d) == 'taylor_core_wide_mma'
    assert ta.core_counter('f32', d) == 'taylor_core_f32'
    # [A | S]^T in bf16: d + 8 columns of the packed feature rows (576 at
    # 32, 192 at 16), sum v
    rows = {32: 576, 16: 192}[d]
    assert ta.wide_scratch_bytes(3, heads, d) == 3 * heads * (
        2 * (d + 8) * rows + 4 * d)


@pytest.mark.parametrize('heads,d', HEADS)
def test_plain_block_matches_pallas_and_reference(heads, d):
    x, gamma, wqkv, wout = _block(heads, d, 30 + d)
    j = [jnp.asarray(a) for a in (x, gamma, wqkv, wout)]
    fused = _taylor_fused(*j, heads, d, 1e-5, d ** -0.5, True, True)
    ref = _taylor_reference(j[0], j[2], j[3], heads, d, 1e-5, d ** -0.5,
                            gamma=j[1])
    got = ta.taylor_attention_ref(_t(x), _t(gamma), _t(wqkv.T), _t(wout.T),
                                  heads, d).numpy()
    np.testing.assert_allclose(got, np.asarray(fused), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=0)
    # the four launches composed on the CPU are the plain version
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in (_t(x), _t(gamma), _t(wqkv.T), _t(wout.T))]
        assert torch.equal(ta.taylor_launches(*args, heads, d),
                           ta.taylor_attention_ref(*args, heads, d))


@pytest.mark.parametrize('impl', ['reference', 'fused'])
def test_no_norm_route_at_32_matches_jax(impl):
    """The conditioned ``LinearAttention``'s route (``gamma=None``, three
    launches on the card) at d = 32 against ``taylor_linear_attention(...,
    gamma=None)``, as tests/test_torch_cond_gateloop.py holds it at 8; the
    Pallas kernel reads 2e-4 there, its sums in another order."""
    heads, d = 2, 32
    x, _, wqkv, wout = _block(heads, d, 33, c=32)
    want = taylor_linear_attention(jnp.asarray(x), jnp.asarray(wqkv),
                                   jnp.asarray(wout), heads, d, impl=impl,
                                   interpret=True, gamma=None)
    got = ta.taylor_attention(_t(x), None, _t(wqkv.T), _t(wout.T), heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if impl == 'fused' else TOL, rtol=0)
    for dt in (torch.float32, torch.bfloat16):
        args = (_t(x).to(dt), None, _t(wqkv.T).to(dt), _t(wout.T).to(dt))
        assert torch.equal(ta.taylor_launches(*args, heads, d),
                           ta.taylor_attention_ref(*args, heads, d))


@pytest.mark.parametrize('norm', [True, False], ids=['norm', 'no_norm'])
def test_twin_float32_gradients_at_32_match_jax(norm):
    heads, d = 2, 32
    x, gamma, wqkv, wout = _block(heads, d, 34)
    ct = np.random.default_rng(35).normal(size=x.shape).astype(np.float32)
    if norm:
        want = _jax_grads(lambda x, g, q, o: _taylor_reference(
            x, q, o, heads, d, 1e-5, d ** -0.5, gamma=g),
            (x, gamma, wqkv, wout), ct)
        arrays = (x, gamma, wqkv.T, wout.T)
    else:
        want = _jax_grads(lambda x, q, o: _taylor_reference(
            x, q, o, heads, d, 1e-5, d ** -0.5), (x, wqkv, wout), ct)
        arrays = (x, wqkv.T, wout.T)
    for fn in (ta.taylor_attention, ta.taylor_attention_twin):
        leaves = [_t(a).requires_grad_(True) for a in arrays]
        args = leaves if norm else (leaves[0], None, *leaves[1:])
        got = torch.autograd.grad(fn(*args, heads, d), leaves, _t(ct))
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            if i >= len(arrays) - 2:      # the weights, (out, in) here
                w = w.T
            assert np.abs(g.numpy() - w).max() <= REL * np.abs(w).max()


def test_twin_bf16_gradients_at_32_match_jax(monkeypatch):
    """The twin the card's backward differentiates keeps
    ``_taylor_reference``'s bf16 cast points at d = 32 (no norm, the
    conditioned route): dwout within ``BF16_FORWARD_REL``, dx and dwqkv
    within ``BF16_REL`` on average, where the same function in float32 math
    is not."""
    import magvit2_pytorch_tpu.ops.pallas.taylor_attention as jax_taylor
    monkeypatch.setattr(jax_taylor, 'jnp', _F32Dots())
    heads, d = 2, 32
    x, _, wqkv, wout = _block(heads, d, 36)
    ct = np.random.default_rng(37).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, q, o: _taylor_reference(
        x, q, o, heads, d, 1e-5, d ** -0.5),
        *[jnp.asarray(a, jnp.bfloat16) for a in (x, wqkv, wout)])
    want = vjp(jnp.asarray(ct, jnp.bfloat16))
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        leaves = [_t(a).to(torch.bfloat16).to(dt).requires_grad_(True)
                  for a in (x, wqkv, wout)]
        out = ta.taylor_attention_twin(leaves[0], None, leaves[1].T,
                                       leaves[2].T, heads, d)
        grads = torch.autograd.grad(
            out, leaves, _t(ct).to(torch.bfloat16).to(dt))
        errs[dt] = [_rel_l1(g.to(torch.bfloat16), w)
                    for g, w in zip(grads, want)]
    twin, f32 = errs[torch.bfloat16], errs[torch.float32]
    assert twin[-1] <= BF16_FORWARD_REL, twin
    assert np.mean(twin[:-1]) <= BF16_REL, twin
    assert np.mean(f32) > BF16_REL, f32


@pytest.mark.parametrize('heads,d', HEADS)
def test_card_function_recomputes_at_wide_heads(monkeypatch, heads, d):
    """The card's ``_TaylorBlock`` at d = 16 and 32, its launch standing in
    as the plain version: the forward is the plain block and the backward
    ``autograd.grad`` of the twin, bit for bit, one backward counted."""
    monkeypatch.setattr(ta, '_block_launch',
                        lambda x, g, q, o, h, dh, eps: ta.taylor_attention_ref(
                            x, g, q, o, h, dh, eps))
    x, gamma, wqkv, wout = _block(heads, d, 38, n=32)
    leaves = [_t(a).requires_grad_(True)
              for a in (x, gamma, wqkv.T, wout.T)]
    ct = _t(np.random.default_rng(39).normal(size=x.shape).astype(
        np.float32))
    reset_launch_counts()
    got = torch.autograd.grad(ta._TaylorBlock.apply(*leaves, heads, d, 1e-5),
                              leaves, ct)
    assert launch_counts()['taylor_attention_block_backward'] == 1
    want = torch.autograd.grad(ta.taylor_attention_twin(*leaves, heads, d),
                               leaves, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the conditioned stack in miniature at the full attention's 32 x 8 heads:
# its linear attention runs over 16 x 16 = 256 tokens a frame
COND_32X8 = dict(image_size=16, init_dim=16, codebook_size=64, dim_cond=4,
                 layers=('residual', 'cond_linear_attend_space',
                         ('compress_space', 16)),
                 attn_heads=8, attn_dim_head=32, use_gan=False,
                 perceptual_loss_weight=0.0)


def test_cond_tokenizer_at_32x8_heads_matches_jax():
    port = VideoTokenizer(device='cpu', seed=4, **COND_32X8)
    basic.live_squeeze_excite_(port.module, torch.Generator().manual_seed(2))
    linear = [m for m in port.module.modules()
              if isinstance(m, attention.TaylorSeriesLinearAttn)]
    assert [(m.heads, m.dim_head) for m in linear] == [(8, 32)] * 2
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_import.jax_params_from_state_dict(port.config,
                                              port.state_dict()))),
        **COND_32X8)
    rng = np.random.default_rng(40)
    video = rng.random((2, 5, 16, 16, 3), dtype=np.float32)
    cond = rng.normal(size=(2, 4)).astype(np.float32)
    codes_j, recon_j = jtok.forward(jnp.asarray(video), cond=jnp.asarray(cond),
                                    return_codes=True, return_recon=True)
    codes, recon = port.forward(video, cond=cond, return_codes=True,
                                return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-3,
                               rtol=0)
