"""The Taylor block (B3) at the head sizes of its streamed cores (every head
up to 256 but 8, 16 and 32), against the JAX package on the CPU.

The port's gate takes every head of 1 to 256 (``taylor_eligible``), a
superset of the JAX kernel's VMEM fit; the CUDA cores run a head that is no
multiple of 8 zero-padded to the next. Here the plain versions that stand in
for the cores on the CPU are held to the JAX package: the block in float32
against ``_taylor_fused`` in interpret mode and ``_taylor_reference``
(1e-5, the same float32 math summed in another order) at (heads, d) = (2,
64), (1, 48), (1, 24), (1, 128); a head of 12 through the block's zero
padding of its weights' heads; the no-norm route at
64 against ``apply_norm=False``; the twin's gradients against ``jax.grad``
of ``_taylor_reference`` at 64; the card's ``autograd.Function`` with its
plain launch; and a small conditioned tokenizer at 64 x 2 heads (codes
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
from test_torch_taylor_heads import _block, _t
from test_torch_train_kernels import REL, _jax_grads

torch.set_num_threads(1)
TOL = 1e-5


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = True


@pytest.mark.parametrize('d', [1, 12, 24, 48, 64, 128, 221, 256])
def test_every_head_to_256_is_eligible(d):
    """The gate, the routes, the cores' head size (the next multiple of 8)
    and each call's counter and scratch; 257 keeps the plain version."""
    assert ta.taylor_eligible(d)
    assert ta.taylor_core_route(torch.bfloat16, d) == 'mma'
    assert ta.taylor_core_route(torch.float32, d) == 'f32'
    k = ta.kernel_dim_head(d)
    assert k % 8 == 0 and d <= k < d + 8
    assert ta.core_counter('mma', k) == ('taylor_core_mma' if k == 8
                                         else 'taylor_core_wide_mma')
    assert ta.core_counter('f32', k) == (
        'taylor_core_f32' if k in (8, 16, 32) else 'taylor_core_wide_f32')
    if k != 8:
        width = ta.core_width(k)
        assert width == {16: 16, 24: 32, 48: 64, 64: 64, 128: 128,
                         224: 256, 256: 256}[k]
        rows = len(ta.feature_pairs(k)[0])
        assert rows % 64 == 0
        assert ta.wide_scratch_bytes(2, 3, k) == 6 * (
            2 * (k + 8) * rows + 4 * k)
    if k not in (8, 16, 32):
        assert ta.wide_scratch_bytes(2, 3, k, 'f32') == 6 * 4 * (
            k + k * k + 1) * (-(-(k + 1) // 32) * 32)
    assert not ta.taylor_eligible(257)


@pytest.mark.parametrize('heads,d', [(2, 64), (1, 48), (1, 24), (1, 128)])
def test_plain_block_matches_pallas_and_reference(heads, d):
    """One frame of 128 tokens (the Pallas kernel's least), 32 channels."""
    x, gamma, wqkv, wout = _block(heads, d, 50 + d, c=32)
    x = x[:1]
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


def test_head_of_12_through_the_zero_padding():
    """The block at d = 12 runs its launches on weights whose heads are
    zero-padded to 16 (the qkv GEMM then gives zero q, k and v columns past
    12, the core runs a head of 16 and the out GEMM reads its zero columns
    against zero weights), composed on the CPU: within 1e-5 of
    ``_taylor_reference`` and ``_taylor_fused`` at 12. The core alone on
    the card takes a multiple of 8 only."""
    heads, d = 2, 12
    x, gamma, wqkv, wout = _block(heads, d, 60, c=32)
    x = x[:1]
    j = [jnp.asarray(a) for a in (x, gamma, wqkv, wout)]
    want = _taylor_reference(j[0], j[2], j[3], heads, d, 1e-5, d ** -0.5,
                             gamma=j[1])
    fused = _taylor_fused(*j, heads, d, 1e-5, d ** -0.5, True, True)
    assert ta.kernel_dim_head(d) == 16
    wq, wo = ta.pad_block_weights(_t(wqkv.T), _t(wout.T), heads, d, 16)
    assert wq.shape == (3 * heads * 16, 32) and wo.shape == (32, heads * 16)
    assert not wq.reshape(3, heads, 16, 32)[:, :, d:].any()
    assert not wo.reshape(32, heads, 16)[..., d:].any()
    got = ta.taylor_launches(_t(x), _t(gamma), _t(wqkv.T), _t(wout.T), heads,
                             d).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(fused), atol=TOL, rtol=0)
    qkv = torch.zeros(128, 3 * heads * d).as_subclass(_OnCard)
    with pytest.raises(ValueError, match='multiple of 8'):
        ta.taylor_core(qkv, 1, heads, d)


@pytest.mark.parametrize('impl', ['reference', 'fused'])
def test_no_norm_route_at_64_matches_jax(impl):
    """The conditioned ``LinearAttention``'s route (``gamma=None``) at
    d = 64 against ``taylor_linear_attention(..., gamma=None)`` on its
    reference and on the Pallas kernel in interpret mode
    (``apply_norm=False``), one frame of 128 tokens, within 1e-5."""
    heads, d = 2, 64
    x, _, wqkv, wout = _block(heads, d, 61, c=32)
    x = x[:1]
    want = taylor_linear_attention(jnp.asarray(x), jnp.asarray(wqkv),
                                   jnp.asarray(wout), heads, d, impl=impl,
                                   interpret=True, gamma=None)
    got = ta.taylor_attention(_t(x), None, _t(wqkv.T), _t(wout.T), heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    for dt in (torch.float32, torch.bfloat16):
        args = (_t(x).to(dt), None, _t(wqkv.T).to(dt), _t(wout.T).to(dt))
        assert torch.equal(ta.taylor_launches(*args, heads, d),
                           ta.taylor_attention_ref(*args, heads, d))


@pytest.mark.parametrize('norm', [True, False], ids=['norm', 'no_norm'])
def test_twin_float32_gradients_at_64_match_jax(norm):
    """The block's and the twin's gradients at d = 64 against ``jax.grad``
    of ``_taylor_reference``, within ``REL`` of the largest value."""
    heads, d = 2, 64
    x, gamma, wqkv, wout = _block(heads, d, 62, n=32, c=32)
    ct = np.random.default_rng(63).normal(size=x.shape).astype(np.float32)
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


def test_card_function_recomputes_at_64(monkeypatch):
    """The card's ``_TaylorBlock`` at 2 heads of 64, its launch standing in
    as the plain version: the forward is the plain block and the backward
    ``autograd.grad`` of the twin, bit for bit, one backward counted."""
    heads, d = 2, 64
    monkeypatch.setattr(ta, '_block_launch',
                        lambda x, g, q, o, h, dh, eps: ta.taylor_attention_ref(
                            x, g, q, o, h, dh, eps))
    x, gamma, wqkv, wout = _block(heads, d, 64, n=32, c=32)
    leaves = [_t(a).requires_grad_(True)
              for a in (x, gamma, wqkv.T, wout.T)]
    ct = _t(np.random.default_rng(65).normal(size=x.shape).astype(
        np.float32))
    reset_launch_counts()
    out = ta._TaylorBlock.apply(*leaves, heads, d, 1e-5)
    assert torch.equal(out, ta.taylor_attention_ref(*leaves, heads, d))
    got = torch.autograd.grad(out, leaves, ct)
    assert launch_counts()['taylor_attention_block_backward'] == 1
    want = torch.autograd.grad(ta.taylor_attention_twin(*leaves, heads, d),
                               leaves, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the conditioned stack in miniature at 64 x 2 heads: its linear attention
# takes the full attention's heads
COND_64X2 = dict(image_size=16, init_dim=8, codebook_size=64, dim_cond=4,
                 layers=('residual', 'cond_linear_attend_space',
                         ('compress_space', 16)),
                 attn_heads=2, attn_dim_head=64, use_gan=False,
                 perceptual_loss_weight=0.0)


def test_cond_tokenizer_at_64x2_heads_matches_jax():
    port = VideoTokenizer(device='cpu', seed=5, **COND_64X2)
    basic.live_squeeze_excite_(port.module, torch.Generator().manual_seed(3))
    linear = [m for m in port.module.modules()
              if isinstance(m, attention.TaylorSeriesLinearAttn)]
    assert [(m.heads, m.dim_head) for m in linear] == [(2, 64)] * 2
    assert all(ta.taylor_eligible(m.dim_head) for m in linear)
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_import.jax_params_from_state_dict(port.config,
                                              port.state_dict()))),
        **COND_64X2)
    rng = np.random.default_rng(66)
    video = rng.random((2, 5, 16, 16, 3), dtype=np.float32)
    cond = rng.normal(size=(2, 4)).astype(np.float32)
    codes_j, recon_j = jtok.forward(jnp.asarray(video), cond=jnp.asarray(cond),
                                    return_codes=True, return_recon=True)
    codes, recon = port.forward(video, cond=cond, return_codes=True,
                                return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=1e-3,
                               rtol=0)
