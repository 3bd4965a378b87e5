"""The space and time attention blocks (B1, B2) at every head size their
CUDA kernels take, against the JAX package on the CPU.

The kernels take each head size d that is a multiple of 8 from 8 to 128
(``takes_dim_head``), at padded widths of 16, 32, 64 and 128 with the true
d at run time; the plain versions that stand in for them on the CPU are
held here to the JAX package at d = 8, 24, 64 and 128 (C = 128, inner 128,
or 192 at d = 24): the space block on 2 frames of 16 tokens and the time
block on (2, 5, 16, 128), 2 memory keys each. float32 against
``fused_attention_block`` / ``fused_time_attention_block`` in interpret mode
within 1e-5 (the same float32 math summed in another order). bf16 against
the TPU kernels' bodies traced under ``jax.jit`` (interpret mode on the CPU
refuses the bf16 x bf16 -> float32 dot), within the d = 32 tests' bf16
limits: the
space block 5e-2 absolute (tests/test_torch_port_attend.py
``test_general_attention_path_bf16_tracks_jax``), the time block one bf16
step of the largest value (tests/test_torch_time_block.py
``test_time_plain_keeps_the_kernels_bf16_cast_points``). Then the card's
``autograd.Function`` at d = 64 with its plain launch, its gradients against
``jax.grad`` of the JAX block (tests/test_torch_train_kernels.py's 1e-4 of
the largest value), and a tiny tokenizer at 64 x 2 heads whose space and
time attention take the blocks, against the JAX tokenizer on the same
weights (codes exact, latents and recon within 1e-5). Inputs are numpy
draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.ops.pallas.axial_attention import (
    _kernel, _time_kernel, _time_s_blk, fused_attention_block,
    fused_time_attention_block)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models import jax_import
from magvit2_pytorch_tpu_torch.ops import attention
from magvit2_pytorch_tpu_torch.ops.kernels import (
    axial_attention as ax, launch_counts, reset_launch_counts)
from test_torch_time_block import _bf16_step
from test_torch_train_kernels import (
    ATTN_LAYOUT, _check, _jax_grads, _leaves, _port_attn)

torch.set_num_threads(1)
TOL = 1e-5
SPACE_BF16_TOL = 5e-2
C = 128
HEADS = {8: 16, 24: 8, 64: 2, 128: 1}       # d -> heads: inner 128 (192)


def _inputs(block, d, seed):
    """x, then gamma, wqkv, mem_kv, wout in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    heads, f = HEADS[d], lambda a: a.astype(np.float32)
    inner = heads * d
    shape = (2, 16, C) if block == 'space' else (2, 5, 16, C)
    return (f(rng.normal(size=shape)), f(1 + 0.1 * rng.normal(size=C)),
            f(rng.normal(size=(C, 3 * inner)) * C ** -0.5),
            f(rng.normal(size=(2, heads, 2, d))),
            f(rng.normal(size=(inner, C)) * inner ** -0.5))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _port(arrays, dtype=torch.float32):
    x, gamma, wqkv, mem_kv, wout = arrays
    return [_t(a, dtype) for a in (x, gamma, wqkv.T, mem_kv, wout.T)]


class _OutRef:
    """The output ref of a TPU kernel body traced under ``jax.jit``: the
    body's one store becomes the traced function's result."""

    def __setitem__(self, index, value):
        self.value = value


def _traced(body, *refs, **static):
    out = _OutRef()
    body(*refs, out, **static)
    return out.value


def _space_kernel_bf16(x, gamma, wqkv, mem_kv, wout, heads, d):
    """``_kernel``'s body over all frames in one grid step, with the
    argument dtypes ``fused_attention_block`` passes (all bf16), traced
    under ``jax.jit`` (interpret mode on the CPU refuses the bf16 x bf16 ->
    float32 dot; XLA's CPU dot takes it)."""
    f, n, c = x.shape
    run = jax.jit(lambda *a: _traced(
        _kernel, *a, N=n, C=c, H=heads, D=d, M=mem_kv.shape[2], F=f,
        causal=False))
    return run(x, gamma.reshape(1, c), wqkv, mem_kv[0], mem_kv[1], wout)


def _time_kernel_bf16(x, gamma, wqkv, mem_kv, wout, heads, d):
    """``_time_kernel``'s body, one (batch, pixel tile) grid step at a time,
    as ``_space_kernel_bf16``."""
    b, t, s, c = x.shape
    blk = _time_s_blk(t, s)
    run = jax.jit(lambda *a: _traced(
        _time_kernel, *a, T=t, S_BLK=blk, C=c, H=heads, D=d,
        M=mem_kv.shape[2], causal=True))
    return jnp.concatenate([jnp.concatenate([
        run(x[i:i + 1, :, s0:s0 + blk], gamma.reshape(1, c), wqkv,
            mem_kv[0], mem_kv[1], wout)
        for s0 in range(0, s, blk)], axis=2) for i in range(b)])


def test_the_head_rule_and_the_core_routes():
    """Every multiple of 8 from 8 to 128 and nothing else; the resident
    core's shared memory (K and V, rows of the padded width plus 8, padded
    to 16 keys, within 227 KB) decides between it and the ring."""
    taken = [d for d in range(0, 200) if ax.takes_dim_head(d)]
    assert taken == list(range(8, 129, 8))
    assert [ax.mma_width(d) for d in (8, 16, 24, 40, 64, 72, 128)] == [
        16, 16, 32, 64, 64, 128, 128]
    for d, most in ((32, 1440), (64, 800), (128, 416)):
        assert ax.space_core_fits(most, d)
        assert not ax.space_core_fits(most + 1, d)
    route = lambda dt, d, keys, g=1, p=1: ax.core_route(dt, d, keys, g, p)
    bf16 = torch.bfloat16
    assert route(bf16, 64, 260) == 'mma'          # the flagship at 64 x 4
    assert route(bf16, 128, 260) == 'mma'
    assert route(bf16, 32, 1028) == 'mma'         # config 4 at 32 x 8
    assert route(bf16, 64, 1028) == 'mma_ring'    # config 4 at 64 x 4
    assert route(bf16, 64, 9, 256, 256) == 'scalar'   # the time layout
    assert route(torch.float32, 64, 260) == 'scalar'
    with pytest.raises(ValueError, match='dim_head 12'):
        route(bf16, 12, 260)


@pytest.mark.parametrize('d', sorted(HEADS))
def test_plain_space_block_matches_pallas(d):
    arrays = _inputs('space', d, d)
    heads = HEADS[d]
    want = jax.jit(fused_attention_block, static_argnums=range(5, 9))(
        *arrays, heads, d, False, True)                      # interpret
    got = ax.attention_block_ref(*_port(arrays), heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    bf = jnp.bfloat16
    want16 = _space_kernel_bf16(*(jnp.asarray(a, bf) for a in arrays), heads,
                                d)
    got16 = ax.attention_block_ref(*_port(arrays, torch.bfloat16), heads, d)
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32),
                               atol=SPACE_BF16_TOL, rtol=0)


@pytest.mark.parametrize('d', sorted(HEADS))
def test_plain_time_block_matches_pallas(d):
    arrays = _inputs('time', d, 100 + d)
    heads = HEADS[d]
    want = jax.jit(fused_time_attention_block, static_argnums=range(5, 9))(
        *arrays, heads, d, True, True)                       # interpret
    got = ax.time_attention_block_ref(*_port(arrays), heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    bf = jnp.bfloat16
    want16 = np.asarray(_time_kernel_bf16(
        *(jnp.asarray(a, bf) for a in arrays), heads, d), np.float32)
    got16 = ax.time_attention_block_ref(*_port(arrays, torch.bfloat16), heads,
                                        d)
    diff = np.abs(got16.float().numpy() - want16)
    assert diff.max() <= _bf16_step(np.abs(want16).max())


@pytest.mark.parametrize('block', ['space', 'time'])
def test_card_function_at_64_matches_jax(block):
    """The card's ``_Block`` at 64 x 2 heads, its launch standing in as the
    plain version: the forward is the plain block, the backward recomputes
    through the twin (one backward counted), and the gradients of x and
    every parameter match ``jax.grad`` of the JAX block in interpret mode
    (whose custom VJP differentiates its XLA twin)."""
    d, heads = 64, HEADS[64]
    arrays = _inputs(block, d, 7)
    x = arrays[0]
    ct = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    if block == 'space':
        jax_fn = lambda *a: fused_attention_block(*a, heads, d, False, True)
        plain, twin = ax.attention_block_ref, ax.attention_block_ref
        name, causal = 'space_attention_block', False
    else:
        jax_fn = lambda *a: fused_time_attention_block(*a, heads, d, True,
                                                       True)
        plain = ax.time_attention_block_ref
        twin = ax.time_attention_block_twin
        name, causal = 'time_attention_block', True
    want = _jax_grads(jax_fn, arrays, ct)
    leaves = _leaves(x, *_port_attn(arrays[1:]))
    reset_launch_counts()
    out = ax._Block.apply(*leaves, heads, d, causal, plain, twin, name)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    assert launch_counts()[f'{name}_backward'] == 1
    assert torch.equal(out, plain(*leaves, heads, d, causal))
    _check(got, want, [None] + ATTN_LAYOUT)


# the README flagship's head shape (64-wide heads) in a tiny stack: space
# attention over 8 x 8 tokens, time attention over 3 frames
HEADS_64 = dict(image_size=16, init_dim=8, codebook_size=64,
                layers=('residual', ('compress_space', 12), 'attend_space',
                        ('compress_time', 16), 'attend_time'),
                attn_heads=2, attn_dim_head=64, use_gan=False,
                perceptual_loss_weight=0.0)


def test_tokenizer_at_64x2_heads_takes_the_blocks_and_matches_jax(
        monkeypatch):
    calls = []
    for fn in ('attention_block', 'time_attention_block'):
        real = getattr(attention, fn)
        monkeypatch.setattr(attention, fn, lambda *a, _r=real, _f=fn, **k: (
            calls.append(_f), _r(*a, **k))[1])
    port = VideoTokenizer(device='cpu', seed=3, **HEADS_64)
    attn = [m for m in port.module.modules()
            if isinstance(m, attention.Attention)]
    assert [(m.heads, m.dim_head) for m in attn] == [(2, 64)] * 4
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_import.jax_params_from_state_dict(port.config,
                                              port.state_dict()))),
        **HEADS_64)
    video = np.random.default_rng(9).random((2, 5, 16, 16, 3),
                                            dtype=np.float32)
    jv = jnp.asarray(video)
    np.testing.assert_allclose(port.encode(video).numpy(),
                               np.asarray(jtok.encode(jv)), atol=TOL, rtol=0)
    assert sorted(set(calls)) == ['attention_block', 'time_attention_block']
    codes_j, recon_j = jtok.forward(jv, return_codes=True, return_recon=True)
    codes, recon = port.forward(video, return_codes=True, return_recon=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=TOL,
                               rtol=0)
