"""The port's kernel modules (magvit2_pytorch_tpu_torch/ops/kernels) on the
CPU: each plain version against the JAX package's Pallas kernel run in
interpret mode, as tests/test_fused_attention.py and tests/test_taylor_fused.py
run them. Inputs come from a numpy seed; weights cross in each package's own
layout ((in, out) in JAX, (out, in) in the port). Tolerance: 1e-5 absolute
in float32 — the same float32 math summed in another order. The CUDA kernels
themselves run only on the card (chip_smoke.py)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.axial_attention import (
    fused_attention_block, fused_time_attention_block)
from magvit2_pytorch_tpu.ops.pallas.taylor_attention import _taylor_fused
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, axial_attention, launch_counts, reset_launch_counts,
    taylor_attention)

torch.set_num_threads(1)
TOL = 1e-5


def _attn_params(rng, c, heads, dh):
    inner = heads * dh
    f = lambda a: a.astype(np.float32)
    return dict(gamma=f(1 + 0.1 * rng.normal(size=c)),
                wqkv=f(rng.normal(size=(c, 3 * inner)) * 0.05),
                mem_kv=f(rng.normal(size=(2, heads, 4, dh))),
                wout=f(rng.normal(size=(inner, c)) * 0.05))


def _jax_attn(p):
    return [jnp.asarray(p[k]) for k in ('gamma', 'wqkv', 'mem_kv', 'wout')]


def _torch_attn(p):
    return [torch.from_numpy(p['gamma']), torch.from_numpy(p['wqkv'].T.copy()),
            torch.from_numpy(p['mem_kv']), torch.from_numpy(p['wout'].T.copy())]


@pytest.mark.parametrize('causal', [False, True])
def test_space_block_plain_matches_pallas(causal):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64, 128)).astype(np.float32)
    p = _attn_params(rng, 128, 4, 32)
    want = fused_attention_block(jnp.asarray(x), *_jax_attn(p), 4, 32,
                                 causal, True)               # interpret
    got = axial_attention.attention_block_ref(
        torch.from_numpy(x), *_torch_attn(p), 4, 32, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize('causal', [True, False])
def test_time_block_plain_matches_pallas(causal):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16, 128)).astype(np.float32)
    p = _attn_params(rng, 128, 4, 32)
    want = fused_time_attention_block(jnp.asarray(x), *_jax_attn(p), 4, 32,
                                      causal, True)          # interpret
    got = axial_attention.time_attention_block_ref(
        torch.from_numpy(x), *_torch_attn(p), 4, 32, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize('heads,d', [(8, 8), (4, 16)])
def test_taylor_block_plain_matches_pallas(heads, d):
    rng = np.random.default_rng(2)
    c = 64
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * heads * d)) * 0.1).astype(np.float32)
    wout = (rng.normal(size=(heads * d, c)) * 0.1).astype(np.float32)
    want = _taylor_fused(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(wqkv),
                         jnp.asarray(wout), heads, d, 1e-5, d ** -0.5, True,
                         True)                               # interpret
    got = taylor_attention.taylor_attention_ref(
        torch.from_numpy(x), torch.from_numpy(gamma),
        torch.from_numpy(wqkv.T.copy()), torch.from_numpy(wout.T.copy()),
        heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers return the plain result, count no launch
    and never build the CUDA library."""
    rng = np.random.default_rng(3)
    p = _torch_attn(_attn_params(rng, 128, 4, 32))
    reset_launch_counts()
    x = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    assert torch.equal(axial_attention.attention_block(x, *p, 4, 32),
                       axial_attention.attention_block_ref(x, *p, 4, 32))
    xt = torch.from_numpy(rng.normal(size=(1, 5, 8, 128)).astype(np.float32))
    assert torch.equal(
        axial_attention.time_attention_block(xt, *p, 4, 32),
        axial_attention.time_attention_block_ref(xt, *p, 4, 32))
    wqkv, wout = p[1][:3 * 64], p[3][:, :64]
    assert torch.equal(
        taylor_attention.taylor_attention(x, p[0], wqkv, wout, 8, 8),
        taylor_attention.taylor_attention_ref(x, p[0], wqkv, wout, 8, 8))
    assert set(launch_counts().values()) == {0}
    assert _build._lib is None


def test_bf16_plain_versions_track_float32():
    """The plain versions in bfloat16 keep the kernels' cast points and stay
    within the bf16 tolerance chip_smoke.py holds the kernels to (5e-2)."""
    rng = np.random.default_rng(4)
    p = _torch_attn(_attn_params(rng, 128, 4, 32))
    x = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    x16 = x.bfloat16()
    got = axial_attention.attention_block_ref(
        x16, *[t.bfloat16() for t in p], 4, 32)
    want = axial_attention.attention_block_ref(
        x16.float(), *[t.bfloat16().float() for t in p], 4, 32)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() < 5e-2


def test_build_targets_hopper_and_hashes_sources():
    nvcc = '/usr/local/cuda/bin/nvcc'
    out = _build.BUILD_DIR / 'lib.so'
    compiles, link = _build.nvcc_commands(nvcc, out)
    for cmd in (*compiles, link):
        assert cmd[0] == nvcc
        assert 'arch=compute_90a,code=sm_90a' in cmd
    cu = {p.name for p in _build.SOURCE_DIR.glob('*.cu')}
    assert cu == {'attention_block.cu', 'flash_attention.cu',
                  'residual_unit.cu', 'taylor_attention.cu'}
    # one compile per source, all objects linked into the library
    assert sorted(c[-1].rsplit('/', 1)[-1] for c in compiles) == sorted(cu)
    objects = [c[c.index('-o') + 1] for c in compiles]
    assert link[-len(objects):] == objects and str(out) in link
    h = hashlib.sha256(' '.join(_build.NVCC_FLAGS).encode())
    for p in _build.sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    assert _build.library_path().name == (
        f'libmagvit2_kernels_{h.hexdigest()[:16]}.so')
    # every C entry point the wrappers call is declared in the sources
    text = ''.join(p.read_text() for p in _build.sources())
    for name in (*_build.SIGNATURES, 'mv2_error_string'):
        assert name + '(' in text
