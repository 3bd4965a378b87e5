"""The port's kernel modules (magvit2_pytorch_tpu_torch/ops/kernels) on the
CPU: each plain version against the JAX package's Pallas kernel run in
interpret mode, as tests/test_fused_attention.py and tests/test_taylor_fused.py
run them. Inputs come from a numpy seed; weights cross in each package's own
layout ((in, out) in JAX, (out, in) in the port). Tolerance: 1e-5 absolute
in float32 — the same float32 math summed in another order. The CUDA kernels
themselves run only on the card (chip_smoke.py)."""

import ctypes
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.axial_attention import (
    fused_attention_block, fused_time_attention_block)
from magvit2_pytorch_tpu.ops.pallas.taylor_attention import (
    _block_masks, _taylor_frame, _taylor_fused)
from magvit2_pytorch_tpu_torch.ops import attention
from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, axial_attention, gemm, launch_counts, reset_launch_counts,
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


def _taylor_frame_eager(x, gamma, wqkv, wout, heads, d, eps=1e-5):
    """The TPU kernel's frame function run eagerly, one frame at a time, on
    numpy buffers standing in for its refs, with the argument dtypes
    ``_taylor_fused`` passes (``taylor_attention.py:260-264``): x and the
    weights in the working dtype, the gather matrices G and expE too, the
    masks numM and denM in float32. (Interpret mode on the CPU refuses the
    bf16 x bf16 -> float32 dot; the eager ops take it.)"""
    dt = x.dtype
    b, n, c = x.shape
    p = (d + 1) * heads * d
    g, num_m, den_m, exp_e = _block_masks(heads, d)
    out = np.zeros((b, n, c), dt)
    for f in range(b):
        _taylor_frame(x, gamma.reshape(1, c), wqkv, wout, g.astype(dt), num_m,
                      den_m, exp_e.astype(dt), out, np.zeros((n, p), dt),
                      np.zeros((n, p), dt), f, heads=heads, d=d, eps=eps,
                      scale=d ** -0.5, apply_norm=True)
    return out


# share of output elements where the plain version and the eager frame
# differ, at most, in bf16: read 0.33% at (8, 8), 1.52% at (4, 16) and
# 1.24% at (2, 32), the largest difference 0.80, 0.72 and 0.75 of a bf16
# step of the largest value (the same roundings summed in another order);
# the plain version without the kernel's cast points read 58% and 57%, and
# 1.60 and 1.43 steps, at the first two
@pytest.mark.parametrize('heads,d,max_share', [(8, 8, 0.01), (4, 16, 0.045),
                                               (2, 32, 0.04)])
def test_taylor_plain_keeps_the_kernels_bf16_cast_points(heads, d, max_share):
    """In bf16 the plain version rounds where ``_taylor_frame`` does (each
    phi entry twice, A and S after their float32 sums, 1 / (den + eps)),
    and keeps sum v and N in float32: it stays within one bf16 step of the
    largest value (2^-8 relative) and differs in few elements."""
    rng = np.random.default_rng(6)
    c, n = 64, 256
    x = rng.normal(size=(2, n, c))
    gamma = rng.uniform(0.5, 1.5, size=c)
    wqkv = rng.normal(size=(c, 3 * heads * d)) * 0.1
    wout = rng.normal(size=(heads * d, c)) * 0.1
    bf = jnp.bfloat16
    want = _taylor_frame_eager(*(a.astype(bf) for a in (x, gamma, wqkv, wout)),
                               heads, d).astype(np.float32)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    got = taylor_attention.taylor_attention_ref(
        t(x), t(gamma), t(wqkv.T), t(wout.T), heads, d).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -8 * np.abs(want).max()
    assert (diff > 0).mean() <= max_share


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = True


@pytest.mark.parametrize('dim_head,kernel', [(8, True), (16, True),
                                             (32, True), (257, False)])
def test_taylor_gate_keeps_other_head_sizes_off_the_kernel(
        monkeypatch, dim_head, kernel):
    """``TaylorSeriesLinearAttn`` on the card: a head size the CUDA cores
    take (every head of 1 to 256) reaches the kernel wrapper, any other
    (257, past the JAX kernel's VMEM fit too) the plain version, whatever
    the device (without the gate the wrapper raises there)."""
    rng = np.random.default_rng(7)
    mod = attention.TaylorSeriesLinearAttn(64, dim_head=dim_head, heads=4)
    init_module_parameters(mod, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(1, 16, 64)).astype(np.float32))
    gamma = torch.ones(64)
    args = (gamma, mod.to_qkv[0].weight.detach(),
            mod.to_out[1].weight.detach(), 4, dim_head)
    if not kernel:
        with pytest.raises(ValueError, match=f'dim_head {dim_head}'):
            taylor_attention.taylor_attention(
                x.as_subclass(_OnCard),
                *(a.as_subclass(_OnCard) for a in args[:3]), *args[3:])
    calls = []

    def spy(x, *a, **kw):
        calls.append(a[3:5])       # heads, dim_head
        return torch.zeros_like(x)

    monkeypatch.setattr(attention, 'taylor_attention', spy)
    with torch.no_grad():
        out = mod(x.as_subclass(_OnCard), gamma)
    assert calls == ([(4, dim_head)] if kernel else [])
    if not kernel:
        assert torch.equal(out.as_subclass(torch.Tensor),
                           taylor_attention.taylor_attention_ref(x, *args))


@pytest.mark.parametrize('dtype,dim_head,route', [
    (torch.bfloat16, 8, 'mma'), (torch.float32, 8, 'f32'),
    (torch.bfloat16, 16, 'mma'), (torch.float32, 16, 'f32'),
    (torch.bfloat16, 32, 'mma'), (torch.float32, 32, 'f32')])
def test_taylor_core_route(dtype, dim_head, route):
    assert taylor_attention.taylor_eligible(dim_head)
    assert taylor_attention.taylor_core_route(dtype, dim_head) == route


@pytest.mark.parametrize('dtype,dim_head,error', [
    (torch.bfloat16, 257, ValueError), (torch.float32, 257, ValueError),
    (torch.float16, 8, TypeError)])
def test_taylor_core_route_refuses_what_no_core_takes(dtype, dim_head, error):
    with pytest.raises(error):
        taylor_attention.taylor_core_route(dtype, dim_head)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_gemm_epilogue_scales_the_first_columns(dtype):
    """The qkv GEMM's epilogue option: the first ``scaled_cols`` columns
    times the scale in float32, then one cast (the JAX kernel's
    ``(qkv[:, :hd] * scale).astype(x.dtype)``); the other columns as
    without it. The wrapper on a CPU tensor is the plain version."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(48, 64)).astype(np.float32))
    a, w = (t.to(dtype) for t in (a, w))
    acc = a.float() @ w.float().T
    got = gemm.gemm_nt(a, w, scaled_cols=16, col_scale=8 ** -0.5)
    assert got.dtype == dtype
    assert torch.equal(got[:, :16], (acc[:, :16] * 8 ** -0.5).to(dtype))
    assert torch.equal(got[:, 16:], gemm.gemm_nt_ref(a, w)[:, 16:])
    assert torch.equal(got, gemm.gemm_nt_ref(a, w, 16, 8 ** -0.5))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_taylor_launches_compose_to_the_plain_block(dtype):
    """The wrapper's four launches (norm, qkv GEMM with the scaled q, the
    core, out GEMM), each on its plain version, give the plain block; the
    core takes q scaled and cast by the GEMM."""
    rng = np.random.default_rng(9)
    c, heads, d = 64, 4, 8
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32) * 0.3).to(dtype)
    x, gamma = t(3, 20, c), 1 + t(c)
    wqkv, wout = t(3 * heads * d, c), t(c, heads * d)
    reset_launch_counts()
    got = taylor_attention.taylor_launches(x, gamma, wqkv, wout, heads, d)
    assert torch.equal(got, taylor_attention.taylor_attention_ref(
        x, gamma, wqkv, wout, heads, d))
    assert set(launch_counts().values()) == {0}


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
    a, w = x.reshape(-1, 128), p[1]
    assert torch.equal(gemm.gemm_nt(a, w), gemm.gemm_nt_ref(a, w))
    assert torch.equal(gemm.rmsnorm(a, p[0]), gemm.rmsnorm_ref(a, p[0]))
    qkv = gemm.gemm_nt_ref(a, w)
    mem_k, mem_v = p[2]
    layout = axial_attention.space_layout(x)
    assert torch.equal(
        axial_attention.attention_core(qkv, mem_k, mem_v, 4, 32, True,
                                       **layout),
        axial_attention.attention_core_ref(qkv, mem_k, mem_v, 4, 32, True,
                                           **layout))
    assert set(launch_counts().values()) == {0}
    assert _build._lib is None


def test_bf16_plain_versions_track_float32():
    """The plain versions in bfloat16 keep the kernels' cast points and stay
    within the bf16 tolerance chip_smoke.py holds the kernels to (2e-2 of
    the largest value)."""
    rng = np.random.default_rng(4)
    p = _torch_attn(_attn_params(rng, 128, 4, 32))
    x = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    x16 = x.bfloat16()
    got = axial_attention.attention_block_ref(
        x16, *[t.bfloat16() for t in p], 4, 32)
    want = axial_attention.attention_block_ref(
        x16.float(), *[t.bfloat16().float() for t in p], 4, 32)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() < 2e-2 * want.abs().max()


def test_build_targets_hopper_and_hashes_sources():
    nvcc = '/usr/local/cuda/bin/nvcc'
    out = _build.BUILD_DIR / 'lib.so'
    compiles, link = _build.nvcc_commands(nvcc, out)
    for cmd in (*compiles, link):
        assert cmd[0] == nvcc
        assert 'arch=compute_90a,code=sm_90a' in cmd
    cu = {p.name for p in _build.SOURCE_DIR.glob('*.cu')}
    assert cu == {'attention_block.cu', 'flash_attention.cu', 'gemm.cu',
                  'int8_conv.cu', 'residual_unit.cu', 'taylor_attention.cu',
                  'time_attention.cu'}
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


# C parameter types -> the ctypes type a SIGNATURES entry must give them
_C_TYPES = {'const void*': ctypes.c_void_p, 'void*': ctypes.c_void_p,
            'int': ctypes.c_int, 'long long': ctypes.c_int64,
            'float': ctypes.c_float}


def test_c_signatures_match_the_entry_points():
    """Every SIGNATURES entry has the C definition's arguments, one for one:
    a missing or mistyped argument shifts every later one, the stream
    included, and then fails only on the card."""
    text = ''.join(p.read_text() for p in _build.SOURCE_DIR.glob('*.cu'))
    defs = dict(re.findall(r'\bint (mv2_\w+)\(([^)]*)\)\s*\{', text))
    assert set(defs) == set(_build.SIGNATURES)
    for name, params in defs.items():
        types = [re.sub(r'\s+', ' ', p.strip()).rsplit(' ', 1)[0]
                 for p in params.split(',')]
        assert [_C_TYPES[t] for t in types] == _build.SIGNATURES[name], name


def _aligned(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# the projections of the flagship's blocks, (M, N, K): B1, B2, B3 qkv / out
@pytest.mark.parametrize('m,n,k', [
    (40960, 768, 512), (40960, 512, 256), (10240, 768, 512),
    (10240, 512, 256), (163840, 384, 256), (163840, 256, 128)])
def test_gemm_route_takes_wgmma_at_the_main_path_shapes(m, n, k):
    a, w = _aligned(8, k), _aligned(n, k)      # m does not enter the rule
    assert gemm.gemm_route(n, k, torch.bfloat16, a, w) == 'wgmma'


@pytest.mark.parametrize('n,k,offset,dtype,route', [
    (768, 100, 0, torch.bfloat16, 'wmma'),     # ragged K
    (200, 512, 0, torch.bfloat16, 'wmma'),     # N not a multiple of 64
    (768, 512, 1, torch.bfloat16, 'wmma'),     # a row start off 16 bytes
    (768, 512, 0, torch.float32, 'f32')])
def test_gemm_route_keeps_other_shapes_off_wgmma(n, k, offset, dtype, route):
    a = _aligned(8 * k + offset)[offset:].view(8, k)
    assert gemm.gemm_route(n, k, dtype, a, _aligned(n, k)) == route


@pytest.mark.parametrize('dtype,keys,inner_groups,pos_stride,route', [
    (torch.bfloat16, 260, 1, 1, 'mma'),        # the flagship's space block
    (torch.bfloat16, 1028, 1, 1, 'mma'),       # n = 1024, the gate's edge
    (torch.bfloat16, 9, 256, 256, 'scalar'),   # the time block
    (torch.float32, 260, 1, 1, 'scalar')])
def test_core_route(dtype, keys, inner_groups, pos_stride, route):
    assert axial_attention.core_route(dtype, 32, keys, inner_groups,
                                      pos_stride) == route


def test_launch_counts_name_the_routes_and_reset():
    names = ('gemm_wgmma', 'gemm_wmma', 'gemm_f32',
             'space_attention_core_mma', 'taylor_core_mma',
             'taylor_core_f32')
    assert set(names) <= set(launch_counts())
    gemm.LAUNCHES['gemm_wgmma'] += 3
    axial_attention.LAUNCHES['space_attention_core_mma'] += 1
    taylor_attention.LAUNCHES['taylor_core_mma'] += 2
    assert launch_counts()['gemm_wgmma'] == 3
    assert launch_counts()['taylor_core_mma'] == 2
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


@pytest.mark.parametrize('block', ['space', 'time'])
def test_block_launches_compose_to_the_plain_block(block):
    """The wrapper's four launches (norm, qkv GEMM, the core over the
    block's group layout, out GEMM), each on its plain version, give the
    plain block: the layout the cores take maps every (group, position) to
    its row."""
    rng = np.random.default_rng(5)
    p = _torch_attn(_attn_params(rng, 128, 4, 32))
    shape = (3, 17, 128) if block == 'space' else (2, 5, 6, 128)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    layout = getattr(axial_attention, f'{block}_layout')(x)
    ref = (axial_attention.attention_block_ref if block == 'space'
           else axial_attention.time_attention_block_ref)
    got = axial_attention.block_launches(x, *p, 4, 32, block == 'time',
                                         **layout)
    np.testing.assert_allclose(got.numpy(), ref(x, *p, 4, 32,
                                                block == 'time').numpy(),
                               atol=TOL, rtol=0)
