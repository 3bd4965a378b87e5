"""The port's time attention block (``ops/kernels/axial_attention.py``,
``csrc/time_attention.cu``) on the CPU: the bf16 plain version against the
TPU kernel's body run eagerly, the route rule, the fused kernel's tiling, and
what the wrapper passes to C on each route (a stand-in library and a tensor
that says it lies on the card). The kernel itself, and its launcher's plan,
run only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.axial_attention import (
    _time_kernel, _time_s_blk)
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, axial_attention as ax, launch_counts, reset_launch_counts)

torch.set_num_threads(1)


def _time_kernel_eager(x, gamma, wqkv, mem_kv, wout, heads, d, causal):
    """``_time_kernel`` run eagerly, one (batch, pixel tile) grid step at a
    time, on numpy buffers standing in for its refs, with the argument
    dtypes ``fused_time_attention_block`` passes (all in the working dtype).
    (Interpret mode on the CPU refuses the bf16 x bf16 -> float32 dot; the
    eager ops take it.)"""
    b, t, s, c = x.shape
    blk = _time_s_blk(t, s)
    out = np.zeros_like(x)
    for i in range(b):
        for s0 in range(0, s, blk):
            o = np.zeros((1, t, blk, c), x.dtype)
            _time_kernel(x[i:i + 1, :, s0:s0 + blk], gamma.reshape(1, c),
                         wqkv, mem_kv[0], mem_kv[1], wout, o, T=t, S_BLK=blk,
                         C=c, H=heads, D=d, M=mem_kv.shape[2], causal=causal)
            out[i, :, s0:s0 + blk] = o[0]
    return out


def _bf16_step(v):
    """bf16's spacing at |v|: 2^(exponent - 7)."""
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)


# share of output elements where the plain version and the eager kernel
# differ in bf16, at most: read 0.12% (T = 1), 1.38% / 1.45% (T = 5, causal
# / not) and 0.24% / 0.28% (T = 16), the largest difference 0.25 to 1.0 of
# a bf16 step of the largest value (the same roundings summed in another
# order). The earlier plain version, through ``attend_with_memory`` (P V
# rounded to bf16 before the memory keys' part was added) and bf16
# ``F.linear``, read 59.5% to 61.1%, and 0.95 to 1.77 steps of 2^-8 of the
# largest value.
MAX_SHARE = 0.03


@pytest.mark.parametrize('t', [1, 5, 16])
@pytest.mark.parametrize('causal', [True, False])
def test_time_plain_keeps_the_kernels_bf16_cast_points(t, causal):
    """In bf16 the plain version rounds where ``_time_kernel`` does (the
    normed x, qkv, e before the products with v and mem_v, the attention
    output, the block output) and sums in float32: it stays within one
    bf16 step of the largest value and differs in few elements."""
    rng = np.random.default_rng(10 + t)
    c, heads, d, s, b = 128, 4, 32, 32, 2
    inner = heads * d
    x = rng.normal(size=(b, t, s, c))
    gamma = 1 + 0.1 * rng.normal(size=c)
    wqkv = rng.normal(size=(c, 3 * inner)) * c ** -0.5
    mem_kv = rng.normal(size=(2, heads, 4, d))
    wout = rng.normal(size=(inner, c)) * inner ** -0.5
    bf = jnp.bfloat16
    want = _time_kernel_eager(
        *(a.astype(bf) for a in (x, gamma, wqkv, mem_kv, wout)), heads, d,
        causal).astype(np.float32)

    def tt(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).astype(np.float32)).bfloat16()

    got = ax.time_attention_block_ref(
        tt(x), tt(gamma), tt(wqkv.T), tt(mem_kv), tt(wout.T), heads, d,
        causal)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= _bf16_step(np.abs(want).max())
    assert (diff > 0).mean() <= MAX_SHARE


def _tensors(*shape, offset=0, dtype=torch.bfloat16):
    """A zero tensor whose storage starts ``offset`` elements past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(*shape)


FLAGSHIP = dict(t=5, s=256, c=512, heads=8, dim_head=32, m=4)


@pytest.mark.parametrize('change,route', [
    ({}, 'fused'),                                 # the flagship's block
    ({'dtype': torch.float32}, 'launches'),
    ({'c': 1024}, 'launches'),                     # the x panel: 128 KB
    ({'c': 576}, 'launches'),                      # past TIME_MAX_C
    ({'heads': 16}, 'launches'),                   # qkv rows: 3 x 512 wide
    ({'heads': 12}, 'launches'),                   # past TIME_MAX_INNER
    ({'offset': 1}, 'launches'),                   # a row start off 16 B
    ({'t': 16}, 'fused'), ({'t': 17}, 'launches'),
    ({'m': 0}, 'fused'), ({'m': 5}, 'launches'),
    ({'c': 96}, 'launches'),                       # not a 64-channel chunk
    ({'dim_head': 64, 'heads': 4}, 'fused'),       # README flagship, 64 x 4
    ({'dim_head': 8, 'heads': 32}, 'fused'),       # the narrowest head
    ({'dim_head': 128, 'heads': 2}, 'fused'),      # the widest head
    ({'dim_head': 12, 'heads': 16}, 'launches'),   # not a multiple of 8
    ({'dim_head': 16, 'heads': 24}, 'launches'),   # inner 384
    ({'c': 64, 'heads': 2}, 'fused'),              # the narrowest taken
    ({'s': 100, 'c': 256}, 'fused')])              # ragged tiles, C 256
def test_time_block_route(change, route):
    kw = dict(FLAGSHIP, **change)
    dtype = kw.pop('dtype', torch.bfloat16)
    offset = kw.pop('offset', 0)
    inner = kw['heads'] * kw['dim_head']
    x = _tensors(8, kw['t'], kw['s'], kw['c'], offset=offset, dtype=dtype)
    params = (_tensors(kw['c'], dtype=dtype),
              _tensors(3 * inner, kw['c'], dtype=dtype),
              _tensors(2, kw['heads'], kw['m'], kw['dim_head'], dtype=dtype),
              _tensors(kw['c'], inner, dtype=dtype))
    assert ax.time_block_route(dtype, *kw.values(), x, *params) == route


@pytest.mark.parametrize('which', range(4))
def test_time_block_route_wants_every_parameter_aligned(which):
    """gamma, wqkv, mem_kv and wout: the kernel reads each in 16-byte
    pieces (TMA for the weights), so one starting off 16 bytes keeps the
    call on the launches."""
    kw = dict(FLAGSHIP)
    inner = kw['heads'] * kw['dim_head']
    shapes = ((kw['c'],), (3 * inner, kw['c']),
              (2, kw['heads'], kw['m'], kw['dim_head']), (kw['c'], inner))
    params = [_tensors(*shape, offset=int(i == which))
              for i, shape in enumerate(shapes)]
    x = _tensors(8, kw['t'], kw['s'], kw['c'])
    assert ax.time_block_route(torch.bfloat16, *kw.values(), x,
                               *params) == 'launches'


@pytest.mark.parametrize('b,t,s,sms,p', [
    (8, 5, 256, 132, 8),       # the flagship: 256 blocks, two waves
    (8, 5, 256, 176, 12),      # one wave takes the most pixels
    (2, 5, 100, 132, 2),       # 100 blocks fill one wave
    (2, 16, 100, 132, 2), (3, 1, 100, 132, 3), (1, 16, 7, 132, 1),
    (4, 16, 1000, 132, 3),     # 3 pixels x 16 frames: the most rows, 48
    (1, 1, 4096, 132, 32)])    # 128 blocks in one wave
def test_the_tile_takes_the_fewest_pixels_that_keep_its_waves(b, t, s, sms,
                                                              p):
    assert ax.time_block_pixels(b, t, s, sms) == p
    waves = lambda q: -(-b * -(-s // q) // sms)
    assert p * t <= ax.TIME_MAX_ROWS
    assert waves(p) == waves(ax.TIME_MAX_ROWS // t)
    assert p == 1 or waves(p - 1) > waves(p)


def _tile_rows(b, tile, t, s, p):
    """The rows of ``x.reshape(-1, C)`` that block (tile, b) of
    ``csrc/time_attention.cu`` reads and writes, in panel order (row
    ``t' * p + i``): frame t' of pixel ``s0 + i``, s0 = tile * p, is row
    ``(b * t + t') * s + s0 + i``; pixels past s are masked."""
    s0 = tile * p
    return [(b * t + f) * s + s0 + i for f in range(t) for i in range(p)
            if s0 + i < s]


@pytest.mark.parametrize('t', [1, 5, 16])
@pytest.mark.parametrize('s', [100, 256])
@pytest.mark.parametrize('sms', [8, 132])
def test_time_tiles_cover_every_row_once(t, s, sms):
    """Every (b, t, s) row of ``x.reshape(-1, C)`` falls in exactly one
    tile, the tiles of a batch index never reach into another, and a tile
    holds at most its R = t * P rows."""
    b = 3
    p = ax.time_block_pixels(b, t, s, sms)
    tiles = -(-s // p)
    seen = []
    for i in range(b):
        for tile in range(tiles):
            rows = _tile_rows(i, tile, t, s, p)
            assert 0 < len(rows) <= t * p <= ax.TIME_MAX_ROWS
            assert all(i * t * s <= row < (i + 1) * t * s for row in rows)
            seen += rows
    assert sorted(seen) == list(range(b * t * s))


class _Library:
    """Stands in for the CUDA library: records each entry point called with
    its arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        types = _build.SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(types), name
            self.calls.append((name, args))
            return 0
        return entry


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = True


@pytest.mark.parametrize('dtype,route', [(torch.bfloat16, 'fused'),
                                         (torch.float32, 'launches')])
def test_each_route_launches_and_counts(monkeypatch, dtype, route):
    """bf16 at a shape the tile takes: one call of the fused entry point
    with the shape, the tiling's pixel count, causal and the route code,
    and no other launch; float32: the four launches on the time layout.
    Each counts the block once and its route once."""
    lib = _Library()
    monkeypatch.setattr(_build, 'load_library', lambda: lib)
    monkeypatch.setattr(_build, 'stream_handle', lambda device: 0)
    monkeypatch.setattr(ax, '_sm_count', lambda device: 132)
    layouts = []

    def four_launches(x, *args, **layout):
        layouts.append(layout)
        return x

    monkeypatch.setattr(ax, 'block_launches', four_launches)
    b, t, s, c, heads = 2, 5, 100, 128, 4
    x = _tensors(b, t, s, c, dtype=dtype)
    gamma = torch.ones(c, dtype=dtype)
    wqkv = _tensors(3 * heads * 32, c, dtype=dtype)
    mem_kv = torch.zeros(2, heads, 4, 32, dtype=dtype)
    wout = _tensors(c, heads * 32, dtype=dtype)
    reset_launch_counts()
    with torch.no_grad():
        ax.time_attention_block(*(a.as_subclass(_OnCard) for a in
                                  (x, gamma, wqkv, mem_kv, wout)), heads, 32,
                                True)
    counts = launch_counts()
    other = {'fused': 'launches', 'launches': 'fused'}[route]
    assert counts['time_attention_block'] == 1
    assert counts[f'time_attention_block_{route}'] == 1
    assert counts[f'time_attention_block_{other}'] == 0
    if route == 'fused':
        assert [name for name, _ in lib.calls] == ['mv2_time_attention_block']
        p = ax.time_block_pixels(b, t, s, 132)
        # dtype, B, T, S, C, heads, dim_head, M, pixels, causal, route
        assert lib.calls[0][1][7:-1] == (
            _build.dtype_code(x), b, t, s, c, heads, 32, 4, p, 1,
            ax.TIME_ROUTES['fused'])
        assert layouts == []
    else:
        assert lib.calls == []
        assert layouts == [ax.time_layout(x)]
    reset_launch_counts()

