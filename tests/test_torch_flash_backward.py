"""The flash-attention kernels' routes and causal tile skip on the CPU.

``flash_route`` picks the forward and backward kernels from the dtype
alone; the causal skip of the tensor-core (``'mma'``) kernels is written
once in Python (``dq_key_tiles``, ``dkv_query_tiles``, ``tile_masked``) and
held here against ``causal_hidden``, the mask the plain versions use; the
plain backward is held against ``jax.grad`` through the Pallas backward
kernels in interpret mode at the shapes the skip cares about (memory keys
over more than one tile, fewer queries than a tile, the largest head
size); and each route's launch is counted, with a stand-in for the CUDA
library, and its code held against the C source's. The kernels themselves
run only on the card (chip_smoke.py)."""

import ctypes
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from magvit2_pytorch_tpu_torch.ops.attend import causal_hidden
from magvit2_pytorch_tpu_torch.ops.kernels import (
    _build, flash_attention as fa, launch_counts, reset_launch_counts)

torch.set_num_threads(1)


@pytest.mark.parametrize('dim_head', [1, 8, 12, 16, 32, 64, 96, 128, 256,
                                      264, 512])
@pytest.mark.parametrize('dtype,route', [(torch.bfloat16, 'mma'),
                                         (torch.float32, 'f32')])
def test_flash_bwd_route(dtype, route, dim_head):
    """One rule by dtype for all three kernels, the forward's included, at
    every head size (over 256 the wide launches)."""
    assert fa.flash_route(dtype, dim_head) == route


@pytest.mark.parametrize('dtype,dim_head,error', [
    (torch.float16, 32, TypeError), (torch.float64, 32, TypeError),
    (torch.bfloat16, 0, ValueError), (torch.float32, -8, ValueError)])
def test_flash_bwd_route_refuses_what_no_kernel_takes(dtype, dim_head, error):
    with pytest.raises(error):
        fa.flash_route(dtype, dim_head)


# ---- the causal tile skip against causal_hidden ---------------------------

# m - n in 0, 4, 70 (memory keys over more than a tile), and at 1, 62, 63,
# 65, where the first visible row or a tile's diagonal sits one step from a
# tile edge; and m - n < 0, fewer keys than queries, where with causal the
# first n - m rows see no key (a block of such rows visits no tile), at the
# same distances from a tile edge
SKIP_CASES = [(n, n + extra) for n in (1, 5, 63, 64, 65, 130)
              for extra in (0, 1, 4, 62, 63, 65, 70, -1, -4, -62, -63, -65,
                            -70)
              if n + extra >= 1]


@pytest.mark.parametrize('rows,tile', [(64, 64), (128, 64), (64, 128),
                                       (128, 128)])
@pytest.mark.parametrize('causal', [True, False])
def test_causal_tile_skip_matches_causal_hidden(rows, tile, causal):
    """For every block and streamed tile of both kernels: no skipped tile
    holds a visible pair, every kept tile holds one, and a tile takes the
    element test exactly where it crosses a ragged edge or holds a hidden
    pair."""
    for n, m in SKIP_CASES:
        hidden = causal_hidden(n, m, 'cpu').numpy()
        visible = ~hidden if causal else np.ones((n, m), bool)

        def check(q0, nq, k0, nk, kept):
            seen = visible[q0:q0 + nq, k0:k0 + nk]
            assert bool(seen.any()) == kept, (n, m, q0, k0, kept)
            if not kept:
                return
            ragged = q0 + nq > n or k0 + nk > m
            assert fa.tile_masked(q0, nq, k0, nk, n, m, causal) == (
                ragged or not seen.all()), (n, m, q0, k0)

        for q0 in range(0, n, rows):          # dQ: a block of query rows
            stop = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
            for t in range(-(-m // tile)):
                check(q0, rows, t * tile, tile, t < stop)
        for k0 in range(0, m, rows):          # dK/dV: a block of keys
            kept = fa.dkv_query_tiles(k0, n, m, causal, tile)
            for t in range(-(-n // tile)):
                check(t * tile, tile, k0, rows, t in kept)


def test_causal_tile_skip_skips_half_the_flagship_step():
    """At the attention step's shape (4096 queries, 4100 keys) the causal
    dQ blocks visit about half the key tiles, and the visible pairs are
    8,407,040 of 16,793,600 per (b, h)."""
    n, m = 4096, 4100
    rows = tile = 64      # csrc/flash_attention.cu kBwdRows, kBwdTile
    visits = sum(fa.dq_key_tiles(q0, rows, n, m, True, tile)
                 for q0 in range(0, n, rows))
    full = (n // rows) * -(-m // tile)
    assert 0.5 <= visits / full < 0.52
    pairs = sum(min(m, i + 1 + m - n) for i in range(n))
    assert (pairs, n * m) == (8407040, 16793600)


# ---- the plain backward against the Pallas backward -----------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize('b,h,n,m,d,causal', [
    (1, 2, 70, 150, 32, True),     # memory keys over more than one tile
    (2, 2, 5, 9, 16, True),        # fewer queries than a tile
    (2, 2, 5, 9, 16, False),
    (1, 2, 70, 74, 64, False),     # the widest head at the 'auto' edge
    (1, 2, 70, 74, 64, True),
    (1, 2, 70, 74, 256, True),     # the largest head size
    (1, 2, 150, 70, 32, False),    # fewer keys than queries
])
def test_flash_backward_ref_matches_pallas_at_the_skip_shapes(b, h, n, m, d,
                                                              causal):
    """``flash_attention_bwd_ref`` against ``jax.grad`` through the Pallas
    backward kernels in interpret mode; atol 5e-4, rtol 1e-3 (those of
    tests/test_torch_port_attend.py)."""
    q, k, v = _rand((b, h, n, d), 1), _rand((b, h, m, d), 2), _rand(
        (b, h, m, d), 3)
    g_out = _rand((b, h, n, d), 4)

    def loss(*a):
        return jnp.sum(jax_flash_attention(*a, causal=causal, interpret=True)
                       * g_out)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal=causal)
    got = fa.flash_attention_bwd_ref(tq, tk, tv, None, out, lse,
                                     torch.from_numpy(g_out), causal,
                                     d ** -0.5)
    for a, w in zip(got[:3], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-3)


# ---- each route's launch, counted ------------------------------------------

class _Library:
    """Stands in for the CUDA library: records the dtype and route codes
    each flash entry point was given and returns success. The dtype is the
    first int after the pointers, the route the argument before the
    stream (``_build.SIGNATURES``)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        types = _build.SIGNATURES[name]
        dtype_at = types.index(ctypes.c_int)

        def entry(*args):
            assert len(args) == len(types), name
            self.calls.append((name, args[dtype_at], args[-2]))
            return 0
        return entry


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""
    is_cuda = True


@pytest.mark.parametrize('dtype,route', [(torch.bfloat16, 'mma'),
                                         (torch.float32, 'f32')])
def test_each_backward_launch_counts_its_route(monkeypatch, dtype, route):
    """The forward and both backward kernels: one launch each, counted on
    the dtype's route, with that route's code passed to C."""
    lib = _Library()
    monkeypatch.setattr(_build, 'load_library', lambda: lib)
    monkeypatch.setattr(_build, 'stream_handle', lambda device: 0)
    q, k, v, dout = (torch.zeros(s, dtype=dtype) for s in
                     ((1, 2, 5, 16), (1, 2, 9, 16), (1, 2, 9, 16),
                      (1, 2, 5, 16)))
    lse = delta = torch.zeros(1, 2, 5)
    reset_launch_counts()
    fa.flash_forward(*(t.as_subclass(_OnCard) for t in (q, k, v)), None,
                     True, 0.25)
    fa.flash_backward_dq(q, k, v, None, dout, lse, delta, True, 0.25)
    fa.flash_backward_dkv(q, k, v, None, dout, lse, delta, True, 0.25)
    counts = launch_counts()
    other = {'mma': 'f32', 'f32': 'mma'}[route]
    for kernel in fa.KERNELS:
        assert counts[kernel] == counts[f'{kernel}_{route}'] == 1
        assert counts[f'{kernel}_{other}'] == 0
    codes = (_build.dtype_code(q), fa.ROUTES[route])
    assert lib.calls == [('mv2_flash_attention_fwd', *codes),
                         ('mv2_flash_attention_bwd_dq', *codes),
                         ('mv2_flash_attention_bwd_dkv', *codes)]
    reset_launch_counts()


def _c_enum(name, text):
    body = re.search(r'enum ' + name + r' \{([^}]*)\}', text)[1]
    return {k.strip(): int(v) for k, v in
            (item.split('=') for item in body.split(','))}


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_c_entry_points_take_the_route_of_the_dtype(dtype):
    """The route code the wrapper passes is one that csrc's route_fits
    accepts with the dtype code of the same call, and every flash entry
    point, the forward's included, takes a route and dispatches through the
    macro that refuses any other pair (on the card)."""
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    routes = _c_enum('Route', src)
    dtypes = _c_enum('DType', (_build.SOURCE_DIR / 'common.cuh').read_text())
    fits = {(routes[r], dtypes[d]) for r, d in re.findall(
        r'route == (kRoute\w+) && dtype == (k\w+)', src)}
    assert len(fits) == len(routes) == len(fa.ROUTES)
    route = fa.flash_route(dtype, 32)
    assert (fa.ROUTES[route], _build.DTYPE_CODES[dtype]) in fits
    macro = re.search(r'#define MV2_FLASH_DISPATCH\(.*?\n\n', src, re.S)[0]
    assert 'if (!mv2::flash::route_fits(route, dtype)) return' in macro
    for kernel in fa.KERNELS:
        params, body = re.search(r'int mv2_' + kernel + r'\(([^)]*)\)\s*'
                                 r'\{(.*?)\n\}', src, re.S).groups()
        assert 'int route' in params and 'MV2_FLASH_DISPATCH(' in body


def test_a_backward_no_route_takes_launches_nothing(monkeypatch):
    """float16, which no route takes: neither the forward nor a backward
    kernel reaches the library or counts a launch."""
    lib = _Library()
    monkeypatch.setattr(_build, 'load_library', lambda: lib)
    q = torch.zeros(1, 2, 5, 16, dtype=torch.float16)
    k = torch.zeros(1, 2, 9, 16, dtype=torch.float16)
    lse = torch.zeros(1, 2, 5)
    reset_launch_counts()
    with pytest.raises(TypeError):
        fa.flash_forward(*(t.as_subclass(_OnCard) for t in (q, k, k)), None,
                         False, 0.25)
    for launch in (fa.flash_backward_dq, fa.flash_backward_dkv):
        with pytest.raises(TypeError):
            launch(q, k, k, None, q, lse, lse, False, 0.25)
    assert lib.calls == [] and not any(launch_counts().values())


def test_route_counters_sit_beside_the_kernel_counters():
    names = {f'flash_attention_{kernel}_{route}'
             for kernel, route in itertools.product(('fwd', 'bwd_dq',
                                                     'bwd_dkv'),
                                                    ('mma', 'f32'))}
    assert names | set(fa.KERNELS) <= set(launch_counts())
    # mma_attributes' kernel names in the numbers the C entry point takes:
    # each number names its kernel at every width, the exact build up to 64
    # and the Hopper kernels above
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    numbered = re.findall(r'kernel == (\d)\)\s+return attributes\(out, '
                          r'(\w+?)_(wg_)?mma_kernel<D>', src)
    assert sorted((int(i), name.removeprefix('bwd_'), bool(wg))
                  for i, name, wg in numbered) == [
        (0, 'dq', False), (0, 'dq', True), (1, 'dkv', False),
        (1, 'dkv', True), (2, 'fwd', False), (2, 'fwd', True)]
    assert [name.removeprefix('bwd_') for i, name, wg in sorted(numbered)
            if not wg] == list(fa.MMA_KERNELS)
    for kernel in fa.MMA_KERNELS:
        for width in fa.WIDTHS:
            name = fa.mma_kernel(kernel, width)
            assert f'{name}<D>' in src, name
            assert (width > fa.EXACT_WIDTH) == ('_wg_' in name)
