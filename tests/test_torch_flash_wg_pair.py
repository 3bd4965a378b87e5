"""The paired Hopper flash-attention kernels' geometry on the CPU: the
forward, dK/dV and dQ at heads of 513 to 1024 (csrc/flash_attention.cu
``fwd_wg_pair_kernel``, ``bwd_dkv_wg_pair_kernel``,
``bwd_dq_wg_pair_kernel``), each a 2-block cluster whose blocks split the
head in halves of 512 columns, each the Hopper wide block (the forward and
dK/dV with its geometry, dQ on stages of its own; the causal skip:
test_torch_flash_wg_wide.py). The constants that the wrapper exposes
against the source, the kernel each head names, and test-local models of
the three loops against the plain versions:
each block's partial scores (and dP) over its own half, formed whole in
each warpgroup or from the two warpgroups' partial sums as each geometry
says, the block's copy pushed to its peer and S = own + peer in each block
(bit for bit alike in both, with P and dS), each warpgroup's 256 output
columns of its block's half, rank 0 alone writing lse and d_bias, the rows
that see no key, dK/dV's grid z, and dQ's rings and inbox buffers as its
layout fills and frees them, in float64 within 1e-6 of the largest value
(the same sums in another order) and in float32 within 1e-5; the plain
versions and the pair models at d = 1024 against the JAX package's flash
attention. Inputs come from numpy seeds. The kernels run only on the card
(chip_smoke.py)."""

import itertools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_forward, _round_up)
from magvit2_pytorch_tpu_torch.ops.kernels import _build
from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_flash_heads import _jax_flash_grads, _port_grads, _qkv, _rand
from test_torch_flash_wg import (LOG2E, _close, _masked, _pad, _rows,
                                 _struct, _value)
from test_torch_flash_wg_wide import _geometry as _wide_geometry

torch.set_num_threads(1)

PANEL = 64          # kSw128Cols: the columns of a TMA box and a score panel
SMEM_MAX = 232448   # kSmemMax
HALF = fa.WG_WIDE_MAX            # a block's columns of the head
WG_COLS = fa.WG_WIDE_HALF        # a consumer warpgroup's output columns


def _source_constants() -> dict:
    """kWgWideMax, kWgPairMax and kPairCluster as the source defines
    them."""
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    env = {}
    for name in ('kWgWideMax', 'kWgPairMax', 'kPairCluster'):
        expr = re.search(rf'constexpr int {name} = ([^;]+);', src)[1]
        env[name] = eval(expr, {}, dict(env))
    return env


BASES = {'WgPairFwdGeo': 'WgWideFwdGeo', 'WgPairDkvGeo': 'WgWideDkvGeo',
         'WgPairDqGeo': 'WgWideDqGeo'}


def _geometry(struct: str) -> dict:
    """Every ``static constexpr`` field of the paired struct's base (the
    wide block's geometry), then of the struct itself, evaluated in
    order."""
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    i = src.index(f'struct {struct} : {BASES[struct]} {{')
    env = {**_source_constants(), 'kSw128Cols': PANEL, 'true': True,
           'false': False, 'sizeof': lambda t: 4}
    for body in (_struct(BASES[struct]), src[i:src.index('};', i)]):
        body = ' '.join(body.replace(f'{BASES[struct]}::', '').split())
        for field in re.findall(r'static constexpr \w+ (\w+) =', body):
            env[field] = _value(body, field, env)
    return env


def test_pair_limits_match_the_source():
    """The widest head of the paired kernels, the blocks a cluster, and
    the columns a block owns: two blocks of the Hopper wide block's width
    cover the head."""
    env = _source_constants()
    assert env['kWgPairMax'] == fa.WG_PAIR_MAX == 1024
    assert env['kPairCluster'] == fa.WG_PAIR_CLUSTER == 2
    assert fa.WG_PAIR_CLUSTER * fa.WG_WIDE_MAX == fa.WG_PAIR_MAX
    assert 2 * WG_COLS == HALF


@pytest.mark.parametrize('struct', ['WgPairFwdGeo', 'WgPairDkvGeo',
                                    'WgPairDqGeo'])
def test_pair_geometry_constants_match_the_source(struct):
    """WgPairFwdGeo and WgPairDkvGeo, each the wide block's geometry
    (WG_WIDE_FWD_*, WG_WIDE_DKV_*) with an inbox (WG_PAIR_FWD_BUFFERS,
    WG_PAIR_DKV_BUFFERS), and WgPairDqGeo, the wide dQ's block on its own
    tile, stages and inbox (WG_PAIR_DQ_*): a block's 512 columns in 8
    panels, 64 rows (or keys) a block, the tile, whether the two
    warpgroups' partial sums make the block's partial (the forward's S
    whole in each warpgroup, dK/dV's and dQ's summed), the inbox buffers of
    the peer's copy (one consumer thread's partial floats for each of the
    128 threads, S and dP in the dK block and in dQ; two in the forward,
    which sends a tile ahead), and the block's shared memory, the wide
    block's (dQ's on its own stages) and the inbox, under the 227 KB a
    block takes."""
    geo = _geometry(struct)
    assert geo['D'] == HALF
    assert geo['panels'] == HALF // PANEL == 8
    assert geo['bytes'] <= SMEM_MAX
    if struct == 'WgPairFwdGeo':
        assert geo['rows'] == fa.WG_WIDE_FWD_ROWS == 64
        assert geo['tile'] == fa.WG_WIDE_FWD_TILE
        assert geo['exchange'] is fa.WG_WIDE_FWD_EXCHANGE
        assert geo['buffers'] == fa.WG_PAIR_FWD_BUFFERS == 2
        assert geo['pfloats'] == 128 * (geo['tile'] // 2)
        # the block's half of Q once, two stages of K's and of V's half-tile
        assert geo['bytes'] == 1024 + 8 * 64 * 128 + 2 * geo['stages'] * (
            8 * geo['tile'] * 128) + 4 * (geo['xfloats'] + geo['buffers']
                                          * geo['pfloats'] + HALF)
    elif struct == 'WgPairDqGeo':
        assert geo['rows'] == fa.WG_WIDE_DQ_ROWS == 64
        assert geo['tile'] == fa.WG_PAIR_DQ_TILE
        assert geo['k_stages'] == fa.WG_PAIR_DQ_K_STAGES
        assert geo['v_stages'] == fa.WG_PAIR_DQ_V_STAGES
        assert geo['buffers'] == fa.WG_PAIR_DQ_BUFFERS
        assert geo['exchange'] is fa.WG_WIDE_DQ_EXCHANGE is True
        assert geo['pfloats'] == 2 * 128 * (geo['tile'] // 2)
        # Q and dO once, the stages of K's and V's half-tiles, the inbox
        assert geo['bytes'] == 1024 + 2 * 8 * 64 * 128 + (
            geo['k_stages'] + geo['v_stages']) * 8 * geo['tile'] * 128 + \
            4 * geo['buffers'] * geo['pfloats']
        # a warpgroup's S and dP partials fill its half of a V stage; the
        # wide dQ's own stages leave no room for one inbox buffer
        assert 2 * 4 * 64 * geo['tile'] == 4 * geo['kv_panel']
        assert _wide_geometry('WgWideDqGeo')['bytes'] + \
            4 * geo['pfloats'] > SMEM_MAX
    else:
        assert geo['keys'] == fa.WG_WIDE_DKV_KEYS == 64
        assert geo['tile'] == fa.WG_WIDE_DKV_TILE
        assert geo['exchange'] is fa.WG_WIDE_DKV_EXCHANGE
        assert geo['buffers'] == fa.WG_PAIR_DKV_BUFFERS
        assert geo['pfloats'] == 2 * 128 * (geo['tile'] // 2)
        assert geo['xfloats'] == 4 * 64 * geo['tile'] * geo['exchange']
        # K's and V's half once, Q and dO half-tiles in the ring, each
        # stage's lse and delta, the warpgroups' partial sums, the inbox and
        # the dO sums of the rows that see no key
        assert geo['bytes'] == 1024 + 2 * 8 * 64 * 128 + 2 * geo[
            'stages'] * 8 * geo['tile'] * 128 + 4 * (
            2 * geo['stages'] * geo['tile'] + geo['xfloats']
            + geo['buffers'] * geo['pfloats'] + HALF)


def _block_partial(a, b, rank, exchange):
    """Block ``rank``'s partial a b^T over its half of the padded head: each
    warpgroup's whole product, or (``exchange``) the two warpgroups'
    partial sums over the halves of the block's panels added."""
    a, b = (t[:, HALF * rank:HALF * (rank + 1)] for t in (a, b))
    if not exchange:
        return a @ b.T
    return a[:, :WG_COLS] @ b[:, :WG_COLS].T + a[:, WG_COLS:] @ b[:, WG_COLS:].T


def _pair_scores(a, b, exchange):
    """The scores each block of the pair holds after the hand-off: own +
    peer in rank 0, peer's own + its copy of rank 0's in rank 1; bit for bit
    alike."""
    own = [_block_partial(a, b, rank, exchange) for rank in (0, 1)]
    held = [own[0] + own[1], own[1] + own[0]]
    assert torch.equal(held[0], held[1])
    return held


def _columns(rank):
    """The head columns of each consumer warpgroup of block ``rank``."""
    return [slice(c, c + WG_COLS)
            for c in range(HALF * rank, HALF * (rank + 1), WG_COLS)]


def _fwd_pair_model(q, k, v, bias, causal, scale):
    """The paired forward's loop: per cluster of WG_WIDE_FWD_ROWS rows (16 a
    warp, both warpgroups of both blocks on the same rows), the key tiles
    of dq_key_tiles of WG_WIDE_FWD_TILE keys, S as _pair_scores forms it in
    each block, each block's online softmax in base 2 (the `pre` form) on
    its own S (bit for bit alike: the same S, max, P and l), O += P V on
    each of its warpgroups' 256 columns; then O / l, and lse in natural log
    from rank 0; the rows that see no key take the mean of v and lse
    kMasked + log m; the columns past d are not stored."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_WIDE_FWD_ROWS, fa.WG_WIDE_FWD_TILE
    qp, kp, vp = (_pad(t, fa.WG_PAIR_MAX) for t in (q, k, v))
    out = torch.full_like(qp, math.nan)
    lse = torch.full((b, h, n), math.nan, dtype=q.dtype)
    blind = fa.no_key_rows(n, m, causal)
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for q0 in range(0, n, rows):
            tiles = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
            for w0 in range(q0, q0 + rows, 16):
                qw = _rows(qp[bi, hi], w0, 16)
                o = [[torch.zeros(16, WG_COLS, dtype=q.dtype)
                      for _ in _columns(rank)] for rank in (0, 1)]
                mx = [torch.full((16,), -math.inf, dtype=q.dtype)] * 2
                l = [torch.zeros(16, dtype=q.dtype)] * 2
                for t in range(tiles):
                    k0 = t * tile
                    held = _pair_scores(qw, _rows(kp[bi, hi], k0, tile),
                                        fa.WG_WIDE_FWD_EXCHANGE)
                    vt = _rows(vp[bi, hi], k0, tile)
                    ps = []
                    for rank, s in enumerate(held):
                        s = s * (scale * LOG2E)
                        if bb is not None:
                            s = s + _rows(_rows(bb, w0, 16).T, k0,
                                          tile).T * LOG2E
                        s = _masked(s, w0, 16, k0, tile, n, m, causal)
                        mnew = torch.maximum(mx[rank], s.max(dim=1).values)
                        base = torch.where(mnew == -math.inf, 0.0, mnew)
                        alpha = torch.exp2(mx[rank] - base)
                        p = torch.exp2(s - base[:, None])
                        l[rank] = l[rank] * alpha + p.sum(dim=1)
                        o[rank] = [oc * alpha[:, None] + p @ vt[:, cols]
                                   for oc, cols in zip(o[rank],
                                                       _columns(rank))]
                        mx[rank] = mnew
                        ps.append(p)
                    assert torch.equal(ps[0], ps[1])
                assert torch.equal(mx[0], mx[1]) and torch.equal(l[0], l[1])
                lsum = torch.clamp(l[0], min=1e-30)
                o = torch.cat(o[0] + o[1], dim=1) / lsum[:, None]
                ls = torch.where(mx[0] == -math.inf,      # rank 0's lse
                                 fa.MASKED + torch.log(lsum),
                                 mx[0] * math.log(2) + torch.log(lsum))
                r = torch.arange(w0, w0 + 16)
                no_key = r < blind
                o[no_key] = vp[bi, hi].mean(dim=0)
                ls[no_key] = fa.MASKED + math.log(m)
                keep = r < n
                out[bi, hi, r[keep]] = o[keep]
                lse[bi, hi, r[keep]] = ls[keep]
    return out[..., :d], lse


def _dkv_pair_model(q, k, v, bias, out, lse, dout, causal, scale):
    """The paired dK/dV's loop: per cluster of WG_WIDE_DKV_KEYS keys, a dV
    cluster (grid z 0) and a dK cluster (z 1); each streams the query tiles
    of dkv_query_tiles of WG_WIDE_DKV_TILE rows, holds S^T (and in the dK
    cluster dP^T) as _pair_scores forms them in each block, P^T = 2^(S^T
    scale log2e + bias log2e - lse log2e) with each warp's element test (16
    keys by the tile) where tile_masked asks for it, dS^T = P^T (dP^T -
    delta), both bit for bit alike in the two blocks, and on each
    warpgroup's 256 columns of its block's half dV += P^T dO or dK += dS^T
    Q; then dV gains the dO of the rows that see no key over m, dK *= scale;
    the columns past d are not stored."""
    b, h, n, d = q.shape
    m = k.shape[2]
    keys, qt = fa.WG_WIDE_DKV_KEYS, fa.WG_WIDE_DKV_TILE
    ex = fa.WG_WIDE_DKV_EXCHANGE    # the two warpgroups' partial sums
    qp, kp, vp, dop = (_pad(t, fa.WG_PAIR_MAX) for t in (q, k, v, dout))
    delta = (dout * out).sum(dim=-1)
    blind = fa.no_key_rows(n, m, causal)
    grads = {'dv': torch.full_like(vp, math.nan),
             'dk': torch.full_like(kp, math.nan)}
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for k0, z in itertools.product(range(0, m, keys), ('dv', 'dk')):
            kk, vv = _rows(kp[bi, hi], k0, keys), _rows(vp[bi, hi], k0, keys)
            acc = [[torch.zeros(keys, WG_COLS, dtype=q.dtype)
                    for _ in _columns(rank)] for rank in (0, 1)]
            for t in fa.dkv_query_tiles(k0, n, m, causal, qt):
                q0 = t * qt
                qq, do = _rows(qp[bi, hi], q0, qt), _rows(dop[bi, hi], q0, qt)
                ls = _rows(lse[bi, hi], q0, qt)
                de = _rows(delta[bi, hi], q0, qt)
                held = _pair_scores(kk, qq, ex)
                held_dp = _pair_scores(vv, do, ex) if z == 'dk' else held
                ws = []
                for rank, (s, dp) in enumerate(zip(held, held_dp)):
                    x = s * (scale * LOG2E) - ls[None, :] * LOG2E
                    if bb is not None:
                        x = x + _rows(_rows(bb, q0, qt).T, k0, keys) * LOG2E
                    p = torch.exp2(torch.cat([
                        _masked(x[i:i + 16], q0, qt, k0 + i, 16, n, m,
                                causal, transposed=True)
                        for i in range(0, keys, 16)]))
                    w = p if z == 'dv' else p * (dp - de[None, :])
                    side = do if z == 'dv' else qq
                    acc[rank] = [a + w @ side[:, cols]
                                 for a, cols in zip(acc[rank],
                                                    _columns(rank))]
                    ws.append(w)
                assert torch.equal(ws[0], ws[1])     # P^T or dS^T
            acc = torch.cat(acc[0] + acc[1], dim=1)
            if z == 'dv' and blind:
                acc = acc + dop[bi, hi, :blind].sum(dim=0) / m
            if z == 'dk':
                acc = acc * scale
            r = torch.arange(k0, k0 + keys)
            keep = r < m
            grads[z][bi, hi, r[keep]] = acc[keep]
    return grads['dk'][..., :d], grads['dv'][..., :d]


class _Ring:
    """Slots of a ring (K's or V's stages, a block's inbox buffers), filled
    and freed in the order the kernel does: step i takes slot i % slots,
    which must be free again (freed in its step i - slots)."""

    def __init__(self, slots):
        self.held = [None] * slots

    def put(self, i, value=None):
        k = i % len(self.held)
        assert self.held[k] is None, f'step {i}: slot {k} still holds ' \
            f'step {self.held[k][0]}'
        self.held[k] = (i, value)

    def get(self, i):
        step, value = self.held[i % len(self.held)]
        assert step == i
        return value

    def free(self, i):
        self.get(i)
        self.held[i % len(self.held)] = None


def _dq_pair_model(q, k, v, bias, out, lse, dout, causal, scale):
    """The paired dQ's loop: per cluster of WG_WIDE_DQ_ROWS query rows (16 a
    warp, both warpgroups of both blocks on the same rows), the key tiles of
    dq_key_tiles of WG_PAIR_DQ_TILE keys through K's and V's rings of
    WG_PAIR_DQ_K_STAGES and WG_PAIR_DQ_V_STAGES stages (V's stage freed
    after the exchange, K's after dQ's product); each block's partial S and
    dP over its half from the two warpgroups' partial sums, pushed into the
    peer's inbox of WG_PAIR_DQ_BUFFERS buffers and own + peer added in step
    in each block (S, dP, P and dS bit for bit alike in both); P = 2^(S
    scale log2e + bias log2e - lse log2e) with each warp's element test
    where tile_masked asks for it, dS = P (dP - delta), dQ += dS K on each
    warpgroup's 256 columns of its block's half; rank 0 writes its float32
    dS as d_bias in every visited tile and zeros in the skipped ones; then
    dQ *= scale, the columns past d not stored. Returns dq and the (b h, n,
    m) dS, NaN where nothing was written."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_WIDE_DQ_ROWS, fa.WG_PAIR_DQ_TILE
    qp, kp, vp, dop = (_pad(t, fa.WG_PAIR_MAX) for t in (q, k, v, dout))
    delta = (dout * out).sum(dim=-1)
    dq = torch.full_like(qp, math.nan)
    ds_all = torch.full((b * h, n, m), math.nan, dtype=q.dtype)
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        ds_head = ds_all[bi * h + hi]
        for q0 in range(0, n, rows):
            tiles = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
            for w0 in range(q0, q0 + rows, 16):
                qw, dow = _rows(qp[bi, hi], w0, 16), _rows(dop[bi, hi], w0, 16)
                ls = _rows(lse[bi, hi], w0, 16)
                de = _rows(delta[bi, hi], w0, 16)
                acc = [[torch.zeros(16, WG_COLS, dtype=q.dtype)
                        for _ in _columns(rank)] for rank in (0, 1)]
                r1 = min(w0 + 16, n) - w0      # the warp's rows inside n
                k_ring = _Ring(fa.WG_PAIR_DQ_K_STAGES)
                v_ring = _Ring(fa.WG_PAIR_DQ_V_STAGES)
                inbox = [_Ring(fa.WG_PAIR_DQ_BUFFERS) for _ in (0, 1)]

                def scores(t):
                    """Tile t's K and V loaded, each block's partial S and
                    dP, V's stage freed, each sent to the peer's inbox; the
                    blocks' own partials."""
                    k0 = t * tile
                    k_ring.put(t, _rows(kp[bi, hi], k0, tile))
                    v_ring.put(t, _rows(vp[bi, hi], k0, tile))
                    kk, vv = k_ring.get(t), v_ring.get(t)
                    own = [(_block_partial(qw, kk, rank, True),
                            _block_partial(dow, vv, rank, True))
                           for rank in (0, 1)]
                    v_ring.free(t)
                    for rank in (0, 1):
                        inbox[1 - rank].put(t, own[rank])
                    return own

                def update(t, own):
                    """Tile t's peer partials added, P, dS and dQ += dS K
                    in each block, K's stage freed."""
                    k0 = t * tile
                    kk = k_ring.get(t)
                    ds = []
                    for rank in (0, 1):
                        peer = inbox[rank].get(t)
                        inbox[rank].free(t)
                        s, dp = (a + b for a, b in zip(own[rank], peer))
                        x = s * (scale * LOG2E) - ls[:, None] * LOG2E
                        if bb is not None:
                            x = x + _rows(_rows(bb, w0, 16).T, k0,
                                          tile).T * LOG2E
                        p = torch.exp2(_masked(x, w0, 16, k0, tile, n, m,
                                               causal))
                        ds.append(p * (dp - de[:, None]))
                        acc[rank] = [a + ds[rank] @ kk[:, cols]
                                     for a, cols in zip(acc[rank],
                                                        _columns(rank))]
                    assert torch.equal(ds[0], ds[1])
                    k_ring.free(t)
                    c1 = min(k0 + tile, m) - k0
                    if r1 > 0:                   # rank 0's d_bias
                        ds_head[w0:w0 + r1, k0:k0 + c1] = ds[0][:r1, :c1]

                for t in range(tiles):
                    update(t, scores(t))
                if r1 > 0:
                    dq[bi, hi, w0:w0 + r1] = torch.cat(
                        acc[0] + acc[1], dim=1)[:r1] * scale
            ds_head[q0:q0 + rows, tiles * tile:] = 0    # rank 0
    return dq[..., :d], ds_all


def _inputs(d, m, causal, dtype):
    rng = np.random.default_rng(13 + d + m + causal)
    b, h, n = 1, 2, 130
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s)).to(dtype) for s in
                     ((b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)))
    bias = torch.from_numpy(rng.normal(size=(h, n, m))).to(dtype)
    return q, k, v, dout, bias


PAIR_CASES = list(itertools.product((520, 776, 1024), (70, 134),
                                    (False, True), (False, True)))


@pytest.mark.parametrize('d,m,causal,with_bias', PAIR_CASES)
def test_the_pair_forward_loop_matches_the_plain_version(d, m, causal,
                                                         with_bias):
    """The paired forward's loop against ``flash_attention_ref`` on (1, 2,
    130, d) / m keys (70: fewer keys than queries, with causal the first 60
    rows see none; 134: a ragged last tile), with an (h, n, m) bias or none:
    out within 1e-6 of the largest value in float64 and 1e-5 in float32,
    lse within 1e-5, every element written; the two blocks' S and P bit for
    bit alike (asserted in the loop)."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, _, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        want_out, want_lse = fa.flash_attention_ref(q, k, v, causal, scale,
                                                    bias)
        out, lse = _fwd_pair_model(q, k, v, bias, causal, scale)
        assert not out.isnan().any() and not lse.isnan().any()
        _close(out, want_out, tol)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize('d,m,causal,with_bias', PAIR_CASES)
def test_the_pair_dkv_loop_matches_the_plain_version(d, m, causal,
                                                     with_bias):
    """The paired dK/dV's loop (both clusters of grid z) against
    ``flash_attention_bwd_ref``'s dk and dv on (1, 2, 130, d) / m keys,
    with an (h, n, m) bias or none: float64 within 1e-6 of the largest
    value, float32 within 1e-5, every element written; the two blocks' S^T,
    P^T and dS^T bit for bit alike (asserted in the loop)."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
        _, want_dk, want_dv, _ = fa.flash_attention_bwd_ref(
            q, k, v, bias, out, lse, dout, causal, scale)
        dk, dv = _dkv_pair_model(q, k, v, bias, out, lse, dout, causal,
                                 scale)
        assert not dk.isnan().any() and not dv.isnan().any()
        _close(dk, want_dk, tol)
        _close(dv, want_dv, tol)


@pytest.mark.parametrize('d,m,causal,with_bias', PAIR_CASES)
def test_the_pair_dq_loop_matches_the_plain_version(d, m, causal,
                                                    with_bias):
    """The paired dQ's loop against ``flash_attention_bwd_ref``'s dq on (1,
    2, 130, d) / m keys (70: with causal the first 60 rows see none, whose
    dq and dS must be exactly 0), with an (h, n, m) bias or none: dq, and
    rank 0's dS as d_bias, every element written, float64 within 1e-6 of
    the largest value, float32 within 1e-5; the two blocks' dS bit for bit
    alike and the committed layout's rings and inbox never overwritten
    before they are read (asserted in the loop)."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
        want_dq, _, _, want_db = fa.flash_attention_bwd_ref(
            q, k, v, bias, out, lse, dout, causal, scale)
        dq, ds = _dq_pair_model(q, k, v, bias, out, lse, dout, causal, scale)
        assert not dq.isnan().any() and not ds.isnan().any()
        _close(dq, want_dq, tol)
        blind = fa.no_key_rows(130, m, causal)
        assert not dq[:, :, :blind].any()
        assert not ds[:, :blind].any()
        if bias is not None:
            _close(fa._reduce_bias_groups(ds, bias), want_db, tol)


@pytest.mark.parametrize('tile,k_stages,v_stages,buffers', [
    (32, 1, 1, 2),      # (A), committed
    (32, 1, 1, 1),      # (A) with one inbox buffer
    (16, 3, 2, 2)])     # (B)
def test_the_pair_dq_layouts(monkeypatch, tile, k_stages, v_stages,
                             buffers):
    """The paired dQ's layouts tried on the card (tools/flash_heads_probe.py
    ``pair_dq_*``) in the loop at d = 776 / 134 keys causal with a bias,
    float64: each matches the plain version within 1e-6, its rings and
    inbox never overwritten before they are read."""
    for name, value in (('TILE', tile), ('K_STAGES', k_stages),
                        ('V_STAGES', v_stages), ('BUFFERS', buffers)):
        monkeypatch.setattr(fa, f'WG_PAIR_DQ_{name}', value)
    q, k, v, dout, bias = _inputs(776, 134, True, torch.float64)
    scale = 776 ** -0.5
    out, lse = fa.flash_attention_ref(q, k, v, True, scale, bias)
    want_dq, _, _, want_db = fa.flash_attention_bwd_ref(
        q, k, v, bias, out, lse, dout, True, scale)
    dq, ds = _dq_pair_model(q, k, v, bias, out, lse, dout, True, scale)
    _close(dq, want_dq, 1e-6)
    _close(fa._reduce_bias_groups(ds, bias), want_db, 1e-6)


@pytest.mark.parametrize('d', [512, 520, 776, 1024, 1032])
def test_each_pair_head_names_its_dq_kernel(d):
    """dQ at a bf16 head of WG_WIDE_MAX + 1 to WG_PAIR_MAX runs the paired
    dQ, beside the paired forward and dK/dV; at WG_WIDE_MAX the Hopper wide
    dQ and past WG_PAIR_MAX the wide mma.sync dQ: names of kernels in the
    source."""
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    name = fa.mma_kernel('dq', d)
    kind = ('wg_wide' if d <= fa.WG_WIDE_MAX else
            'wg_pair' if d <= fa.WG_PAIR_MAX else 'wide_mma')
    assert name == f'bwd_dq_{kind}_kernel'
    if kind == 'wg_pair':
        assert {fa.mma_kernel(k, d) for k in ('fwd', 'dkv')} == {
            'fwd_wg_pair_kernel', 'bwd_dkv_wg_pair_kernel'}
    assert re.search(rf'__global__ void __launch_bounds__\([^)]*\)\s+'
                     rf'{name}\(', src), name


@pytest.mark.parametrize('exchange', [False, True])
def test_the_pair_scores_are_alike_in_both_blocks_in_float32(exchange):
    """S (and so P and dS) that the two blocks hold after the hand-off are
    equal bit for bit in float32 at d = 1024 over a 32-key tile, whichever
    way each block forms its partial sum, though each block's own partial
    differs from the whole product in its last bits."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.normal(size=(64, fa.WG_PAIR_MAX))).float()
            for _ in range(2))
    held = _pair_scores(a, b, exchange)
    assert torch.equal(held[0], held[1])
    p = [torch.exp2(s - s.max(dim=1, keepdim=True).values) for s in held]
    assert torch.equal(p[0], p[1])
    ds = [x * (x - 0.5) for x in p]
    assert torch.equal(ds[0], ds[1])
    _close(held[0], a.double() @ b.double().T, 1e-6)


@pytest.mark.parametrize('with_bias', [False, True])
def test_the_plain_version_at_1024_matches_the_jax_flash_attention(
        with_bias):
    """At d = 1024, (1, 1, 70) / 74 keys causal, float32: the plain forward
    (out, lse) against the JAX package's ``_flash_forward`` in interpret
    mode (out atol 2e-5 rtol 1e-4, lse atol 1e-5), the gradients through
    the port's Function (on the CPU its plain backward) against ``jax.grad``
    through the Pallas backward in interpret mode, and the paired loops'
    out, dq, dk and dv against the same, each within 1e-5 of its largest
    value (the JAX kernel sums over the head in another order); with an (h,
    n, m) bias also d_bias, the plain backward's and the paired dQ's."""
    n, m, d = 70, 74, 1024
    q, k, v = _qkv(1, 1, n, m, d, 40)
    b = _rand((1, n, m), 44) if with_bias else None
    g_out = _rand((1, 1, n, d), 45)
    scale = d ** -0.5
    want_out, want_lse = _flash_forward(
        *map(jnp.asarray, (q, k, v)),
        None if b is None else jnp.asarray(b), True, scale,
        _round_up(n, 128), _round_up(m, 128), True)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g_out))
    bt = None if b is None else torch.from_numpy(b)
    out, lse = fa.flash_attention_ref(qt, kt, vt, True, scale, bt)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.numpy().reshape(1, n),
                               np.asarray(want_lse)[:, 0, :n], atol=1e-5,
                               rtol=0)
    want = _jax_flash_grads(q, k, v, b, g_out, True)
    _, got = _port_grads(q, k, v, b, g_out, True)
    for x, y in zip(got, want):
        _close(x, torch.from_numpy(np.array(y)), 1e-5)
    pair_out, _ = _fwd_pair_model(qt, kt, vt, bt, True, scale)
    _close(pair_out, torch.from_numpy(np.array(want_out)), 1e-5)
    dk, dv = _dkv_pair_model(qt, kt, vt, bt, out, lse, gt, True, scale)
    _close(dk, torch.from_numpy(np.array(want[1])), 1e-5)
    _close(dv, torch.from_numpy(np.array(want[2])), 1e-5)
    dq, ds = _dq_pair_model(qt, kt, vt, bt, out, lse, gt, True, scale)
    _close(dq, torch.from_numpy(np.array(want[0])), 1e-5)
    if b is not None:
        _close(fa._reduce_bias_groups(ds, bt),
               torch.from_numpy(np.array(want[3])), 1e-5)
