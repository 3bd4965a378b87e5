"""The Hopper wide flash-attention kernels' geometry on the CPU: the
forward, dQ and dK/dV at heads of 257 to 512 (csrc/flash_attention.cu
``fwd_wg_wide_kernel``, ``bwd_dq_wg_wide_kernel``,
``bwd_dkv_wg_wide_kernel``). The constants that the wrapper exposes against
the source, the causal-skip twins at their 64-row and 64-key blocks against
a dense mask, and test-local models of the three loops against the plain
versions: the scores formed in each warpgroup whole or once a block as two
partial sums over halves of the 64-column panels, as each kernel's geometry
says, the output columns split between the two consumer warpgroups, the
per-warp element tests, the rows that see no key, dS written as d_bias by
one warpgroup, and dK/dV's grid z (a dV block and a dK block of the same
keys), in float64 within 1e-6 of the largest value (the same sums in
another order) and in float32 within 1e-5; dQ also with dS rounded to bf16
where the kernel hands it to ``wgmma``, and against the JAX custom VJP.
Inputs come from numpy seeds. The kernels run only on the card
(chip_smoke.py)."""

import itertools
import math
import re

import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu_torch.ops.kernels import _build
from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_flash_heads import _jax_flash_grads, _qkv, _rand
from test_torch_flash_wg import (LOG2E, SKIP_SHAPES, _check_query_blocks,
                                 _close, _masked, _pad, _padded_mask, _rows,
                                 _struct, _value)

torch.set_num_threads(1)

PANEL = 64          # kSw128Cols: the columns of a TMA box and a score panel
SMEM_MAX = 232448   # kSmemMax


def _source_int(name: str) -> int:
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', src)[1])


def _geometry(struct: str) -> dict:
    """Every ``static constexpr`` field of the struct, evaluated in order."""
    body = ' '.join(_struct(struct).split())    # one line a field
    env = {'kWgWideMax': _source_int('kWgWideMax'), 'kSw128Cols': PANEL,
           'true': True, 'false': False, 'sizeof': lambda t: 4}
    for field in re.findall(r'static constexpr \w+ (\w+) =', body):
        env[field] = _value(body, field, env)
    return env


def test_wide_limits_match_the_source():
    """The widest head of the Hopper wide kernels and the columns a
    warpgroup owns, against the wrapper's constants: two warpgroups cover
    the head."""
    assert _source_int('kWgWideMax') == fa.WG_WIDE_MAX == 512
    assert fa.WG_WIDE_HALF == fa.WG_WIDE_MAX // 2
    assert fa.NARROW_MAX < fa.WG_WIDE_MAX


@pytest.mark.parametrize('struct', ['WgWideFwdGeo', 'WgWideDqGeo',
                                    'WgWideDkvGeo'])
def test_wide_geometry_constants_match_the_source(struct):
    """WgWideFwdGeo against WG_WIDE_FWD_ROWS / WG_WIDE_FWD_TILE, WgWideDqGeo
    against WG_WIDE_DQ_ROWS / WG_WIDE_DQ_TILE, WgWideDkvGeo against
    WG_WIDE_DKV_KEYS / WG_WIDE_DKV_TILE: 64 rows a block (one wgmma M, both
    warpgroups), the forward's S formed whole in each warpgroup and dQ's
    and dK/dV's from two partial sums (WG_WIDE_FWD_EXCHANGE,
    WG_WIDE_DQ_EXCHANGE, WG_WIDE_DKV_EXCHANGE), their buffers, the shared
    memory under the 227 KB a block takes, and a consumer thread's
    accumulator floats (its 256 output columns, S and, in dQ and the dK
    block, dP; in dQ also dS's A fragments)."""
    geo = _geometry(struct)
    assert geo['D'] == fa.WG_WIDE_MAX
    assert geo['panels'] == fa.WG_WIDE_MAX // PANEL
    assert geo['bytes'] <= SMEM_MAX
    if struct == 'WgWideFwdGeo':
        assert geo['rows'] == fa.WG_WIDE_FWD_ROWS == 64
        assert geo['tile'] == fa.WG_WIDE_FWD_TILE
        assert geo['exchange'] is fa.WG_WIDE_FWD_EXCHANGE
        # each warpgroup's partial S in float32, 64 rows by a key tile
        assert geo['xfloats'] == 2 * 64 * geo['tile'] * geo['exchange']
        held = fa.WG_WIDE_HALF // 2 + geo['tile'] // 2
        assert held == 144
    elif struct == 'WgWideDqGeo':
        assert geo['rows'] == fa.WG_WIDE_DQ_ROWS == 64
        assert geo['tile'] == fa.WG_WIDE_DQ_TILE
        assert geo['exchange'] is fa.WG_WIDE_DQ_EXCHANGE
        # Q and dO once, a 64-column panel of 64 rows each, then the stages
        # of K and of V
        assert geo['q_panel'] == 64 * 128
        assert geo['bytes'] == 1024 + 2 * 8 * 64 * 128 + (
            geo['k_stages'] + geo['v_stages']) * 8 * geo['tile'] * 128
        # a warpgroup's float32 S and dP partials fill the half of a V
        # stage its dP read (the exchange needs no buffer of its own)
        assert 2 * 4 * 64 * geo['tile'] == geo['panels'] // 2 * \
            geo['kv_panel']
        held = (fa.WG_WIDE_HALF // 2 + 2 * (geo['tile'] // 2)
                + geo['tile'] // 4)
        assert held == {16: 148, 32: 168}[geo['tile']]
    else:
        assert geo['keys'] == fa.WG_WIDE_DKV_KEYS == 64
        assert geo['tile'] == fa.WG_WIDE_DKV_TILE
        assert geo['exchange'] is fa.WG_WIDE_DKV_EXCHANGE
        # S and dP
        assert geo['xfloats'] == 2 * 2 * 64 * geo['tile'] * geo['exchange']
        held = fa.WG_WIDE_HALF // 2 + 2 * (geo['tile'] // 2)
        assert held == 144


@pytest.mark.parametrize('n,m', SKIP_SHAPES)
@pytest.mark.parametrize('causal', [False, True])
def test_causal_skip_at_the_wide_geometry(n, m, causal):
    """The wide forward's blocks of WG_WIDE_FWD_ROWS rows visit key tiles
    0 .. dq_key_tiles - 1 of WG_WIDE_FWD_TILE keys, dK/dV's blocks of
    WG_WIDE_DKV_KEYS keys the query tiles of dkv_query_tiles of
    WG_WIDE_DKV_TILE rows: every visible pair lies in a visited tile, and a
    warp's tile that tile_masked passes untested (16 rows by a key tile in
    the forward, a query tile by 16 keys in dK/dV) holds only visible pairs
    inside n, m. The paired forward and dK/dV's clusters take this geometry
    too, both blocks of a cluster the same tiles, so that every push of
    the hand-off meets its wait."""
    big = _padded_mask(n, m, causal)
    _check_query_blocks(big, n, m, causal, fa.WG_WIDE_FWD_ROWS,
                        fa.WG_WIDE_FWD_TILE)
    keys, qt = fa.WG_WIDE_DKV_KEYS, fa.WG_WIDE_DKV_TILE
    for k0 in range(0, m, keys):
        seen = np.zeros(n + 512, bool)
        for t in fa.dkv_query_tiles(k0, n, m, causal, qt):
            seen[t * qt:(t + 1) * qt] = True
            for kw in range(k0, k0 + keys, 16):
                if not fa.tile_masked(t * qt, qt, kw, 16, n, m, causal):
                    assert big[t * qt:(t + 1) * qt, kw:kw + 16].all()
        assert not big[~seen, k0:k0 + keys].any()


@pytest.mark.parametrize('n,m', SKIP_SHAPES)
@pytest.mark.parametrize('causal', [False, True])
def test_causal_skip_at_the_wide_dq_geometry(n, m, causal):
    """The wide dQ's blocks of WG_WIDE_DQ_ROWS rows visit the key tiles of
    dq_key_tiles of WG_WIDE_DQ_TILE keys: every visible pair (and so every
    dS the kernel writes from its accumulators) lies in a visited tile, and
    a warp's tile (16 rows by a key tile) that tile_masked passes untested
    is all visible."""
    _check_query_blocks(_padded_mask(n, m, causal), n, m, causal,
                        fa.WG_WIDE_DQ_ROWS, fa.WG_WIDE_DQ_TILE)


def _scores(a, b, exchange):
    """a b^T over the padded width as the warpgroups form it: with
    ``exchange`` each multiplies half of the 64-column panels and the
    partial sums add, else each forms the whole product."""
    if not exchange:
        return a @ b.T
    half = fa.WG_WIDE_MAX // 2
    return a[:, :half] @ b[:, :half].T + a[:, half:] @ b[:, half:].T


def _columns():
    """The output columns of each consumer warpgroup."""
    return [slice(c, c + fa.WG_WIDE_HALF)
            for c in range(0, fa.WG_WIDE_MAX, fa.WG_WIDE_HALF)]


def _fwd_wide_model(q, k, v, bias, causal, scale):
    """The wide forward's loop: per block of WG_WIDE_FWD_ROWS rows (16 a
    warp, both warpgroups on the same rows), the key tiles of dq_key_tiles
    of WG_WIDE_FWD_TILE keys, S as WG_WIDE_FWD_EXCHANGE forms it, an
    online softmax in base 2 (the `pre` form), O += P V on each
    warpgroup's 256 columns; then O / l and lse in natural log (warpgroup
    0's); the rows that see no key take the mean of v and lse kMasked +
    log m; the columns past d are not stored."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_WIDE_FWD_ROWS, fa.WG_WIDE_FWD_TILE
    qp, kp, vp = (_pad(t, fa.WG_WIDE_MAX) for t in (q, k, v))
    out = torch.full_like(qp, math.nan)
    lse = torch.full((b, h, n), math.nan, dtype=q.dtype)
    blind = fa.no_key_rows(n, m, causal)
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for q0 in range(0, n, rows):
            tiles = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
            for w0 in range(q0, q0 + rows, 16):
                qw = _rows(qp[bi, hi], w0, 16)
                o = [torch.zeros(16, fa.WG_WIDE_HALF, dtype=q.dtype)
                     for _ in _columns()]
                mx = torch.full((16,), -math.inf, dtype=q.dtype)
                l = torch.zeros(16, dtype=q.dtype)
                for t in range(tiles):
                    k0 = t * tile
                    s = _scores(qw, _rows(kp[bi, hi], k0, tile),
                                fa.WG_WIDE_FWD_EXCHANGE)
                    s = s * (scale * LOG2E)
                    if bb is not None:
                        s = s + _rows(_rows(bb, w0, 16).T, k0,
                                      tile).T * LOG2E
                    s = _masked(s, w0, 16, k0, tile, n, m, causal)
                    mnew = torch.maximum(mx, s.max(dim=1).values)
                    base = torch.where(mnew == -math.inf, 0.0, mnew)
                    alpha = torch.exp2(mx - base)
                    p = torch.exp2(s - base[:, None])
                    l = l * alpha + p.sum(dim=1)
                    vt = _rows(vp[bi, hi], k0, tile)
                    o = [oc * alpha[:, None] + p @ vt[:, cols]
                         for oc, cols in zip(o, _columns())]
                    mx = mnew
                lsum = torch.clamp(l, min=1e-30)
                o = torch.cat(o, dim=1) / lsum[:, None]
                ls = torch.where(mx == -math.inf, fa.MASKED + torch.log(lsum),
                                 mx * math.log(2) + torch.log(lsum))
                r = torch.arange(w0, w0 + 16)
                no_key = r < blind
                o[no_key] = vp[bi, hi].mean(dim=0)
                ls[no_key] = fa.MASKED + math.log(m)
                keep = r < n
                out[bi, hi, r[keep]] = o[keep]
                lse[bi, hi, r[keep]] = ls[keep]
    return out[..., :d], lse


def _dkv_wide_model(q, k, v, bias, out, lse, dout, causal, scale):
    """The wide dK/dV's loop: per block of WG_WIDE_DKV_KEYS keys, a dV block
    (grid z 0) and a dK block (z 1); each streams the query tiles of
    dkv_query_tiles of WG_WIDE_DKV_TILE rows, forms S^T (and in the dK
    block dP^T) as WG_WIDE_DKV_EXCHANGE says, P^T = 2^(S^T scale
    log2e + bias log2e - lse log2e) with each warp's element test (16 keys
    by the tile) where tile_masked asks for it, and on each warpgroup's 256
    columns dV += P^T dO or dK += dS^T Q, dS^T = P^T (dP^T - delta); then
    dV gains the dO of the rows that see no key over m, dK *= scale; the
    columns past d are not stored."""
    b, h, n, d = q.shape
    m = k.shape[2]
    keys, qt = fa.WG_WIDE_DKV_KEYS, fa.WG_WIDE_DKV_TILE
    qp, kp, vp, dop = (_pad(t, fa.WG_WIDE_MAX) for t in (q, k, v, dout))
    delta = (dout * out).sum(dim=-1)
    blind = fa.no_key_rows(n, m, causal)
    grads = {'dv': torch.full_like(vp, math.nan),
             'dk': torch.full_like(kp, math.nan)}
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for k0, z in itertools.product(range(0, m, keys), ('dv', 'dk')):
            kk, vv = _rows(kp[bi, hi], k0, keys), _rows(vp[bi, hi], k0, keys)
            acc = [torch.zeros(keys, fa.WG_WIDE_HALF, dtype=q.dtype)
                   for _ in _columns()]
            for t in fa.dkv_query_tiles(k0, n, m, causal, qt):
                q0 = t * qt
                qq, do = _rows(qp[bi, hi], q0, qt), _rows(dop[bi, hi], q0, qt)
                ls = _rows(lse[bi, hi], q0, qt)
                x = (_scores(kk, qq, fa.WG_WIDE_DKV_EXCHANGE)
                     * (scale * LOG2E) - ls[None, :] * LOG2E)
                if bb is not None:
                    x = x + _rows(_rows(bb, q0, qt).T, k0, keys) * LOG2E
                p = torch.exp2(torch.cat([
                    _masked(x[i:i + 16], q0, qt, k0 + i, 16, n, m, causal,
                            transposed=True) for i in range(0, keys, 16)]))
                if z == 'dv':
                    acc = [a + p @ do[:, cols]
                           for a, cols in zip(acc, _columns())]
                else:
                    de = _rows(delta[bi, hi], q0, qt)
                    ds = p * (_scores(vv, do, fa.WG_WIDE_DKV_EXCHANGE)
                              - de[None, :])
                    acc = [a + ds @ qq[:, cols]
                           for a, cols in zip(acc, _columns())]
            acc = torch.cat(acc, dim=1)
            if z == 'dv' and blind:
                acc = acc + dop[bi, hi, :blind].sum(dim=0) / m
            if z == 'dk':
                acc = acc * scale
            r = torch.arange(k0, k0 + keys)
            keep = r < m
            grads[z][bi, hi, r[keep]] = acc[keep]
    return grads['dk'][..., :d], grads['dv'][..., :d]


def _dq_wide_model(q, k, v, bias, out, lse, dout, causal, scale,
                   ds_dtype=None):
    """The wide dQ's loop: per block of WG_WIDE_DQ_ROWS query rows (16 a
    warp, both warpgroups on the same rows), the key tiles of dq_key_tiles
    of WG_WIDE_DQ_TILE keys; S and dP as WG_WIDE_DQ_EXCHANGE forms them
    (the sums over the panels of each half, then the two halves added),
    P = 2^(S scale log2e + bias log2e - lse log2e) with each warp's element
    test where tile_masked asks for it, dS = P (dP - delta), dQ += dS K on
    each warpgroup's 256 columns, with dS rounded to ``ds_dtype`` (bf16 on
    the card) where the kernel hands it to ``wgmma``; warpgroup 0 writes its
    float32 dS as d_bias in every visited tile and zeros in the skipped
    ones; then dQ *= scale, the columns past d not stored. Returns dq and
    the (b h, n, m) dS, NaN where nothing was written."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_WIDE_DQ_ROWS, fa.WG_WIDE_DQ_TILE
    qp, kp, vp, dop = (_pad(t, fa.WG_WIDE_MAX) for t in (q, k, v, dout))
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
                acc = [torch.zeros(16, fa.WG_WIDE_HALF, dtype=q.dtype)
                       for _ in _columns()]
                r1 = min(w0 + 16, n) - w0      # the warp's rows inside n
                for t in range(tiles):
                    k0 = t * tile
                    kk = _rows(kp[bi, hi], k0, tile)
                    vv = _rows(vp[bi, hi], k0, tile)
                    x = (_scores(qw, kk, fa.WG_WIDE_DQ_EXCHANGE)
                         * (scale * LOG2E) - ls[:, None] * LOG2E)
                    if bb is not None:
                        x = x + _rows(_rows(bb, w0, 16).T, k0,
                                      tile).T * LOG2E
                    p = torch.exp2(_masked(x, w0, 16, k0, tile, n, m, causal))
                    ds = p * (_scores(dow, vv, fa.WG_WIDE_DQ_EXCHANGE)
                              - de[:, None])
                    handed = ds if ds_dtype is None else \
                        ds.to(ds_dtype).to(ds.dtype)
                    acc = [a + handed @ kk[:, cols]
                           for a, cols in zip(acc, _columns())]
                    c1 = min(k0 + tile, m) - k0
                    if r1 > 0:
                        ds_head[w0:w0 + r1, k0:k0 + c1] = ds[:r1, :c1]
                if r1 > 0:
                    dq[bi, hi, w0:w0 + r1] = torch.cat(acc, dim=1)[:r1] * scale
            ds_head[q0:q0 + rows, tiles * tile:] = 0
    return dq[..., :d], ds_all


def _inputs(d, m, causal, dtype):
    rng = np.random.default_rng(11 + d + m + causal)
    b, h, n = 1, 2, 130
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s)).to(dtype) for s in
                     ((b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)))
    bias = torch.from_numpy(rng.normal(size=(h, n, m))).to(dtype)
    return q, k, v, dout, bias


WIDE_CASES = list(itertools.product((264, 320, 512), (70, 134),
                                    (False, True), (False, True)))


@pytest.mark.parametrize('d,m,causal,with_bias', WIDE_CASES)
def test_the_wide_forward_loop_matches_the_plain_version(d, m, causal,
                                                         with_bias):
    """The wide forward's loop against ``flash_attention_ref`` on (1, 2,
    130, d) / m keys (70: fewer keys than queries, with causal the first 60
    rows see none; 134: a ragged last tile), with an (h, n, m) bias or none:
    out within 1e-6 of the largest value in float64 and 1e-5 in float32,
    lse within 1e-5, every element written."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, _, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        want_out, want_lse = fa.flash_attention_ref(q, k, v, causal, scale,
                                                    bias)
        out, lse = _fwd_wide_model(q, k, v, bias, causal, scale)
        assert not out.isnan().any() and not lse.isnan().any()
        _close(out, want_out, tol)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize('d,m,causal,with_bias', WIDE_CASES)
def test_the_wide_dkv_loop_matches_the_plain_version(d, m, causal,
                                                     with_bias):
    """The wide dK/dV's loop (both blocks of grid z) against
    ``flash_attention_bwd_ref``'s dk and dv on (1, 2, 130, d) / m keys,
    with an (h, n, m) bias or none: float64 within 1e-6 of the largest
    value, float32 within 1e-5, every element written."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
        _, want_dk, want_dv, _ = fa.flash_attention_bwd_ref(
            q, k, v, bias, out, lse, dout, causal, scale)
        dk, dv = _dkv_wide_model(q, k, v, bias, out, lse, dout, causal,
                                 scale)
        assert not dk.isnan().any() and not dv.isnan().any()
        _close(dk, want_dk, tol)
        _close(dv, want_dv, tol)


@pytest.mark.parametrize('d,m,causal,with_bias', WIDE_CASES)
def test_the_wide_dq_loop_matches_the_plain_version(d, m, causal, with_bias):
    """The wide dQ's loop against ``flash_attention_bwd_ref`` on (1, 2, 130,
    d) / m keys (70: fewer keys than queries, with causal the first 60 rows
    see none, whose dq must be exactly 0; 134: a ragged last tile), with an
    (h, n, m) bias or none: dq, and dS as d_bias, every element written,
    float64 within 1e-6 of the largest value, float32 within 1e-5."""
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
        want_dq, _, _, want_db = fa.flash_attention_bwd_ref(
            q, k, v, bias, out, lse, dout, causal, scale)
        dq, ds = _dq_wide_model(q, k, v, bias, out, lse, dout, causal, scale)
        assert not dq.isnan().any() and not ds.isnan().any()
        _close(dq, want_dq, tol)
        blind = fa.no_key_rows(130, m, causal)
        assert not dq[:, :, :blind].any()
        assert not ds[:, :blind].any()
        if bias is not None:
            _close(fa._reduce_bias_groups(ds, bias), want_db, tol)


@pytest.mark.parametrize('causal', [False, True])
def test_the_wide_dq_loop_with_ds_in_bf16(causal):
    """The loop with dS rounded to bf16 where the kernel hands it to
    ``wgmma`` (the A operand of dQ += dS K), float32 otherwise, at d = 320 /
    134 keys with a bias: dq within 1e-2 of the largest value of the plain
    version's (each dS carries bf16's 2^-9 relative rounding into a sum
    over ~130 keys), d_bias (from the unrounded float32 dS) within 1e-5."""
    q, k, v, dout, bias = _inputs(320, 134, causal, torch.float32)
    scale = 320 ** -0.5
    out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
    want_dq, _, _, want_db = fa.flash_attention_bwd_ref(
        q, k, v, bias, out, lse, dout, causal, scale)
    dq, ds = _dq_wide_model(q, k, v, bias, out, lse, dout, causal, scale,
                            ds_dtype=torch.bfloat16)
    _close(dq, want_dq, 1e-2)
    _close(fa._reduce_bias_groups(ds, bias), want_db, 1e-5)


@pytest.mark.parametrize('with_bias', [False, True])
def test_the_wide_dq_loop_matches_the_jax_custom_vjp(with_bias):
    """The wide dQ's loop at d = 320, (1, 1, 70) / 74 keys causal, against
    the dq of ``jax.grad`` through the JAX package's Pallas backward in
    interpret mode, on the port's plain forward's out and lse; with an
    (h, n, m) bias also d_bias: float32, within 1e-5 of the largest
    value."""
    n, m, d = 70, 74, 320
    q, k, v = _qkv(1, 1, n, m, d, 90)
    b = _rand((1, n, m), 94) if with_bias else None
    g_out = _rand((1, 1, n, d), 95)
    want = _jax_flash_grads(q, k, v, b, g_out, True)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g_out))
    bt = None if b is None else torch.from_numpy(b)
    out, lse = fa.flash_attention_ref(qt, kt, vt, True, d ** -0.5, bt)
    dq, ds = _dq_wide_model(qt, kt, vt, bt, out, lse, gt, True, d ** -0.5)
    _close(dq, torch.from_numpy(np.array(want[0])), 1e-5)
    if b is not None:
        _close(fa._reduce_bias_groups(ds, bt),
               torch.from_numpy(np.array(want[3])), 1e-5)


@pytest.mark.parametrize('d', [264, 512, 520, 1024, 1032])
def test_each_wide_head_names_its_kernel(d):
    """Heads of 257 to WG_WIDE_MAX run the Hopper wide forward, dQ and
    dK/dV; heads of WG_WIDE_MAX + 1 to WG_PAIR_MAX the paired forward, dQ
    and dK/dV; wider heads the three wide kernels: the names
    ``mma_kernel`` gives are kernels of the source."""
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    names = {kernel: fa.mma_kernel(kernel, d) for kernel in fa.MMA_KERNELS}
    if d <= fa.WG_WIDE_MAX:
        kind = {'dq': 'wg_wide', 'dkv': 'wg_wide', 'fwd': 'wg_wide'}
    elif d <= fa.WG_PAIR_MAX:
        kind = dict.fromkeys(fa.MMA_KERNELS, 'wg_pair')
    else:
        kind = dict.fromkeys(fa.MMA_KERNELS, 'wide_mma')
    assert names == {
        'dq': f'bwd_dq_{kind["dq"]}_kernel',
        'dkv': f'bwd_dkv_{kind["dkv"]}_kernel',
        'fwd': f'fwd_{kind["fwd"]}_kernel'}
    for name in names.values():
        assert re.search(rf'__global__ void __launch_bounds__\([^)]*\)\s+'
                         rf'{name}\(', src), name
