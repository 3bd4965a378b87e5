"""The Hopper flash-attention kernels' geometry on the CPU: the forward, dQ
and dK/dV at the padded widths 128 and 256 (csrc/flash_attention.cu
``fwd_wg_mma_kernel``, ``bwd_dq_wg_mma_kernel``, ``bwd_dkv_wg_mma_kernel``).
The constants that the wrapper exposes against the source, the causal-skip
twins at that geometry against a dense mask, and test-local models of the
three kernels' loops (query blocks, key blocks, key and query tiles, the
per-warp element tests, the rows that see no key, dS written as d_bias in
every visited tile and as zeros in the skipped ones and, at 256, dK/dV's
split of the products between the warpgroups with P^T handed over
unrounded) against the plain versions, in float64 within 1e-6 of the
largest value (the same sums in another order) and in float32 within 1e-5.
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

torch.set_num_threads(1)

WG_WIDTHS = (128, 256)
LOG2E = 1.4426950408889634


def _struct(name: str) -> str:
    src = (_build.SOURCE_DIR / 'flash_attention.cu').read_text()
    i = src.index(f'struct {name} {{')
    return src[i:src.index('};', i)]


def _value(body: str, field: str, env: dict):
    """``static constexpr ... field = <expr>;`` evaluated at env, with C's
    ``a ? b : c``, ``==`` and casts to size_t."""
    expr = re.search(rf'\b{field} =\s+([^;]+);', body)[1]
    expr = expr.replace('(size_t)', '')

    def ev(e):
        e = e.strip()
        hit = re.fullmatch(r'(.+?)\s*\?\s*(.+?)\s*:\s*(.+)', e)
        if hit:
            return ev(hit[2]) if ev(hit[1]) else ev(hit[3])
        return eval(e, {}, env)   # a name, a number or a comparison
    return ev(expr)


def test_geometry_constants_match_the_source():
    fwd, dkv = _struct('WgFwdGeo'), _struct('WgDkvGeo')
    for d in WG_WIDTHS:
        assert _value(fwd, 'rows', {'D': d}) == fa.WG_FWD_ROWS
        assert _value(fwd, 'tile', {'D': d}) == fa.WG_FWD_TILE[d]
        split = _value(dkv, 'split', {'D': d})
        assert split == (d == 256)
        assert _value(dkv, 'keys', {'D': d, 'split': split}) == \
            fa.WG_DKV_KEYS[d]
        assert _value(dkv, 'tile', {'D': d}) == fa.WG_DKV_TILE
    # a warpgroup owns 64 rows: the forward's two, dK/dV's keys
    assert fa.WG_FWD_ROWS == 2 * 64
    assert all(fa.WG_DKV_KEYS[d] == (64 if d == 256 else 128)
               for d in WG_WIDTHS)


@pytest.mark.parametrize('d', WG_WIDTHS)
def test_dq_geometry_constants_match_the_source(d):
    """WgDqGeo against WG_DQ_ROWS / WG_DQ_TILE: two warpgroups of 64 query
    rows, 64-key tiles at 128 and 32 at 256; its shared memory (Q and dO
    once, K and V rings) under the 227 KB a block takes, and a consumer
    thread's dQ, S, dP and dS fragments as the source's comment counts
    them."""
    geo = _struct('WgDqGeo')
    env = {'D': d, 'kSw128Cols': 64}
    for field in ('rows', 'tile', 'stages', 'panels', 'q_panel', 'kv_panel',
                  'kv_tile'):
        env[field] = _value(geo, field, env)
    assert env['rows'] == fa.WG_DQ_ROWS == 2 * 64
    assert env['tile'] == fa.WG_DQ_TILE[d]
    assert _value(geo, 'bytes', env) <= 232448
    held = d // 2 + 2 * (env['tile'] // 2) + env['tile'] // 4
    assert held == {128: 144, 256: 168}[d]


def _visible(n: int, m: int, causal: bool):
    """(n, m) bool: query i sees key j (right-aligned causal mask)."""
    i, j = np.arange(n)[:, None], np.arange(m)[None, :]
    return (j <= i + (m - n)) if causal else np.ones((n, m), bool)


def _padded_mask(n: int, m: int, causal: bool):
    """The (n, m) visibility inside a zero margin of rows and keys past the
    edges."""
    big = np.zeros((n + 512, m + 512), bool)
    big[:n, :m] = _visible(n, m, causal)
    return big


def _check_query_blocks(big, n, m, causal, rows, tile):
    """Blocks of ``rows`` query rows visit key tiles 0 .. dq_key_tiles - 1
    of ``tile`` keys: no visible pair past them, and a warp's tile (16 rows
    by a key tile) that tile_masked passes untested holds only visible pairs
    inside n, m."""
    for q0 in range(0, n, rows):
        tiles = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
        assert not big[q0:q0 + rows, tiles * tile:].any()
        for w0, t in itertools.product(range(q0, q0 + rows, 16),
                                       range(tiles)):
            if not fa.tile_masked(w0, 16, t * tile, tile, n, m, causal):
                assert big[w0:w0 + 16, t * tile:(t + 1) * tile].all()


SKIP_SHAPES = list(itertools.product((1, 5, 70, 130, 300), (1, 64, 129, 260)))


@pytest.mark.parametrize('n,m', SKIP_SHAPES)
@pytest.mark.parametrize('causal', [False, True])
def test_causal_skip_at_the_hopper_geometry(n, m, causal):
    """The forward's blocks of WG_FWD_ROWS rows visit key tiles
    0 .. dq_key_tiles - 1 of WG_FWD_TILE keys, dK/dV's blocks of WG_DKV_KEYS
    keys the query tiles of dkv_query_tiles of WG_DKV_TILE rows: every
    visible pair lies in a visited tile, and a warp's tile that
    tile_masked passes untested (16 rows by a key tile in the forward, a
    query tile by 16 keys in dK/dV) holds only visible pairs inside n, m."""
    big = _padded_mask(n, m, causal)
    for d in WG_WIDTHS:
        _check_query_blocks(big, n, m, causal, fa.WG_FWD_ROWS,
                            fa.WG_FWD_TILE[d])
        keys, qt = fa.WG_DKV_KEYS[d], fa.WG_DKV_TILE
        for k0 in range(0, m, keys):
            visited = fa.dkv_query_tiles(k0, n, m, causal, qt)
            seen = np.zeros(n + 512, bool)
            for t in visited:
                seen[t * qt:(t + 1) * qt] = True
                for kw in range(k0, k0 + keys, 16):
                    if not fa.tile_masked(t * qt, qt, kw, 16, n, m, causal):
                        assert big[t * qt:(t + 1) * qt, kw:kw + 16].all()
            assert not big[~seen, k0:k0 + keys].any()


@pytest.mark.parametrize('n,m', SKIP_SHAPES)
@pytest.mark.parametrize('causal', [False, True])
def test_causal_skip_at_the_dq_geometry(n, m, causal):
    """dQ's blocks of WG_DQ_ROWS rows visit the key tiles of dq_key_tiles
    of WG_DQ_TILE keys, as the forward's do: every visible pair (and so
    every dS the kernel writes from its accumulators) lies in a visited
    tile, and a warp's untested tile is all visible."""
    big = _padded_mask(n, m, causal)
    for d in WG_WIDTHS:
        _check_query_blocks(big, n, m, causal, fa.WG_DQ_ROWS,
                            fa.WG_DQ_TILE[d])


def _pad(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _masked(x, q0, nq, k0, nk, n, m, causal, transposed=False):
    """One warp's tile of exponents with the kernel's element test (-inf
    where hidden) where tile_masked asks for it, else as it is: x is
    (queries, keys), or (keys, queries) when transposed."""
    if fa.tile_masked(q0, nq, k0, nk, n, m, causal):
        rows = torch.arange(q0, q0 + nq)[:, None]
        cols = torch.arange(k0, k0 + nk)[None, :]
        ok = (rows < n) & (cols < m)
        if causal:
            ok &= cols <= rows + (m - n)
        x = x.masked_fill(~(ok.T if transposed else ok), -math.inf)
    return x


def _rows(t, r0, count):
    """Rows r0 .. r0 + count - 1 of t (rows, .), zeros past the last."""
    out = t.new_zeros((count,) + t.shape[1:])
    got = t[r0:r0 + count]
    out[:got.shape[0]] = got
    return out


def _fwd_model(q, k, v, bias, causal, scale, width):
    """The forward's loop at width D: per block of WG_FWD_ROWS rows, 16
    rows a warp, the key tiles of dq_key_tiles, an online softmax in base 2
    (the `pre` form: the scores scaled, the bias added), O += P V, then
    O / l and lse in natural log; the rows that see no key take the mean of
    v and lse kMasked + log m."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_FWD_ROWS, fa.WG_FWD_TILE[width]
    qp, kp, vp = (_pad(t, width) for t in (q, k, v))
    out = torch.zeros_like(qp)
    lse = torch.zeros(b, h, n, dtype=q.dtype)
    blind = fa.no_key_rows(n, m, causal)
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for q0 in range(0, n, rows):
            tiles = fa.dq_key_tiles(q0, rows, n, m, causal, tile)
            for w0 in range(q0, q0 + rows, 16):
                qw = _rows(qp[bi, hi], w0, 16)
                o = torch.zeros(16, width, dtype=q.dtype)
                mx = torch.full((16,), -math.inf, dtype=q.dtype)
                l = torch.zeros(16, dtype=q.dtype)
                for t in range(tiles):
                    k0 = t * tile
                    s = qw @ _rows(kp[bi, hi], k0, tile).T * (scale * LOG2E)
                    if bb is not None:
                        s = s + _rows(_rows(bb, w0, 16).T, k0,
                                      tile).T * LOG2E
                    s = _masked(s, w0, 16, k0, tile, n, m, causal)
                    mnew = torch.maximum(mx, s.max(dim=1).values)
                    base = torch.where(mnew == -math.inf, 0.0, mnew)
                    alpha = torch.exp2(mx - base)
                    p = torch.exp2(s - base[:, None])
                    l = l * alpha + p.sum(dim=1)
                    o = o * alpha[:, None] + p @ _rows(vp[bi, hi], k0, tile)
                    mx = mnew
                lsum = torch.clamp(l, min=1e-30)
                o = o / lsum[:, None]
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


def _dkv_model(q, k, v, bias, out, lse, dout, causal, scale, width):
    """dK/dV's loop at width D: per block of WG_DKV_KEYS keys, 64 a
    warpgroup (at 256 both warpgroups on the same 64: one forms S^T, P^T
    and dV and hands P^T over unrounded, the other dP^T, dS^T and dK), the
    query tiles of dkv_query_tiles, P^T = 2^(S^T scale log2e + bias log2e -
    lse log2e) with each warp's element test where tile_masked asks for it,
    dV += P^T dO, dS^T = P^T (dP^T - delta), dK += dS^T Q; then dV gains the
    dO of the rows that see no key over m, and dK *= scale."""
    b, h, n, d = q.shape
    m = k.shape[2]
    keys, qt = fa.WG_DKV_KEYS[width], fa.WG_DKV_TILE
    split = width == 256
    qp, kp, vp, dop = (_pad(t, width) for t in (q, k, v, dout))
    delta = (dout * out).sum(dim=-1)
    blind = fa.no_key_rows(n, m, causal)
    dk = torch.zeros_like(kp)
    dv = torch.zeros_like(vp)
    for bi, hi in itertools.product(range(b), range(h)):
        bb = None if bias is None else bias[(bi * h + hi) % bias.shape[0]]
        for k0 in range(0, m, keys):
            for kw in ((k0,) if split else (k0, k0 + 64)):
                kk, vv = _rows(kp[bi, hi], kw, 64), _rows(vp[bi, hi], kw, 64)
                acc_v = torch.zeros(64, width, dtype=q.dtype)
                acc_k = torch.zeros(64, width, dtype=q.dtype)
                for t in fa.dkv_query_tiles(k0, n, m, causal, qt):
                    q0 = t * qt
                    qq, do = _rows(qp[bi, hi], q0, qt), _rows(dop[bi, hi], q0,
                                                              qt)
                    ls = _rows(lse[bi, hi], q0, qt)
                    de = _rows(delta[bi, hi], q0, qt)
                    # the warpgroup forming S^T, P^T and dV
                    x = kk @ qq.T * (scale * LOG2E) - ls[None, :] * LOG2E
                    if bb is not None:
                        x = x + _rows(_rows(bb, q0, qt).T, kw, 64) * LOG2E
                    p = torch.exp2(torch.cat([
                        _masked(x[i:i + 16], q0, qt, kw + i, 16, n, m, causal,
                                transposed=True) for i in range(0, 64, 16)]))
                    acc_v += p @ do
                    handed = p.clone() if split else p    # shared memory
                    # the one forming dP^T, dS^T and dK
                    ds = handed * (vv @ do.T - de[None, :])
                    acc_k += ds @ qq
                if blind:
                    acc_v += dop[bi, hi, :blind].sum(dim=0) / m
                r = torch.arange(kw, kw + 64)
                keep = r < m
                dv[bi, hi, r[keep]] = acc_v[keep]
                dk[bi, hi, r[keep]] = acc_k[keep] * scale
    return dk[..., :d], dv[..., :d]


def _dq_model(q, k, v, bias, out, lse, dout, causal, scale, width):
    """dQ's loop at width D: per block of WG_DQ_ROWS query rows (two
    warpgroups of 64, 16 rows a warp), the key tiles of dq_key_tiles of
    WG_DQ_TILE keys: P = 2^(S scale log2e + bias log2e - lse log2e) with
    each warp's element test where tile_masked asks for it, dS = P (dP -
    delta), dQ += dS K; dS goes to d_bias from every visited tile (its
    elements inside n, m) and zeros to the key tiles the block skips; then
    dQ *= scale. Returns dq and the (b h, n, m) dS, NaN where nothing was
    written."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rows, tile = fa.WG_DQ_ROWS, fa.WG_DQ_TILE[width]
    qp, kp, vp, dop = (_pad(t, width) for t in (q, k, v, dout))
    delta = (dout * out).sum(dim=-1)
    dq = torch.zeros_like(qp)
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
                acc = torch.zeros(16, width, dtype=q.dtype)
                r1 = min(w0 + 16, n) - w0      # the warp's rows inside n
                for t in range(tiles):
                    k0 = t * tile
                    kk = _rows(kp[bi, hi], k0, tile)
                    x = qw @ kk.T * (scale * LOG2E) - ls[:, None] * LOG2E
                    if bb is not None:
                        x = x + _rows(_rows(bb, w0, 16).T, k0,
                                      tile).T * LOG2E
                    p = torch.exp2(_masked(x, w0, 16, k0, tile, n, m, causal))
                    ds = p * (dow @ _rows(vp[bi, hi], k0, tile).T
                              - de[:, None])
                    acc += ds @ kk
                    c1 = min(k0 + tile, m) - k0
                    if r1 > 0:
                        ds_head[w0:w0 + r1, k0:k0 + c1] = ds[:r1, :c1]
                if r1 > 0:
                    dq[bi, hi, w0:w0 + r1] = acc[:r1] * scale
            ds_head[q0:q0 + rows, tiles * tile:] = 0
    return dq[..., :d], ds_all


def _inputs(d, m, causal, dtype):
    rng = np.random.default_rng(7 + d + m + causal)
    b, h, n = 1, 2, 130
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s)).to(dtype) for s in
                     ((b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d)))
    bias = torch.from_numpy(rng.normal(size=(h, n, m))).to(dtype)
    return q, k, v, dout, bias


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, tol)


@pytest.mark.parametrize('d', [96, 256])
@pytest.mark.parametrize('m', [70, 134])
@pytest.mark.parametrize('causal', [False, True])
def test_the_hopper_loops_match_the_plain_versions(d, m, causal):
    """The forward's and dK/dV's loops at the padded width of d against
    ``flash_attention_ref`` / ``flash_attention_bwd_ref`` on (1, 2, 130, d)
    / m keys with an (h, n, m) bias: float64 within 1e-6 of the largest
    value, float32 within 1e-5 (lse 1e-5 absolute)."""
    width = 128 if d <= 128 else 256
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        scale = d ** -0.5
        want_out, want_lse = fa.flash_attention_ref(q, k, v, causal, scale,
                                                    bias)
        out, lse = _fwd_model(q, k, v, bias, causal, scale, width)
        _close(out, want_out, tol)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                                   atol=1e-5)
        _, want_dk, want_dv, _ = fa.flash_attention_bwd_ref(
            q, k, v, bias, want_out, want_lse, dout, causal, scale)
        dk, dv = _dkv_model(q, k, v, bias, want_out, want_lse, dout, causal,
                            scale, width)
        _close(dk, want_dk, tol)
        _close(dv, want_dv, tol)


@pytest.mark.parametrize('d', [96, 160, 256])
@pytest.mark.parametrize('m', [70, 134])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('with_bias', [False, True])
def test_the_hopper_dq_loop_matches_the_plain_version(d, m, causal,
                                                      with_bias):
    """dQ's loop at the padded width of d against ``flash_attention_bwd_ref``
    on (1, 2, 130, d) / m keys (70: fewer keys than queries, with causal the
    first 60 rows see none; 134: a ragged last tile), with an (h, n, m) bias
    or none: dq, and dS as d_bias, every element written, float64 within
    1e-6 of the largest value, float32 within 1e-5."""
    width = 128 if d <= 128 else 256
    for dtype, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        q, k, v, dout, bias = _inputs(d, m, causal, dtype)
        bias = bias if with_bias else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_ref(q, k, v, causal, scale, bias)
        want_dq, _, _, want_db = fa.flash_attention_bwd_ref(
            q, k, v, bias, out, lse, dout, causal, scale)
        dq, ds = _dq_model(q, k, v, bias, out, lse, dout, causal, scale,
                           width)
        _close(dq, want_dq, tol)
        assert not ds.isnan().any()
        if bias is not None:
            _close(fa._reduce_bias_groups(ds, bias), want_db, tol)
