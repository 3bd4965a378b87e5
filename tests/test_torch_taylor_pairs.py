"""The feature packing of the Taylor block's bf16 wgmma core (B3 at every
head but 8), on the CPU.

phi_ij == phi_ji to the bit, so the core builds each feature row once: the
constant, k_j and phi_ij for i <= j, in the order of ``feature_pairs``,
which the wrapper hands both launches as a table (``pair_table``) and uses
for the scratch size (``wide_scratch_bytes``). An off-diagonal row stands
for phi_ij and phi_ji, so the contraction weights it by 2, exact in bf16.
Here: the rows at every padded head width (each pair, each k_j and the
constant exactly once, at most 1.1 F rows from d = 32 on), the table words
and the scratch size; a test-local model of the symmetric contraction,
with the off-diagonal weight in phi(q) or in the stored moments, against
``taylor_core_ref`` (float32 within 1e-6; bf16 on the plain version's cast
points within the card's tolerance) and against the JAX package's
``_taylor_reference`` (float32, the whole block, within 1e-5); and the
doubling exact in bf16. Inputs are numpy draws from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.taylor_attention import _taylor_reference
from magvit2_pytorch_tpu_torch.ops.kernels import gemm, taylor_attention as ta
from test_torch_taylor_heads import _block, _t

torch.set_num_threads(1)
WIDTHS = range(8, 257, 8)


def _features(d):
    return 1 + d + d * (d + 1) // 2


@pytest.mark.parametrize('k', WIDTHS)
def test_rows_hold_each_feature_once(k):
    """Every head 1 .. 256 runs at the next multiple of 8 (k): the rows
    list the constant once, each k_j once and each unordered pair once,
    zeros elsewhere, in 64-row tiles whose 16-row steps hold one kind and
    whose rows r and r + 8 share their first factor."""
    assert [d for d in range(1, 257) if ta.kernel_dim_head(d) == k] == list(
        range(k - 7, k + 1))
    rows, linear = ta.feature_pairs(k)
    one, zero = ta.ONE, ta.ZERO
    assert len(rows) % 64 == 0 and linear % 16 == 0
    head = [r for r in rows[:linear] if r != (one, zero)]
    assert sorted(head) == sorted([(one, one)] + [(one, j) for j in range(k)])
    assert all(x == one for x, _ in rows[:linear])
    products = [r for r in rows[linear:] if zero not in r]
    assert all(0 <= x < k and 0 <= y < k for x, y in products)
    assert len(products) == len({frozenset(p) for p in products}) == (
        k * (k + 1) // 2)
    assert {frozenset(p) for p in products} == {
        frozenset((i, j)) for i in range(k) for j in range(k)}
    assert sum(zero in r for r in rows) == len(rows) - _features(k)
    for s in range(0, len(rows), 16):
        assert all(rows[s + r][0] == rows[s + r + 8][0] for r in range(8))
        assert len({t >= linear for t in range(s, s + 16)}) == 1
    if k >= 32:
        assert len(rows) <= 1.1 * _features(k)


@pytest.mark.parametrize('k', WIDTHS)
def test_table_words_and_scratch_follow_the_rows(k):
    """The kernel's table: staged factor rows x_i | x_j << 16 (1 and 0 at
    the core's width D and D + 1), bit 31 on the product rows and the zeros
    after them; the scratch: d + 8 columns of the rows in bf16, then sum v
    in float32."""
    rows, linear = ta.feature_pairs(k)
    width = ta.core_width(k)
    assert width in ta.WG_WIDTHS and k <= width and (k > width // 2
                                                     or width == 16)
    staged = {ta.ONE: width, ta.ZERO: width + 1}
    for r, (word, (i, j)) in enumerate(zip(ta.pair_table(k), rows)):
        w = word & 0xFFFFFFFF
        assert w & 0x7FFF == staged.get(i, i)
        assert w >> 16 & 0x7FFF == staged.get(j, j)
        assert w >> 31 == (r >= linear)
    if k == 8:
        assert ta.wide_scratch_bytes(3, 5, k) == 0
    else:
        assert ta.wide_scratch_bytes(3, 5, k) == 15 * (
            2 * (k + 8) * len(rows) + 4 * k)


def _qkv(frames, n, heads, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(frames * n, heads * d)) * d ** -0.5
    k, v = (rng.normal(size=(frames * n, heads * d)) for _ in range(2))
    return torch.from_numpy(np.concatenate([q, k, v], 1).astype(np.float32))


def _symmetric_core(qkv, frames, heads, d, weight='q', eps=1e-5,
                    sums=torch.float32):
    """The core on the packed rows, with ``taylor_core_ref``'s cast points
    in the working dtype and its sums in ``sums``: each off-diagonal row
    weighted by 2 in phi(q) (``weight='q'``) or in the stored moments
    (``'moments'``, the card's); the constant row gives sum v and drops out
    of the contraction."""
    dt = qkv.dtype
    n = qkv.shape[0] // frames
    hd = heads * d
    q, k, v = (qkv[:, i * hd:(i + 1) * hd].reshape(frames, n, heads, d)
               for i in range(3))
    rows, linear = ta.feature_pairs(d)
    index = {ta.ONE: d, ta.ZERO: d + 1}
    fi = torch.tensor([index.get(i, i) for i, _ in rows])
    fj = torch.tensor([index.get(j, j) for _, j in rows])
    product = torch.arange(len(rows)) >= linear
    off = product & (fi != fj)
    inv_sqrt2 = torch.tensor(ta.INV_SQRT2, dtype=dt)

    def phi(t):
        ext = torch.cat([t, torch.ones_like(t[..., :1]),
                         torch.zeros_like(t[..., :1])], -1)
        x = ext[..., fi] * ext[..., fj]
        return torch.where(product, x * inv_sqrt2, x).to(sums)

    pq, pk = phi(q), phi(k)
    v32 = v.to(sums)
    a = torch.einsum('gnhf,gnhe->ghfe', pk, v32)
    s = pk.sum(dim=1)
    sum_v = a[:, :, 0].clone()
    a[:, :, 0], s[:, :, 0] = 0, 0
    if weight == 'moments':
        a[:, :, off], s[:, :, off] = 2 * a[:, :, off], 2 * s[:, :, off]
    else:
        pq = torch.where(off, 2 * pq, pq)
    a, s = a.to(dt).to(sums), s.to(dt).to(sums)
    num = torch.einsum('gnhf,ghfe->gnhe', pq, a) + sum_v[:, None]
    den = torch.einsum('gnhf,ghf->gnh', pq, s) + n
    r = (1.0 / (den + eps)).to(dt).to(sums)
    return (num * r[..., None]).to(dt).reshape(frames * n, hd)


CASES = [(8, 16), (4, 32), (2, 64), (1, 24)]


@pytest.mark.parametrize('weight', ['q', 'moments'])
@pytest.mark.parametrize('heads,d', CASES)
def test_symmetric_contraction_matches_plain_core(heads, d, weight):
    """float32, 2 frames x 128 tokens: the packed rows give the plain
    core's function within 1e-6 of its largest value. The model sums in
    float64 here (each float32 order lies ~8e-7 from it, so two float32
    orders lie ~1e-6 apart); its float32 sums within 1e-6 of its float64
    ones."""
    qkv = _qkv(2, 128, heads, d, 60 + d)
    want = ta.taylor_core_ref(qkv, 2, heads, d)
    exact = _symmetric_core(qkv, 2, heads, d, weight, sums=torch.float64)
    peak = want.abs().max()
    err = (exact - want).abs().max() / peak
    assert err <= 1e-6, err
    err32 = (_symmetric_core(qkv, 2, heads, d, weight) - exact).abs().max()
    assert err32 / peak <= 1e-6, err32 / peak


@pytest.mark.parametrize('heads,d', CASES)
def test_symmetric_contraction_in_bf16(heads, d):
    """bf16 on the plain version's cast points: within the card's bf16
    tolerance of ``taylor_core_ref`` in bf16 (chip_smoke.py TOL), and the
    two places of the weight agree to the bit."""
    qkv = _qkv(2, 128, heads, d, 70 + d).to(torch.bfloat16)
    want = ta.taylor_core_ref(qkv, 2, heads, d).float()
    got = _symmetric_core(qkv, 2, heads, d, 'moments')
    assert torch.equal(got, _symmetric_core(qkv, 2, heads, d, 'q'))
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err <= 2e-2, err


@pytest.mark.parametrize('heads,d', [(2, 32), (1, 64)])
def test_symmetric_contraction_matches_jax_reference(heads, d):
    """The whole block in float32 (norm, qkv, the packed core, out) against
    the JAX package's ``_taylor_reference``, within 1e-5."""
    x, gamma, wqkv, wout = _block(heads, d, 80 + d, c=32)
    want = np.asarray(_taylor_reference(
        jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wout), heads, d, 1e-5,
        d ** -0.5, gamma=jnp.asarray(gamma)))
    b, n, c = x.shape
    xn = gemm.rmsnorm_ref(_t(x).reshape(b * n, c), _t(gamma))
    qkv = gemm.gemm_nt_ref(xn, _t(wqkv.T), scaled_cols=heads * d,
                           col_scale=d ** -0.5)
    attn = _symmetric_core(qkv, b, heads, d, 'moments')
    got = gemm.gemm_nt_ref(attn, _t(wout.T)).reshape(b, n, c).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_doubling_is_exact_in_bf16():
    """2 phi_ij in bf16 is exact: bf16(2 phi) == 2 phi for phi = bf16(bf16(
    a b) bf16(1/sqrt2)) over random bf16 a, b, and rounding a doubled
    float32 moment equals doubling the rounded one."""
    rng = np.random.default_rng(7)
    a, b = (torch.from_numpy(rng.normal(size=1 << 16).astype(np.float32)
                             * 4).to(torch.bfloat16) for _ in range(2))
    inv_sqrt2 = torch.tensor(ta.INV_SQRT2, dtype=torch.bfloat16)
    phi = a * b * inv_sqrt2
    assert torch.equal((2 * phi).float(), 2 * phi.float())
    assert torch.equal((phi.float() * 2).to(torch.bfloat16), 2 * phi)
    m = torch.from_numpy(rng.normal(size=1 << 16).astype(np.float32) * 100)
    assert torch.equal((2 * m).to(torch.bfloat16),
                       2 * m.to(torch.bfloat16))
