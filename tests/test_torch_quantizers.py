"""The port's quantizers (``ops/quantizers.py``) against the JAX package's on
the CPU and against the committed oracle fixtures.

LFQ in eval and ``train=True`` (quantized output, indices, aux loss and its
breakdown, the straight-through gradient) with no projection, projection +
clamp, spherical and multi-codebook; the full, factorized and chunked exact
entropy; FSQ with and without projection and with several codebooks. The
same numpy-seeded inputs and params go through both packages, on a dyadic
grid (multiples of 1/8 and 1/64) so that the projections sum exactly in
any order and both packages quantize the same values. Tolerance: 1e-5
relative in float32 (values against the largest value of the JAX output,
scalar losses against themselves), indices exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops import quantizers as jquant
from magvit2_pytorch_tpu_torch.ops import quantizers

torch.set_num_threads(1)
DATA = Path(__file__).parent / 'fixtures' / 'data'
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    """``got`` within ``rtol`` of the largest |want| (all of an array)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f'relative error {err:.3e} > {rtol:g}'


def _dyadic(a, step):
    return (np.round(np.asarray(a) / step) * step).astype(np.float32)


def _inputs(rng, shape, scale=2.0):
    return _dyadic(scale * rng.normal(size=shape), 1 / 8)


def _params(jmod, x, seed):
    """The JAX module's params, every leaf a seeded normal on the grid."""
    p = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: _dyadic(0.3 * rng.normal(size=np.shape(a)), 1 / 64),
        jax.tree.map(np.asarray, p.get('params', {})))


def _apply(jmod, params, *args, **kwargs):
    """``jmod.apply`` under ``jax.jit`` (one compile, not one per op)."""
    return jax.jit(lambda *a: jmod.apply({'params': params}, *a, **kwargs))(
        *args)


def _load(port, params):
    """The JAX projections' params into the port module: kernel (i, o) ->
    weight (o, i)."""
    port.load_state_dict({
        f'{name}.{"weight" if leaf == "kernel" else leaf}': torch.from_numpy(
            np.ascontiguousarray(a.T if leaf == 'kernel' else a))
        for name, sub in params.items() for leaf, a in sub.items()},
        strict=True)
    return port


LFQ_CASES = {
    'noproj': dict(dim=8, codebook_size=256, soft_clamp_input_value=None),
    'proj_clamp': dict(dim=16, codebook_size=512),
    'spherical': dict(dim=8, codebook_size=256, spherical=True),
    'multicb': dict(dim=12, codebook_size=64, num_codebooks=2),
    'spherical_proj_multicb': dict(dim=10, codebook_size=16, num_codebooks=3,
                                   spherical=True),
}


def _lfq_pair(kwargs, x, seed=0, **extra):
    jmod = jquant.LFQ(**kwargs, **extra)
    params = _params(jmod, x, seed)
    port = quantizers.LFQ(**kwargs, **extra)
    return jmod, params, _load(port, params)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', list(LFQ_CASES))
def test_lfq_matches_jax(case, train):
    kwargs = LFQ_CASES[case]
    rng = np.random.default_rng(1)
    x = _inputs(rng, (2, 3, 4, 4, kwargs['dim']))
    g = rng.normal(size=x.shape).astype(np.float32)
    jmod, params, port = _lfq_pair(kwargs, x)
    want = _apply(jmod, params, jnp.asarray(x), train=train)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, train=train)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert got.indices.dtype == torch.int64
    _close(got.quantized.detach(), want.quantized)
    _close(got.aux_loss.detach(), want.aux_loss)
    for a, b in zip(got.breakdown, want.breakdown):
        _close(a.detach(), b)
    if train:
        assert float(want.aux_loss) != 0.0
        # the straight-through estimator and the aux losses' gradients
        (got.quantized * torch.from_numpy(g)).sum().add(
            got.aux_loss).backward()

        def loss(x):
            out = jmod.apply({'params': params}, x, train=True)
            return jnp.sum(out.quantized * g) + out.aux_loss
        _close(xt.grad, jax.jit(jax.grad(loss))(jnp.asarray(x)))
    codes = port.indices_to_codes(got.indices)
    _close(codes.detach(), _apply(jmod, params, want.indices,
                                  method=jquant.LFQ.indices_to_codes))
    _close(port.sign_values(torch.from_numpy(x)).detach(), _apply(
        jmod, params, jnp.asarray(x), method=jquant.LFQ.sign_values))


@pytest.mark.parametrize('mode', ['full', 'factorized', 'chunked'])
def test_lfq_entropy_modes_match_jax(mode):
    """The three entropy forms of ``train=True`` against the JAX package's,
    values and gradients, at a low inverse temperature (not one-hot)."""
    extra = dict(inv_temperature=1.0)
    if mode != 'full':
        extra['entropy_full_max_size'] = 1
    if mode == 'chunked':
        extra.update(exact_codebook_entropy=True, entropy_chunk_size=64)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
    kwargs = dict(dim=8, codebook_size=256)
    jmod, params, port = _lfq_pair(kwargs, x, **extra)
    want = _apply(jmod, params, jnp.asarray(x), train=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, train=True)
    for a, b in zip(got.breakdown, want.breakdown):
        _close(a.detach(), b)
    got.aux_loss.backward()
    _close(xt.grad, jax.jit(jax.grad(lambda v: jmod.apply(
        {'params': params}, v, train=True).aux_loss))(jnp.asarray(x)))


def test_chunked_codebook_entropy_matches_dense_exact():
    """The chunk-enumerated codebook entropy equals the dense full-softmax
    one (values and gradients) on a codebook small enough for both, as
    tests/test_quantizers.py holds the JAX package's; the per-sample
    entropy's closed form equals the dense one."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32))
    dense = quantizers.LFQ(8, 256, inv_temperature=1.0)
    chunked = quantizers.LFQ(8, 256, inv_temperature=1.0,
                             entropy_full_max_size=1,
                             exact_codebook_entropy=True,
                             entropy_chunk_size=64)
    grads = []
    for mod in (dense, chunked):
        xt = x.clone().requires_grad_(True)
        out = mod(xt, train=True)
        out.aux_loss.backward()
        grads.append((out.breakdown, xt.grad))
    (bd_d, g_d), (bd_c, g_c) = grads
    np.testing.assert_allclose(bd_c.codebook_entropy.item(),
                               bd_d.codebook_entropy.item(), rtol=RTOL)
    np.testing.assert_allclose(bd_c.per_sample_entropy.item(),
                               bd_d.per_sample_entropy.item(), rtol=RTOL)
    np.testing.assert_allclose(g_c.numpy(), g_d.numpy(), rtol=2e-4,
                               atol=1e-6)


def test_chunked_entropy_keeps_no_codebook_wide_tensor():
    """The chunks' backward keeps their inputs only: no tensor saved for
    the backward holds a chunk's ``(tokens, codebooks, chunk)`` values, so
    memory stays O(chunk) at any codebook size."""
    tokens, chunk = 2 * 4 * 4, 64
    x = torch.randn(2, 4, 4, 12, requires_grad=True)
    mod = quantizers.LFQ(12, 4096, entropy_full_max_size=1,
                         exact_codebook_entropy=True,
                         entropy_chunk_size=chunk)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = mod(x, train=True)
    out.aux_loss.backward()
    assert torch.isfinite(x.grad).all()
    assert max(sizes) < tokens * chunk, (max(sizes), tokens * chunk)


def _codebook_entropy_f64(z, inv_temperature):
    """The exact codebook entropy of z ``(N, d)`` in float64 numpy over the
    whole codebook at once."""
    a = 4.0 * inv_temperature * z.astype(np.float64)
    lp_pos, lp_neg = -np.logaddexp(0, -a), -np.logaddexp(0, a)
    d = z.shape[-1]
    bits = (np.arange(2 ** d)[:, None] >> np.arange(d - 1, -1, -1)) & 1
    m = np.exp(lp_pos @ bits.T + lp_neg @ (1 - bits).T).mean(0)
    return -np.sum(np.where(m > 1e-30, m * np.log(np.maximum(m, 1e-30)), 0))


JAX_CANCELLATION = 5e-5


def test_chunked_codebook_entropy_2e18_matches_jax():
    """2^18 codes at a few tokens: the chunked exact entropy runs (64
    chunks), is finite and differentiable, stays under its mixture bound,
    and matches a float64 evaluation; the other terms match the JAX
    package's. The JAX package's float32 codebook entropy reads 2.6e-5
    from the float64 one here: its ``base + bits @ diff`` cancels, the
    port's sum of one-signed terms does not (LFQ._chunked_codebook_entropy).
    So the port's is held to the JAX package's within ``JAX_CANCELLATION``,
    the cancellation measured here with margin; 1e-5 against the JAX package
    holds at inv_temperature 1 (test_lfq_entropy_modes_match_jax).
    """
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 2, 2, 2, 18)).astype(np.float32)
    kwargs = dict(dim=18, codebook_size=2 ** 18)
    jmod, params, port = _lfq_pair(kwargs, x, exact_codebook_entropy=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, train=True)
    want = _apply(jmod, params, jnp.asarray(x), train=True)
    h = out.breakdown.codebook_entropy.item()
    assert np.isfinite(h)
    assert h <= np.log(8) + out.breakdown.per_sample_entropy.item() + 1e-3
    _close(out.breakdown.per_sample_entropy.detach(),
           want.breakdown.per_sample_entropy)
    _close(out.breakdown.commitment.detach(), want.breakdown.commitment)
    _close(h, _codebook_entropy_f64(x.reshape(8, 18), 100.0))
    _close(h, want.breakdown.codebook_entropy, rtol=JAX_CANCELLATION)
    out.aux_loss.backward()
    assert torch.isfinite(xt.grad).all()
    assert out.indices.max() < 2 ** 18


def test_lfq_bit_order_is_msb_first_at_18_bits():
    """Index k's code has bit (17 - j) of k at position j, +1 for a set bit;
    the int64 indices round-trip through the codes."""
    lfq = quantizers.LFQ(18, 2 ** 18)
    k = torch.tensor([0, 1, 2 ** 17, 2 ** 18 - 1, 0b101 << 15])
    codes = lfq.indices_to_codes(k[:, None])[:, 0]
    bits = codes > 0
    for j in range(18):
        assert torch.equal(bits[:, j], ((k >> (17 - j)) & 1).bool())
    assert torch.equal(lfq(codes[:, None]).indices[:, 0], k)


FSQ_CASES = {
    'basic': dict(levels=(8, 5, 5, 5)),
    'proj': dict(levels=(7, 5, 5), dim=9),
    'multicb': dict(levels=(5, 3), num_codebooks=2),
    'proj_multicb': dict(levels=(8, 6, 5), dim=16, num_codebooks=2),
}


@pytest.mark.parametrize('case', list(FSQ_CASES))
def test_fsq_matches_jax(case):
    kwargs = FSQ_CASES[case]
    jmod = jquant.FSQ(**kwargs)
    dim = kwargs.get('dim', len(kwargs['levels'])
                     * kwargs.get('num_codebooks', 1))
    rng = np.random.default_rng(3)
    x = _inputs(rng, (2, 3, 4, 4, dim))
    params = _params(jmod, x, 4)
    port = _load(quantizers.FSQ(**kwargs), params)
    assert port.codebook_size == jmod.codebook_size
    # eager: under jax.jit, XLA contracts the JAX FSQ's (q / w) * w + w to
    # a fused multiply-add that lands below the integer it should give, and
    # the int32 cast then drops a digit at half widths w that are not powers
    # of two (ROADMAP.md queue C); eager JAX and the reference give the
    # exact digits, as the port does
    want = jmod.apply({'params': params}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    _close(got.quantized.detach(), want.quantized)
    assert float(got.aux_loss) == 0.0
    _close(port.bounded_values(torch.from_numpy(x)).detach(), _apply(
        jmod, params, jnp.asarray(x), method=jquant.FSQ.bounded_values))
    _close(port.indices_to_codes(got.indices).detach(), _apply(
        jmod, params, want.indices, method=jquant.FSQ.indices_to_codes))
    # the straight-through round passes the bound's gradient
    got.quantized.sum().backward()
    _close(xt.grad, jax.jit(jax.grad(lambda v: jnp.sum(jmod.apply(
        {'params': params}, v).quantized)))(jnp.asarray(x)))


def _fixture(name):
    f = np.load(DATA / f'{name}.npz')
    out = {k: f[k] for k in f.files}
    meta = json.loads(bytes(out.pop('meta')).decode())
    state = {k[3:]: torch.from_numpy(out.pop(k))
             for k in list(out) if k.startswith('sd.')}
    return meta, state, out


def _cl(x):
    return torch.from_numpy(np.moveaxis(x, 1, -1))


@pytest.mark.parametrize('name', ['lfq_noproj', 'lfq_noproj_eval',
                                  'lfq_proj_clamp', 'lfq_spherical',
                                  'lfq_multicb'])
def test_lfq_fixture(name):
    """The oracle of tests/fixtures (its tolerances,
    tests/test_torch_parity.py:54-94)."""
    meta, state, arr = _fixture(name)
    lfq = quantizers.LFQ(meta['dim'], meta['codebook_size'],
                         num_codebooks=meta['num_codebooks'],
                         soft_clamp_input_value=meta['soft_clamp'],
                         spherical=meta['spherical'])
    lfq.load_state_dict(state, strict=True)
    out = lfq(_cl(arr['x']), train=meta['train'])
    np.testing.assert_array_equal(out.indices.numpy(), arr['indices'])
    np.testing.assert_allclose(out.quantized.detach().numpy(),
                               _cl(arr['quantized']).numpy(), atol=1e-5)
    if meta['train']:
        for got, key, atol in (
                (out.aux_loss, 'aux', 1e-4),
                (out.breakdown.per_sample_entropy, 'per_sample_entropy',
                 1e-4),
                (out.breakdown.codebook_entropy, 'batch_entropy', 1e-4),
                (out.breakdown.commitment, 'commitment', 1e-5)):
            np.testing.assert_allclose(got.item(), arr[key], rtol=2e-4,
                                       atol=atol)
    else:
        assert float(out.aux_loss) == 0.0
    np.testing.assert_allclose(
        lfq.indices_to_codes(torch.from_numpy(arr['indices'])).detach(),
        _cl(arr['decoded']).numpy(), atol=1e-5)


@pytest.mark.parametrize('name', ['fsq_basic', 'fsq_proj', 'fsq_multicb'])
def test_fsq_fixture(name):
    meta, state, arr = _fixture(name)
    fsq = quantizers.FSQ(meta['levels'], dim=meta['dim'],
                         num_codebooks=meta['num_codebooks'])
    fsq.load_state_dict(state, strict=True)
    out = fsq(_cl(arr['x']))
    np.testing.assert_array_equal(out.indices.numpy(), arr['indices'])
    np.testing.assert_allclose(out.quantized.detach().numpy(),
                               _cl(arr['quantized']).numpy(), atol=1e-5)
    np.testing.assert_allclose(
        fsq.indices_to_codes(torch.from_numpy(arr['indices'])).detach(),
        _cl(arr['decoded']).numpy(), atol=1e-5)
