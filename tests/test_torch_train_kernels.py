"""The backward of the port's kernels B1-B5 on the CPU, against ``jax.grad``
through the JAX package's Pallas wrappers in interpret mode (whose custom
VJPs differentiate their XLA twins), as tests/test_fused_attention.py,
tests/test_taylor_fused.py and tests/test_fused_residual*.py run them; and
the card's ``torch.autograd.Function`` plumbing (forward launch, backward
recompute through the twin, ``<name>_backward`` counts, a second-order
backward) driven on the CPU with the plain version standing in for the
launch.

Inputs, weights and upstream gradients are numpy draws from a seed. Every
gradient is held within 1e-4 of its largest value (float32, the same
function summed in another order); a gradient that is zero by its math (the
SqueezeExcite logit bias: the softmax does not see a shift) is held to
1e-4 of 1e-3 of the call's largest gradient instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.ops.pallas.axial_attention import (
    _time_block_xla, fused_attention_block, fused_time_attention_block)
from magvit2_pytorch_tpu.ops.pallas.residual_unit import (
    fused_residual_unit as jax_fused_packed)
from magvit2_pytorch_tpu.ops.pallas.residual_unit_wide import (
    fused_residual_unit_wide as jax_fused_wide)
from magvit2_pytorch_tpu.ops.pallas.taylor_attention import (
    _taylor_fused, _taylor_reference)
from magvit2_pytorch_tpu_torch.ops.kernels import (
    axial_attention as aa, launch_counts, reset_launch_counts,
    residual_unit as ru, taylor_attention as ta)

torch.set_num_threads(1)
REL = 1e-4


def assert_rel(got, want, rel=REL, floor=1e-30):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f'{err:.3g} > {rel} x {scale:.3g}'


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
            for a in arrays]


def _attn(rng, c=128, heads=4, dh=32):
    inner = heads * dh
    f = lambda a: a.astype(np.float32)
    return (f(1 + 0.1 * rng.normal(size=c)),
            f(rng.normal(size=(c, 3 * inner)) * 0.05),
            f(rng.normal(size=(2, heads, 4, dh))),
            f(rng.normal(size=(inner, c)) * 0.05))


def _port_attn(p):
    gamma, wqkv, mem_kv, wout = p
    return gamma, wqkv.T, mem_kv, wout.T


def _jax_grads(fn, args, ct):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * ct),
                    argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])


def _port_grads(fn, leaves, ct):
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, torch.from_numpy(ct))


def _check(port, jax_, layouts=None):
    floor = 1e-3 * max(np.abs(np.asarray(w)).max() for w in jax_)
    for i, (g, w) in enumerate(zip(port, jax_)):
        w = np.asarray(w)
        if layouts and layouts[i]:
            w = layouts[i](w)
        assert_rel(g, w, floor=floor)


ATTN_LAYOUT = [None, lambda w: w.T, None, lambda w: w.T]


@pytest.mark.parametrize('causal', [False, True])
def test_space_block_backward_matches_jax(causal):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 128)).astype(np.float32)
    p = _attn(rng)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(lambda *a: fused_attention_block(*a, 4, 32, causal,
                                                       True), (x, *p), ct)
    leaves = _leaves(x, *_port_attn(p))
    for fn in (aa.attention_block, aa.attention_block_ref):
        got = _port_grads(lambda *a: fn(*a, 4, 32, causal), leaves, ct)
        _check(got, want, [None] + ATTN_LAYOUT)


@pytest.mark.parametrize('causal', [True, False])
def test_time_block_backward_matches_jax(causal):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16, 128)).astype(np.float32)
    p = _attn(rng)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(lambda *a: fused_time_attention_block(
        *a, 4, 32, causal, True), (x, *p), ct)
    twin = _jax_grads(lambda *a: _time_block_xla(
        *a, heads=4, dim_head=32, causal=causal), (x, *p), ct)
    leaves = _leaves(x, *_port_attn(p))
    for fn in (aa.time_attention_block, aa.time_attention_block_twin):
        got = _port_grads(lambda *a: fn(*a, 4, 32, causal), leaves, ct)
        _check(got, want, [None] + ATTN_LAYOUT)
        _check(got, twin, [None] + ATTN_LAYOUT)


@pytest.mark.parametrize('apply_norm', [True, False], ids=['norm', 'no_norm'])
def test_taylor_block_backward_matches_jax(apply_norm):
    rng = np.random.default_rng(2)
    c, heads, d = 64, 8, 8
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * heads * d)) * 0.1).astype(np.float32)
    wout = (rng.normal(size=(heads * d, c)) * 0.1).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(lambda *a: _taylor_fused(
        *a, heads, d, 1e-5, d ** -0.5, True, apply_norm),
        (x, gamma, wqkv, wout), ct)
    if not apply_norm:      # the JAX _bwd zeroes the gamma it passed
        assert not np.asarray(want[1]).any()
        twin = _jax_grads(lambda x, wq, wo: _taylor_reference(
            x, wq, wo, heads, d, 1e-5, d ** -0.5), (x, wqkv, wout), ct)
        _check(twin, (want[0], want[2], want[3]))
    lx, lg, lq, lo = _leaves(x, gamma, wqkv.T, wout.T)
    args = (lx, lg, lq, lo) if apply_norm else (lx, lq, lo)
    layouts = [None, None, lambda w: w.T, lambda w: w.T]
    for fn in (ta.taylor_attention, ta.taylor_attention_twin):
        if apply_norm:
            got = _port_grads(lambda *a: fn(*a, heads, d), args, ct)
            _check(got, want, layouts)
        else:
            got = _port_grads(lambda x, q, o: fn(x, None, q, o, heads, d),
                              args, ct)
            _check(got, (want[0], want[2], want[3]),
                   [None, lambda w: w.T, lambda w: w.T])


def _ru_params(rng, c):
    hidden = max(16, c // 2)
    n = lambda shape, s, shift=0.0: (rng.normal(size=shape) * s
                                     + shift).astype(np.float32)
    return (n((3, 3, 3, c, c), 0.05), n((c,), 0.1), n((c, c), 0.09),
            n((c,), 0.1), n((c, 1), 0.3), n((1,), 0.1), n((c, hidden), 0.15),
            n((hidden,), 0.1), n((hidden, c), 0.15), n((c,), 0.1, 0.0))


def _ru_port(jp):
    conv_k, conv_b, pw_k, pw_b, tok_k, tok_b, gi_k, gi_b, go_k, go_b = jp
    return (conv_k.transpose(4, 3, 0, 1, 2), conv_b, pw_k.T, pw_b, tok_k.T,
            tok_b, gi_k.T, gi_b, go_k.T, go_b)


RU_LAYOUT = [None, lambda w: w.transpose(4, 3, 0, 1, 2), None,
             lambda w: w.T, None, lambda w: w.T, None, lambda w: w.T, None,
             lambda w: w.T, None]


def test_wide_unit_backward_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, 8, 8, 64)).astype(np.float32)
    jp = _ru_params(rng, 64)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(lambda *a: jax_fused_wide(*a, True), (x, *jp), ct)
    leaves = _leaves(x, *_ru_port(jp))
    got = _port_grads(ru.fused_residual_unit_wide, leaves, ct)
    _check(got, want, RU_LAYOUT)


@pytest.mark.parametrize('packed_io', [True, False], ids=['packed', 'unpacked'])
def test_packed_unit_backward_matches_jax(packed_io):
    rng = np.random.default_rng(4)
    b, t, h, w2, c = 1, 3, 8, 4, 64
    jp = _ru_params(rng, c)
    xb = rng.normal(size=(b, t, h, w2, 2 * c)).astype(np.float32)
    x = xb if packed_io else xb.reshape(b, t, h, 2 * w2, c)
    ct = rng.normal(size=x.shape).astype(np.float32)
    want = _jax_grads(lambda *a: jax_fused_packed(*a, True, packed_io),
                      (x, *jp), ct)
    leaves = _leaves(x, *_ru_port(jp))
    got = _port_grads(lambda *a: ru.fused_residual_unit(
        *a, packed_io=packed_io), leaves, ct)
    _check(got, want, RU_LAYOUT)


# -- the twins' bf16 cast points ------------------------------------------------

# In bf16 a gradient is held to JAX's by its mean error over its mean
# magnitude. dwout reads only the forward's rounded attention output, so it
# is held to 1e-4: the twin's forward must be JAX's to the bit (a twin that
# multiplies by d^-1/2 and 1/sqrt2 unrounded reads 1.4e-3). The average over
# the other gradients but dgamma is held to 3e-3, which the same functions
# in float32 math (inputs and upstream gradient rounded to bf16, the
# gradients rounded back) exceed in every case (3.9e-3 to 5.2e-3 on these
# draws, against 0.7e-3 to 2.7e-3 for the twins). dgamma is held to 2e-2:
# JAX sums it over the rows in bf16, 1.4% from the same function in float32
# math on the same bf16 inputs.
BF16_FORWARD_REL = 1e-4
BF16_REL = 3e-3
BF16_GAMMA_REL = 2e-2


class _F32Dots:
    """``jnp`` for ``_taylor_reference`` on the CPU, whose dot refuses bf16
    operands with a float32 result: such an einsum takes its operands to
    float32 first (exact products, float32 sums, as
    ``preferred_element_type`` asks); every cast point of the twin stays."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


def _rel_l1(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    return np.abs(got - want).mean() / np.abs(want).mean()


def _bf16_case(case, monkeypatch):
    """(JAX twin, port twin, JAX arrays, port layouts, gamma index) on the
    existing tests' shapes; the port twin takes its arrays in JAX order."""
    if case.startswith('time'):
        causal = case == 'time_causal'
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, 5, 16, 128)).astype(np.float32)
        jax_fn = lambda *a: _time_block_xla(*a, heads=4, dim_head=32,
                                            causal=causal)
        port_fn = lambda x, g, q, m, o: aa.time_attention_block_twin(
            x, g, q.T, m, o.T, 4, 32, causal)
        return jax_fn, port_fn, (x, *_attn(rng)), 1
    import magvit2_pytorch_tpu.ops.pallas.taylor_attention as jax_taylor
    monkeypatch.setattr(jax_taylor, 'jnp', _F32Dots())
    norm = case == 'taylor_norm'
    rng = np.random.default_rng(2)
    c, heads, d = 64, 8, 8
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * heads * d)) * 0.1).astype(np.float32)
    wout = (rng.normal(size=(heads * d, c)) * 0.1).astype(np.float32)
    if norm:
        jax_fn = lambda x, g, q, o: _taylor_reference(
            x, q, o, heads, d, 1e-5, d ** -0.5, gamma=g)
        port_fn = lambda x, g, q, o: ta.taylor_attention_twin(
            x, g, q.T, o.T, heads, d)
        return jax_fn, port_fn, (x, gamma, wqkv, wout), 1
    jax_fn = lambda x, q, o: _taylor_reference(x, q, o, heads, d, 1e-5,
                                               d ** -0.5)
    port_fn = lambda x, q, o: ta.taylor_attention_twin(x, None, q.T, o.T,
                                                       heads, d)
    return jax_fn, port_fn, (x, wqkv, wout), None


@pytest.mark.parametrize('case', ['time_causal', 'time', 'taylor_norm',
                                  'taylor_no_norm'])
def test_twin_bf16_gradients_match_jax(monkeypatch, case):
    """The twins that the card's B2 and B3 backward differentiate
    (``time_attention_block_twin``, ``taylor_attention_twin``) keep the cast
    points of ``_time_block_xla`` / ``_taylor_reference``: in bf16 dwout is
    JAX's within ``BF16_FORWARD_REL``, the other gradients within
    ``BF16_REL`` on average (dgamma within ``BF16_GAMMA_REL``), and the
    same functions in float32 math are not."""
    jax_fn, port_fn, arrays, gamma_at = _bf16_case(case, monkeypatch)
    ct = np.random.default_rng(7).normal(
        size=arrays[0].shape).astype(np.float32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    _, vjp = jax.vjp(jax_fn, *bf)
    want = vjp(jnp.asarray(ct, jnp.bfloat16))
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        leaves = [torch.from_numpy(a).to(torch.bfloat16).to(dt)
                  .requires_grad_(True) for a in arrays]
        up = torch.from_numpy(ct).to(torch.bfloat16).to(dt)
        grads = torch.autograd.grad(port_fn(*leaves), leaves, up)
        errs[dt] = [_rel_l1(g.to(torch.bfloat16), w)
                    for g, w in zip(grads, want)]
    twin, f32 = errs[torch.bfloat16], errs[torch.float32]
    assert twin[-1] <= BF16_FORWARD_REL, twin
    if gamma_at is not None:
        assert twin[gamma_at] <= BF16_GAMMA_REL, twin
        twin, f32 = (e[:gamma_at] + e[gamma_at + 1:] for e in (twin, f32))
    assert np.mean(twin[:-1]) <= BF16_REL, twin
    assert np.mean(f32) > BF16_REL, f32


# -- the card's autograd.Function, with the plain version as the launch --------


def _plain_launches(monkeypatch):
    monkeypatch.setattr(ta, '_block_launch',
                        lambda x, g, q, o, h, d, eps: ta.taylor_attention_ref(
                            x, g, q, o, h, d, eps))
    monkeypatch.setattr(ru, '_launch',
                        lambda x, params, name: ru.residual_unit_ref(
                            x, *params))


def _functions(rng):
    """(name, function on leaves, twin on leaves, leaves) for each block."""
    x3 = rng.normal(size=(2, 16, 128)).astype(np.float32)
    x4 = rng.normal(size=(2, 5, 8, 128)).astype(np.float32)
    p = _port_attn(_attn(rng))
    space = lambda *a: aa._Block.apply(*a, 4, 32, False, aa.attention_block_ref,
                                       aa.attention_block_ref,
                                       'space_attention_block')
    time = lambda *a: aa._Block.apply(
        *a, 4, 32, True, aa.time_attention_block_ref,
        aa.time_attention_block_twin, 'time_attention_block')
    xt = rng.normal(size=(2, 128, 64)).astype(np.float32)
    tp = (rng.uniform(0.5, 1.5, size=64).astype(np.float32),
          (rng.normal(size=(192, 64)) * 0.1).astype(np.float32),
          (rng.normal(size=(64, 64)) * 0.1).astype(np.float32))
    taylor = lambda *a: ta._TaylorBlock.apply(*a, 8, 8, 1e-5)
    xr = rng.normal(size=(1, 3, 8, 8, 64)).astype(np.float32)
    rp = _ru_port(_ru_params(rng, 64))
    unit = lambda *a: ru._Unit.apply('residual_unit_wide', *a)
    return [
        ('space_attention_block', space,
         lambda *a: aa.attention_block_ref(*a, 4, 32, False), (x3, *p)),
        ('time_attention_block', time,
         lambda *a: aa.time_attention_block_twin(*a, 4, 32, True), (x4, *p)),
        ('taylor_attention_block', taylor,
         lambda *a: ta.taylor_attention_twin(*a, 8, 8), (xt, *tp)),
        ('residual_unit_wide', unit, ru.residual_unit_ref, (xr, *rp)),
    ]


@pytest.mark.parametrize('which', range(4), ids=['B1', 'B2', 'B3', 'B4'])
def test_card_function_recomputes_through_the_twin(monkeypatch, which):
    """The Function's backward is ``autograd.grad`` of the twin on the saved
    inputs (bit for bit), counts one ``<name>_backward``, and supports a
    second backward (R1 through the discriminator's B3)."""
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(5 + which)
    name, fn, twin, arrays = _functions(rng)[which]
    leaves = _leaves(*arrays)
    ct = torch.from_numpy(rng.normal(size=arrays[0].shape).astype(np.float32))
    reset_launch_counts()
    got = torch.autograd.grad(fn(*leaves), leaves, ct)
    assert launch_counts()[f'{name}_backward'] == 1
    want = torch.autograd.grad(twin(*leaves), leaves, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # second order: d/dparams of ||d out / d x||^2
    (gx,) = torch.autograd.grad((fn(*leaves) * ct).sum(), leaves[0],
                                create_graph=True)
    got2 = torch.autograd.grad(gx.square().sum(), leaves[1:],
                               allow_unused=True)
    (tx,) = torch.autograd.grad((twin(*leaves) * ct).sum(), leaves[0],
                                create_graph=True)
    want2 = torch.autograd.grad(tx.square().sum(), leaves[1:],
                                allow_unused=True)
    for g, w in zip(got2, want2):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


def test_no_norm_function_returns_no_dgamma(monkeypatch):
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(9)
    x, q, o = _leaves(rng.normal(size=(1, 32, 64)).astype(np.float32),
                      (rng.normal(size=(192, 64)) * 0.1).astype(np.float32),
                      (rng.normal(size=(64, 64)) * 0.1).astype(np.float32))
    out = ta._TaylorBlock.apply(x, None, q, o, 8, 8, 1e-5)
    grads = torch.autograd.grad(out.sum(), (x, q, o))
    want = torch.autograd.grad(ta.taylor_attention_twin(
        x, None, q, o, 8, 8).sum(), (x, q, o))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_launches_inside_a_block_refuse_gradients():
    """A launch without a backward of its own (the GEMM, the RU's five)
    still refuses an input that needs a gradient on the card; the check
    runs before any CUDA call, so a tensor subclass that claims CUDA is
    enough to reach it."""
    class Fake(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.zeros(4, 8).as_subclass(Fake).requires_grad_(True)
    with pytest.raises(RuntimeError, match='no backward of its own'):
        from magvit2_pytorch_tpu_torch.ops.kernels import _build
        _build.check_cuda_inputs('gemm_nt', x, ())
