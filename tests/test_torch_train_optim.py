"""The port's optimizer and EMA on the CPU against the JAX package's
(``training/optimizer.py`` on optax, ``training/ema.py``): the weight-decay
mask on the JAX shapes through the bridge's names, for every layer type;
AdamW and Adam steps with the warmup schedule, a scheduler, the global-norm
clip (no epsilon) and the non-finite skip (a skipped step changes nothing;
the 11th in a row is applied); and the EMA's decay ramp and cadence.

Gradients and parameters are numpy draws from a seed; parameters after
each step agree within 1e-6 of their largest value (float32, the same
arithmetic in another order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magvit2_pytorch_tpu.training.ema import (
    EMAConfig as JaxEMAConfig, ema_decay as jax_ema_decay,
    ema_update as jax_ema_update)
from magvit2_pytorch_tpu.training.optimizer import (
    get_optimizer as jax_get_optimizer, wd_mask as jax_wd_mask)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    bridge_entries, discr_bridge_entries, jax_params_from_state_dict,
    tree_from_state_dict)
from magvit2_pytorch_tpu_torch.training.ema import (
    EMAConfig, ema_decay, ema_update)
from magvit2_pytorch_tpu_torch.training.optimizer import (
    get_optimizer, wd_mask)

torch.set_num_threads(1)
ALL_LAYERS = dict(
    image_size=16, init_dim=8, codebook_size=64, dim_cond=4,
    layers=('residual', 'consecutive_residual', ('compress_space', 16),
            'cond_residual', 'linear_attend_space', 'cond_attend_space',
            ('compress_time', 16), 'attend_time', 'cond_linear_attend_space',
            'gateloop_time', 'cond_attend_time'),
    attn_heads=2, linear_attn_heads=4,
    discr_kwargs=dict(dim=4, image_size=16, channels=3, max_dim=16),
    perceptual_loss_weight=0.0)


def test_wd_mask_matches_jax_through_the_bridge():
    """Every generator and discriminator weight decays in the port exactly
    when the JAX package's ``wd_mask`` (ndim >= 2 on its shapes) says so."""
    kw = dict(ALL_LAYERS)
    kw['layers'] = tuple((l, 2) if l == 'consecutive_residual' else l
                         for l in kw['layers'])
    tok = VideoTokenizer(device='cpu', **kw)
    for module, entries, tree in (
            (tok.module, bridge_entries(tok.config),
             jax_params_from_state_dict(tok.config, tok.state_dict())),
            (tok.discr, discr_bridge_entries(tok.discr),
             tree_from_state_dict(discr_bridge_entries(tok.discr),
                                  tok.discr.state_dict()))):
        params = dict(module.named_parameters())
        mask = wd_mask(params, entries)
        jmask = jax_wd_mask(tree)
        for key, path, _ in entries:
            node = jmask
            for name in path:
                node = node[name]
            assert mask[key] == bool(node), (key, path)
        assert len(entries) == len(params)
        assert set(mask) == set(params)


SHAPES = {'w': (6, 5), 'b': (5,), 'k': (3, 3, 2, 4)}


def _run(steps, grads, **kw):
    """The port's and optax's parameters after each step."""
    rng = np.random.default_rng(0)
    init = {n: rng.normal(size=s).astype(np.float32)
            for n, s in SHAPES.items()}
    port = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    opt = get_optimizer(port, **kw)
    tx = jax_get_optimizer(**kw)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    state = tx.init(jp)
    out = []
    for g in grads[:steps]:
        opt.step({n: torch.from_numpy(a) for n, a in g.items()})
        updates, state = tx.update({n: jnp.asarray(a) for n, a in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        out.append(({n: t.numpy().copy() for n, t in port.items()},
                    {n: np.asarray(a) for n, a in jp.items()}))
    return out, opt


def _grads(n, rng, scale=1.0, bad=()):
    out = []
    for i in range(n):
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        if i in bad:
            g['b'][0] = np.nan if i % 2 else np.inf
        out.append(g)
    return out


def _close(a, b, rel=1e-6):
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=0,
                                   atol=rel * max(np.abs(b[n]).max(), 1e-30),
                                   equal_nan=True)


@pytest.mark.parametrize('kw', [
    dict(lr=1e-2, wd=1e-2, warmup_steps=3),
    dict(lr=1e-2, wd=0.0, warmup_steps=0),
    dict(lr=1e-2, wd=0.1, warmup_steps=2, max_grad_norm=1.0),
    dict(lr=1e-2, wd=1e-2, betas=(0.5, 0.9), eps=1e-6,
         scheduler=lambda count: 1e-2 / (1.0 + count)),
    dict(lr=1e-2, wd=1e-2, group_wd_params=False),
], ids=['adamw_warmup', 'adam', 'clip', 'scheduler', 'no_grouping'])
@pytest.mark.parametrize('steps', [1, 3])
def test_optimizer_steps_match_optax(kw, steps):
    rng = np.random.default_rng(1)
    grads = _grads(3, rng, scale=3.0)
    out, opt = _run(steps, grads, **kw)
    for port, want in out:
        _close(port, want)
    assert opt.count == steps


def test_nonfinite_steps_are_skipped_then_applied_after_ten():
    """A non-finite step changes nothing (parameters, moments, counts) and
    the next finite one continues; the 11th non-finite step in a row is
    applied, as optax's ``apply_if_finite(max_consecutive_errors=10)``."""
    rng = np.random.default_rng(2)
    grads = _grads(15, rng, bad=(1, *range(3, 14)))
    out, opt = _run(15, grads, lr=1e-2, wd=1e-2, warmup_steps=3,
                    max_grad_norm=1.0)
    for port, want in out:
        _close(port, want)
    for n in SHAPES:
        assert np.array_equal(out[0][0][n], out[1][0][n])   # step 1 skipped
        assert np.array_equal(out[12][0][n], out[2][0][n])  # 3-12 skipped
    assert np.isnan(out[13][0]['b']).any()                  # 14th: applied
    assert opt.total_notfinite == 12 and opt.notfinite_count == 0


def test_optimizer_state_round_trips():
    rng = np.random.default_rng(3)
    grads = _grads(3, rng)
    a = {n: torch.ones(s) for n, s in SHAPES.items()}
    b = {n: torch.ones(s) for n, s in SHAPES.items()}
    oa, ob = get_optimizer(a, lr=1e-2), get_optimizer(b, lr=1e-2)
    oa.step({n: torch.from_numpy(g) for n, g in grads[0].items()})
    ob.step({n: torch.from_numpy(g) for n, g in grads[0].items()})
    state = oa.state_dict()
    oc = get_optimizer({n: t.clone() for n, t in a.items()}, lr=1e-2)
    oc.load_state_dict(state)
    for o in (oa, oc):
        o.step({n: torch.from_numpy(g) for n, g in grads[1].items()})
    for n in SHAPES:
        assert torch.equal(oa.params[n], oc.params[n])


@pytest.mark.parametrize('step', [0, 5, 99, 100, 101, 102, 110, 111, 250,
                                  1000, 10 ** 6])
def test_ema_matches_jax(step):
    cfg = dict(beta=0.999, update_after_step=100, update_every=10)
    assert ema_decay(step, EMAConfig(**cfg)) == pytest.approx(
        float(jax_ema_decay(jnp.asarray(step), JaxEMAConfig(**cfg))),
        rel=0, abs=1e-7)
    rng = np.random.default_rng(step % 97)
    e, p = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    want = jax_ema_update({'x': jnp.asarray(e)}, {'x': jnp.asarray(p)},
                          step, JaxEMAConfig(**cfg))['x']
    et = torch.from_numpy(e.copy())
    version = et._version
    ema_update([et], [torch.from_numpy(p)], step, EMAConfig(**cfg))
    np.testing.assert_allclose(et.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if not np.array_equal(et.numpy(), e):
        assert et._version > version        # in place: the version moves
