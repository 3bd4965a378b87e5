"""The port's ``VideoTokenizerTrainer.load_torch_checkpoint`` against the
JAX package's, on a reference trainer ``.pt`` package this file writes
(the layout of ``tests/test_torch_trainer_import.py``, which needs the
reference's sources; reference trainer.py:291-310): the port's
reference-named weights with the reference's buffers, an ``ema_model.``
shadow scaled by 1.5, ``torch.optim.AdamW`` stepped twice on seeded
gradients in the reference's weight-decay groups (ndim >= 2 first), for the
generator, the discriminator and one multiscale discriminator, and
``step=17``.

Both packages import it; the weights, the EMA, the discriminators, the Adam
moments, the counts and the step agree leaf by leaf through the bridge's
table. The table's upsampler transform is taken without its flip over the
sub-pixel position: both importers read a reference kernel as it is
(ROADMAP.md C3), and the moments of these kernels, unlike their initial
weights, differ across the positions. Then the multiscale warnings, and one
port step after the import against one after the port's own ``load`` of
the same state. No JAX train step is compiled.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models.torch_import import (
    discr_param_order, generator_param_order)
from magvit2_pytorch_tpu.training.trainer import (
    VideoTokenizerTrainer as JaxTrainer)
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.data import cycle
from magvit2_pytorch_tpu_torch.models.jax_import import (
    bridge_entries, discr_bridge_entries, multiscale_bridge_entries,
    tree_from_state_dict)
from magvit2_pytorch_tpu_torch.models import torch_import as port_import
from magvit2_pytorch_tpu_torch.training import VideoTokenizerTrainer

torch.set_num_threads(1)
KW = dict(image_size=16, init_dim=8, codebook_size=64,
          layers=('residual', 'compress_space'), use_gan=True,
          perceptual_loss_weight=0.0,
          discr_kwargs=dict(dim=8, image_size=16, channels=3, max_dim=16),
          multiscale_discrs=(dict(dim=4, max_dim=16),))


class Clips:
    def __init__(self, n=8):
        self.items = np.random.default_rng(0).random(
            (n, 3, 16, 16, 3), np.float32)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _stepped_adamw(state, order, gen):
    """``torch.optim.AdamW`` over ``state[k]`` for k in ``order``, in the
    reference's two groups, stepped twice on seeded gradients."""
    params = {k: state[k].detach().clone().float().requires_grad_(True)
              for k in order}
    opt = torch.optim.AdamW(
        [{'params': [params[k] for k in order if params[k].ndim >= 2]},
         {'params': [params[k] for k in order if params[k].ndim < 2],
          'weight_decay': 0.0}], lr=1e-4, weight_decay=1e-2)
    for _ in range(2):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return opt.state_dict()


def _package(tok, scales=(0,), ms_prefix='multiscale_discrs'):
    """A reference trainer package of ``tok``'s weights."""
    model = dict(tok.module.state_dict())
    # the reference's generator buffers, which both importers skip
    model.update({'zero': torch.tensor(0.0),
                  'quantizers.mask': 2 ** torch.arange(5, -1, -1),
                  'quantizers.codebook': torch.ones(64, 6)})
    for k, v in tok.discr.state_dict().items():
        model[f'discr.{k}'] = v
    model['discr.blocks.0.0.maybe_blur.f'] = torch.tensor([1.0, 2.0, 1.0])
    for i in scales:
        for k, v in tok.multiscale_discrs[0].state_dict().items():
            model[f'{ms_prefix}.{i}.{k[len("discr."):]}'] = v
    gen = torch.Generator().manual_seed(1)
    pkg = dict(
        model=model,
        ema_model={'initted': torch.tensor(True), 'step': torch.tensor(2),
                   **{f'ema_model.{k}': (v * 1.5 if v.is_floating_point()
                                         else v) for k, v in model.items()}},
        optimizer=_stepped_adamw(model, generator_param_order(model), gen),
        discr_optimizer=_stepped_adamw(model, discr_param_order(model), gen),
        warmup={}, scheduler={}, discr_warmup={}, discr_scheduler={},
        step=17)
    for i in scales:
        pkg[f'multiscale_discr_optimizer_{i}'] = _stepped_adamw(
            model, discr_param_order(model, f'{ms_prefix}.{i}.'), gen)
    return pkg


def _unflipped(entries):
    return [(k, p, 'dense' if kind.startswith('upsample') else kind)
            for k, p, kind in entries]


def _port_trainer(seed, tmp_path, **kw):
    tok = VideoTokenizer(device='cpu', seed=seed, **KW)
    return VideoTokenizerTrainer(
        tok, batch_size=2, num_train_steps=100, warmup_steps=10,
        dataset=Clips(), valid_frac=0.0, discr_start_after_step=0,
        checkpoints_folder=str(tmp_path / 'ck'),
        results_folder=str(tmp_path / 'res'), **kw)


def _jax_trainer(tok, tmp_path):
    """The JAX trainer on ``tok``'s weights (no JAX init)."""
    as_jax = lambda tree: jax.tree.map(jnp.asarray, tree)
    jtok = JaxTokenizer(
        params=as_jax(tree_from_state_dict(bridge_entries(tok.config),
                                           tok.module.state_dict())),
        discr_params=as_jax(tree_from_state_dict(
            discr_bridge_entries(tok.discr), tok.discr.state_dict())),
        multiscale_params=[as_jax(tree_from_state_dict(
            multiscale_bridge_entries(m), m.state_dict()))
            for m in tok.multiscale_discrs], **KW)
    return JaxTrainer(jtok, batch_size=8, num_train_steps=100,
                      warmup_steps=10, dataset=Clips(), valid_frac=0.0,
                      checkpoints_folder=str(tmp_path / 'jck'),
                      results_folder=str(tmp_path / 'jres'))


def _adam_states(state):
    found = []

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            found.append(s)
        elif hasattr(s, '_fields'):
            for f in s._fields:
                walk(getattr(s, f))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for x in s.values():
                walk(x)
    walk(state)
    return found


def _leaves_equal(port_tree, jax_tree):
    """Every leaf of the port's tree (numpy) equal to the JAX tree's leaf
    at its path."""
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(port_tree):
        want = jax_tree
        for k in path:
            want = want[k.key] if hasattr(k, 'key') else want[k.idx]
        np.testing.assert_array_equal(
            leaf, np.asarray(want, np.float32),
            err_msg=jax.tree_util.keystr(path))
        n += 1
    return n


@pytest.fixture(scope='module')
def loaded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('train_import')
    source = VideoTokenizer(device='cpu', seed=0, **KW)
    pkg = _package(source)
    path = tmp / 'trainer.pt'
    torch.save(pkg, str(path))
    port = _port_trainer(1, tmp)
    jt = _jax_trainer(port.model, tmp)   # seed 1's weights, as the port's
    jt.load_torch_checkpoint(path)
    port.load_torch_checkpoint(path)
    return dict(port=port, jax=jt, pkg=pkg, path=path, tmp=tmp,
                source=source)


def test_weights_ema_and_step_match_jax(loaded):
    port, jt = loaded['port'], loaded['jax']
    entries = _unflipped(bridge_entries(port.model.config))
    n = _leaves_equal(tree_from_state_dict(entries, port.module.state_dict()),
                      jt.model.params)
    assert n == len(entries)
    _leaves_equal(tree_from_state_dict(entries, port.ema_module.state_dict()),
                  jt.ema_params)
    # the package's weights, and its shadow 1.5 times them
    src = loaded['source'].module.state_dict()
    for k, v in port.ema_module.state_dict().items():
        assert torch.equal(v, src[k] * 1.5), k
        assert torch.equal(port.module.state_dict()[k], src[k]), k
    # written back into the tokenizer
    for k, v in port.model.module.state_dict().items():
        assert torch.equal(v, src[k]), k
    assert port.step == jt.step == 17


def test_generator_moments_and_count_match_jax(loaded):
    port, jt = loaded['port'], loaded['jax']
    (adam,) = _adam_states(jt.opt_state)
    entries = _unflipped(bridge_entries(port.model.config))
    for mine, theirs in ((port.optimizer.mu, adam.mu),
                         (port.optimizer.nu, adam.nu)):
        _leaves_equal(tree_from_state_dict(entries, mine), theirs)
    assert port.optimizer.count == int(adam.count) == 2
    # the moments are the AdamW's (nu is positive where stepped)
    assert all(float(v.min()) > 0 for v in port.optimizer.nu.values())


def test_discriminators_match_jax(loaded):
    port, jt = loaded['port'], loaded['jax']
    d_entries = discr_bridge_entries(port.discr)
    m_entries = multiscale_bridge_entries(port.multiscale[0])
    _leaves_equal(tree_from_state_dict(d_entries, port.discr.state_dict()),
                  jt.model.discr_params)
    _leaves_equal(tree_from_state_dict(
        m_entries, port.multiscale[0].state_dict()),
        jt.model.multiscale_params[0])
    adams = _adam_states(jt.discr_opt_state)
    assert len(adams) == 2
    # multi_transform: each Adam state holds the whole tree, with empty
    # MaskedNodes where another optimizer's parameters are
    seen = 0
    for adam in adams:
        for opt, entries, pick in (
                (port.discr_optimizers[0], d_entries, lambda t: t['discr']),
                (port.discr_optimizers[1], m_entries,
                 lambda t: t['multiscale'][0])):
            if jax.tree.leaves(pick(adam.mu)):
                _leaves_equal(tree_from_state_dict(entries, opt.mu),
                              pick(adam.mu))
                _leaves_equal(tree_from_state_dict(entries, opt.nu),
                              pick(adam.nu))
                seen += 1
        assert int(adam.count) == 2
    assert seen == 2
    assert [o.count for o in port.discr_optimizers] == [2, 2]


def _warnings_of(load):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter('always')
        load()
    return sorted(str(w.message) for w in got
                  if 'multiscale' in str(w.message))


@pytest.mark.parametrize('case', ['absent', 'misfit', 'extra'])
def test_multiscale_warnings_match_jax(loaded, case, tmp_path):
    """A scale absent from the package, one that does not fit the configured
    scale, and more scales than the trainer has: the same warnings in both
    packages; a scale kept keeps its weights and gets zero moments."""
    source = loaded['source']
    if case == 'absent':
        pkg = _package(source, scales=())
    elif case == 'misfit':
        pkg = _package(source)
        key = next(k for k in pkg['model']
                   if k.startswith('multiscale_discrs.0.')
                   and k.endswith('net.0.weight'))
        pkg['model'][key] = torch.zeros(3, 3, 3, 3)
    else:
        pkg = _package(source, scales=(0, 1))
    path = tmp_path / 'trainer.pt'
    torch.save(pkg, str(path))
    port = _port_trainer(1, tmp_path)
    before = {k: v.clone() for k, v in port.multiscale[0].state_dict().items()}
    jt = _jax_trainer(port.model, tmp_path)
    want = _warnings_of(lambda: jt.load_torch_checkpoint(path))
    got = _warnings_of(lambda: port.load_torch_checkpoint(path))
    assert got == want and len(want) == 1
    kept = all(torch.equal(v, before[k])
               for k, v in port.multiscale[0].state_dict().items())
    assert kept == (case != 'extra')
    _leaves_equal(tree_from_state_dict(
        multiscale_bridge_entries(port.multiscale[0]),
        port.multiscale[0].state_dict()), jt.model.multiscale_params[0])
    if kept:
        assert all(float(v.abs().max()) == 0
                   for v in port.discr_optimizers[1].mu.values())


def test_a_step_after_the_import_equals_one_after_load(loaded):
    """The imported state saved by the port and loaded into another
    trainer: one step of each on the same batches, bit for bit."""
    a, tmp = loaded['port'], loaded['tmp']
    path = tmp / 'native.pt'
    a.save(path)
    b = _port_trainer(2, tmp / 'b')
    b.load(path)
    batches = [(Clips().items[i:i + 2],) for i in (0, 2, 4, 6)]
    metrics = [t.train_step(iter(batches)) for t in (a, b)]
    assert metrics[0] == metrics[1]
    for name in ('module', 'ema_module', 'discr'):
        for x, y in zip(getattr(a, name).state_dict().values(),
                        getattr(b, name).state_dict().values()):
            assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count == 3


def test_the_port_importer_refuses_a_misfit(loaded):
    port = loaded['port']
    state = dict(loaded['pkg']['model'])
    state['discr.to_logits.3.weight'] = torch.zeros(7, 7)
    with pytest.raises(ValueError, match='does not fit'):
        port_import.load_torch_discr_state_dict(port.discr, state)
    del state['discr.to_logits.3.weight']
    with pytest.raises(KeyError, match='missing'):
        port_import.load_torch_discr_state_dict(port.discr, state)
