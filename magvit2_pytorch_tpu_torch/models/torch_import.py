"""The reference's own checkpoints: its ``VideoTokenizer.state_dict()`` and
its ``.pt`` package (the generator half of the JAX package's
``magvit2_pytorch_tpu/models/torch_import.py``).

The port's modules carry the reference's names (``conv_in.conv``,
``encoder_layers.{i}``, the decoder reversed as the reference's
``insert(0)`` builds it, ``encoder_cond_in.0``, ``quantizers.*``; the
conditioned layers' ``to_cond``, ``conv.weights``, ``conv_out`` and
``norm.to_gamma``; GateLoop's ``fn.fn.to_qkva`` / ``to_out``) and its
layouts, so the name map of the JAX package's
``load_torch_tokenizer_state_dict`` (``torch_import.py:229-318``) is the
identity here, up to singleton dims: the reference's 1x1 convs are the
port's ``Linear`` weights and its channel-first gammas ``(C, 1, 1)`` the
port's ``(C,)``. What it skips is the JAX package's too: buffers (LFQ mask
and codebook, FSQ levels and basis, ``zero``) and the discriminator and VGG
keys.

A reference trainer package (its ``VideoTokenizerTrainer.save``,
trainer.py:291-310) also holds the discriminators' weights and every
optimizer's ``state_dict``: ``load_torch_discr_state_dict``,
``load_torch_multiscale_discr_state_dict`` and the ``*_adam_moments``
functions read them (the JAX package's ``torch_import.py:319-507``). A
moment has its parameter's shape, so it takes its parameter's name and
reshape.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

# state_dict entries of the reference that are buffers, not parameters
# (LFQ mask/codebook, FSQ levels/basis, the model's ``zero``); the port
# computes them from the config
GENERATOR_BUFFER_KEYS = ('quantizers.mask', 'quantizers.codebook',
                         'quantizers._levels', 'quantizers._basis', 'zero')
NON_GENERATOR_PREFIXES = ('discr.', 'vgg.', 'multiscale_discrs.')


def _fitted(own: Mapping, state: Mapping) -> dict:
    """``state`` as tensors, each that differs from ``own``'s tensor of its
    name only by singleton dims (1x1 conv kernels, channel-first gammas)
    reshaped to it. A key ``own`` lacks stays as it is."""
    out = {}
    for key, value in state.items():
        t = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value)
                            else value)
        if key in own and t.shape != own[key].shape:
            squeeze = lambda s: tuple(d for d in s if d != 1)
            if squeeze(t.shape) != squeeze(own[key].shape):
                raise ValueError(f'{key}: reference shape {tuple(t.shape)} '
                                 f'does not fit {tuple(own[key].shape)}')
            t = t.reshape(own[key].shape)
        out[key] = t
    return out


def reference_state_dict(module: torch.nn.Module, state: Mapping) -> dict:
    """A reference ``VideoTokenizer.state_dict()`` (tensors or numpy) made
    ready for ``module.load_state_dict``: buffers and discriminator / VGG
    keys dropped, and tensors that differ from the port's parameter only by
    singleton dims (1x1 conv kernels, channel-first gammas) reshaped to
    it. A key the module lacks stays as it is."""
    return _fitted(module.state_dict(), {
        k: v for k, v in state.items()
        if k not in GENERATOR_BUFFER_KEYS
        and not k.startswith(NON_GENERATOR_PREFIXES)})


def _load_strict(module: torch.nn.Module, state: Mapping, what: str):
    """Load ``state`` (already fitted) into ``module``: every key of the
    module present, no other; nothing is loaded when one is off."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing:
        raise KeyError(f'missing torch {what} keys: {missing[:8]}')
    if unknown:
        raise ValueError(f'unconverted torch {what} keys: {unknown[:8]}')
    module.load_state_dict({k: state[k] for k in own}, strict=True)


def load_torch_tokenizer_state_dict(module: torch.nn.Module, state: Mapping,
                                    strict: bool = True):
    """Load a reference ``VideoTokenizer.state_dict()`` into ``module`` (a
    ``TokenizerModule``) in its device and dtype. Every weight of the module
    must be in ``state``; ``strict=True`` also refuses a generator key the
    module does not have, as the JAX package's importer does."""
    state = reference_state_dict(module, state)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unknown = sorted(set(state) - set(own))
    if missing:
        raise KeyError(f'missing torch keys: {missing[:8]}')
    if strict and unknown:
        raise ValueError(f'unconverted torch keys: {unknown[:8]}')
    module.load_state_dict({k: state[k] for k in own}, strict=True)


def read_torch_state(state_or_path) -> Mapping:
    """A ``state_dict`` mapping as it is; a path: an ``.npz`` of its keys,
    or a ``.pth`` / ``.pt`` file holding the mapping bare or under
    ``model_state_dict`` (the reference's ``save``,
    magvit2_pytorch.py:1495-1505) or ``model`` (a trainer's)."""
    if not isinstance(state_or_path, (str, Path)):
        return state_or_path
    path = str(state_or_path)
    if path.endswith('.npz'):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    pkg = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(pkg, dict):
        return pkg.get('model_state_dict', pkg.get('model', pkg))
    return pkg


def torch_config_to_kwargs(raw: Mapping) -> dict:
    """The reference's pickled constructor locals (a ``.pt`` package's
    ``config``, magvit2_pytorch.py:1095-1100, 1447-1458) ->
    ``TokenizerConfig`` kwargs, as the JAX package's
    ``torch_config_to_kwargs`` (``torch_import.py:508``) reads them:

    - ``lfq_activation``: only the default ``nn.Identity`` is taken; any
      other raises;
    - ``vgg`` (an inlined module) is dropped with a warning, ``vgg_weights``
      (a torchvision enum) kept by its ``.name``;
    - ``multiscale_discrs`` (constructed modules) become ``()``, with a
      warning when there were any;
    - an unknown key is dropped with a warning (the weight import after it
      is strict, so a real mismatch still fails)."""
    from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
        TokenizerConfig)
    known = {f.name for f in dataclasses.fields(TokenizerConfig)}
    out = {}
    for key, val in dict(raw).items():
        if key == 'lfq_activation':
            if val is not None and type(val).__name__ != 'Identity':
                raise ValueError(
                    f'unsupported lfq_activation {type(val).__name__!r}: '
                    'only the default nn.Identity is supported')
        elif key == 'vgg':
            if val is not None:
                warnings.warn('dropping the inlined vgg module of the torch '
                              'config')
        elif key == 'vgg_weights':
            out[key] = getattr(val, 'name', None) if val is not None else None
        elif key == 'multiscale_discrs':
            if val:
                warnings.warn('dropping the constructed multiscale_discrs of '
                              'the torch config (discriminator weights are '
                              'not imported)')
            out[key] = tuple()
        elif key == 'layers':
            out[key] = tuple(tuple(l) if isinstance(l, (list, tuple)) else l
                             for l in val)
        elif key == 'fsq_levels':
            out[key] = tuple(val) if val is not None else None
        elif key not in known:
            warnings.warn(f'dropping unknown torch config key {key!r}')
        else:
            out[key] = val
    return out


# -- a reference trainer package: discriminators and optimizer moments -------

# explicit module order of the reference's ``parameters()`` override
# (magvit2_pytorch.py:1460-1471), not registration order
_PARAMETERS_MODULE_ORDER = (
    'conv_in', 'conv_in_first_frame', 'conv_out_first_frame', 'conv_out',
    'encoder_layers', 'decoder_layers', 'encoder_cond_in', 'decoder_cond_in',
    'quantizers')
BLUR_BUFFER = 'maybe_blur.f'


def generator_param_order(state: Mapping) -> list:
    """The generator's parameter keys in the order the reference's
    ``parameters()`` yields them: its explicit module list, each module in
    registration (= ``state_dict``) order; buffers excluded."""
    by_module = {}
    for k in state:
        if k not in GENERATOR_BUFFER_KEYS:
            by_module.setdefault(k.split('.', 1)[0], []).append(k)
    return [k for mod in _PARAMETERS_MODULE_ORDER
            for k in by_module.get(mod, [])]


def discr_param_order(state: Mapping, prefix: str = 'discr.') -> list:
    """A discriminator's parameter keys (with ``prefix``) in its
    ``parameters()`` order (registration order); Blur's ``f`` buffers
    excluded."""
    return [k for k in state
            if k.startswith(prefix) and not k.endswith(BLUR_BUFFER)]


def _moment_state_dicts(model_state: Mapping, opt_state: Mapping, order):
    """A torch ``Adam`` / ``AdamW`` ``state_dict()`` over the parameters
    ``order`` names -> ``(exp_avg, exp_avg_sq, count)``: two dicts by those
    names (zeros for a parameter never stepped) and the largest step.

    Torch keys its state by position in the concatenated param groups. The
    reference's ``get_optimizer`` (optimizer.py:12-42) makes one group
    (``wd == 0``, the parameters in ``order``) or two (the
    ``separate_weight_decayable_params`` split: ndim >= 2 first)."""
    groups = opt_state['param_groups']
    if len(groups) == 1:
        seq = list(order)
    else:
        assert len(groups) == 2, f'unexpected param_groups: {len(groups)}'
        ndim = {k: np.ndim(model_state[k]) for k in order}
        seq = ([k for k in order if ndim[k] >= 2]
               + [k for k in order if ndim[k] < 2])
    idxs = [i for g in groups for i in g['params']]
    assert len(idxs) == len(seq), (
        f'optimizer holds {len(idxs)} params, state_dict implies {len(seq)}')
    name_of = dict(zip(idxs, seq))
    exp_avg = {k: torch.zeros(tuple(np.shape(model_state[k])))
               for k in order}
    exp_avg_sq = dict(exp_avg)
    count = 0
    for i, st in opt_state['state'].items():
        k = name_of[int(i)]
        exp_avg[k] = torch.as_tensor(st['exp_avg']).float()
        exp_avg_sq[k] = torch.as_tensor(st['exp_avg_sq']).float()
        count = max(count, int(st['step']))
    return exp_avg, exp_avg_sq, count


def _by_parameter(module: torch.nn.Module, state: Mapping) -> dict:
    """A fitted moment per parameter of ``module``, by its name."""
    fitted = _fitted(module.state_dict(), state)
    names = [n for n, _ in module.named_parameters()]
    missing = [n for n in names if n not in fitted]
    if missing:
        raise KeyError(f'no moment for {missing[:8]}')
    return {n: fitted[n] for n in names}


def generator_adam_moments(module: torch.nn.Module, model_state: Mapping,
                           opt_state: Mapping):
    """The generator optimizer's state (reference trainer.py:156) ->
    ``(mu, nu, count)``, ``mu`` and ``nu`` by the names of ``module``'s
    parameters (a ``TokenizerModule``)."""
    exp_avg, exp_avg_sq, count = _moment_state_dicts(
        model_state, opt_state, generator_param_order(model_state))
    return (_by_parameter(module, exp_avg),
            _by_parameter(module, exp_avg_sq), count)


def _discr_state(state: Mapping, prefix: str, into: str = '') -> dict:
    """The keys under ``prefix`` (Blur buffers dropped), renamed to
    ``into`` + the rest."""
    return {into + k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix) and not k.endswith(BLUR_BUFFER)}


def load_torch_discr_state_dict(discr: torch.nn.Module, state: Mapping,
                                prefix: str = 'discr.'):
    """Load the reference image ``Discriminator``'s weights (its keys under
    ``prefix``, magvit2_pytorch.py:549-675) into the port's
    ``Discriminator``, whose names are the reference's. Blur's ``f`` buffer
    is a constant here and is skipped. Strict: every weight present, no
    other key."""
    _load_strict(discr, _fitted(discr.state_dict(),
                                _discr_state(state, prefix)),
                 'discriminator')


def discr_adam_moments(discr: torch.nn.Module, model_state: Mapping,
                       opt_state: Mapping, prefix: str = 'discr.'):
    """The main discriminator's optimizer state (reference trainer.py:157)
    -> ``(mu, nu, count)`` by the port's parameter names."""
    exp_avg, exp_avg_sq, count = _moment_state_dicts(
        model_state, opt_state, discr_param_order(model_state, prefix))
    return (_by_parameter(discr, _discr_state(exp_avg, prefix)),
            _by_parameter(discr, _discr_state(exp_avg_sq, prefix)), count)


def multiscale_discr_indices(state: Mapping) -> list:
    """The scales ``i`` whose ``multiscale_discrs.{i}.`` keys the reference
    ``state_dict`` holds (a ``ModuleList``, magvit2_pytorch.py:1433)."""
    return sorted({int(k.split('.')[1]) for k in state
                   if k.startswith('multiscale_discrs.')})


def load_torch_multiscale_discr_state_dict(ms: torch.nn.Module,
                                           state: Mapping, index: int):
    """Load reference multiscale discriminator ``index`` into the port's
    ``MultiscaleDiscriminator`` ``ms``, whose image discriminator sits under
    ``discr``. The reference takes any user module here
    (magvit2_pytorch.py:1085, 1433): this reads the common case, its own
    ``Discriminator``, and raises ``KeyError`` / ``ValueError`` on anything
    else, loading nothing."""
    _load_strict(ms, _fitted(ms.state_dict(), _discr_state(
        state, f'multiscale_discrs.{index}.', 'discr.')),
        f'multiscale discriminator {index}')


def multiscale_discr_adam_moments(ms: torch.nn.Module, model_state: Mapping,
                                  opt_state: Mapping, index: int):
    """Multiscale optimizer ``index`` (one Adam a scale, saved as
    ``multiscale_discr_optimizer_{i}``, reference trainer.py:209-217,
    307-308) -> ``(mu, nu, count)`` by ``ms``'s parameter names."""
    prefix = f'multiscale_discrs.{index}.'
    exp_avg, exp_avg_sq, count = _moment_state_dicts(
        model_state, opt_state, discr_param_order(model_state, prefix))
    return (_by_parameter(ms, _discr_state(exp_avg, prefix, 'discr.')),
            _by_parameter(ms, _discr_state(exp_avg_sq, prefix, 'discr.')),
            count)
