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
keys. The discriminator and optimizer-moment importers belong to training
(ROADMAP.md queue A items 11-12).
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


def reference_state_dict(module: torch.nn.Module, state: Mapping) -> dict:
    """A reference ``VideoTokenizer.state_dict()`` (tensors or numpy) made
    ready for ``module.load_state_dict``: buffers and discriminator / VGG
    keys dropped, and tensors that differ from the port's parameter only by
    singleton dims (1x1 conv kernels, channel-first gammas) reshaped to
    it. A key the module lacks stays as it is."""
    own = module.state_dict()
    out = {}
    for key, value in state.items():
        if key in GENERATOR_BUFFER_KEYS or key.startswith(
                NON_GENERATOR_PREFIXES):
            continue
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
