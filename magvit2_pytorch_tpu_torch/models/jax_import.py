"""Weights between the JAX package and the port, and from reference
checkpoints.

``state_dict_from_jax_params`` takes the JAX params pytree (numpy arrays,
no JAX needed) and returns a ``state_dict`` with which the port computes
what the JAX package computes; ``jax_params_from_state_dict`` is its exact
inverse, the JAX pytree (numpy float32 leaves) with which the JAX package
computes what the port computes. Both read one table,
``bridge_entries(config)``: each entry a port key, the path of the JAX leaf
and the layout transform between them. The table inverts the JAX package's
``load_torch_tokenizer_state_dict`` (``magvit2_pytorch_tpu/models/
torch_import.py:229``) in every key and layout, with one difference: the
decoder's upsamplers. The JAX package's ``SpatialUpsample2x`` /
``TimeUpsample2x`` apply sub-pixel position p with the kernel columns of
position 1 - p (per axis; the bias is not flipped), where the port and the
reference apply those of p. So the bridge flips those kernels over p both
ways, and ``load_torch_tokenizer_state_dict`` does not flip them back. For
upsampler kernels that are equal across p, as both packages initialise
them, the flip changes nothing; for trained ones it is what makes both
packages decode alike.

The port keeps the reference's keys and layouts, so the JAX package also
imports ``port.state_dict()`` through ``load_torch_tokenizer_state_dict`` as
it is (and, with trained upsamplers, decodes those sub-pixels as the JAX
package does, mirrored).

Layout transforms (JAX channels-last -> PyTorch):
- Conv3d kernel (kt, kh, kw, i, o) -> (o, i, kt, kh, kw)
- Conv2d kernel (kh, kw, i, o) -> (o, i, kh, kw)
- per-frame Conv2d as 3D (1, kh, kw, i, o) -> (o, i, kh, kw)
- per-pixel Conv1d as 3D (kt, 1, 1, i, o) -> (o, i, kt)
- Dense / 1x1 conv kernel (i, o) -> (o, i)
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import numpy as np
import torch

from magvit2_pytorch_tpu_torch.models.layerspec import parse_layers

# state_dict entries of the reference that are buffers, not parameters
# (LFQ mask/codebook, FSQ levels/basis, the model's ``zero``); the port
# computes them from the config
GENERATOR_BUFFER_KEYS = ('quantizers.mask', 'quantizers.codebook',
                         'quantizers._levels', 'quantizers._basis', 'zero')
NON_GENERATOR_PREFIXES = ('discr.', 'vgg.', 'multiscale_discrs.')


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order='C'))


def p_flipped(kernel, positions: int):
    """A JAX upsampler's 1x1 kernel ``(i, c * 2**positions)``, in
    ``(c, p1[, p2])`` column order, with every position axis reversed (its
    own inverse)."""
    k = np.asarray(kernel)
    c_in, total = k.shape
    k = k.reshape(c_in, total // 2 ** positions, *(2,) * positions)
    k = k[(slice(None), slice(None)) + (slice(None, None, -1),) * positions]
    return k.reshape(c_in, total)


# transform name -> (JAX leaf -> port layout, port tensor -> JAX layout), on
# numpy arrays
TRANSFORMS = {
    'copy': (lambda a: a, lambda a: a),
    'dense': (lambda k: k.T, lambda w: w.T),
    'conv3d': (lambda k: k.transpose(4, 3, 0, 1, 2),
               lambda w: w.transpose(2, 3, 4, 1, 0)),
    'conv2d': (lambda k: k.transpose(3, 2, 0, 1),
               lambda w: w.transpose(2, 3, 1, 0)),
    'conv2d_from3d': (lambda k: k[0].transpose(3, 2, 0, 1),
                      lambda w: w.transpose(2, 3, 1, 0)[None]),
    'conv1d_from3d': (lambda k: k[:, 0, 0].transpose(2, 1, 0),
                      lambda w: w.transpose(2, 1, 0)[:, None, None]),
    'upsample_space': (lambda k: p_flipped(k, 2).T,
                       lambda w: p_flipped(w.T, 2)),
    'upsample_time': (lambda k: p_flipped(k, 1).T,
                      lambda w: p_flipped(w.T, 1)),
}

Entry = Tuple[str, Tuple[str, ...], str]


def _linear(p: str, j: tuple, kernel: str = 'dense') -> List[Entry]:
    return [(f'{p}.weight', j + ('kernel',), kernel),
            (f'{p}.bias', j + ('bias',), 'copy')]


def _residual_unit_entries(p: str, j: tuple) -> List[Entry]:
    f = j + ('fn',)
    return [*_linear(f'{p}.fn.0.conv', f + ('conv',), 'conv3d'),
            *_linear(f'{p}.fn.2', f + ('conv_pointwise',)),
            *_linear(f'{p}.fn.4.to_k', f + ('se', 'to_k')),
            *_linear(f'{p}.fn.4.net.0', f + ('se', 'gate_in')),
            *_linear(f'{p}.fn.4.net.2', f + ('se', 'gate_out'))]


def _attention_entries(p: str, j: tuple) -> List[Entry]:
    return [(f'{p}.norm.gamma', j + ('norm', 'gamma'), 'copy'),
            (f'{p}.to_qkv.0.weight', j + ('to_qkv', 'kernel'), 'dense'),
            (f'{p}.mem_kv', j + ('mem_kv',), 'copy'),
            (f'{p}.to_out.1.weight', j + ('to_out', 'kernel'), 'dense')]


def _linear_attention_entries(p: str, j: tuple) -> List[Entry]:
    return [(f'{p}.norm.gamma', j + ('norm', 'gamma'), 'copy'),
            (f'{p}.attn.to_qkv.0.weight', j + ('attn', 'to_qkv_kernel'),
             'dense'),
            (f'{p}.attn.to_out.1.weight', j + ('attn', 'to_out_kernel'),
             'dense')]


def _feedforward_entries(p: str, j: tuple) -> List[Entry]:
    return [(f'{p}.norm.gamma', j + ('norm', 'gamma'), 'copy'),
            *_linear(f'{p}.net.0', j + ('proj_in',)),
            *_linear(f'{p}.net.2', j + ('proj_out',))]


def _layer_entries(layer_type, params, p: str, j: tuple,
                   encoder: bool) -> List[Entry]:
    if layer_type == 'residual':
        return _residual_unit_entries(p, j)
    if layer_type == 'consecutive_residual':
        (num,) = params
        return [e for i in range(num)
                for e in _residual_unit_entries(f'{p}.{i}', j + (f'fns_{i}',))]
    if layer_type in ('compress_space', 'compress_time'):
        if encoder:
            kind = ('conv2d_from3d' if layer_type == 'compress_space'
                    else 'conv1d_from3d')
            return _linear(f'{p}.conv', j, kind)
        kind = ('upsample_space' if layer_type == 'compress_space'
                else 'upsample_time')
        return _linear(f'{p}.net.0', j, kind)
    if layer_type == 'attend_space':
        return [*_attention_entries(f'{p}.0.fn', j + ('fns_0', 'fn')),
                *_feedforward_entries(f'{p}.1.fn', j + ('fns_1', 'fn'))]
    if layer_type == 'attend_time':
        return [*_attention_entries(f'{p}.0.fn.fn',
                                    j + ('fns_0', 'fn', 'fn')),
                *_feedforward_entries(f'{p}.1.fn.fn',
                                      j + ('fns_1', 'fn', 'fn'))]
    if layer_type == 'linear_attend_space':
        return [*_linear_attention_entries(f'{p}.0.fn', j + ('fns_0', 'fn')),
                *_feedforward_entries(f'{p}.1.fn', j + ('fns_1', 'fn'))]
    raise NotImplementedError(
        f'layer type {layer_type!r} is not ported to PyTorch yet: '
        'ROADMAP.md queue A item 9')


def _quantizer_dims(config) -> int:
    if config.use_fsq:
        return len(config.fsq_levels) * config.num_codebooks
    return int(math.log2(config.codebook_size)) * config.num_codebooks


def bridge_entries(config) -> List[Entry]:
    """Every generator weight of ``config`` (either package's
    ``TokenizerConfig``): (port key, path in the JAX params, transform)."""
    parsed = parse_layers(config.layers, init_dim=config.init_dim,
                          image_size=config.image_size,
                          max_dim=config.max_dim, dim_cond=config.dim_cond)
    n = len(parsed.specs)
    out = [*_linear('conv_in.conv', ('conv_in',), 'conv3d'),
           *_linear('conv_out.conv', ('conv_out',), 'conv3d')]
    if config.separate_first_frame_encoding:
        out += [*_linear('conv_in_first_frame', ('conv_in_first_frame',),
                         'conv2d'),
                *_linear('conv_out_first_frame', ('conv_out_first_frame',),
                         'conv2d')]
    for spec in parsed.specs:
        i = spec.index
        out += _layer_entries(spec.layer_type, spec.params,
                              f'encoder_layers.{i}', (f'encoder_{i}',), True)
        # the decoder is stored reversed: spec i at index n - 1 - i
        out += _layer_entries(spec.layer_type, spec.params,
                              f'decoder_layers.{n - 1 - i}', (f'decoder_{i}',),
                              False)
    out += [(f'encoder_layers.{n}.1.weight', ('final_norm', 'gamma'), 'copy'),
            (f'encoder_layers.{n}.1.bias', ('final_norm', 'beta'), 'copy')]
    if parsed.final_dim != _quantizer_dims(config):
        out += [*_linear('quantizers.project_in',
                         ('quantizers', 'project_in')),
                *_linear('quantizers.project_out',
                         ('quantizers', 'project_out'))]
    return out


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _apply(out: dict, entries: List[Entry], tree):
    for key, path, kind in entries:
        out[key] = _t(TRANSFORMS[kind][0](np.asarray(_get(tree, path))))


def state_dict_from_jax_params(config, params: Mapping) -> dict:
    """JAX ``TokenizerModule`` params (numpy leaves) -> the port's
    ``state_dict`` for ``config`` (either package's ``TokenizerConfig``),
    with the decoder's upsampler kernels flipped over p (module docstring)."""
    out = {}
    _apply(out, bridge_entries(config), params)
    return out


def jax_params_from_state_dict(config, state: Mapping) -> dict:
    """The port's ``state_dict`` (tensors of any device and dtype) -> the
    JAX package's params pytree for ``config``, numpy float32 leaves; the
    exact inverse of ``state_dict_from_jax_params``."""
    out = {}
    for key, path, kind in bridge_entries(config):
        t = state[key]
        a = (t.detach().float().cpu().numpy() if torch.is_tensor(t)
             else np.asarray(t, np.float32))
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(TRANSFORMS[kind][1](a),
                                              dtype=np.float32)
    return out


def reference_state_dict(module: torch.nn.Module, state: Mapping) -> dict:
    """A reference ``VideoTokenizer.state_dict()`` (tensors or numpy) made
    ready for ``module.load_state_dict(..., strict=True)``: buffers and
    discriminator / VGG keys dropped, and tensors that differ from the port's
    parameter only by singleton dims (1x1 conv kernels, channel-first
    gammas) reshaped to it."""
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
