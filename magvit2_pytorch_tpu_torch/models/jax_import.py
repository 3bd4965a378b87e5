"""Weights between the JAX package and the port, and from reference
checkpoints.

``state_dict_from_jax_params`` takes the JAX params pytree (numpy arrays,
no JAX needed) and returns a ``state_dict`` with which the port computes
what the JAX package computes. It inverts the JAX package's
``load_torch_tokenizer_state_dict`` (``magvit2_pytorch_tpu/models/
torch_import.py:229``) in every key and layout, with one difference: the
decoder's upsamplers. The JAX package's ``SpatialUpsample2x`` /
``TimeUpsample2x`` apply sub-pixel position p with the kernel columns of
position 1 - p (per axis; the bias is not flipped), where the port and the
reference apply those of p. So the bridge flips those kernels over p, and
``load_torch_tokenizer_state_dict`` does not flip them back. For upsampler
kernels that are equal across p, as both packages initialise them, the
flip changes nothing and the round trip is exact; for trained ones it gives
the p-flipped kernels back.

The other direction needs no code here: the port keeps the reference's keys
and layouts, so the JAX package imports ``port.state_dict()`` through that
function as it is (and, with trained upsamplers, decodes those sub-pixels
as the JAX package does, mirrored).

Layout transforms (JAX channels-last -> PyTorch):
- Conv3d kernel (kt, kh, kw, i, o) -> (o, i, kt, kh, kw)
- per-frame Conv2d as 3D (1, kh, kw, i, o) -> (o, i, kh, kw)
- per-pixel Conv1d as 3D (kt, 1, 1, i, o) -> (o, i, kt)
- Dense / 1x1 conv kernel (i, o) -> (o, i)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from magvit2_pytorch_tpu_torch.models.layerspec import parse_layers

# state_dict entries of the reference that are buffers, not parameters
# (LFQ mask/codebook, FSQ levels/basis, the model's ``zero``)
GENERATOR_BUFFER_KEYS = ('quantizers.mask', 'quantizers.codebook',
                         'quantizers._levels', 'quantizers._basis', 'zero')
NON_GENERATOR_PREFIXES = ('discr.', 'vgg.', 'multiscale_discrs.')


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order='C'))


def _conv3d(k):
    return _t(np.asarray(k).transpose(4, 3, 0, 1, 2))


def _conv2d_from3d(k):
    return _t(np.asarray(k)[0].transpose(3, 2, 0, 1))


def _conv1d_from3d(k):
    return _t(np.asarray(k)[:, 0, 0].transpose(2, 1, 0))


def _dense(k):
    return _t(np.asarray(k).T)


def _linear_params(out, p, jp):
    out[f'{p}.weight'] = _dense(jp['kernel'])
    out[f'{p}.bias'] = _t(jp['bias'])


def p_flipped(kernel, positions: int):
    """A JAX upsampler's 1x1 kernel ``(i, c * 2**positions)``, in
    ``(c, p1[, p2])`` column order, with every position axis reversed."""
    k = np.asarray(kernel)
    c_in, total = k.shape
    k = k.reshape(c_in, total // 2 ** positions, *(2,) * positions)
    k = k[(slice(None), slice(None)) + (slice(None, None, -1),) * positions]
    return k.reshape(c_in, total)


def _upsampler(out, p, jp, positions: int):
    out[f'{p}.net.0.weight'] = _dense(p_flipped(jp['kernel'], positions))
    out[f'{p}.net.0.bias'] = _t(jp['bias'])


def _residual_unit(out, p, jp):
    fn = jp['fn']
    out[f'{p}.fn.0.conv.weight'] = _conv3d(fn['conv']['kernel'])
    out[f'{p}.fn.0.conv.bias'] = _t(fn['conv']['bias'])
    _linear_params(out, f'{p}.fn.2', fn['conv_pointwise'])
    se = fn['se']
    _linear_params(out, f'{p}.fn.4.to_k', se['to_k'])
    _linear_params(out, f'{p}.fn.4.net.0', se['gate_in'])
    _linear_params(out, f'{p}.fn.4.net.2', se['gate_out'])


def _attention(out, p, jp):
    out[f'{p}.norm.gamma'] = _t(jp['norm']['gamma'])
    out[f'{p}.to_qkv.0.weight'] = _dense(jp['to_qkv']['kernel'])
    out[f'{p}.mem_kv'] = _t(jp['mem_kv'])
    out[f'{p}.to_out.1.weight'] = _dense(jp['to_out']['kernel'])


def _linear_attention(out, p, jp):
    out[f'{p}.norm.gamma'] = _t(jp['norm']['gamma'])
    out[f'{p}.attn.to_qkv.0.weight'] = _dense(jp['attn']['to_qkv_kernel'])
    out[f'{p}.attn.to_out.1.weight'] = _dense(jp['attn']['to_out_kernel'])


def _feedforward(out, p, jp):
    out[f'{p}.norm.gamma'] = _t(jp['norm']['gamma'])
    _linear_params(out, f'{p}.net.0', jp['proj_in'])
    _linear_params(out, f'{p}.net.2', jp['proj_out'])


def _layer(out, layer_type, params, p, jp, encoder: bool):
    if layer_type == 'residual':
        _residual_unit(out, p, jp)
    elif layer_type == 'consecutive_residual':
        (num,) = params
        for j in range(num):
            _residual_unit(out, f'{p}.{j}', jp[f'fns_{j}'])
    elif layer_type == 'compress_space':
        if encoder:
            out[f'{p}.conv.weight'] = _conv2d_from3d(jp['kernel'])
            out[f'{p}.conv.bias'] = _t(jp['bias'])
        else:
            _upsampler(out, p, jp, positions=2)
    elif layer_type == 'compress_time':
        if encoder:
            out[f'{p}.conv.weight'] = _conv1d_from3d(jp['kernel'])
            out[f'{p}.conv.bias'] = _t(jp['bias'])
        else:
            _upsampler(out, p, jp, positions=1)
    elif layer_type == 'attend_space':
        _attention(out, f'{p}.0.fn', jp['fns_0']['fn'])
        _feedforward(out, f'{p}.1.fn', jp['fns_1']['fn'])
    elif layer_type == 'attend_time':
        _attention(out, f'{p}.0.fn.fn', jp['fns_0']['fn']['fn'])
        _feedforward(out, f'{p}.1.fn.fn', jp['fns_1']['fn']['fn'])
    elif layer_type == 'linear_attend_space':
        _linear_attention(out, f'{p}.0.fn', jp['fns_0']['fn'])
        _feedforward(out, f'{p}.1.fn', jp['fns_1']['fn'])
    else:
        raise NotImplementedError(
            f'layer type {layer_type!r} is not ported to PyTorch yet: '
            'ROADMAP.md queue A item 9')


def state_dict_from_jax_params(config, params: Mapping) -> dict:
    """JAX ``TokenizerModule`` params (numpy leaves) -> the port's
    ``state_dict`` for ``config`` (either package's ``TokenizerConfig``),
    with the decoder's upsampler kernels flipped over p (module docstring)."""
    parsed = parse_layers(config.layers, init_dim=config.init_dim,
                          image_size=config.image_size,
                          max_dim=config.max_dim, dim_cond=config.dim_cond)
    n = len(parsed.specs)
    out = {
        'conv_in.conv.weight': _conv3d(params['conv_in']['kernel']),
        'conv_in.conv.bias': _t(params['conv_in']['bias']),
        'conv_out.conv.weight': _conv3d(params['conv_out']['kernel']),
        'conv_out.conv.bias': _t(params['conv_out']['bias']),
    }
    for spec in parsed.specs:
        i = spec.index
        _layer(out, spec.layer_type, spec.params, f'encoder_layers.{i}',
               params[f'encoder_{i}'], encoder=True)
        # the decoder is stored reversed: spec i at index n - 1 - i
        _layer(out, spec.layer_type, spec.params,
               f'decoder_layers.{n - 1 - i}', params[f'decoder_{i}'],
               encoder=False)
    out[f'encoder_layers.{n}.1.weight'] = _t(params['final_norm']['gamma'])
    out[f'encoder_layers.{n}.1.bias'] = _t(params['final_norm']['beta'])
    if 'quantizers' in params:
        q = params['quantizers']
        _linear_params(out, 'quantizers.project_in', q['project_in'])
        _linear_params(out, 'quantizers.project_out', q['project_out'])
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
