"""User-facing ``VideoTokenizer`` for serving (PyTorch counterpart of
``magvit2_pytorch_tpu/models/tokenizer.py``).

``encode``, ``decode``, ``tokenize``, ``decode_from_code_indices`` and
``forward(return_codes=..., return_recon=...)`` run under
``torch.inference_mode()``. Tensors are channels-last ``(B, T, H, W, C)``;
``channel_first=True`` takes and returns the reference's
``(B, C, T, H, W)``. Weights are made on the CPU from ``seed`` with the
reference's init distributions, then moved to ``device`` in ``dtype`` (the
working dtype of the whole graph; quantization math stays float32).
``device`` defaults to the card (``'cuda'``) and raises where there is none;
``device='cpu'`` runs every kernel's plain PyTorch version.

``save`` / ``load`` / ``init_and_load_from`` read and write the JAX
package's checkpoint format: msgpack (``utils/serialization.py``, the port's
own codec) of ``{'version', 'config': TokenizerConfig JSON, 'params': the
JAX params pytree}``, so a checkpoint moves between the two packages either
way. ``state_dict`` / ``load_state_dict`` stay the module's torch state. The
loss modes, conditioning, ``init_and_load_from_torch`` and int8 calibration
are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from magvit2_pytorch_tpu_torch.models.jax_import import (
    jax_params_from_state_dict, reference_state_dict,
    state_dict_from_jax_params)
from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
    TokenizerConfig, TokenizerModule, not_ported)
from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
from magvit2_pytorch_tpu_torch.utils import serialization
from magvit2_pytorch_tpu_torch.utils.helpers import divisible_by, exists
from magvit2_pytorch_tpu_torch.version import __version__


class VideoTokenizer:
    """Construct with the JAX package's ``TokenizerConfig`` kwargs."""

    def __init__(self, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, **kwargs):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'VideoTokenizer runs on the GPU by default and no CUDA '
                    'device is available; pass device="cpu" to run the '
                    'plain PyTorch versions of the kernels on the CPU')
            device = 'cuda'
        self.config = TokenizerConfig(**kwargs)
        self.module = TokenizerModule(self.config)
        init_module_parameters(self.module,
                               torch.Generator().manual_seed(seed))
        self.device = torch.device(device)
        self.dtype = dtype
        self.module.to(device=self.device, dtype=dtype).eval()
        self.module.requires_grad_(False)

    # -- derived ---------------------------------------------------------------

    @property
    def image_size(self):
        return self.config.image_size

    @property
    def fmap_size(self):
        return self.module.parsed_layers.fmap_size

    @property
    def time_downsample_factor(self):
        return self.module.parsed_layers.time_downsample_factor

    @property
    def codebook_size(self):
        return self.module.quantizers.codebook_size

    # -- weights ---------------------------------------------------------------

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state, strict: bool = True):
        return self.module.load_state_dict(state, strict=strict)

    def load_reference_state_dict(self, state):
        """Load a reference (lucidrains) ``VideoTokenizer.state_dict()``."""
        self.module.load_state_dict(reference_state_dict(self.module, state),
                                    strict=True)

    # -- checkpoints in the JAX package's format -------------------------------

    def save(self, path, overwrite: bool = True):
        """Write a checkpoint that the JAX package's ``VideoTokenizer.load``
        and ``init_and_load_from`` read: the config and the generator's
        weights as the JAX params pytree, in float32."""
        path = Path(path)
        if path.exists() and not overwrite:
            raise FileExistsError(f'{path} already exists')
        pkg = {'version': __version__, 'config': self.config.to_json(),
               'params': jax_params_from_state_dict(self.config,
                                                    self.state_dict())}
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(serialization.msgpack_serialize(pkg))

    def load(self, path, strict: bool = True):
        """Load the generator's weights from a checkpoint the JAX package
        (or ``save``) wrote, onto ``self.device`` in ``self.dtype``.

        ``strict=True`` refuses a checkpoint whose params are not exactly
        the tree this config makes (a leaf missing, left over, or of another
        shape); ``strict=False`` loads every leaf that fits and keeps the
        rest. A checkpoint's ``discr_params`` and ``multiscale_params`` are
        skipped: the port has no discriminator yet (ROADMAP.md queue A item
        11), and they are never loaded into the generator."""
        self._load_params(_read_checkpoint(path)['params'], strict, path)

    def _load_params(self, params, strict: bool, path):
        template = _leaves(jax_params_from_state_dict(self.config,
                                                      self.state_dict()))
        given = _leaves(params)
        missing = sorted(set(template) - set(given))
        unused = sorted(set(given) - set(template))
        misfit = sorted(k for k in set(template) & set(given)
                        if np.shape(given[k]) != template[k].shape)
        if strict and (missing or unused or misfit):
            raise ValueError(
                f'checkpoint {path} does not fit this config: missing '
                f'{missing[:5]}, unused {unused[:5]}, other shapes '
                f'{[(k, np.shape(given[k]), template[k].shape) for k in misfit[:5]]}')
        params = {}
        for key, leaf in template.items():
            if key in given and key not in misfit:
                leaf = given[key]
            node = params
            for name in key[:-1]:
                node = node.setdefault(name, {})
            node[key[-1]] = leaf
        self.load_state_dict(state_dict_from_jax_params(self.config, params))

    @classmethod
    def init_and_load_from(cls, path, strict: bool = True, device=None,
                           dtype: torch.dtype = torch.float32):
        """Build the tokenizer a checkpoint's config describes and load its
        weights (``load``); ``device`` as in the constructor."""
        pkg = _read_checkpoint(path)
        if 'config' not in pkg:
            raise ValueError(f'{path}: no model config in this checkpoint')
        config = TokenizerConfig.from_json(pkg['config'])
        tokenizer = cls(device=device, dtype=dtype,
                        **dataclasses.asdict(config))
        tokenizer._load_params(pkg['params'], strict, path)
        return tokenizer

    @classmethod
    def init_and_load_from_torch(cls, path, strict: bool = True,
                                 **overrides):
        """The reference's ``.pt`` package: not ported yet (its only offline
        oracle needs the reference checkout)."""
        not_ported('init_and_load_from_torch', '8')

    # -- core API --------------------------------------------------------------

    def _video(self, video, channel_first: bool):
        video = torch.as_tensor(video, device=self.device).to(self.dtype)
        if channel_first:
            video = video.movedim(1, -1)
        return video

    def encode(self, video, quantize: bool = False,
               video_contains_first_frame: bool = True,
               channel_first: bool = False, cond=None):
        """reference magvit2_pytorch.py:1522-1576."""
        if exists(cond):
            not_ported('cond', '9')
        with torch.inference_mode():
            video = self._video(video, channel_first)
            latents = self.module.encode(video, video_contains_first_frame)
            if quantize:
                latents = self.module.quantize(latents).quantized
        return latents.movedim(-1, 1) if channel_first else latents

    def decode(self, quantized, video_contains_first_frame: bool = True,
               channel_first: bool = False, cond=None):
        """reference magvit2_pytorch.py:1597-1649."""
        if exists(cond):
            not_ported('cond', '9')
        with torch.inference_mode():
            quantized = self._video(quantized, channel_first)
            video = self.module.decode(quantized, video_contains_first_frame)
        return video.movedim(-1, 1) if channel_first else video

    def decode_from_code_indices(self, codes,
                                 video_contains_first_frame: bool = True,
                                 channel_first: bool = False, cond=None):
        """Flattened ``(b, f*h*w)`` or shaped ``(b, f, h, w)`` integer codes
        (reference magvit2_pytorch.py:1578-1595)."""
        codes = torch.as_tensor(codes, device=self.device)
        assert not codes.is_floating_point(), 'codes must be integers'
        if codes.ndim == 2:
            fmap = self.fmap_size
            assert divisible_by(codes.shape[-1], fmap * fmap), (
                f'flattened video ids must have a length ({codes.shape[-1]}) '
                f'divisible by fmap size ({fmap}) squared ({fmap * fmap})')
            codes = codes.reshape(codes.shape[0], -1, fmap, fmap)
        with torch.inference_mode():
            quantized = self.module.indices_to_codes(codes.long(), self.dtype)
        return self.decode(quantized, video_contains_first_frame,
                           channel_first=channel_first, cond=cond)

    def tokenize(self, video, **kwargs):
        """reference magvit2_pytorch.py:1651-1654."""
        return self.forward(video, return_codes=True, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, video_or_images, cond=None, return_loss: bool = False,
                return_codes: bool = False, return_recon: bool = False,
                return_discr_loss: bool = False,
                return_recon_loss_only: bool = False,
                video_contains_first_frame: bool = True,
                train: Optional[bool] = None, channel_first: bool = False):
        """The serving modes of the reference forward
        (magvit2_pytorch.py:1656-1896): recon, codes, or both."""
        if return_loss or return_discr_loss or return_recon_loss_only:
            not_ported('the loss modes of forward', '11')
        if train:
            not_ported('train=True', '11')
        if exists(cond):
            not_ported('cond', '9')

        video = self._video(video_or_images, channel_first)
        assert video.ndim in (4, 5)
        is_image = video.ndim == 4
        if is_image:
            video = video[:, None]
            video_contains_first_frame = True
        assert video.shape[2] == video.shape[3] == self.image_size
        frames = video.shape[1]
        assert divisible_by(
            frames - int(video_contains_first_frame),
            self.time_downsample_factor), (
            f'number of frames {frames} minus first frame must be divisible '
            f'by the total time downsample factor '
            f'{self.time_downsample_factor}')

        with torch.inference_mode():
            qout = self.module.quantize(
                self.module.encode(video, video_contains_first_frame))
            if return_codes and not return_recon:
                # codes only: the reference returns before decoding too
                return qout.indices
            recon = self.module.decode(qout.quantized,
                                       video_contains_first_frame)

        if is_image:
            recon = recon[:, 0]
        if channel_first:
            recon = recon.movedim(-1, 1)
        if return_codes:
            return qout.indices, recon
        return recon


def _read_checkpoint(path) -> dict:
    pkg = serialization.msgpack_restore(Path(path).read_bytes())
    if not isinstance(pkg, dict) or 'params' not in pkg:
        raise ValueError(f'{path} is not a tokenizer checkpoint')
    return pkg


def _leaves(tree, prefix=()) -> dict:
    """A nested dict's leaves by key path."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out
