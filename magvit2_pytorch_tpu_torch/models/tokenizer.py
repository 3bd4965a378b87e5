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
``device='cpu'`` runs every kernel's plain PyTorch version. The
loss modes, conditioning, checkpoints in the JAX package's msgpack format
and int8 calibration are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from magvit2_pytorch_tpu_torch.models.jax_import import reference_state_dict
from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
    TokenizerConfig, TokenizerModule, not_ported)
from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
from magvit2_pytorch_tpu_torch.utils.helpers import divisible_by, exists


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

    # -- weights ---------------------------------------------------------------

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state, strict: bool = True):
        return self.module.load_state_dict(state, strict=strict)

    def load_reference_state_dict(self, state):
        """Load a reference (lucidrains) ``VideoTokenizer.state_dict()``."""
        self.module.load_state_dict(reference_state_dict(self.module, state),
                                    strict=True)

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
