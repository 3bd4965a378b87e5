"""GAN discriminators with anti-aliased downsampling (PyTorch counterpart of
``magvit2_pytorch_tpu/models/discriminator.py``; reference
magvit2_pytorch.py:549-675).

Channels-last ``(B, H, W, C)``, as the JAX package's. Module names follow
the reference's ``state_dict`` (``blocks.{i}.0`` the conv block with
``conv_res``, ``net.0``, ``net.2`` and ``downsample.1``; ``blocks.{i}.1`` the
linear attention and feed-forward residuals; ``to_logits.0`` and
``to_logits.3``); ``models/jax_import.py`` maps them to the JAX package's
``block_{i}``, ``LinearSpaceAttention_{i}``, ``FeedForward_{i}``,
``to_logits_conv`` and ``to_logits``. The space-to-depth downsample keeps
the reference's channel-first ``(c p1 p2)`` order, and the logit head
flattens channel-first, so both packages hold the same weights.
``MultiscaleDiscriminator`` is the JAX package's first-party multiscale
discriminator: the video average-pooled by ``downscale_factor``, the image
discriminator on every frame, the logits averaged per sample.

The discriminators run plain PyTorch apart from the linear attention, which
takes the Taylor block (B3) where its head size is 8; R1's double backward
goes through B3's backward, whose recompute is itself differentiable
(``ops/kernels/_build.py`` ``recompute_grads``).
"""

from __future__ import annotations

import math

import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.ops.attention import LinearSpaceAttention
from magvit2_pytorch_tpu_torch.ops.basic import FeedForward, Linear, Residual
from magvit2_pytorch_tpu_torch.ops.conv import Conv2d, blur
from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple


class LeakyReLU(nn.LeakyReLU):
    """The reference's ``leaky_relu(p=0.1)`` (magvit2_pytorch.py:117-118)."""

    def __init__(self):
        super().__init__(0.1)


class SpaceToDepth(nn.Module):
    """``(B, H, W, C)`` -> ``(B, H/2, W/2, 4C)`` in the reference's
    channel-first ``(c p1 p2)`` order."""

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, h // 2, w // 2, c * 4)


class DiscriminatorBlock(nn.Module):
    """Reference magvit2_pytorch.py:549-586."""

    def __init__(self, dim_in: int, filters: int, downsample: bool = True,
                 antialiased_downsample: bool = True):
        super().__init__()
        self.antialiased = downsample and antialiased_downsample
        self.conv_res = Conv2d(dim_in, filters, 1,
                               stride=2 if downsample else 1)
        self.net = nn.Sequential(
            Conv2d(dim_in, filters, 3, padding=1), LeakyReLU(),
            Conv2d(filters, filters, 3, padding=1), LeakyReLU())
        self.downsample = (nn.Sequential(SpaceToDepth(),
                                         Conv2d(filters * 4, filters, 1))
                           if downsample else None)

    def forward(self, x):
        res = self.conv_res(x)
        x = self.net(x)
        if self.downsample is not None:
            if self.antialiased:
                x = blur(x, space_only=True)
            x = self.downsample(x)
        return (x + res) * (2 ** -0.5)


class FlattenChannelFirst(nn.Module):
    def forward(self, x):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class Discriminator(nn.Module):
    """Image discriminator (reference magvit2_pytorch.py:588-675): input
    ``(B, H, W, C)``, one logit a sample ``(B,)``."""

    def __init__(self, dim: int, image_size, channels: int = 3,
                 max_dim: int = 512, attn_heads: int = 8,
                 attn_dim_head: int = 32, linear_attn_dim_head: int = 8,
                 linear_attn_heads: int = 16, ff_mult: float = 4.0,
                 antialiased_downsample: bool = False):
        super().__init__()
        image_size = cast_tuple(image_size, 2)
        num_layers = int(math.log2(min(image_size)) - 2)
        layer_dims = [channels] + [(dim * 4) * (2 ** i)
                                   for i in range(num_layers + 1)]
        layer_dims = [min(d, max_dim) for d in layer_dims]
        dims_in_out = list(zip(layer_dims[:-1], layer_dims[1:]))
        self.blocks = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(dims_in_out):
            is_not_last = ind != len(dims_in_out) - 1
            self.blocks.append(nn.ModuleList([
                DiscriminatorBlock(
                    dim_in, dim_out, downsample=is_not_last,
                    antialiased_downsample=antialiased_downsample),
                nn.Sequential(
                    Residual(LinearSpaceAttention(
                        dim_out, dim_head=linear_attn_dim_head,
                        heads=linear_attn_heads)),
                    Residual(FeedForward(dim_out, mult=ff_mult)))]))
        dim_last = layer_dims[-1]
        downsampled = 2 ** (len(dims_in_out) - 1)
        h, w = (s // downsampled for s in image_size)
        self.to_logits = nn.Sequential(
            Conv2d(dim_last, dim_last, 3, padding=1), LeakyReLU(),
            FlattenChannelFirst(), Linear(dim_last * h * w, 1))

    def forward(self, x):
        for block, attn_ff in self.blocks:
            x = attn_ff(block(x))
        return self.to_logits(x)[:, 0]


class MultiscaleDiscriminator(nn.Module):
    """The JAX package's first-party multiscale discriminator
    (``models/discriminator.py:109-147``): video ``(B, T, H, W, C)`` or
    images ``(B, H, W, C)``, average-pooled by ``downscale_factor``, the
    image discriminator (``discr``) on every frame, logits averaged per
    sample."""

    def __init__(self, dim: int, image_size: int, channels: int = 3,
                 max_dim: int = 512, downscale_factor: int = 2,
                 antialiased_downsample: bool = True):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.discr = Discriminator(
            dim=dim, image_size=image_size // downscale_factor,
            channels=channels, max_dim=max_dim,
            antialiased_downsample=antialiased_downsample)

    def forward(self, x):
        is_video = x.ndim == 5
        if is_video:
            b, t = x.shape[:2]
            x = x.reshape(b * t, *x.shape[2:])
        f = self.downscale_factor
        if f > 1:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), f, f).permute(0, 2, 3, 1)
        logits = self.discr(x)
        if is_video:
            logits = logits.reshape(b, t).mean(dim=-1)
        return logits
