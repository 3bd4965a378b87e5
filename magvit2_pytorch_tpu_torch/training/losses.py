"""The loss side of training (PyTorch counterpart of
``magvit2_pytorch_tpu/training/losses.py``): reconstruction, the quantizer's
aux losses, the VGG perceptual loss, the hinge GAN losses with the adaptive
adversarial weight, R1 and the multiscale GAN terms, as the reference's
forward computes them (magvit2_pytorch.py:1656-1896), with the JAX
package's two fixes: only the pixels head is differentiated for the
adaptive weight, and the multiscale generator loss applies the
discriminator.

The random draws (which frame of each clip the perceptual loss, the
generator's adversarial loss and the discriminator look at) come from a
``torch.Generator`` and are kept apart from the math: ``draw_*`` makes them,
and ``tokenizer_loss`` / ``discriminator_loss`` take them as index tensors,
so a test can hand both packages the same picks.

The modules carry their own weights. The trainer runs these functions on
modules whose parameters it has swapped for compute-dtype copies
(``torch.func.functional_call``); ``_grad_norm_wrt_conv_out`` swaps one more
(the last conv's weight) the same way.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.utils.helpers import exists


class LossBreakdown(NamedTuple):
    """The reference's LossBreakdown (magvit2_pytorch.py:1028-1037) plus the
    JAX package's codebook canaries: the mean bit entropy (LFQ only) and the
    codes seen in the batch."""
    recon_loss: torch.Tensor
    lfq_aux_loss: torch.Tensor
    quantizer_loss_breakdown: Any
    perceptual_loss: torch.Tensor
    adversarial_gen_loss: torch.Tensor
    adaptive_adversarial_weight: torch.Tensor
    multiscale_gen_losses: Tuple
    multiscale_gen_adaptive_weights: Tuple
    mean_bit_entropy: Optional[torch.Tensor] = None
    codes_seen: Optional[torch.Tensor] = None


class DiscrLossBreakdown(NamedTuple):
    """The reference's DiscrLossBreakdown (magvit2_pytorch.py:1039-1043)."""
    discr_loss: torch.Tensor
    multiscale_discr_losses: Tuple
    gradient_penalty: torch.Tensor


def codebook_stats(indices, codebook_size: int, is_lfq: bool):
    """``(mean_bit_entropy, seen_mask)`` of the code indices: the mean over
    the code's bits of the binary entropy of each bit's rate in the batch
    (LFQ only, else None; below ~0.1 early means the codebook collapsed),
    and which codes the batch holds."""
    flat = indices.reshape(-1).long()
    seen = torch.zeros(codebook_size, dtype=torch.bool, device=flat.device)
    seen[flat] = True
    if not is_lfq:
        return None, seen
    num_bits = int(round(math.log2(codebook_size)))
    bits = ((flat[:, None] >> torch.arange(num_bits, device=flat.device))
            & 1).float()
    p = bits.mean(dim=0)
    h = -(torch.xlogy(p, p) + torch.xlogy(1 - p, 1 - p))
    return h.mean(), seen


def hinge_discr_loss(fake, real):
    return (F.relu(1 + fake) + F.relu(1 - real)).mean()


def hinge_gen_loss(fake):
    return -fake.mean()


def pick_video_frame(video, frame_indices):
    """``(b, t, h, w, c)`` and ``(b,)`` indices -> ``(b, h, w, c)``."""
    return video[torch.arange(video.shape[0], device=video.device),
                 frame_indices.to(video.device)]


def draw_frames(batch: int, frames: int, generator: torch.Generator):
    """One frame index a clip, uniform over ``frames``: the JAX package's
    ``jax.random.randint(key, (b,), 0, frames)``, drawn on the CPU from
    ``generator``."""
    return torch.randint(0, frames, (batch,), generator=generator)


def draw_tokenizer_loss(batch: int, frames: int,
                        generator: torch.Generator) -> dict:
    """The frame picks of one ``tokenizer_loss`` call: the perceptual
    loss's, then the generator's adversarial loss's."""
    return {'perceptual': draw_frames(batch, frames, generator),
            'gen': draw_frames(batch, frames, generator)}


class _Bound(nn.Module):
    """``module.<method>`` as a module's forward, for functional_call."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.method)(*args, **kwargs)


def call_with(module: nn.Module, params: dict, method: str, *args, **kwargs):
    """``module.<method>(*args, **kwargs)`` with the parameters named in
    ``params`` swapped for the given tensors for the call
    (``torch.func.functional_call``); the rest stay the module's."""
    return torch.func.functional_call(
        _Bound(module, method), {f'module.{k}': v for k, v in params.items()},
        args, kwargs, strict=False)


def gradient_penalty(discr: nn.Module, images, center: float = 0.0):
    """Zero-centred R1: ``mean((||d sum(D(x)) / dx|| - center)^2)`` with x in
    float32; the gradient keeps its graph, so the penalty trains the
    discriminator through a second backward."""
    images = images.detach().float().requires_grad_(True)
    total = discr(images).float().sum()
    (grads,) = torch.autograd.grad(total, images, create_graph=True)
    norms = grads.reshape(images.shape[0], -1).norm(dim=1)
    return ((norms - center) ** 2).mean()


def _grad_norm_wrt_conv_out(module, x_dec, video_contains_first_frame,
                            loss_of_recon):
    """``||d loss(decode_pixels(sg(x_dec); w)) / dw||`` for w the last conv's
    weight, taken in float32 (the JAX package's ``losses.py:121-142``):
    every path from w to the loss goes through the pixels, so the decoder
    features are detached and only the pixels head is differentiated."""
    w = module.conv_out.conv.weight.detach().float().requires_grad_(True)
    with torch.enable_grad():
        recon = call_with(module, {'conv_out.conv.weight': w},
                          'decode_pixels', x_dec.detach(),
                          video_contains_first_frame=video_contains_first_frame)
        (g,) = torch.autograd.grad(loss_of_recon(recon).float(), w)
    return g.reshape(-1).norm()


def _to_rgb(frames, channels: int):
    """A frame batch as VGG takes it: grey repeated to RGB, RGBA cut to RGB,
    and frames under 32 pixels upscaled bilinearly (VGG's five pools need
    32; the JAX package's ``losses.py:210-224``)."""
    if channels == 1:
        frames = frames.repeat(1, 1, 1, 3)
    elif channels == 4:
        frames = frames[..., :3]
    h, w = frames.shape[1:3]
    if h < 32 or w < 32:
        up = F.interpolate(frames.permute(0, 3, 1, 2).float(),
                           size=(max(h, 32), max(w, 32)), mode='bilinear',
                           align_corners=False)
        frames = up.permute(0, 2, 3, 1).to(frames.dtype)
    return frames


def codebook_size_of(config) -> int:
    if config.use_fsq:
        return math.prod(config.fsq_levels)
    return config.codebook_size


def tokenizer_loss(
    module,
    video,
    picks: dict,
    *,
    discr=None,
    multiscale: Tuple = (),
    vgg=None,
    cond=None,
    video_contains_first_frame: bool = True,
    train: bool = True,
    use_vgg: bool = False,
    has_gan: bool = False,
    has_multiscale_gan: bool = False,
    perceptual_loss_weight: float = 1e-1,
    quantizer_aux_loss_weight: float = 1.0,
    adversarial_loss_weight: float = 1.0,
    multiscale_adversarial_loss_weight: float = 1.0,
    generator: Optional[torch.Generator] = None,
):
    """The generator's loss (reference forward(return_loss=True),
    magvit2_pytorch.py:1695-1896; the JAX package's ``losses.py:145-326``)
    on ``video (b, t, h, w, c)``, with the frame picks of
    :func:`draw_tokenizer_loss`. ``generator`` draws attention dropout when
    ``train`` (with ``attn_dropout > 0``). Returns ``(total, LossBreakdown,
    recon)``."""
    b, channels = video.shape[0], video.shape[-1]
    dropout = dict(generator=generator) if train else {}
    latents = module.encode(
        video, cond=cond,
        video_contains_first_frame=video_contains_first_frame, **dropout)
    qout = module.quantize(latents, train=train)
    x_dec = module.decode_features(qout.quantized, cond=cond, **dropout)
    recon = module.decode_pixels(
        x_dec, video_contains_first_frame=video_contains_first_frame)

    recon_loss = ((video.float() - recon.float()) ** 2).mean()
    zero = torch.zeros((), dtype=torch.float32, device=video.device)

    def vgg_features(frames):
        return vgg(_to_rgb(frames, channels)).float()

    norm_grad_wrt_perceptual = None
    if use_vgg:
        fidx = picks['perceptual']
        inp_feats = vgg_features(pick_video_frame(video, fidx))
        rec_feats = vgg_features(pick_video_frame(recon, fidx))
        perceptual_loss = ((inp_feats - rec_feats) ** 2).mean()
        if train and (has_gan or has_multiscale_gan):
            inp_sg = inp_feats.detach()
            norm_grad_wrt_perceptual = _grad_norm_wrt_conv_out(
                module, x_dec, video_contains_first_frame,
                lambda r: ((inp_sg - vgg_features(
                    pick_video_frame(r, fidx))) ** 2).mean())
    else:
        perceptual_loss = zero

    if has_gan:
        gidx = picks['gen']
        gen_loss = hinge_gen_loss(discr(pick_video_frame(recon, gidx)))
        adaptive_weight = torch.ones((), dtype=torch.float32,
                                     device=video.device)
        if exists(norm_grad_wrt_perceptual):
            norm_grad_wrt_gen = _grad_norm_wrt_conv_out(
                module, x_dec, video_contains_first_frame,
                lambda r: hinge_gen_loss(discr(pick_video_frame(r, gidx))))
            adaptive_weight = (norm_grad_wrt_perceptual
                               / norm_grad_wrt_gen.clamp_min(1e-3))
            adaptive_weight = adaptive_weight.clamp_max(1e3)
            adaptive_weight = torch.where(torch.isnan(adaptive_weight),
                                          torch.ones_like(adaptive_weight),
                                          adaptive_weight)
        adaptive_weight = adaptive_weight.detach()
    else:
        gen_loss, adaptive_weight = zero, zero

    multiscale_gen_losses, multiscale_weights = [], []
    if has_multiscale_gan:
        for ms in multiscale:
            multiscale_gen_losses.append(hinge_gen_loss(ms(recon)))
            weight = torch.ones((), dtype=torch.float32, device=video.device)
            if exists(norm_grad_wrt_perceptual):
                ms_norm = _grad_norm_wrt_conv_out(
                    module, x_dec, video_contains_first_frame,
                    lambda r, ms=ms: hinge_gen_loss(ms(r)))
                weight = (norm_grad_wrt_perceptual
                          / ms_norm.clamp_min(1e-5)).clamp_max(1e3)
            multiscale_weights.append(weight.detach())

    total = (recon_loss
             + qout.aux_loss * quantizer_aux_loss_weight
             + perceptual_loss * perceptual_loss_weight
             + gen_loss * adaptive_weight * adversarial_loss_weight)
    if multiscale_gen_losses:
        weighted = sum(l * w for l, w in zip(multiscale_gen_losses,
                                             multiscale_weights))
        total = total + weighted * multiscale_adversarial_loss_weight

    cfg = module.config
    mean_bit_entropy, codes_seen = codebook_stats(
        qout.indices, codebook_size_of(cfg), is_lfq=not cfg.use_fsq)
    breakdown = LossBreakdown(
        recon_loss=recon_loss,
        lfq_aux_loss=qout.aux_loss,
        quantizer_loss_breakdown=qout.breakdown,
        perceptual_loss=perceptual_loss,
        adversarial_gen_loss=gen_loss,
        adaptive_adversarial_weight=adaptive_weight,
        multiscale_gen_losses=tuple(multiscale_gen_losses),
        multiscale_gen_adaptive_weights=tuple(multiscale_weights),
        mean_bit_entropy=mean_bit_entropy,
        codes_seen=codes_seen,
    )
    return total, breakdown, recon


def discriminator_loss(
    module,
    discr,
    video,
    frame_indices,
    *,
    multiscale: Tuple = (),
    cond=None,
    video_contains_first_frame: bool = True,
    apply_gradient_penalty: bool = True,
    grad_penalty_loss_weight: float = 10.0,
    multiscale_adversarial_loss_weight: float = 1.0,
):
    """The discriminator's loss (reference forward(return_discr_loss=True),
    magvit2_pytorch.py:1731-1786; the JAX package's ``losses.py:329-391``)
    on ``video``, with one frame a clip (``frame_indices``, from
    :func:`draw_frames`). The generator is frozen: its reconstruction is
    made without autograd. Returns ``(total, DiscrLossBreakdown)``."""
    with torch.no_grad():
        recon, _ = module(video, cond=cond,
                          video_contains_first_frame=video_contains_first_frame)
    real = pick_video_frame(video, frame_indices)
    fake = pick_video_frame(recon, frame_indices)
    discr_loss = hinge_discr_loss(discr(fake), discr(real))

    multiscale_losses = [hinge_discr_loss(ms(recon), ms(video))
                         for ms in multiscale]
    zero = torch.zeros((), dtype=torch.float32, device=video.device)
    gp = (gradient_penalty(discr, real) + gradient_penalty(discr, fake)
          if apply_gradient_penalty else zero)
    total = (discr_loss + gp * grad_penalty_loss_weight
             + sum(multiscale_losses, zero)
             * multiscale_adversarial_loss_weight)
    return total, DiscrLossBreakdown(
        discr_loss=discr_loss, multiscale_discr_losses=tuple(multiscale_losses),
        gradient_penalty=gp)
