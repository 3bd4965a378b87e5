"""The tokenizer network (encoder -> LFQ -> decoder) as an ``nn.Module``:
PyTorch counterpart of ``magvit2_pytorch_tpu/models/tokenizer_module.py``.

Layout is channels-last ``(B, T, H, W, C)`` throughout. Module names and
parameter shapes follow the reference's ``state_dict`` (``conv_in.conv``,
``encoder_layers.{i}``, ``decoder_layers.{i}`` with the decoder stored in
reverse as the reference's ``insert(0)`` builds it, ``quantizers.*``, and the
final encoder LayerNorm at ``encoder_layers.{n}.1``, present but not applied
unless ``apply_final_norm``: reference quirk #10).

The port serves every configuration of the JAX package (LFQ in all its
options, FSQ, separate first-frame encoding, every pad mode) except
conditioning, gateloop, streaming and remat: those raise
``NotImplementedError`` naming their ROADMAP.md item.

``flash_attn`` never changes the model graph, in either package: it only
picks the ``attend`` backend the attention layers are built with (None, i.e.
``'auto'``, or the plain one), and a layer without a mask takes the fused
block or ``attend_with_memory`` whatever that backend is
(``magvit2_pytorch_tpu/ops/attention.py:160-166``). ``use_rotary_pos_emb``
and ``attn_dropout > 0`` make every attention layer ineligible for the fused
blocks, as in the JAX package, and take the general path.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional, Tuple

import torch
from torch import nn

from magvit2_pytorch_tpu_torch.models.layerspec import (
    LayerSpec, ParsedLayers, parse_layers)
from magvit2_pytorch_tpu_torch.ops.attention import (
    LinearSpaceAttention, SpaceAttention, TimeAttention)
from magvit2_pytorch_tpu_torch.ops.basic import (
    FeedForward, Residual, TokenShift)
from magvit2_pytorch_tpu_torch.ops.conv import (
    ZERO_PAD_MODES, CausalConv3d, SameConv2d, pad_time_front)
from magvit2_pytorch_tpu_torch.ops.norms import LayerNorm
from magvit2_pytorch_tpu_torch.ops.quantizers import FSQ, LFQ
from magvit2_pytorch_tpu_torch.ops.resample import (
    ResidualUnit, SpatialDownsample2x, SpatialUpsample2x, TimeDownsample2x,
    TimeUpsample2x)
from magvit2_pytorch_tpu_torch.utils.helpers import exists, not_ported


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """The JAX package's ``TokenizerConfig``: same fields, defaults and JSON,
    so a config moves between the two packages unchanged. The loss, GAN and
    VGG fields are parsed for that reason; the port's serving path does not
    read them."""

    image_size: int
    layers: Tuple = (('residual',), ('residual',), ('residual',))
    residual_conv_kernel_size: int = 3
    num_codebooks: int = 1
    codebook_size: Optional[int] = None
    channels: int = 3
    init_dim: int = 64
    max_dim: float = float('inf')
    dim_cond: Optional[int] = None
    dim_cond_expansion_factor: float = 4.0
    input_conv_kernel_size: Tuple[int, int, int] = (7, 7, 7)
    output_conv_kernel_size: Tuple[int, int, int] = (3, 3, 3)
    pad_mode: str = 'constant'
    lfq_entropy_loss_weight: float = 0.1
    lfq_commitment_loss_weight: float = 1.0
    lfq_diversity_gamma: float = 2.5
    lfq_spherical: bool = False
    quantizer_aux_loss_weight: float = 1.0
    lfq_soft_clamp_input_value: Optional[float] = 10.0
    lfq_exact_codebook_entropy: bool = False
    lfq_entropy_inv_temperature: float = 100.0
    use_fsq: bool = False
    fsq_levels: Optional[Tuple[int, ...]] = None
    attn_dim_head: int = 32
    attn_heads: int = 8
    attn_dropout: float = 0.0
    linear_attn_dim_head: int = 8
    linear_attn_heads: int = 16
    vgg_weights: Optional[str] = None
    perceptual_loss_weight: float = 1e-1
    discr_kwargs: Optional[dict] = None
    multiscale_discrs: Tuple[dict, ...] = tuple()
    use_gan: bool = True
    adversarial_loss_weight: float = 1.0
    grad_penalty_loss_weight: float = 10.0
    multiscale_adversarial_loss_weight: float = 1.0
    flash_attn: bool = True
    separate_first_frame_encoding: bool = False
    use_rotary_pos_emb: bool = False
    streaming_kv_window: Optional[int] = None
    apply_final_norm: bool = False
    remat: object = False
    lane_pack: object = False

    def __post_init__(self):
        object.__setattr__(self, 'layers', tuple(
            tuple(l) if isinstance(l, (list, tuple)) else (l,)
            for l in self.layers))
        for key in ('input_conv_kernel_size', 'output_conv_kernel_size'):
            object.__setattr__(self, key, tuple(getattr(self, key)))
        if exists(self.fsq_levels):
            object.__setattr__(self, 'fsq_levels', tuple(self.fsq_levels))
        if exists(self.multiscale_discrs):
            object.__setattr__(self, 'multiscale_discrs', tuple(
                dict(d) for d in self.multiscale_discrs))
        if not self.use_fsq:
            assert exists(self.codebook_size) and not exists(self.fsq_levels), (
                'if use_fsq=False, `codebook_size` must be set (and not '
                '`fsq_levels`)')
            if (self.codebook_size >= 2 ** 14
                    and self.lfq_entropy_inv_temperature > 4):
                # the JAX package's warning, word for word, so that both
                # packages warn alike (its tokenizer_module.py:174-193)
                warnings.warn(
                    f'codebook_size={self.codebook_size} (>= 2^14) with '
                    f'lfq_entropy_inv_temperature='
                    f'{self.lfq_entropy_inv_temperature} (> 4): at this scale '
                    'the entropy diversity gradient saturates within ~25 '
                    'steps and codebook utilization collapses permanently '
                    '(measured: results/codebook_2e18_t2.log). Set '
                    'lfq_entropy_inv_temperature~=2 for real runs, and watch '
                    "the trainer's mean_bit_entropy metric in the first 50 "
                    'steps — below ~0.1 means the collapse already happened.',
                    stacklevel=3)
        else:
            assert not exists(self.codebook_size) and exists(self.fsq_levels), (
                'if use_fsq=True, `fsq_levels` must be set (and not '
                '`codebook_size`)')

    def parsed(self) -> ParsedLayers:
        return parse_layers(
            self.layers, init_dim=self.init_dim, image_size=self.image_size,
            max_dim=self.max_dim, dim_cond=self.dim_cond)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d['max_dim'] == float('inf'):
            d['max_dim'] = 'inf'
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> 'TokenizerConfig':
        d = json.loads(s)
        if d.get('max_dim') == 'inf':
            d['max_dim'] = float('inf')
        return cls(**d)


def check_supported(cfg: TokenizerConfig):
    """Raise ``NotImplementedError`` for any config outside the port's slice;
    nothing is silently ignored."""
    for spec in cfg.parsed().specs:
        t = spec.layer_type
        if t == 'gateloop_time' or t.startswith('cond_'):
            not_ported(f'layer type {t!r}', '9')
    checks = (
        (exists(cfg.dim_cond), 'dim_cond (conditioning)', '9'),
        (exists(cfg.streaming_kv_window), 'streaming_kv_window', '10'),
        (bool(cfg.remat), 'remat (training)', '12'),
    )
    for bad, what, item in checks:
        if bad:
            not_ported(what, item)


def _compute_lane_pack_end(config: TokenizerConfig) -> int:
    """Spec index of the ``compress_space`` that ends the lane-packed stem,
    or -1 when packing is off or the config is ineligible (a copy of
    ``magvit2_pytorch_tpu/models/tokenizer_module.py:224-244``). The stem is
    conv_in + a (possibly empty) run of residual layers. In the port the
    activations stay unpacked: ``lane_pack`` only routes the stem's
    ResidualUnits to the fused kernel B5 (``w_blocked``)."""
    cfg = config
    if not cfg.lane_pack:
        return -1
    if cfg.separate_first_frame_encoding:
        return -1
    if cfg.pad_mode not in ZERO_PAD_MODES:
        return -1
    if cfg.init_dim >= 128 or cfg.image_size % 2:
        return -1
    for i, spec in enumerate(cfg.parsed().specs):
        t = spec.layer_type
        if t == 'compress_space':
            return i
        if t not in ('residual', 'consecutive_residual'):
            return -1
    return -1


def _apply_layer(layer, x, w_blocked: bool):
    """``layer(x)``; a stem layer of the lane-packed region hands
    ``w_blocked`` to each of its ResidualUnits."""
    if not w_blocked:
        return layer(x)
    for unit in (layer if isinstance(layer, nn.Sequential) else (layer,)):
        x = unit(x, w_blocked=True)
    return x


def _attend_backend(cfg: TokenizerConfig) -> Optional[str]:
    """flash_attn=True -> the default ('auto') dispatch of ``attend``, else
    the plain backend (``tokenizer_module.py:247-250`` of the JAX package)."""
    return None if cfg.flash_attn else 'plain'


def _build_layer(spec: LayerSpec, cfg: TokenizerConfig, encoder: bool):
    t = spec.layer_type
    k = cfg.residual_conv_kernel_size
    dim, dim_out = spec.dim_in, spec.dim_out
    attn = dict(dim_head=cfg.attn_dim_head, heads=cfg.attn_heads,
                backend=_attend_backend(cfg), dropout=cfg.attn_dropout,
                use_rotary=cfg.use_rotary_pos_emb)

    if t == 'residual':
        return ResidualUnit(dim, k, pad_mode=cfg.pad_mode)
    if t == 'consecutive_residual':
        (num,) = spec.params
        return nn.Sequential(*[ResidualUnit(dim, k, pad_mode=cfg.pad_mode)
                               for _ in range(num)])
    if t == 'compress_space':
        if encoder:
            return SpatialDownsample2x(dim, dim_out)
        return SpatialUpsample2x(dim_out, dim)
    if t == 'compress_time':
        if encoder:
            return TimeDownsample2x(dim, dim_out)
        return TimeUpsample2x(dim_out, dim)
    if t == 'attend_space':
        return nn.Sequential(
            Residual(SpaceAttention(dim, **attn)),
            Residual(FeedForward(dim)))
    if t == 'linear_attend_space':
        return nn.Sequential(
            Residual(LinearSpaceAttention(dim,
                                          dim_head=cfg.linear_attn_dim_head,
                                          heads=cfg.linear_attn_heads)),
            Residual(FeedForward(dim)))
    if t == 'attend_time':
        return nn.Sequential(
            Residual(TokenShift(TimeAttention(dim, **attn))),
            Residual(TokenShift(FeedForward(dim))))
    raise ValueError(f'unknown layer type {t}')


class TokenizerModule(nn.Module):
    """Encoder / quantizer / decoder graph; every method takes channels-last
    video ``(B, T, H, W, C)``."""

    def __init__(self, config: TokenizerConfig):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        parsed = self.parsed_layers = config.parsed()
        self.time_padding = parsed.time_downsample_factor - 1
        end = _compute_lane_pack_end(cfg)
        self.lane_pack_end = end if cfg.lane_pack in (True, 'encoder') else -1
        self.lane_pack_dec_end = end if cfg.lane_pack is True else -1

        self.conv_in = CausalConv3d(cfg.channels, cfg.init_dim,
                                    cfg.input_conv_kernel_size,
                                    pad_mode=cfg.pad_mode)
        self.conv_out = CausalConv3d(cfg.init_dim, cfg.channels,
                                     cfg.output_conv_kernel_size,
                                     pad_mode=cfg.pad_mode)
        if cfg.separate_first_frame_encoding:
            self.conv_in_first_frame = SameConv2d(
                cfg.channels, cfg.init_dim, cfg.input_conv_kernel_size[-2:])
            self.conv_out_first_frame = SameConv2d(
                cfg.init_dim, cfg.channels, cfg.output_conv_kernel_size[-2:])
        self.encoder_layers = nn.ModuleList(
            [_build_layer(spec, cfg, encoder=True) for spec in parsed.specs])
        # the reference appends the final norm (Rearrange, LayerNorm,
        # Rearrange) to encoder_layers
        self.encoder_layers.append(nn.Sequential(
            nn.Identity(), LayerNorm(parsed.final_dim), nn.Identity()))
        self.decoder_layers = nn.ModuleList(
            [_build_layer(spec, cfg, encoder=False)
             for spec in reversed(parsed.specs)])
        if cfg.use_fsq:
            self.quantizers = FSQ(cfg.fsq_levels, dim=parsed.final_dim,
                                  num_codebooks=cfg.num_codebooks)
        else:
            self.quantizers = LFQ(
                parsed.final_dim, cfg.codebook_size,
                num_codebooks=cfg.num_codebooks,
                entropy_loss_weight=cfg.lfq_entropy_loss_weight,
                commitment_loss_weight=cfg.lfq_commitment_loss_weight,
                diversity_gamma=cfg.lfq_diversity_gamma,
                soft_clamp_input_value=cfg.lfq_soft_clamp_input_value,
                spherical=cfg.lfq_spherical,
                exact_codebook_entropy=cfg.lfq_exact_codebook_entropy,
                inv_temperature=cfg.lfq_entropy_inv_temperature)

    @property
    def num_layers(self) -> int:
        return len(self.parsed_layers.specs)

    def _first_frame_apart(self, video_contains_first_frame: bool) -> bool:
        return (self.config.separate_first_frame_encoding
                and video_contains_first_frame)

    def encode(self, video, video_contains_first_frame: bool = True):
        """Video -> continuous latents ``(B, T', H', W', D)`` before
        quantization (reference magvit2_pytorch.py:1522-1576). With
        ``separate_first_frame_encoding`` the first frame takes its own 2D
        conv and the rest ``conv_in``; the time padding goes back in front
        after them (the JAX package's ``tokenizer_module.py:455-472``)."""
        tp = self.time_padding
        if video_contains_first_frame:
            video = pad_time_front(video, tp)
        if self._first_frame_apart(video_contains_first_frame):
            first = self.conv_in_first_frame(video[:, tp])
            x = torch.cat([first[:, None], self.conv_in(video[:, tp + 1:])],
                          dim=1)
            x = pad_time_front(x, tp)
        else:
            x = self.conv_in(video)
        for i, layer in enumerate(self.encoder_layers[:self.num_layers]):
            x = _apply_layer(layer, x, i < self.lane_pack_end)
        if self.config.apply_final_norm:
            x = self.encoder_layers[self.num_layers][1](x)
        return x

    def quantize(self, x):
        return self.quantizers(x)

    def indices_to_codes(self, indices, dtype=torch.float32):
        return self.quantizers.indices_to_codes(indices, dtype=dtype)

    def decode(self, quantized, video_contains_first_frame: bool = True):
        """Quantized latents -> video (reference magvit2_pytorch.py:1597-1649):
        the decoder layers, ``conv_out``, then the front time padding is
        cut off; with ``separate_first_frame_encoding`` the first frame after
        the padding takes its own 2D conv and the padding is dropped
        (``tokenizer_module.py:530-560`` of the JAX package)."""
        x = quantized
        n = len(self.decoder_layers)
        for j, layer in enumerate(self.decoder_layers):
            # decoder_layers are stored reversed: spec index n - 1 - j
            x = _apply_layer(layer, x, n - 1 - j < self.lane_pack_dec_end)
        tp = self.time_padding
        if self._first_frame_apart(video_contains_first_frame):
            first = self.conv_out_first_frame(x[:, tp])
            return torch.cat([first[:, None], self.conv_out(x[:, tp + 1:])],
                             dim=1)
        video = self.conv_out(x)
        if video_contains_first_frame:
            video = video[:, tp:]
        return video

    def forward(self, video, video_contains_first_frame: bool = True):
        """Full round trip; returns ``(recon, QuantizerOutput)``."""
        qout = self.quantize(self.encode(
            video, video_contains_first_frame=video_contains_first_frame))
        recon = self.decode(
            qout.quantized,
            video_contains_first_frame=video_contains_first_frame)
        return recon, qout
