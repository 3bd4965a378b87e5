"""The tokenizer network (encoder -> LFQ -> decoder) as an ``nn.Module``:
PyTorch counterpart of ``magvit2_pytorch_tpu/models/tokenizer_module.py``.

Layout is channels-last ``(B, T, H, W, C)`` throughout. Module names and
parameter shapes follow the reference's ``state_dict`` (``conv_in.conv``,
``encoder_layers.{i}``, ``decoder_layers.{i}`` with the decoder stored in
reverse as the reference's ``insert(0)`` builds it, ``quantizers.*``, and the
final encoder LayerNorm at ``encoder_layers.{n}.1``, present but not applied
unless ``apply_final_norm``: reference quirk #10).

The port serves every configuration of the JAX package: LFQ in all its
options, FSQ, separate first-frame encoding, every pad mode, conditioning
(the ``cond_*`` layers, ``dim_cond``), ``gateloop_time`` and chunked causal
streaming (``streaming=True`` with a stream's ``state``, a dict keyed by
module that ``models/streaming.py`` owns and hands down), and ``remat`` for
training: ``True`` / ``'full'`` recompute each encoder and decoder layer in
the backward (``torch.utils.checkpoint``, non-reentrant), ``'dots'`` keeps
the conv and matmul outputs inside each layer and recomputes the rest, as
the JAX package's ``'dots'`` policy does (its ``tokenizer_module.py:61``,
``:613-625``). A stream bypasses it, as in the JAX package.

Every layer is handed the kwargs the JAX package hands it (``cond`` from the
first conditioned layer on, the reference's running flag; ``state`` when
streaming; ``w_blocked`` in the lane-packed stem) and takes those its
``forward`` accepts (``ops.basic.filter_kwargs``).

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
import functools
import json
import warnings
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from magvit2_pytorch_tpu_torch.models.layerspec import (
    LayerSpec, ParsedLayers, parse_layers)
from magvit2_pytorch_tpu_torch.ops.attention import (
    LinearSpaceAttention, SpaceAttention, TimeAttention)
from magvit2_pytorch_tpu_torch.ops.basic import (
    FeedForward, Linear, Residual, Sequential, TokenShift, filter_kwargs)
from magvit2_pytorch_tpu_torch.ops.conv import (
    ZERO_PAD_MODES, CausalConv3d, SameConv2d, pad_time_front)
from magvit2_pytorch_tpu_torch.ops.gateloop import (
    SimpleGateLoopLayer, ToTimeSequence)
from magvit2_pytorch_tpu_torch.ops.norms import LayerNorm
from magvit2_pytorch_tpu_torch.ops.quantizers import FSQ, LFQ
from magvit2_pytorch_tpu_torch.ops.resample import (
    ResidualUnit, ResidualUnitMod, SpatialDownsample2x, SpatialUpsample2x,
    TimeDownsample2x, TimeUpsample2x)
from magvit2_pytorch_tpu_torch.utils.helpers import exists

REMAT_MODES = (False, True, 'full', 'dots')
# what remat='dots' keeps: the outputs of the convolutions and matrix
# products (the JAX policy's conv_general_dilated and dot_general)
_DOTS_SAVED = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ('convolution', 'mm', 'bmm', 'addmm', 'baddbmm'))


def _dots_policy(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer: nn.Module, x, kwargs: dict, remat):
    """``layer(x, **kwargs)`` recomputed in the backward: every activation
    (``True`` / ``'full'``) or all but the conv and matmul outputs
    (``'dots'``). A dropout ``generator`` in ``kwargs`` draws the forward's
    masks; the recompute draws from a copy of it set back to its state
    before the layer, so it draws the same masks and leaves the caller's
    generator alone (a recompute may stop early)."""
    generator = kwargs.get('generator')
    before = generator.get_state() if generator is not None else None
    calls = []

    def run(x):
        args = kwargs
        if calls and generator is not None:
            copy = torch.Generator(device=generator.device)
            copy.set_state(before)
            args = {**kwargs, 'generator': copy}
        calls.append(1)
        return layer(x, **args)

    context = {}
    if remat == 'dots':
        context['context_fn'] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch_checkpoint.checkpoint(run, x, use_reentrant=False,
                                       **context)


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

    @property
    def expanded_dim_cond(self) -> Optional[int]:
        """The width of the cond vector after the cond stems, which every
        conditioned layer takes (the JAX package's fix of the reference's
        quirk #7, ``tokenizer_module.py:14-17``)."""
        if not exists(self.dim_cond):
            return None
        return int(self.dim_cond * self.dim_cond_expansion_factor)

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
    """Raise ``ValueError`` for a ``remat`` the JAX package does not know."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f'remat={cfg.remat!r}: expected one of '
                         f'{REMAT_MODES}')


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


def _attend_backend(cfg: TokenizerConfig) -> Optional[str]:
    """flash_attn=True -> the default ('auto') dispatch of ``attend``, else
    the plain backend (``tokenizer_module.py:247-250`` of the JAX package)."""
    return None if cfg.flash_attn else 'plain'


def _build_layer(spec: LayerSpec, cfg: TokenizerConfig, encoder: bool):
    """One layer of the stack (the JAX package's ``_build_layer``,
    ``tokenizer_module.py:259-340``), under the reference's module names."""
    t = spec.layer_type
    k = cfg.residual_conv_kernel_size
    dim, dim_out = spec.dim_in, spec.dim_out
    dc = cfg.expanded_dim_cond if t.startswith('cond_') else None
    attn = dict(dim_head=cfg.attn_dim_head, heads=cfg.attn_heads,
                backend=_attend_backend(cfg), dropout=cfg.attn_dropout,
                use_rotary=cfg.use_rotary_pos_emb, dim_cond=dc)

    if t == 'residual':
        return ResidualUnit(dim, k, pad_mode=cfg.pad_mode)
    if t == 'consecutive_residual':
        (num,) = spec.params
        return Sequential(*[ResidualUnit(dim, k, pad_mode=cfg.pad_mode)
                            for _ in range(num)])
    if t == 'cond_residual':
        return ResidualUnitMod(dim, k, dim_cond=dc, pad_mode=cfg.pad_mode)
    if t == 'compress_space':
        if encoder:
            return SpatialDownsample2x(dim, dim_out)
        return SpatialUpsample2x(dim_out, dim)
    if t == 'compress_time':
        if encoder:
            return TimeDownsample2x(dim, dim_out)
        return TimeUpsample2x(dim_out, dim)
    if t in ('attend_space', 'cond_attend_space'):
        return Sequential(
            Residual(SpaceAttention(dim, **attn)),
            Residual(FeedForward(dim, dim_cond=dc)))
    if t in ('linear_attend_space', 'cond_linear_attend_space'):
        # the conditioned form takes the full attention's head shape, as
        # the JAX package builds it (tokenizer_module.py:301-308)
        heads = (dict(dim_head=cfg.attn_dim_head, heads=cfg.attn_heads)
                 if dc else dict(dim_head=cfg.linear_attn_dim_head,
                                 heads=cfg.linear_attn_heads))
        return Sequential(
            Residual(LinearSpaceAttention(dim, dim_cond=dc, **heads)),
            Residual(FeedForward(dim, dim_cond=dc)))
    if t == 'gateloop_time':
        return ToTimeSequence(Residual(SimpleGateLoopLayer(dim)))
    if t in ('attend_time', 'cond_attend_time'):
        return Sequential(
            Residual(TokenShift(TimeAttention(
                dim, kv_window=cfg.streaming_kv_window, **attn))),
            Residual(TokenShift(FeedForward(dim, dim_cond=dc))))
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

        if parsed.has_cond:
            # reference: Sequential(Linear(dim_cond, expanded), SiLU())
            self.encoder_cond_in = nn.Sequential(
                Linear(cfg.dim_cond, cfg.expanded_dim_cond), nn.SiLU())
            self.decoder_cond_in = nn.Sequential(
                Linear(cfg.dim_cond, cfg.expanded_dim_cond), nn.SiLU())

    @property
    def num_layers(self) -> int:
        return len(self.parsed_layers.specs)

    def _first_frame_apart(self, video_contains_first_frame: bool) -> bool:
        return (self.config.separate_first_frame_encoding
                and video_contains_first_frame)

    def _prep_cond(self, cond, batch: int, encoder: bool):
        """The cond vector ``(B, dim_cond)`` through its stem, or None
        (``tokenizer_module.py:421-432`` of the JAX package)."""
        has_cond = self.parsed_layers.has_cond
        assert not has_cond or exists(cond), (
            '`cond` must be passed in since conditionable layers were '
            'specified')
        if not exists(cond):
            return None
        if not has_cond:
            raise ValueError('`cond` was given, but no layer of this config '
                             'is conditioned')
        assert tuple(cond.shape) == (batch, self.config.dim_cond), (
            f'cond {tuple(cond.shape)}, expected ({batch}, '
            f'{self.config.dim_cond})')
        stem = self.encoder_cond_in if encoder else self.decoder_cond_in
        return stem(cond)

    @staticmethod
    def _stream_args(streaming: bool, state):
        if streaming and state is None:
            raise ValueError('streaming=True needs the stream\'s state '
                             '(a dict, see models/streaming.py)')
        return state if streaming else None

    def _run(self, layers, x, cond, has_cond, state, blocked,
             generator=None):
        """The layers in order, each with the kwargs it takes: ``cond`` from
        the first conditioned layer on, ``state`` when streaming,
        ``w_blocked`` where ``blocked(i)`` (layer i of ``layers``), the
        attention dropout's ``generator`` where given; each under
        ``remat`` unless streaming."""
        remat = self.config.remat and state is None and torch.is_grad_enabled()
        for i, (layer, conditioned) in enumerate(zip(layers, has_cond)):
            kwargs = {}
            if conditioned and exists(cond):
                kwargs['cond'] = cond
            if state is not None:
                kwargs['state'] = state
            if blocked(i):
                kwargs['w_blocked'] = True
            if generator is not None:
                kwargs['generator'] = generator
            kwargs = filter_kwargs(layer, kwargs)
            if remat:
                x = remat_layer(layer, x, kwargs, self.config.remat)
            else:
                x = layer(x, **kwargs)
        return x

    def encode(self, video, cond=None, video_contains_first_frame: bool = True,
               streaming: bool = False, state: Optional[dict] = None,
               generator: Optional[torch.Generator] = None):
        """Video -> continuous latents ``(B, T', H', W', D)`` before
        quantization (reference magvit2_pytorch.py:1522-1576). With
        ``separate_first_frame_encoding`` the first frame takes its own 2D
        conv and the rest ``conv_in``; the time padding goes back in front
        after them (the JAX package's ``tokenizer_module.py:437-494``).

        ``streaming=True``: one chunk of a stream whose ``state`` carries
        every time-causal op's history; the caller puts the first chunk's
        time padding in front and passes
        ``video_contains_first_frame=False``. ``generator`` draws the
        attention dropout (``attn_dropout > 0``), which runs only with
        one."""
        state = self._stream_args(streaming, state)
        if streaming:
            assert not self.config.separate_first_frame_encoding
        tp = self.time_padding
        if video_contains_first_frame and not streaming:
            video = pad_time_front(video, tp)
        cond = self._prep_cond(cond, video.shape[0], encoder=True)
        if self._first_frame_apart(video_contains_first_frame):
            first = self.conv_in_first_frame(video[:, tp])
            x = torch.cat([first[:, None], self.conv_in(video[:, tp + 1:])],
                          dim=1)
            x = pad_time_front(x, tp)
        else:
            x = self.conv_in(video, state=state)
        x = self._run(self.encoder_layers[:self.num_layers], x, cond,
                      self.parsed_layers.has_cond_across_layers, state,
                      lambda i: i < self.lane_pack_end, generator)
        if self.config.apply_final_norm:
            x = self.encoder_layers[self.num_layers][1](x)
        return x

    def quantize(self, x, train: bool = False):
        return self.quantizers(x, train=train)

    def indices_to_codes(self, indices, dtype=torch.float32):
        return self.quantizers.indices_to_codes(indices, dtype=dtype)

    def decode_features(self, quantized, cond=None, streaming: bool = False,
                        state: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None):
        """Quantized latents -> the features before ``conv_out`` (still
        time-padded): the decoder layers, stored reversed as the
        reference's ``insert(0)`` builds them (spec index ``n - 1 - j``)."""
        state = self._stream_args(streaming, state)
        cond = self._prep_cond(cond, quantized.shape[0], encoder=False)
        n = len(self.decoder_layers)
        return self._run(
            self.decoder_layers, quantized, cond,
            tuple(reversed(self.parsed_layers.has_cond_across_layers)),
            state, lambda j: n - 1 - j < self.lane_pack_dec_end, generator)

    def decode_pixels(self, x, video_contains_first_frame: bool = True,
                      streaming: bool = False, state: Optional[dict] = None):
        """Features -> video (reference magvit2_pytorch.py:1631-1649):
        ``conv_out``, then the front time padding is cut off; with
        ``separate_first_frame_encoding`` the first frame after the padding
        takes its own 2D conv and the padding is dropped
        (``tokenizer_module.py:526-560`` of the JAX package). Streaming, the
        caller cuts the first chunk's padding."""
        state = self._stream_args(streaming, state)
        tp = self.time_padding
        if self._first_frame_apart(video_contains_first_frame) and not (
                streaming):
            first = self.conv_out_first_frame(x[:, tp])
            return torch.cat([first[:, None], self.conv_out(x[:, tp + 1:])],
                             dim=1)
        video = self.conv_out(x, state=state)
        if video_contains_first_frame and not streaming:
            video = video[:, tp:]
        return video

    def decode(self, quantized, cond=None,
               video_contains_first_frame: bool = True,
               streaming: bool = False, state: Optional[dict] = None):
        """Quantized latents -> video (reference magvit2_pytorch.py:
        1597-1649): ``decode_features`` then ``decode_pixels``."""
        x = self.decode_features(quantized, cond=cond, streaming=streaming,
                                 state=state)
        return self.decode_pixels(
            x, video_contains_first_frame=video_contains_first_frame,
            streaming=streaming, state=state)

    def forward(self, video, cond=None,
                video_contains_first_frame: bool = True):
        """Full round trip; returns ``(recon, QuantizerOutput)``."""
        qout = self.quantize(self.encode(
            video, cond=cond,
            video_contains_first_frame=video_contains_first_frame))
        recon = self.decode(
            qout.quantized, cond=cond,
            video_contains_first_frame=video_contains_first_frame)
        return recon, qout
