"""Canonical configurations (BASELINE.json configs 1-5).

Copied from ``magvit2_pytorch_tpu/configs.py``, so the port names the same
configurations without importing the JAX package. The port serves config 5
whole-clip; its chunked streaming is ROADMAP.md queue A item 10."""

from __future__ import annotations

# README default video tokenizer (reference README.md:35-56): 128px x 17
# frames, codebook 1024, 8x spatial / 4x temporal downsample -> codes
# (b, 5, 16, 16). (The README comment claiming (1, 9, 16, 16) is stale —
# BASELINE.md.)
README_LAYERS = (
    'residual',
    'compress_space',
    ('consecutive_residual', 2),
    'compress_space',
    ('consecutive_residual', 2),
    'linear_attend_space',
    'compress_space',
    ('consecutive_residual', 2),
    'attend_space',
    'compress_time',
    ('consecutive_residual', 2),
    'compress_time',
    ('consecutive_residual', 2),
    'attend_time',
)


def readme_video_tokenizer_kwargs(**overrides):
    """BASELINE config 2: the README default video tokenizer."""
    kwargs = dict(
        image_size=128,
        init_dim=64,
        max_dim=512,
        codebook_size=1024,
        layers=README_LAYERS,
    )
    kwargs.update(overrides)
    return kwargs


def images_mode_tokenizer_kwargs(**overrides):
    """BASELINE config 1: images-mode 64px tokenizer, LFQ-512."""
    kwargs = dict(
        image_size=64,
        init_dim=32,
        codebook_size=512,
        layers=(
            'residual',
            'compress_space',
            'residual',
            'compress_space',
            'residual',
        ),
        use_gan=False,
        perceptual_loss_weight=0.0,
    )
    kwargs.update(overrides)
    return kwargs


def fsq_gan_tokenizer_kwargs(**overrides):
    """BASELINE config 3: FSQ variant + GAN training."""
    kwargs = dict(
        image_size=128,
        init_dim=64,
        max_dim=512,
        codebook_size=None,
        use_fsq=True,
        fsq_levels=(8, 8, 8, 5, 5, 5),
        layers=README_LAYERS,
        use_gan=True,
    )
    kwargs.update(overrides)
    return kwargs


def open_magvit2_image_tokenizer_kwargs(**overrides):
    """BASELINE config 4: Open-MAGVIT2 scale — 256px image tokenizer with a
    2^18 LFQ codebook (image pretraining stage)."""
    kwargs = dict(
        image_size=256,
        init_dim=128,
        max_dim=512,
        codebook_size=2 ** 18,
        layers=(
            'residual',
            'compress_space',
            ('consecutive_residual', 2),
            'compress_space',
            ('consecutive_residual', 2),
            'linear_attend_space',
            'compress_space',
            ('consecutive_residual', 2),
            'attend_space',
        ),
    )
    kwargs.update(overrides)
    return kwargs


def streaming_video_tokenizer_kwargs(**overrides):
    """BASELINE config 5: 256px x 65-frame causal chunked tokenize/decode."""
    kwargs = dict(
        image_size=256,
        init_dim=64,
        max_dim=512,
        codebook_size=2 ** 14,
        layers=(
            'residual',
            'compress_space',
            ('consecutive_residual', 2),
            'compress_space',
            ('consecutive_residual', 2),
            'compress_space',
            ('consecutive_residual', 2),
            'compress_time',
            ('consecutive_residual', 2),
            'compress_time',
            ('consecutive_residual', 2),
        ),
    )
    kwargs.update(overrides)
    return kwargs
