"""The README flagship configuration (BASELINE.json config 2).

Copied from ``magvit2_pytorch_tpu/configs.py``, so the port names the same
configuration without importing the JAX package. The other configurations
there come over with the features they need."""

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

