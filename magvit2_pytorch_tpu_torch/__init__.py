"""PyTorch + CUDA port of the MagViT2 video tokenizer, held against the JAX
package ``magvit2_pytorch_tpu`` beside it. Imports ``torch``, never ``jax``.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use on a CUDA tensor (``ops/kernels``); on the CPU every kernel runs
its plain PyTorch version.
"""

from magvit2_pytorch_tpu_torch.models import (
    TokenizerConfig,
    TokenizerModule,
    VideoTokenizer,
)

__all__ = ['VideoTokenizer', 'TokenizerConfig', 'TokenizerModule']
