from magvit2_pytorch_tpu_torch.models.tokenizer import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
    TokenizerConfig,
    TokenizerModule,
)

__all__ = ['VideoTokenizer', 'TokenizerConfig', 'TokenizerModule']
