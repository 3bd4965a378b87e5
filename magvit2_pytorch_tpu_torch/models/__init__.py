from magvit2_pytorch_tpu_torch.models.layerspec import (
    ParsedLayers, parse_layers)
from magvit2_pytorch_tpu_torch.models.tokenizer import MagViT2, VideoTokenizer
from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
    TokenizerConfig,
    TokenizerModule,
)

__all__ = ['VideoTokenizer', 'MagViT2', 'TokenizerConfig', 'TokenizerModule',
           'ParsedLayers', 'parse_layers']
