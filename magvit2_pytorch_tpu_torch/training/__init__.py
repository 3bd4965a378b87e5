from magvit2_pytorch_tpu_torch.training.ema import (
    EMAConfig, ema_decay, ema_update)
from magvit2_pytorch_tpu_torch.training.losses import (
    DiscrLossBreakdown, LossBreakdown, discriminator_loss, tokenizer_loss)
from magvit2_pytorch_tpu_torch.training.metrics import (
    code_entropy, codebook_utilization, psnr)
from magvit2_pytorch_tpu_torch.training.optimizer import (
    get_optimizer, wd_mask)
from magvit2_pytorch_tpu_torch.training.trainer import VideoTokenizerTrainer
