"""VGG16 feature extractor for the perceptual loss (PyTorch counterpart of
``magvit2_pytorch_tpu/models/vgg.py``).

The reference takes torchvision's pretrained VGG16 with the classifier cut
after its second 4096-wide Linear + ReLU (magvit2_pytorch.py:1392-1407), fed
raw [0, 1] frames. torchvision is not a dependency, so this is the same
network written out, channels-last ``(B, H, W, 3)``, under torchvision's
``state_dict`` names (``features.{i}``, ``classifier.0``, ``classifier.3``),
so a torchvision ``vgg16`` state_dict loads as it is
(``load_torch_vgg16_state_dict``). The adaptive 7x7 pool flattens
channel-first, as torchvision does; dropout is left out (the perceptual net
runs in eval mode).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.ops.basic import Linear
from magvit2_pytorch_tpu_torch.ops.conv import Conv2d

VGG16_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M')
# the seed of the orthogonal fallback (the JAX package's default, vgg.py:116)
ORTHOGONAL_SEED = 7


def adaptive_avg_pool_2d(x, out_hw=(7, 7)):
    """torch ``AdaptiveAvgPool2d`` on ``(B, H, W, C)``: output cell i averages
    ``[floor(i H / out), ceil((i + 1) H / out))``, exact at any ratio (the
    JAX package's ``vgg.py:33-54``)."""
    out = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return out.permute(0, 2, 3, 1)


class MaxPool2x2(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class VGG16Features(nn.Module):
    """VGG16 up to the truncated classifier: ``(B, H, W, 3)`` -> ``(B,
    4096)``."""

    def __init__(self):
        super().__init__()
        layers, dim_in = [], 3
        for v in VGG16_CFG:
            if v == 'M':
                layers.append(MaxPool2x2())
            else:
                layers += [Conv2d(dim_in, v, 3, padding=1), nn.ReLU()]
                dim_in = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Identity(),
            Linear(4096, 4096), nn.ReLU())

    def forward(self, x):
        x = adaptive_avg_pool_2d(self.features(x), (7, 7))
        return self.classifier(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1))


def conv_and_linear_names():
    """The weight-bearing layers in order: (port and torchvision prefix,
    the JAX package's name)."""
    out, idx, conv = [], 0, 0
    for v in VGG16_CFG:
        if v == 'M':
            idx += 1
            continue
        out.append((f'features.{idx}', f'conv_{conv}'))
        idx, conv = idx + 2, conv + 1
    return out + [('classifier.0', 'fc_0'), ('classifier.3', 'fc_1')]


def load_torch_vgg16_state_dict(state_dict) -> dict:
    """A torchvision ``vgg16`` state_dict (tensors or arrays keyed
    ``features.N.*`` / ``classifier.N.*``; the classifier's last layer and
    anything else is skipped) -> this module's ``state_dict``."""
    out = {}
    for prefix, _ in conv_and_linear_names():
        for leaf in ('weight', 'bias'):
            t = state_dict[f'{prefix}.{leaf}']
            out[f'{prefix}.{leaf}'] = torch.as_tensor(
                np.asarray(t.detach().cpu().numpy() if hasattr(t, 'detach')
                           else t, np.float32))
    return out


def read_vgg_weights(path) -> dict:
    """A ``.npz`` of torchvision's keys, or a ``.pth`` state_dict, as this
    module's ``state_dict`` (the JAX package's ``load_vgg_weights``)."""
    path = str(path)
    if path.endswith('.npz'):
        with np.load(path) as f:
            state = dict(f)
    else:
        state = torch.load(path, map_location='cpu', weights_only=True)
    return load_torch_vgg16_state_dict(state)


def orthogonal_(weight, gen: torch.Generator, gain: float = 2 ** 0.5):
    """Fill ``weight (out, *fan_in)`` in place with ``gain`` times an
    orthogonal matrix over (fan_in, out): orthonormal columns when fan_in >=
    out, else orthonormal rows (jax.nn.initializers.orthogonal on the JAX
    layout). The normal draws come from ``gen`` on the CPU; the QR runs on
    the weight's device."""
    out_dim, fan_in = weight.shape[0], weight[0].numel()
    a = torch.randn(max(fan_in, out_dim), min(fan_in, out_dim),
                    generator=gen).to(weight.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if fan_in < out_dim:
        q = q.T
    with torch.no_grad():     # q is (fan_in, out); the port keeps (out, ...)
        weight.copy_((q.T * gain).reshape(weight.shape).to(weight.dtype))


def orthogonalize_vgg_(vgg: VGG16Features, seed: int = ORTHOGONAL_SEED):
    """Refill every VGG weight with an orthogonal matrix at ReLU gain
    sqrt(2), in place (the JAX package's ``orthogonalize_vgg_params``,
    ``vgg.py:113-139``). A random VGG under the default init measures
    perceptual losses of 1e-11-1e-14 and so zeroes the adaptive adversarial
    weight; orthogonal kernels keep the features O(1). Not a substitute for
    pretrained weights. The draws come from one ``torch.Generator`` seeded
    with ``seed``, layer after layer, so the weights are the same in every
    process (the JAX package seeds from Python's salted ``hash()``,
    ROADMAP.md C5)."""
    gen = torch.Generator().manual_seed(seed)
    for prefix, _ in conv_and_linear_names():
        orthogonal_(vgg.get_submodule(prefix).weight, gen)


def warn_orthogonal_fallback():
    warnings.warn(
        'perceptual loss is enabled but no pretrained VGG16 weights were '
        'given — the perceptual net is randomly initialized (orthogonal '
        'kernels: non-degenerate activations, but NO perceptual prior — '
        'unlike the reference, which always uses torchvision-pretrained '
        "VGG16). Pass vgg_weights='vgg16.npz' (torchvision's keys) or set "
        'perceptual_loss_weight=0 to silence this.', stacklevel=3)
