"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (built for ``sm_90a`` at first
use, see ``_build``) or raises. Each launch adds one to the wrapper's count
in ``launch_counts()``: the attention blocks per block, their GEMMs by route
(``gemm_wgmma``, ``gemm_wmma``, ``gemm_f32``), the space block's
tensor-core core as ``space_attention_core_mma``, the fused ResidualUnit per
unit and its conv and 1x1 by route (``ru_conv_wgmma``, ``ru_conv_wmma``,
``ru_conv_f32``, ``ru_pointwise_*``). The attention blocks, Taylor
attention and the fused ResidualUnit (B1-B5) are ``torch.autograd.Function``s
on the card whose backward recomputes through the plain version that mirrors
the JAX custom VJP's XLA twin, counted as ``<name>_backward``;
``flash_attention``'s backward launches two kernels of its own.
"""

from __future__ import annotations

from magvit2_pytorch_tpu_torch.ops.kernels import (
    axial_attention,
    flash_attention,
    gemm,
    residual_unit,
    taylor_attention,
)

_COUNTERS = (axial_attention.LAUNCHES, taylor_attention.LAUNCHES,
             gemm.LAUNCHES, residual_unit.LAUNCHES, flash_attention.LAUNCHES)


def launch_counts() -> dict:
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts():
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
