"""Mixed-precision policy (PyTorch counterpart of
``magvit2_pytorch_tpu/utils/precision.py``): parameters and optimizer state
in float32, the batch and so every op in ``compute_dtype``, losses in
float32. The JAX package's ``param_dtype`` and ``output_dtype`` are not
fields here: its trainer reads only ``compute_dtype``, and so does the
port's. The trainer casts the batch (and the value-only VGG once) to
``compute_dtype``; each op of the port casts its parameters to its input's
dtype, as the JAX package's ops do, so bf16 batches on float32 parameters
compute what the JAX package computes, and the gradients reach the float32
parameters through those casts.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32


def default_policy(device=None) -> Policy:
    """bf16 compute on the card (the production policy), float32 on the
    CPU (exact numerics), as the JAX package's default is bf16 on its TPU
    and float32 elsewhere."""
    if torch.device(device if device is not None else 'cpu').type == 'cuda':
        return bf16_policy()
    return Policy()


def bf16_policy() -> Policy:
    """float32 parameters, bf16 compute."""
    return Policy(compute_dtype=torch.bfloat16)
