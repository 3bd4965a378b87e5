"""Declarative layer-spec DSL for the tokenizer encoder/decoder.

Pure parsing of the reference's ``layers: Tuple[str | (str, int), ...]`` DSL
(magvit2_pytorch.py:1138-1318): tracks channel dims, spatial fmap size,
temporal downsample factor and per-layer conditioning — all static Python.

A copy of ``magvit2_pytorch_tpu/models/layerspec.py``: the port must import
without JAX, and the JAX package's ``utils`` import ``jax.numpy``. Keep the
two in step (tests/test_torch_port_slice.py compares their output).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple, default, safe_get_index

LAYER_TYPES = (
    'residual',
    'consecutive_residual',
    'cond_residual',
    'compress_space',
    'compress_time',
    'attend_space',
    'linear_attend_space',
    'gateloop_time',
    'attend_time',
    'cond_attend_space',
    'cond_linear_attend_space',
    'cond_attend_time',
)

COND_LAYER_TYPES = (
    'cond_residual', 'cond_attend_space', 'cond_linear_attend_space',
    'cond_attend_time',
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    layer_type: str
    params: Tuple
    dim_in: int
    dim_out: int
    has_cond: bool


@dataclasses.dataclass(frozen=True)
class ParsedLayers:
    specs: Tuple[LayerSpec, ...]
    final_dim: int
    fmap_size: int
    time_downsample_factor: int
    has_cond_across_layers: Tuple[bool, ...]
    has_cond: bool


def parse_layers(
    layers,
    *,
    init_dim: int,
    image_size: int,
    max_dim: float = float('inf'),
    dim_cond: Optional[int] = None,
) -> ParsedLayers:
    dim = init_dim
    fmap_size = image_size
    time_downsample_factor = 1
    has_cond_across_layers: List[bool] = []
    specs: List[LayerSpec] = []
    has_cond = False

    for index, layer_def in enumerate(layers):
        layer_type, *layer_params = cast_tuple(layer_def)
        assert layer_type in LAYER_TYPES, f'unknown layer type {layer_type}'

        dim_out = dim

        if layer_type in COND_LAYER_TYPES:
            assert dim_cond is not None, (
                'dim_cond must be passed into VideoTokenizer if conditionable '
                'layers are specified')
            has_cond = True

        if layer_type in ('compress_space', 'compress_time'):
            dim_out = safe_get_index(layer_params, 0)
            dim_out = default(dim_out, dim * 2)
            dim_out = int(min(dim_out, max_dim))
            if layer_type == 'compress_space':
                assert fmap_size > 1
                fmap_size //= 2
            else:
                time_downsample_factor *= 2

        specs.append(LayerSpec(
            index=index,
            layer_type=layer_type,
            params=tuple(layer_params),
            dim_in=dim,
            dim_out=dim_out,
            has_cond=has_cond,
        ))
        has_cond_across_layers.append(has_cond)
        dim = dim_out

    return ParsedLayers(
        specs=tuple(specs),
        final_dim=dim,
        fmap_size=fmap_size,
        time_downsample_factor=time_downsample_factor,
        has_cond_across_layers=tuple(has_cond_across_layers),
        has_cond=any(has_cond_across_layers),
    )
