"""Basic blocks: Linear with torch-default init, GEGLU FeedForward, TokenShift,
SqueezeExcite, Residual and a kwargs-forwarding Sequential (PyTorch
counterpart of ``magvit2_pytorch_tpu/ops/basic.py``).

Parameters keep the reference's PyTorch layouts and ``state_dict`` names
(weights ``(out, in)``; the reference's 1x1 convs are ``Linear`` over the
trailing channel axis, which is the same product on channels-last tensors).
Every parameterised module fills its own tensors in ``init_parameters(gen)``
from an explicit ``torch.Generator``, so a seed fixes the weights whatever
the device.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from magvit2_pytorch_tpu_torch.ops.norms import AdaptiveRMSNorm, RMSNorm
from magvit2_pytorch_tpu_torch.utils.helpers import exists


def filter_kwargs(module: nn.Module, kwargs: dict) -> dict:
    """The kwargs ``module.forward`` accepts, per key (the JAX package's
    ``_filter_kwargs``, ``ops/basic.py:290-303``): the tokenizer hands
    ``cond``, ``state`` and ``w_blocked`` to every layer from the first
    conditioned one on, and each module takes only what it knows."""
    accepted = _accepted_kwargs(type(module))
    if accepted is None:
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in accepted}


@functools.lru_cache(maxsize=None)
def _accepted_kwargs(cls):
    """The parameter names of ``cls.forward``, or None where it takes
    ``**kwargs``."""
    params = inspect.signature(cls.forward).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return None
    return frozenset(params)


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def torch_default_init_(weight, bias, fan_in: int, gen: torch.Generator):
    """torch's ``kaiming_uniform_(a=sqrt(5))`` default for convs and linears:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias alike."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    uniform_(weight, bound, gen)
    if bias is not None:
        uniform_(bias, bound, gen)


class Linear(nn.Module):
    """``y = x W^T + b`` with W ``(dim_out, dim_in)``; the weights are cast to
    the input's dtype at use, like the JAX package's ``Linear``."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(dim_out)) if bias else None

    def init_parameters(self, gen: torch.Generator):
        torch_default_init_(self.weight, self.bias, self.weight.shape[1], gen)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class GEGLU(nn.Module):
    """``gelu(gate) * x`` over the halves of the channel axis. ``jax.nn.gelu``
    defaults to the tanh approximation, so this one does too."""

    def forward(self, x):
        x, gate = x.chunk(2, dim=-1)
        return F.gelu(gate, approximate='tanh') * x


class FeedForward(nn.Module):
    """(Adaptive)RMSNorm -> 1x1 GEGLU MLP, inner dim ``int(dim * mult * 2 /
    3)`` (reference magvit2_pytorch.py:471-508). With ``dim_cond`` the norm's
    gamma comes from the cond vector ``(B, dim_cond)``, broadcast over the
    middle axes."""

    def __init__(self, dim: int, mult: float = 4.0,
                 dim_cond: Optional[int] = None):
        super().__init__()
        dim_inner = int(dim * mult * 2 / 3)
        self.norm = (AdaptiveRMSNorm(dim, dim_cond) if exists(dim_cond)
                     else RMSNorm(dim))
        self.net = nn.Sequential(
            Linear(dim, dim_inner * 2), GEGLU(), Linear(dim_inner, dim))

    def forward(self, x, cond=None):
        return self.net(self.norm(x, cond))


class TokenShift(nn.Module):
    """The second half of the channels moves one frame later (zero frame in
    front, last frame dropped); ``fn`` runs on the result (reference
    magvit2_pytorch.py:244-254). Input ``(B, T, H, W, C)``.

    ``state`` (a stream's dict keyed by module, ``models/streaming.py``):
    the frame in front is the last shifted frame of the previous chunk,
    zeros for the first (``ops/basic.py:112-140`` of the JAX package).
    ``state`` and the other kwargs go on to ``fn`` where it takes them."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, state: Optional[dict] = None, **kwargs):
        x_main, x_shift = x.chunk(2, dim=-1)
        if state is not None:
            front = state.get(self)
            if front is None:
                front = torch.zeros_like(x_shift[:, :1])
            state[self] = x_shift[:, -1:].clone()
            x_shift = torch.cat((front, x_shift), dim=1)[:, :-1]
            kwargs['state'] = state
        else:
            x_shift = F.pad(x_shift, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
        return self.fn(torch.cat((x_main, x_shift), dim=-1),
                       **filter_kwargs(self.fn, kwargs))


class SqueezeExcite(nn.Module):
    """Global-context squeeze-excite (reference magvit2_pytorch.py:194-240):
    softmax over (h, w) of a 1x1 logit map, in float32, gives each frame a
    weighted mean of its pixels; a leaky-relu MLP and a sigmoid turn that
    into per-channel gates. The last layer starts at weight 0 and bias -10,
    so the block starts near zero output."""

    def __init__(self, dim: int, dim_hidden_min: int = 16,
                 init_bias: float = -10.0):
        super().__init__()
        dim_hidden = max(dim_hidden_min, dim // 2)
        self.init_bias = init_bias
        self.to_k = Linear(dim, 1)
        # reference leaky_relu(p=0.1), magvit2_pytorch.py:117-118
        self.net = nn.Sequential(
            Linear(dim, dim_hidden), nn.LeakyReLU(0.1),
            Linear(dim_hidden, dim), nn.Sigmoid())

    def init_parameters(self, gen: torch.Generator):
        # runs after the children's own init (see init_module_parameters)
        with torch.no_grad():
            self.net[2].weight.zero_()
            self.net[2].bias.fill_(self.init_bias)

    def forward(self, x):
        # x: (..., h, w, c); the context is per frame
        *lead, h, w, c = x.shape
        k = self.to_k(x).float().reshape(*lead, h * w)
        attn = torch.softmax(k, dim=-1).to(x.dtype)
        # (..., 1, hw) @ (..., hw, c): float32 accumulation, one rounding to
        # the working dtype — the JAX einsum with an f32 result then a cast
        context = torch.matmul(attn.unsqueeze(-2), x.reshape(*lead, h * w, c))
        gates = self.net(context.reshape(*lead, 1, 1, c))
        return gates * x


def live_squeeze_excite_(module: nn.Module, gen: torch.Generator):
    """For parity checks, never for users: redraw the output layer
    (``net.2``) of every SqueezeExcite in ``module`` with a kaiming-uniform
    weight and a zero bias, so the gates sit near 0.5. Under the init users
    get, every gate is sigmoid(-10) ~ 4.5e-5 and a ResidualUnit adds ~1e-4
    of its branch to x, so a comparison of two versions would not see the
    unit at all."""
    for m in module.modules():
        if isinstance(m, SqueezeExcite):
            out = m.net[2]
            uniform_(out.weight, math.sqrt(6.0 / out.weight.shape[1]), gen)
            with torch.no_grad():
                out.bias.zero_()


class Residual(nn.Module):
    """``fn(x) + x`` (reference magvit2_pytorch.py:167-174); the kwargs
    ``fn`` takes go on to it."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(x, **filter_kwargs(self.fn, kwargs)) + x


class Sequential(nn.Sequential):
    """``nn.Sequential`` that hands each module the kwargs it takes
    (reference Sequential, magvit2_pytorch.py:159-165; the JAX package's
    ``ops/basic.py:267-276``)."""

    def forward(self, x, **kwargs):
        for module in self:
            x = module(x, **filter_kwargs(module, kwargs))
        return x


def init_module_parameters(module: nn.Module, gen: torch.Generator):
    """Fill every parameter of ``module`` from ``gen``: children first, in
    registration order, then the parent's ``init_parameters`` (which may
    override a child's, as SqueezeExcite and the upsamplers do)."""
    for child in module.children():
        init_module_parameters(child, gen)
    own = getattr(type(module), 'init_parameters', None)
    if own is not None:
        module.init_parameters(gen)
