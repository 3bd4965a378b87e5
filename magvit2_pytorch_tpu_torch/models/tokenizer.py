"""User-facing ``VideoTokenizer`` for serving (PyTorch counterpart of
``magvit2_pytorch_tpu/models/tokenizer.py``).

``encode``, ``decode``, ``tokenize``, ``decode_from_code_indices`` and
``forward(return_codes=..., return_recon=...)`` run under
``torch.inference_mode()`` and take the JAX package's parameters in its
order, ``cond`` (the per-sample ``(B, dim_cond)`` vector of a conditioned
config) included. Tensors are channels-last ``(B, T, H, W, C)``;
``channel_first=True`` takes and returns the reference's
``(B, C, T, H, W)``. Weights are made on the CPU from ``seed`` with the
reference's init distributions, then moved to ``device`` in ``dtype`` (the
working dtype of the whole graph; quantization math stays float32).
``device`` defaults to the card (``'cuda'``) and raises where there is none;
``device='cpu'`` runs every kernel's plain PyTorch version. Chunked causal
streaming is ``models/streaming.py``.

``save`` / ``load`` / ``init_and_load_from`` read and write the JAX
package's checkpoint format: msgpack (``utils/serialization.py``, the port's
own codec) of ``{'version', 'config': TokenizerConfig JSON, 'params': the
JAX params pytree}``, so a checkpoint moves between the two packages either
way. ``load_torch_state_dict`` / ``init_and_load_from_torch`` read the
reference's own ``state_dict`` and ``.pt`` package (``torch_import.py``).
``state_dict`` / ``load_state_dict`` stay the module's torch state.

The loss modes of ``forward`` (``return_loss``, ``return_discr_loss``,
``return_recon_loss_only``, ``train=True``) compute the JAX package's losses
(``training/losses.py``) with autograd on. The discriminator, the
multiscale discriminators and the VGG perceptual net are built when the JAX
package builds them (``use_gan``, ``perceptual_loss_weight``,
``vgg_weights``; without VGG weights an orthogonal fallback, with a
warning), and checkpoints carry ``discr_params`` and ``multiscale_params``
in its layout. Every module here is frozen: ``training/trainer.py`` trains
copies of its own and writes their weights back. int8 calibration is TPU
work and is not here.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from magvit2_pytorch_tpu_torch.models.discriminator import (
    Discriminator, MultiscaleDiscriminator)
from magvit2_pytorch_tpu_torch.models.jax_import import (
    discr_bridge_entries, jax_params_from_state_dict,
    multiscale_bridge_entries, state_dict_from_jax_params,
    state_dict_from_tree, tree_from_state_dict)
from magvit2_pytorch_tpu_torch.models.torch_import import (
    load_torch_tokenizer_state_dict, read_torch_state, torch_config_to_kwargs)
from magvit2_pytorch_tpu_torch.models.tokenizer_module import (
    TokenizerConfig, TokenizerModule)
from magvit2_pytorch_tpu_torch.models.vgg import (
    VGG16Features, orthogonalize_vgg_, read_vgg_weights,
    warn_orthogonal_fallback)
from magvit2_pytorch_tpu_torch.ops.basic import init_module_parameters
from magvit2_pytorch_tpu_torch.utils import serialization
from magvit2_pytorch_tpu_torch.utils.helpers import (
    default, divisible_by, exists)
from magvit2_pytorch_tpu_torch.version import __version__


class VideoTokenizer:
    """Construct with the JAX package's ``TokenizerConfig`` kwargs."""

    def __init__(self, *, seed: int = 0, device=None,
                 dtype: torch.dtype = torch.float32, **kwargs):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'VideoTokenizer runs on the GPU by default and no CUDA '
                    'device is available; pass device="cpu" to run the '
                    'plain PyTorch versions of the kernels on the CPU')
            device = 'cuda'
        self.config = cfg = TokenizerConfig(**kwargs)
        self.device = torch.device(device)
        self.dtype = dtype
        self._rng = torch.Generator().manual_seed(seed)
        gen = torch.Generator().manual_seed(seed)
        self.module = TokenizerModule(cfg)
        init_module_parameters(self.module, gen)

        # the perceptual net (reference magvit2_pytorch.py:1392-1407), when
        # the JAX package builds it (its tokenizer.py:117-150)
        self.use_vgg = (cfg.channels in (1, 3, 4)
                        and cfg.perceptual_loss_weight > 0)
        self._seed = seed
        self._vgg = None
        self.vgg_pretrained = self.use_vgg and exists(cfg.vgg_weights)
        if self.use_vgg and not self.vgg_pretrained:
            warn_orthogonal_fallback()

        # the discriminators, only with use_gan (the JAX package's fix of the
        # reference's quirk #6)
        self.use_gan = cfg.use_gan
        self.has_gan = cfg.use_gan and cfg.adversarial_loss_weight > 0
        self.has_multiscale_gan = (
            cfg.use_gan and cfg.multiscale_adversarial_loss_weight > 0)
        self.discr = None
        self.multiscale_discrs = []
        if cfg.use_gan:
            final_dim = self.module.parsed_layers.final_dim
            self.discr = Discriminator(**default(cfg.discr_kwargs, dict(
                dim=final_dim, image_size=cfg.image_size,
                channels=cfg.channels, max_dim=512)))
            init_module_parameters(self.discr, gen)
            for ms_kwargs in cfg.multiscale_discrs:
                ms_kwargs = {'dim': final_dim, 'image_size': cfg.image_size,
                             'channels': cfg.channels, **ms_kwargs}
                ms = MultiscaleDiscriminator(**ms_kwargs)
                init_module_parameters(ms, gen)
                self.multiscale_discrs.append(ms)
        self.has_multiscale_discrs = (
            self.has_multiscale_gan and len(self.multiscale_discrs) > 0)

        for m in self._modules():
            self._frozen(m)

    def _modules(self):
        """The tokenizer's modules: the generator, then the discriminators
        and VGG where built."""
        return [m for m in (self.module, self.discr, *self.multiscale_discrs,
                            self._vgg) if m is not None]

    @property
    def vgg(self):
        """The perceptual net, built at first use (VGG16 holds 138M weights,
        and its orthogonal fallback takes a QR of each kernel): from
        ``vgg_weights`` where the config names them, else the fallback;
        None without a perceptual loss."""
        if self._vgg is None and self.use_vgg:
            if exists(self.config.vgg_weights):
                self.load_vgg_weights(self.config.vgg_weights)
            else:
                vgg = VGG16Features()
                init_module_parameters(
                    vgg, torch.Generator().manual_seed(self._seed))
                orthogonalize_vgg_(vgg.to(self.device))
                self._vgg = self._frozen(vgg)
        return self._vgg

    def _frozen(self, module):
        module.to(device=self.device, dtype=self.dtype).eval()
        return module.requires_grad_(False)

    # -- derived ---------------------------------------------------------------

    @property
    def image_size(self):
        return self.config.image_size

    @property
    def channels(self):
        return self.config.channels

    @property
    def fmap_size(self):
        return self.module.parsed_layers.fmap_size

    @property
    def time_downsample_factor(self):
        return self.module.parsed_layers.time_downsample_factor

    @property
    def time_padding(self):
        return self.time_downsample_factor - 1

    @property
    def codebook_size(self):
        return self.module.quantizers.codebook_size

    # -- weights ---------------------------------------------------------------

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state, strict: bool = True):
        return self.module.load_state_dict(state, strict=strict)

    def load_torch_state_dict(self, state_or_path, strict: bool = True):
        """Load the reference's (PyTorch) ``VideoTokenizer`` weights: a
        ``state_dict`` mapping, an ``.npz`` of the same keys, or a ``.pth``
        / ``.pt`` file (a bare ``state_dict``, or a package holding it
        under ``model_state_dict`` or ``model``), as the JAX package's
        ``load_torch_state_dict`` takes them. Every generator weight must
        be there; ``strict=True`` also refuses a key this config does not
        have (discriminator and VGG keys and buffers are always skipped)."""
        state = read_torch_state(state_or_path)
        load_torch_tokenizer_state_dict(self.module, state, strict=strict)

    def copy_for_eval(self):
        """A copy for evaluation without discriminator or VGG (reference
        magvit2_pytorch.py:1476-1485; the JAX package's
        ``tokenizer.py:595-623``): its config says so, and it shares this
        tokenizer's module and weights, which the port keeps frozen."""
        clone = object.__new__(VideoTokenizer)
        clone.__dict__.update(self.__dict__)
        clone.config = dataclasses.replace(
            self.config, use_gan=False, perceptual_loss_weight=0.0,
            multiscale_discrs=tuple())
        clone.use_vgg = clone.use_gan = clone.has_gan = False
        clone.has_multiscale_gan = clone.has_multiscale_discrs = False
        clone._vgg, clone.discr, clone.multiscale_discrs = None, None, []
        clone._rng = torch.Generator().manual_seed(0)
        return clone

    def parameters(self):
        """The generator's parameters (no discriminator or VGG)."""
        return self.module.parameters()

    def discr_parameters(self):
        return self.discr.parameters() if exists(self.discr) else iter(())

    def load_vgg_weights(self, path):
        """Load torchvision ``vgg16`` weights (a ``.pth`` state_dict or an
        ``.npz`` of the same keys) into the perceptual net."""
        vgg = VGG16Features()
        vgg.load_state_dict(read_vgg_weights(path))
        self._vgg = self._frozen(vgg)
        self.vgg_pretrained = True

    # -- checkpoints in the JAX package's format -------------------------------

    def save(self, path, overwrite: bool = True):
        """Write a checkpoint that the JAX package's ``VideoTokenizer.load``
        and ``init_and_load_from`` read: the config and the generator's
        weights as the JAX params pytree, in float32."""
        path = Path(path)
        if path.exists() and not overwrite:
            raise FileExistsError(f'{path} already exists')
        pkg = {'version': __version__, 'config': self.config.to_json(),
               'params': jax_params_from_state_dict(self.config,
                                                    self.state_dict())}
        if exists(self.discr):
            pkg['discr_params'] = tree_from_state_dict(
                discr_bridge_entries(self.discr), self.discr.state_dict())
        if self.multiscale_discrs:
            pkg['multiscale_params'] = [
                tree_from_state_dict(multiscale_bridge_entries(ms),
                                     ms.state_dict())
                for ms in self.multiscale_discrs]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(serialization.msgpack_serialize(pkg))

    def load(self, path, strict: bool = True):
        """Load the generator's weights from a checkpoint the JAX package
        (or ``save``) wrote, onto ``self.device`` in ``self.dtype``.

        ``strict=True`` refuses a checkpoint whose params are not exactly
        the tree this config makes (a leaf missing, left over, or of another
        shape); ``strict=False`` loads every leaf that fits and keeps the
        rest. A checkpoint's ``discr_params`` and ``multiscale_params`` load
        into the discriminators where this tokenizer has them (as the JAX
        package's ``load_state_dict`` takes them), by the same rule."""
        self._load_all(_read_checkpoint(path), strict, path)

    def _load_all(self, pkg, strict: bool, path):
        self._load_params(pkg['params'], strict, path)
        if exists(self.discr) and 'discr_params' in pkg:
            _load_tree(self.discr, discr_bridge_entries(self.discr),
                       pkg['discr_params'], strict, path)
        for ms, tree in zip(self.multiscale_discrs,
                            pkg.get('multiscale_params', ())):
            _load_tree(ms, multiscale_bridge_entries(ms), tree, strict, path)

    def _load_params(self, params, strict: bool, path):
        template = _leaves(jax_params_from_state_dict(self.config,
                                                      self.state_dict()))
        given = _leaves(params)
        missing = sorted(set(template) - set(given))
        unused = sorted(set(given) - set(template))
        misfit = sorted(k for k in set(template) & set(given)
                        if np.shape(given[k]) != template[k].shape)
        if strict and (missing or unused or misfit):
            raise ValueError(
                f'checkpoint {path} does not fit this config: missing '
                f'{missing[:5]}, unused {unused[:5]}, other shapes '
                f'{[(k, np.shape(given[k]), template[k].shape) for k in misfit[:5]]}')
        params = {}
        for key, leaf in template.items():
            if key in given and key not in misfit:
                leaf = given[key]
            node = params
            for name in key[:-1]:
                node = node.setdefault(name, {})
            node[key[-1]] = leaf
        self.load_state_dict(state_dict_from_jax_params(self.config, params))

    @classmethod
    def init_and_load_from(cls, path, strict: bool = True, device=None,
                           dtype: torch.dtype = torch.float32):
        """Build the tokenizer a checkpoint's config describes and load its
        weights (``load``); ``device`` as in the constructor."""
        pkg = _read_checkpoint(path)
        if 'config' not in pkg:
            raise ValueError(f'{path}: no model config in this checkpoint')
        config = TokenizerConfig.from_json(pkg['config'])
        tokenizer = cls(device=device, dtype=dtype,
                        **dataclasses.asdict(config))
        tokenizer._load_all(pkg, strict, path)
        return tokenizer

    @classmethod
    def init_and_load_from_torch(cls, path, strict: bool = True,
                                 **overrides):
        """Build the tokenizer a reference ``.pt`` package describes and
        load its weights (the JAX package's ``tokenizer.py:702-730``): the
        pickled constructor kwargs under ``config`` go through
        ``torch_config_to_kwargs``, ``overrides`` go on top (``device`` and
        ``dtype`` among them, as in the constructor), and the state under
        ``model_state_dict`` (or ``model``) through
        ``load_torch_state_dict``. Like the reference's own loader this
        unpickles the file: load only checkpoints you trust."""
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(path)
        # weights_only=False: the config is a pickled locals() that may
        # hold torch objects (nn.Identity, torchvision enums)
        pkg = torch.load(str(path), map_location='cpu', weights_only=False)
        if not isinstance(pkg, dict) or 'config' not in pkg:
            raise ValueError(f'{path}: no model config in this package')
        kwargs = torch_config_to_kwargs(pickle.loads(pkg['config']))
        kwargs.update(overrides)
        tokenizer = cls(**kwargs)
        state = pkg.get('model_state_dict', pkg.get('model'))
        if state is None:
            raise ValueError(f'{path}: no state_dict in this package')
        tokenizer.load_torch_state_dict(state, strict=strict)
        return tokenizer

    # -- core API --------------------------------------------------------------

    def _video(self, video, channel_first: bool):
        video = torch.as_tensor(video, device=self.device).to(self.dtype)
        if channel_first:
            video = video.movedim(1, -1)
        return video

    def _cond(self, cond):
        if cond is None:
            return None
        return torch.as_tensor(cond, device=self.device).to(self.dtype)

    def encode(self, video, quantize: bool = False, cond=None,
               video_contains_first_frame: bool = True,
               channel_first: bool = False):
        """reference magvit2_pytorch.py:1522-1576."""
        with torch.inference_mode():
            video = self._video(video, channel_first)
            latents = self.module.encode(
                video, cond=self._cond(cond),
                video_contains_first_frame=video_contains_first_frame)
            if quantize:
                latents = self.module.quantize(latents).quantized
        return latents.movedim(-1, 1) if channel_first else latents

    def decode(self, quantized, cond=None,
               video_contains_first_frame: bool = True,
               channel_first: bool = False):
        """reference magvit2_pytorch.py:1597-1649."""
        with torch.inference_mode():
            quantized = self._video(quantized, channel_first)
            video = self.module.decode(
                quantized, cond=self._cond(cond),
                video_contains_first_frame=video_contains_first_frame)
        return video.movedim(-1, 1) if channel_first else video

    def decode_from_code_indices(self, codes, cond=None,
                                 video_contains_first_frame: bool = True,
                                 channel_first: bool = False):
        """Flattened ``(b, f*h*w)`` or shaped ``(b, f, h, w)`` integer codes
        (reference magvit2_pytorch.py:1578-1595)."""
        codes = torch.as_tensor(codes, device=self.device)
        assert not codes.is_floating_point(), 'codes must be integers'
        if codes.ndim == 2:
            fmap = self.fmap_size
            assert divisible_by(codes.shape[-1], fmap * fmap), (
                f'flattened video ids must have a length ({codes.shape[-1]}) '
                f'divisible by fmap size ({fmap}) squared ({fmap * fmap})')
            codes = codes.reshape(codes.shape[0], -1, fmap, fmap)
        with torch.inference_mode():
            quantized = self.module.indices_to_codes(codes.long(), self.dtype)
        return self.decode(quantized, cond=cond,
                           video_contains_first_frame=video_contains_first_frame,
                           channel_first=channel_first)

    def tokenize(self, video, **kwargs):
        """reference magvit2_pytorch.py:1651-1654."""
        return self.forward(video, return_codes=True, train=False, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, video_or_images, cond=None, return_loss: bool = False,
                return_codes: bool = False, return_recon: bool = False,
                return_discr_loss: bool = False,
                return_recon_loss_only: bool = False,
                apply_gradient_penalty: bool = True,
                video_contains_first_frame: bool = True,
                adversarial_loss_weight: Optional[float] = None,
                multiscale_adversarial_loss_weight: Optional[float] = None,
                rng: Optional[torch.Generator] = None,
                train: Optional[bool] = None, channel_first: bool = False):
        """One method, five modes (reference forward,
        magvit2_pytorch.py:1656-1896; the JAX package's
        ``tokenizer.py:420-545``), its parameters in the JAX package's
        order: recon, codes, or both; ``return_recon_loss_only`` ->
        ``(recon_loss, recon)``; ``return_loss`` -> ``(total,
        LossBreakdown)``; ``return_discr_loss`` -> ``(total,
        DiscrLossBreakdown)``. ``rng`` (a ``torch.Generator``) draws the
        loss modes' frame picks and the attention dropout; without one the
        tokenizer's own generator, seeded from ``seed``, draws them. The
        loss modes run with autograd on, on this tokenizer's frozen
        modules."""
        from magvit2_pytorch_tpu_torch.training import losses

        cfg = self.config
        adversarial_loss_weight = default(adversarial_loss_weight,
                                          cfg.adversarial_loss_weight)
        multiscale_adversarial_loss_weight = default(
            multiscale_adversarial_loss_weight,
            cfg.multiscale_adversarial_loss_weight)
        assert (int(return_loss) + int(return_codes)
                + int(return_discr_loss)) <= 1

        video = self._video(video_or_images, channel_first)
        assert video.ndim in (4, 5)
        is_image = video.ndim == 4
        if is_image:
            video = video[:, None]
            video_contains_first_frame = True
        assert video.shape[2] == video.shape[3] == self.image_size
        b, frames = video.shape[:2]
        assert divisible_by(
            frames - int(video_contains_first_frame),
            self.time_downsample_factor), (
            f'number of frames {frames} minus first frame must be divisible '
            f'by the total time downsample factor '
            f'{self.time_downsample_factor}')
        train = default(train, return_loss or return_discr_loss)
        rng = default(rng, self._rng)
        vcff = video_contains_first_frame

        if return_discr_loss:
            assert self.has_gan and exists(self.discr)
            with torch.enable_grad():
                return losses.discriminator_loss(
                    self.module, self.discr, video,
                    losses.draw_frames(b, frames, rng),
                    multiscale=tuple(self.multiscale_discrs),
                    cond=self._cond(cond), video_contains_first_frame=vcff,
                    apply_gradient_penalty=apply_gradient_penalty,
                    grad_penalty_loss_weight=cfg.grad_penalty_loss_weight,
                    multiscale_adversarial_loss_weight=(
                        multiscale_adversarial_loss_weight))

        if return_recon_loss_only:
            with torch.inference_mode():
                recon, _ = self.module(video, cond=self._cond(cond),
                                       video_contains_first_frame=vcff)
                recon_loss = ((video.float() - recon.float()) ** 2).mean()
            return recon_loss, self._out(recon, is_image, channel_first)

        if return_loss:
            picks = losses.draw_tokenizer_loss(b, frames, rng)
            with torch.enable_grad():
                total, breakdown, _ = losses.tokenizer_loss(
                    self.module, video, picks, discr=self.discr,
                    multiscale=tuple(self.multiscale_discrs), vgg=self.vgg,
                    cond=self._cond(cond), video_contains_first_frame=vcff,
                    train=train, use_vgg=self.use_vgg,
                    has_gan=self.has_gan and adversarial_loss_weight > 0,
                    has_multiscale_gan=(
                        self.has_multiscale_discrs
                        and multiscale_adversarial_loss_weight > 0),
                    perceptual_loss_weight=cfg.perceptual_loss_weight,
                    quantizer_aux_loss_weight=cfg.quantizer_aux_loss_weight,
                    adversarial_loss_weight=adversarial_loss_weight,
                    multiscale_adversarial_loss_weight=(
                        multiscale_adversarial_loss_weight),
                    generator=rng)
            return total, breakdown

        with torch.inference_mode():
            cond = self._cond(cond)
            qout = self.module.quantize(self.module.encode(
                video, cond=cond, video_contains_first_frame=vcff),
                train=bool(train))
            if return_codes and not return_recon:
                # codes only: the reference returns before decoding too
                return qout.indices
            recon = self.module.decode(qout.quantized, cond=cond,
                                       video_contains_first_frame=vcff)
        recon = self._out(recon, is_image, channel_first)
        if return_codes:
            return qout.indices, recon
        return recon

    @staticmethod
    def _out(recon, is_image: bool, channel_first: bool):
        if is_image:
            recon = recon[:, 0]
        return recon.movedim(-1, 1) if channel_first else recon


class MagViT2:
    """Identity stub exported as the reference and the JAX package export
    it (``tokenizer.py:745-755``): the reference's planned MaskGit stage was
    never built (magvit2_pytorch.py:1900-1905)."""

    def __init__(self):
        pass

    def __call__(self, x):
        return x

    forward = __call__


def _read_checkpoint(path) -> dict:
    pkg = serialization.msgpack_restore(Path(path).read_bytes())
    if not isinstance(pkg, dict) or 'params' not in pkg:
        raise ValueError(f'{path} is not a tokenizer checkpoint')
    return pkg


def _load_tree(module, entries, tree, strict: bool, path):
    """Load a JAX params tree into ``module`` through its bridge table,
    under the rule of ``VideoTokenizer._load_params``."""
    template = {p: tuple(module.state_dict()[k].shape) for k, p, _ in entries}
    given = _leaves(tree)
    missing = sorted(set(template) - set(given))
    unused = sorted(set(given) - set(template))
    if strict and (missing or unused):
        raise ValueError(f'checkpoint {path} does not fit this '
                         f'discriminator: missing {missing[:5]}, unused '
                         f'{unused[:5]}')
    fits = [e for e in entries if e[1] in given]
    state = state_dict_from_tree(fits, tree)
    state = {k: v for k, v in state.items()
             if tuple(v.shape) == tuple(module.state_dict()[k].shape)}
    if strict and len(state) != len(entries):
        raise ValueError(f'checkpoint {path}: discriminator weights of '
                         'other shapes')
    module.load_state_dict(state, strict=False)


def _leaves(tree, prefix=()) -> dict:
    """A nested dict's leaves by key path."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out
