"""``VideoTokenizerTrainer``: the GAN training loop (PyTorch counterpart of
``magvit2_pytorch_tpu/training/trainer.py``; reference trainer.py:59-538).

Each ``train_step`` is a generator step, then (once the discriminator has
started) a discriminator step, as the JAX package's two jitted steps are:

- generator: ``grad_accum_every`` micro-batches, each ``tokenizer_loss``
  differentiated for the generator's parameters alone; the gradients summed
  in float32 and divided by the count; one optimizer update; the EMA update;
  the codebook canaries (mean bit entropy, cumulative unique codes, the seen
  mask updated after every micro-batch);
- discriminator: the same over ``discriminator_loss``, with R1 every
  ``apply_gradient_penalty_every`` steps, one optimizer for each
  discriminator (the main one and each multiscale one), so each is clipped
  by its own norm.

``grad_accum_split=False`` fetches the step's micro-batches together and
uploads them in one copy; ``True`` fetches and uploads one a micro-step.
The math, the frame picks and the summation order are the same.

Precision: the trainer trains float32 copies of the tokenizer's generator
and discriminators (``VideoTokenizer`` keeps its own frozen) and writes
their weights back into the tokenizer after every step, as the JAX trainer
updates ``model.params``. The policy casts the batch to the compute dtype
(bf16 on the card, float32 on the CPU by default) and the VGG once; every
op casts its float32 parameters to its input's dtype, as the JAX package's
ops do, so the gradients land on the float32 parameters through those
casts. The updates are in place under ``torch.no_grad()``.

Randomness: every micro-step draws its frame picks and attention dropout
from a ``torch.Generator`` seeded from ``(seed, step, generator or
discriminator, micro-batch)``, so both accumulation modes and a resumed run
draw the same.

Several processes (``parallel/``): one rank a device, laid out by a
``mesh`` (default: data parallel over every rank). ``batch_size`` is global;
each rank loads its contiguous rows of it, and a step gives what the
one-process step gives on the global batch, as the JAX package's SPMD step
does:

- after the accumulation loop, one all-reduce a module (the generator, each
  discriminator) of its gradients in one flat float32 buffer, averaged over
  the batch axes; no gradient moves inside a micro-step, and the optimizer's
  non-finite skip and clip read the reduced gradients, so every rank takes
  the same update;
- the terms that read the whole batch are global (``parallel/batch.py``):
  the frame picks and dropout are drawn for the global batch and cut, the
  LFQ codebook entropy and the entropy canary sum their rows over the ranks,
  the adaptive adversarial weight takes the norms of the averaged
  gradients; the step metrics are averaged and the codes seen OR-ed;
- rank 0 prints, logs, writes the sample GIF and saves, behind a barrier;
  ``load`` and ``maybe_auto_resume`` run on every rank; ``valid_step``
  averages over the ranks.

``tensor_parallel=True`` with a ``'tensor'`` axis cuts the generator's
master weights and Adam moments over it, on the JAX package's rule
(``_TensorShards``); the ranks of a tensor group load the same rows and run
the whole forward, so the update is the data-parallel one.

``save`` / ``load`` write the same state as the JAX trainer in the port's
own format (``torch.save``): the JAX trainer's Orbax checkpoints need
tensorstore and are not read. ``load_torch_checkpoint`` resumes a reference
trainer ``.pt`` package.
"""

from __future__ import annotations

import copy
import math
import os
import time
import warnings
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from magvit2_pytorch_tpu_torch.data.datasets import (
    DataLoader, ImageDataset, VideoDataset, cycle, normalize_u8,
    random_split)
from magvit2_pytorch_tpu_torch.data.video_io import video_array_to_gif
from magvit2_pytorch_tpu_torch.models.jax_import import (
    bridge_entries, discr_bridge_entries, multiscale_bridge_entries)
from magvit2_pytorch_tpu_torch.parallel import (
    BatchShard, batch_axes, batch_index, data_parallel_extent,
    is_main_process, make_mesh, process_count, replicate, sharded_batch,
    shard_params_tensor_parallel, tensor_parallel_shardings)
from magvit2_pytorch_tpu_torch.training.ema import EMAConfig, ema_update
from magvit2_pytorch_tpu_torch.training.losses import (
    codebook_size_of, discriminator_loss, draw_frames, draw_tokenizer_loss,
    tokenizer_loss)
from magvit2_pytorch_tpu_torch.training.metrics import codes_hit, psnr_from_mse
from magvit2_pytorch_tpu_torch.training.optimizer import (
    get_optimizer, wd_mask)
from magvit2_pytorch_tpu_torch.utils.helpers import default, exists
from magvit2_pytorch_tpu_torch.utils.precision import Policy, default_policy

GEN_METRICS = ('recon_loss', 'perceptual_loss', 'adversarial_gen_loss',
               'adaptive_adversarial_weight', 'lfq_aux_loss',
               'multiscale_gen_loss')
DISCR_METRICS = ('total_discr_loss', 'discr_loss', 'gradient_penalty',
                 'multiscale_discr_loss')


def _trainable(module, device):
    """A float32 copy of ``module`` on ``device`` whose parameters train."""
    out = copy.deepcopy(module).to(device=device, dtype=torch.float32)
    return out.requires_grad_(True)


def _flat_zeros(params):
    """Zeroed float32 gradients for ``params``: views into one flat buffer,
    which one collective reduces. Returns ``(buffer, views)``."""
    flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                       device=params[0].device)
    views, offset = [], 0
    for p in params:
        views.append(flat[offset:offset + p.numel()].view(p.shape))
        offset += p.numel()
    return flat, views


def _accumulate(grads, total, params):
    """Add ``d total / d params`` into ``grads``; a parameter the loss does
    not reach (the final encoder norm unless applied) gets 0, as under
    ``jax.grad``."""
    for acc, g in zip(grads, torch.autograd.grad(total, params,
                                                 allow_unused=True)):
        if g is not None:
            acc.add_(g)


def _collective(name: str, fallback: str):
    """A ``torch.distributed`` collective under its current name."""
    return getattr(dist, name, None) or getattr(dist, fallback)


class _TensorShards:
    """The generator cut over the mesh's ``'tensor'`` axis (the JAX
    package's ``tensor_parallel_shardings``): each rank of a tensor group
    keeps a master copy of its part of every cut parameter, and the
    optimizer's moments of it; the module holds the whole parameters for
    the forward. After the backward, :meth:`scatter_grads` reduce-scatters
    the (data-averaged) gradients to the parts, averaged over the tensor
    axis; after the update, :meth:`gather` all-gathers the parts into the
    module's parameters, before the EMA and the next forward. One flat
    buffer a collective."""

    def __init__(self, module, mesh, entries):
        self.full = dict(module.named_parameters())
        self.group = mesh.group(('tensor',))
        self.tp, self.k = mesh.shape['tensor'], mesh.coordinate['tensor']
        self.dims = {n: d for n, d in tensor_parallel_shardings(
            self.full, mesh, entries=entries).items() if d is not None}
        self.master = shard_params_tensor_parallel(self.full, mesh,
                                                   entries=entries)
        self.size = sum(self.master[n].numel() for n in self.dims)

    def cut(self, tensors: dict) -> dict:
        """Whole tensors by parameter name -> this rank's parts."""
        return {n: (t.chunk(self.tp, self.dims[n])[self.k] if n in self.dims
                    else t) for n, t in tensors.items()}

    def scatter_grads(self, grads: dict) -> dict:
        if not self.dims:
            return grads
        rows = grads[next(iter(self.dims))].new_empty(self.tp, self.size)
        offset = 0
        for n, d in self.dims.items():
            for r, part in enumerate(grads[n].chunk(self.tp, d)):
                rows[r, offset:offset + part.numel()] = part.reshape(-1)
            offset += part.numel()
        mine = rows.new_empty(self.size)
        _collective('reduce_scatter_single', 'reduce_scatter_tensor')(
            mine, rows.reshape(-1), group=self.group)
        mine /= self.tp
        out, offset = dict(grads), 0
        for n in self.dims:
            part = self.master[n]
            out[n] = mine[offset:offset + part.numel()].view(part.shape)
            offset += part.numel()
        return out

    def whole(self, parts: dict) -> dict:
        """This rank's parts -> the whole tensors (every rank calls it)."""
        if not self.dims:
            return dict(parts)
        mine = torch.cat([parts[n].reshape(-1) for n in self.dims])
        rows = mine.new_empty(self.tp * self.size)
        _collective('all_gather_single', 'all_gather_into_tensor')(
            rows, mine, group=self.group)
        rows = rows.view(self.tp, self.size)
        out, offset = dict(parts), 0
        for n, d in self.dims.items():
            part = parts[n]
            out[n] = torch.cat([rows[r, offset:offset + part.numel()].view(
                part.shape) for r in range(self.tp)], d)
            offset += part.numel()
        return out

    @torch.no_grad()
    def gather(self):
        for n, t in self.whole({n: self.master[n] for n in self.dims}).items():
            self.full[n].copy_(t)

    @torch.no_grad()
    def scatter_params(self):
        """The masters from the module's (loaded) parameters."""
        for n, t in self.cut({n: self.full[n] for n in self.dims}).items():
            self.master[n].copy_(t)


class VideoTokenizerTrainer:

    def __init__(
        self,
        model,
        *,
        batch_size: int,
        num_train_steps: int,
        learning_rate: float = 1e-5,
        grad_accum_every: int = 1,
        grad_accum_split: bool = False,
        apply_gradient_penalty_every: int = 4,
        max_grad_norm: Optional[float] = None,
        dataset=None,
        valid_dataset=None,
        dataset_folder: Optional[str] = None,
        dataset_type: str = 'videos',
        checkpoints_folder: str = './checkpoints',
        results_folder: str = './results',
        random_split_seed: int = 42,
        valid_frac: float = 0.05,
        validate_every_step: int = 100,
        checkpoint_every_step: int = 100,
        num_frames: int = 17,
        use_wandb_tracking: bool = False,
        discr_start_after_step: int = 0,
        warmup_steps: int = 1000,
        scheduler=None,
        optimizer_kwargs: Optional[dict] = None,
        ema_kwargs: Optional[dict] = None,
        dataset_kwargs: Optional[dict] = None,
        mesh=None,
        policy: Optional[Policy] = None,
        tensor_parallel: bool = False,
        seed: int = 0,
        profile_dir: Optional[str] = None,
        log_every: int = 1,
    ):
        # the int8 conv path is inference-only (round() has no gradient)
        if os.environ.get('MAGVIT2_TPU_INT8_CONV', '') == '1':
            raise RuntimeError(
                'MAGVIT2_TPU_INT8_CONV=1 is an inference-only path (round() '
                'kills conv gradients); unset it before constructing '
                'VideoTokenizerTrainer')
        self.model = model
        self.device = model.device
        self.batch_size = batch_size
        self.num_train_steps = num_train_steps
        self.grad_accum_every = grad_accum_every
        self.grad_accum_split = bool(grad_accum_split) and grad_accum_every > 1
        self.apply_gradient_penalty_every = apply_gradient_penalty_every
        self.discr_start_after_step = discr_start_after_step
        self.validate_every_step = validate_every_step
        self.checkpoint_every_step = checkpoint_every_step
        self.use_wandb_tracking = use_wandb_tracking
        self.log_every = max(1, log_every)
        self.policy = default(policy, default_policy(self.device))
        self.profile_dir = profile_dir
        self.seed = seed

        # the mesh: batch_size is global, each rank loads its rows of it
        self.mesh = mesh if exists(mesh) else make_mesh()
        self._n_data = n_data = data_parallel_extent(self.mesh)
        assert batch_size % n_data == 0, (
            f'batch_size {batch_size} must divide the data-parallel extent '
            f'{n_data}')
        self._n_proc = process_count()
        assert batch_size % self._n_proc == 0, (
            f'global batch_size {batch_size} must divide the process count '
            f'{self._n_proc}')
        self._batch_group = self.mesh.group(batch_axes(self.mesh))
        self._shard = (BatchShard(self._batch_group, batch_index(self.mesh),
                                  n_data) if n_data > 1 else None)
        self.allreduce_bytes = 0      # the gradient all-reduces' payload

        # datasets (reference trainer.py:115-149)
        dataset_kwargs = dict(default(dataset_kwargs, {}))
        dataset_kwargs['channels'] = model.channels
        dataset_kwargs.setdefault('output_dtype', 'uint8')
        if not exists(dataset):
            assert exists(dataset_folder)
            if dataset_type == 'videos':
                dataset = VideoDataset(dataset_folder,
                                       image_size=model.image_size,
                                       num_frames=num_frames,
                                       **dataset_kwargs)
            else:
                dataset = ImageDataset(dataset_folder,
                                       image_size=model.image_size,
                                       **dataset_kwargs)
        assert 0 <= valid_frac < 1
        if not exists(valid_dataset):
            if valid_frac > 0:
                train_size = int((1 - valid_frac) * len(dataset))
                dataset, valid_dataset = random_split(
                    dataset, [train_size, len(dataset) - train_size],
                    seed=random_split_seed)
                self.print(f'training with dataset of {len(dataset)} samples '
                           f'and validating with randomly splitted '
                           f'{len(valid_dataset)} samples')
            else:
                valid_dataset = dataset
                self.print(f'training with shared training and valid dataset '
                           f'of {len(dataset)} samples')
        self.dataset, self.valid_dataset = dataset, valid_dataset
        # the ranks of one batch shard load the same rows
        shards = dict(num_shards=n_data, shard_id=batch_index(self.mesh))
        self.dataloader = DataLoader(dataset, batch_size=batch_size,
                                     shuffle=True, drop_last=True, **shards)
        # the global validation batch divides the data-parallel extent and
        # the process count; a split too small for that skips validation
        # (every rank computes the same size, so all skip together)
        vbs = min(batch_size, len(valid_dataset))
        if self._n_proc > 1:
            vbs -= vbs % math.lcm(n_data, self._n_proc)
        self._valid_enabled = vbs > 0
        if not self._valid_enabled:
            self.print(f'valid split of {len(valid_dataset)} samples is '
                       f'smaller than the data-parallel extent {n_data} — '
                       'validation disabled')
        self.valid_dataloader = DataLoader(
            valid_dataset, batch_size=vbs, shuffle=True, drop_last=True,
            **shards) if self._valid_enabled else None

        # the trained modules: float32 copies (the tokenizer keeps its own)
        self.module = _trainable(model.module, self.device)
        self.ema_module = copy.deepcopy(self.module).requires_grad_(False)
        self.has_gan = model.use_gan and exists(model.discr)
        self.discr = (_trainable(model.discr, self.device)
                      if self.has_gan else None)
        self.multiscale = [_trainable(ms, self.device)
                           for ms in model.multiscale_discrs
                           ] if self.has_gan else []
        # the perceptual net is value-only: held once in the compute dtype
        self.vgg = (copy.deepcopy(model.vgg).to(
            device=self.device, dtype=self.policy.compute_dtype)
            if exists(model.vgg) else None)
        if self.mesh.size > 1:
            # every rank starts from rank 0's weights
            replicate([self.module, self.ema_module, self.discr,
                       *self.multiscale, self.vgg], self.mesh)
            self._write_back()

        # optimizers (reference trainer.py:154-171): warmup and clip in the
        # chain; one optimizer per discriminator
        opt_kwargs = dict(lr=learning_rate, warmup_steps=warmup_steps,
                          max_grad_norm=max_grad_norm, scheduler=scheduler,
                          **default(optimizer_kwargs, {}))
        entries = bridge_entries(model.config)
        # tensor parallelism cuts the generator's state over 'tensor'
        self._tp = (_TensorShards(self.module, self.mesh, entries)
                    if tensor_parallel and self.mesh.shape['tensor'] > 1
                    else None)
        self.optimizer = self._optimizer(self.module, entries, opt_kwargs)
        if self._tp:
            self.optimizer.shard(self._tp.group, self._tp.dims)
        self.discr_optimizers = []
        if self.has_gan:
            self.discr_optimizers = [
                self._optimizer(self.discr, discr_bridge_entries(self.discr),
                                opt_kwargs)] + [
                self._optimizer(ms, multiscale_bridge_entries(ms), opt_kwargs)
                for ms in self.multiscale]

        self.ema_config = EMAConfig(**default(ema_kwargs, {}))

        self.checkpoints_folder = Path(checkpoints_folder)
        self.results_folder = Path(results_folder)
        self.checkpoints_folder.mkdir(parents=True, exist_ok=True)
        self.results_folder.mkdir(parents=True, exist_ok=True)

        self.step = 0
        self.codebook_size = codebook_size_of(model.config)
        self._code_seen = torch.zeros(self.codebook_size, dtype=torch.bool,
                                      device=self.device)
        self._wandb_run = None

    def _optimizer(self, module, entries, kwargs):
        params = dict(module.named_parameters())
        mask = wd_mask(params, entries)
        if module is self.module and self._tp:
            params = self._tp.master
        return get_optimizer(params, mask=mask, **kwargs)

    # -- plumbing ------------------------------------------------------------

    @property
    def is_main(self) -> bool:
        return is_main_process()

    def print(self, msg):
        if self.is_main:
            print(msg)

    def log(self, **data):
        if exists(self._wandb_run) and self.is_main:
            self._wandb_run.log(data, step=self.step)

    def _barrier(self):
        if self.mesh.size > 1:
            dist.barrier()

    def _rows(self, picks):
        """This rank's rows of draws made for the global batch."""
        if self._shard is None:
            return picks
        n = picks.shape[0] // self._shard.count
        return picks[self._shard.index * n:(self._shard.index + 1) * n]

    def _global_rows(self, batch) -> int:
        return batch.shape[0] * (self._shard.count if self._shard else 1)

    def _batch_mean(self, x):
        """``x`` averaged over the batch axes in place, in one all-reduce
        (unchanged without a group)."""
        if self._batch_group is not None:
            dist.all_reduce(x, group=self._batch_group)
            if self._n_data > 1:
                x.div_(self._n_data)
        return x

    def _reduce_grads(self, flats):
        """Average each flat gradient buffer over the batch axes: one
        all-reduce a module."""
        if self._batch_group is None:
            return
        for flat in flats:
            self._batch_mean(flat)
            self.allreduce_bytes += flat.numel() * flat.element_size()

    def _reduce_metrics(self, sums: dict) -> dict:
        """The micro-batch sums averaged over the batch axes, in one
        all-reduce."""
        if self._batch_group is None:
            return sums
        keys = list(sums)
        packed = self._batch_mean(torch.stack([sums[k].float()
                                               for k in keys]))
        return dict(zip(keys, packed.unbind()))

    def _reduce_seen(self, seen):
        """A mask of the codes seen, OR-ed over the batch axes (an
        all-reduce MAX)."""
        if self._batch_group is None:
            return seen
        seen = seen.to(torch.uint8)
        dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=self._batch_group)
        return seen.bool()

    @contextmanager
    def trackers(self, project_name: str, run_name: Optional[str] = None,
                 hps: Optional[dict] = None):
        """wandb tracking context (reference trainer.py:241-257)."""
        assert self.use_wandb_tracking
        import wandb
        self._wandb_run = wandb.init(project=project_name, name=run_name,
                                     config=hps)
        try:
            yield
        finally:
            self._wandb_run.finish()
            self._wandb_run = None

    @property
    def ema_tokenizer(self):
        """An evaluation copy of the tokenizer on the EMA weights (reference
        trainer.py:284-286)."""
        ema = self.model.copy_for_eval()
        ema.module = self.ema_module
        return ema

    def tokenize(self, *args, **kwargs):
        return self.ema_tokenizer.tokenize(*args, **kwargs)

    def _generator(self, step: int, part: int, micro: int):
        """The draws of one micro-step: part 0 the generator's, 1 the
        discriminator's."""
        seed = np.random.SeedSequence([self.seed, step, part, micro])
        return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))

    def _to_device(self, batch, dtype):
        """A host batch on the card in ``dtype``; uint8 normalized there;
        images lifted to one-frame videos."""
        x = torch.as_tensor(np.asarray(batch)).to(self.device)
        if x.dtype == torch.uint8:
            x = normalize_u8(x)
        return x.to(dtype)

    def _next_batches(self, dl_iter):
        """The step's micro-batches: one stacked upload (monolithic) or a
        generator of one upload each (split)."""
        dt = self.policy.compute_dtype

        def lift(x):
            return x[:, None] if x.ndim == 4 else x

        if self.grad_accum_split:
            return (lift(self._to_device(next(dl_iter)[0], dt))
                    for _ in range(self.grad_accum_every))
        stacked = np.stack([np.asarray(next(dl_iter)[0])
                            for _ in range(self.grad_accum_every)])
        return list(lift(x) for x in self._to_device(stacked, dt))

    # -- the two steps ---------------------------------------------------------

    def _gen_step(self, train_adversarially: bool, dl_iter, step: int):
        model, cfg = self.model, self.model.config
        adv_w = cfg.adversarial_loss_weight if train_adversarially else 0.0
        ms_adv_w = (cfg.multiscale_adversarial_loss_weight
                    if train_adversarially else 0.0)
        has_gan = self.has_gan and train_adversarially and adv_w > 0
        has_ms = (model.has_multiscale_discrs and train_adversarially
                  and ms_adv_w > 0)
        params = list(self.module.parameters())
        flat, grads = _flat_zeros(params)
        sums = {k: torch.zeros((), device=self.device) for k in GEN_METRICS}
        if not cfg.use_fsq:
            sums['mean_bit_entropy'] = torch.zeros((), device=self.device)
        loss_sum = torch.zeros((), device=self.device)
        for i, batch in enumerate(self._next_batches(dl_iter)):
            gen = self._generator(step, 0, i)
            picks = draw_tokenizer_loss(self._global_rows(batch),
                                        batch.shape[1], gen)
            with sharded_batch(self._shard):
                total, bd, _ = tokenizer_loss(
                    self.module, batch,
                    {k: self._rows(v) for k, v in picks.items()},
                    discr=self.discr, multiscale=tuple(self.multiscale),
                    vgg=self.vgg, train=True, use_vgg=model.use_vgg,
                    has_gan=has_gan, has_multiscale_gan=has_ms,
                    perceptual_loss_weight=cfg.perceptual_loss_weight,
                    quantizer_aux_loss_weight=cfg.quantizer_aux_loss_weight,
                    adversarial_loss_weight=adv_w,
                    multiscale_adversarial_loss_weight=ms_adv_w,
                    generator=gen)
                _accumulate(grads, total, params)
            with torch.no_grad():
                loss_sum += total
                ms = bd.multiscale_gen_losses
                micro = {
                    'recon_loss': bd.recon_loss,
                    'perceptual_loss': bd.perceptual_loss,
                    'adversarial_gen_loss': bd.adversarial_gen_loss,
                    'adaptive_adversarial_weight':
                        bd.adaptive_adversarial_weight,
                    'lfq_aux_loss': bd.lfq_aux_loss,
                    'multiscale_gen_loss': (sum(ms) / len(ms) if ms
                                            else torch.zeros_like(total)),
                }
                if exists(bd.mean_bit_entropy):
                    micro['mean_bit_entropy'] = bd.mean_bit_entropy
                for k, v in micro.items():
                    sums[k] += v
                self._code_seen |= bd.codes_seen
        accum = self.grad_accum_every
        self._reduce_grads([flat])
        grads = {n: g / accum for (n, _), g in zip(
            self.module.named_parameters(), grads)}
        if self._tp:
            grads = self._tp.scatter_grads(grads)
        self.optimizer.step(grads)
        if self._tp:
            self._tp.gather()
        ema_update(self.ema_module.parameters(), self.module.parameters(),
                   step, self.ema_config)
        sums = self._reduce_metrics({**sums, 'total_loss': loss_sum})
        self._code_seen.copy_(self._reduce_seen(self._code_seen))
        metrics = {k: v / accum for k, v in sums.items()}
        metrics['codebook_unique_codes'] = self._code_seen.sum()
        return metrics

    def _discr_step(self, apply_gradient_penalty: bool, dl_iter, step: int):
        cfg = self.model.config
        nets = [self.discr, *self.multiscale]
        params = [p for n in nets for p in n.parameters()]
        bufs = [_flat_zeros(list(n.parameters())) for n in nets]
        grads = [g for _, views in bufs for g in views]
        sums = {k: torch.zeros((), device=self.device) for k in DISCR_METRICS}
        for i, batch in enumerate(self._next_batches(dl_iter)):
            gen = self._generator(step, 1, i)
            picks = draw_frames(self._global_rows(batch), batch.shape[1], gen)
            with sharded_batch(self._shard):
                total, bd = discriminator_loss(
                    self.module, self.discr, batch, self._rows(picks),
                    multiscale=tuple(self.multiscale),
                    apply_gradient_penalty=apply_gradient_penalty,
                    grad_penalty_loss_weight=cfg.grad_penalty_loss_weight,
                    multiscale_adversarial_loss_weight=(
                        cfg.multiscale_adversarial_loss_weight))
                _accumulate(grads, total, params)
            with torch.no_grad():
                ms = bd.multiscale_discr_losses
                micro = {'total_discr_loss': total,
                         'discr_loss': bd.discr_loss,
                         'gradient_penalty': bd.gradient_penalty,
                         'multiscale_discr_loss': (sum(ms) / len(ms) if ms
                                                   else torch.zeros_like(total))}
                for k, v in micro.items():
                    sums[k] += v.detach()
        accum = self.grad_accum_every
        self._reduce_grads([f for f, _ in bufs])
        for net, opt, (_, views) in zip(nets, self.discr_optimizers, bufs):
            opt.step({n: g / accum for (n, _), g in zip(
                net.named_parameters(), views)})
        sums = self._reduce_metrics(sums)
        return {k: v / accum for k, v in sums.items()}

    @torch.no_grad()
    def _write_back(self):
        """The trained weights into the tokenizer the trainer was given (in
        place: the version counters move, so the fused ResidualUnit's
        re-lay cache sees the change)."""
        pairs = [(self.model.module, self.module)]
        if self.has_gan:
            pairs += [(self.model.discr, self.discr),
                      *zip(self.model.multiscale_discrs, self.multiscale)]
        for dst, src in pairs:
            for d, s in zip(dst.parameters(), src.parameters()):
                d.copy_(s)

    def train_step(self, dl_iter):
        step = self.step
        train_adversarially = (
            self.has_gan and (step + 1) > self.discr_start_after_step)
        metrics = self._gen_step(train_adversarially, dl_iter, step)
        discr_metrics, apply_gp = None, False
        if train_adversarially:
            apply_gp = not (step % self.apply_gradient_penalty_every)
            discr_metrics = self._discr_step(apply_gp, dl_iter, step)
        self._write_back()
        self.step += 1
        return self._emit_metrics(step, metrics, discr_metrics, apply_gp)

    def _emit_metrics(self, step, metrics, discr_metrics=None,
                      apply_gp: bool = False):
        """Metrics to the host and the log every ``log_every`` steps (a
        ``float()`` waits for the card); other steps return the device
        tensors."""
        if step % self.log_every:
            out = dict(metrics)
            if exists(discr_metrics):
                out.update(discr_metrics)
            return out
        metrics = {k: float(v) for k, v in metrics.items()}
        self.log(**metrics)
        self.print(f"recon loss: {metrics['recon_loss']:.3f}")
        if exists(discr_metrics):
            discr_metrics = {k: float(v) for k, v in discr_metrics.items()}
            self.log(discr_loss=discr_metrics['discr_loss'])
            if apply_gp:
                self.log(gradient_penalty=discr_metrics['gradient_penalty'])
            self.print(f"discr loss: {discr_metrics['discr_loss']:.3f}")
            metrics = {**metrics, **discr_metrics}
        return metrics

    def valid_step(self, dl_iter, save_recons: bool = True,
                   num_save_recons: int = 1):
        """Validation recon loss of the online and the EMA model, PSNR and
        codebook utilization over every micro-batch, and a real | recon GIF
        grid (reference trainer.py:452-510). Every rank runs it on its rows
        of the global batch: the losses and each micro-batch's squared
        error are averaged over the ranks and the codes hit are OR-ed, so
        the numbers are the global batch's; rank 0 writes the GIF."""
        model, ema_model = self.model, self.ema_tokenizer
        valid_videos, recon_videos, readings, codes = [], [], [], []
        for _ in range(self.grad_accum_every):
            video = self._to_device(next(dl_iter)[0], torch.float32)
            loss, _ = model.forward(video, return_recon_loss_only=True)
            ema_loss, ema_recon = ema_model.forward(
                video, return_recon_loss_only=True)
            if video.ndim == 4:
                video, ema_recon = video[:, None], ema_recon[:, None]
            video, ema_recon = video.float(), ema_recon.float()
            mse = ((video - ema_recon.clamp(0, 1)) ** 2).mean()
            readings.append(torch.stack([loss.float(), ema_loss.float(),
                                         mse]))
            codes.append(ema_model.tokenize(video).reshape(-1))
            valid_videos.append(video)
            recon_videos.append(ema_recon)
        readings = self._batch_mean(torch.stack(readings))
        hit = self._reduce_seen(codes_hit(torch.cat(codes),
                                          ema_model.codebook_size))
        n = len(readings)
        recon_loss = sum(float(r[0]) / n for r in readings)
        ema_recon_loss = sum(float(r[1]) / n for r in readings)
        valid_psnr = sum(float(psnr_from_mse(r[2])) / n for r in readings)
        utilization = float(hit.float().mean())
        self.log(valid_recon_loss=recon_loss,
                 valid_ema_recon_loss=ema_recon_loss, valid_psnr=valid_psnr,
                 codebook_utilization=utilization)
        self.print(f'validation recon loss {recon_loss:.3f}')
        self.print(f'validation EMA recon loss {ema_recon_loss:.3f}')
        self.print(f'validation PSNR {valid_psnr:.2f} dB | codebook '
                   f'utilization {utilization:.3f}')
        if not save_recons or not self.is_main:
            return recon_loss, ema_recon_loss

        valid = torch.cat(valid_videos)[:num_save_recons].cpu().numpy()
        recon = torch.cat(recon_videos)[:num_save_recons].clamp(0, 1)
        pair = np.stack([valid, recon.cpu().numpy()])
        n, b, t, h, w, c = pair.shape
        grid = pair.transpose(2, 1, 3, 0, 4, 5).reshape(t, b * h, n * w, c)
        sample_path = (self.results_folder
                       / f'sampled.{self.step // self.validate_every_step}.gif')
        video_array_to_gif(grid, str(sample_path))
        self.print(f'sample saved to {sample_path}')
        return recon_loss, ema_recon_loss

    def train(self):
        """The outer loop (reference trainer.py:512-538): a checkpoint before
        exit on SIGTERM / SIGINT, validation and checkpoints on their
        cadence; with ``profile_dir``, a ``torch.profiler`` trace of steps
        2-3."""
        import signal

        stop = {'flag': False}

        def _on_signal(signum, frame):
            self.print(f'signal {signum} received — checkpointing and '
                       'stopping')
            stop['flag'] = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _on_signal)
            except ValueError:      # not the main thread
                pass
        dl_iter = cycle(self.dataloader)
        valid_iter = (cycle(self.valid_dataloader) if self._valid_enabled
                      else None)
        profiler = None
        try:
            while self.step < self.num_train_steps:
                if stop['flag']:
                    self.save(self.checkpoints_folder / 'checkpoint.preempt')
                    break
                step = self.step
                self.print(f'step {step}')
                if exists(self.profile_dir) and step == 2:
                    profiler = torch.profiler.profile()
                    profiler.__enter__()
                t0 = time.perf_counter()
                self.train_step(dl_iter)
                self.log(step_time=time.perf_counter() - t0)
                if profiler is not None and step == 3:
                    profiler.__exit__(None, None, None)
                    Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
                    profiler.export_chrome_trace(
                        str(Path(self.profile_dir) / 'trace.json'))
                    profiler = None
                if not (step % self.validate_every_step) and exists(
                        valid_iter):
                    self.valid_step(valid_iter)
                if not (step % self.checkpoint_every_step):
                    self.save(self.checkpoints_folder / f'checkpoint.'
                              f'{step // self.checkpoint_every_step}')
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
            for sig, handler in prev.items():
                signal.signal(sig, handler)

    # -- checkpoint / resume (reference trainer.py:291-330) --------------------

    def _state(self) -> dict:
        """The state to save; under tensor parallelism the optimizer's
        moments are gathered whole (a collective: every rank calls it)."""
        opt_state = self.optimizer.state_dict()
        if self._tp:
            opt_state = {**opt_state, 'mu': self._tp.whole(opt_state['mu']),
                         'nu': self._tp.whole(opt_state['nu'])}
        state = {'params': self.module.state_dict(),
                 'ema_params': self.ema_module.state_dict(),
                 'opt_state': opt_state,
                 'step': self.step,
                 'code_seen': self._code_seen}
        if self.has_gan:
            state['discr_params'] = self.discr.state_dict()
            state['multiscale_params'] = [m.state_dict()
                                          for m in self.multiscale]
            state['discr_opt_states'] = [o.state_dict()
                                         for o in self.discr_optimizers]
        return state

    def save(self, path):
        """Every piece of training state (the JAX trainer's ``_state``) in
        one ``torch.save`` file, written by rank 0; every rank calls it and
        returns once the file is there."""
        path = Path(path)
        state = self._state()
        if self.is_main:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(state, str(path))
        self._barrier()

    @torch.no_grad()
    def load(self, path):
        path = Path(path)
        assert path.exists()
        state = torch.load(str(path), map_location=self.device,
                           weights_only=True)
        self.module.load_state_dict(state['params'])
        self.ema_module.load_state_dict(state['ema_params'])
        opt_state = state['opt_state']
        if self._tp:
            self._tp.scatter_params()
            opt_state = {**opt_state, 'mu': self._tp.cut(opt_state['mu']),
                         'nu': self._tp.cut(opt_state['nu'])}
        self.optimizer.load_state_dict(opt_state)
        self.step = int(state['step'])
        self._code_seen.copy_(state['code_seen'])
        if self.has_gan and 'discr_params' in state:
            self.discr.load_state_dict(state['discr_params'])
            for m, s in zip(self.multiscale, state['multiscale_params']):
                m.load_state_dict(s)
            for o, s in zip(self.discr_optimizers,
                            state['discr_opt_states']):
                o.load_state_dict(s)
        self._write_back()

    def maybe_auto_resume(self) -> bool:
        """Resume from the newest checkpoint in ``checkpoints_folder``, if
        any; True if one was loaded."""
        candidates = sorted(self.checkpoints_folder.glob('checkpoint.*'),
                            key=lambda p: p.stat().st_mtime)
        if not candidates:
            return False
        self.print(f'auto-resuming from {candidates[-1]}')
        self.load(candidates[-1])
        return True

    @torch.no_grad()
    def load_torch_checkpoint(self, path):
        """Resume from a reference trainer ``.pt`` package (its
        ``VideoTokenizerTrainer.save``, trainer.py:291-310; the JAX
        trainer's ``load_torch_checkpoint``): the model and EMA weights,
        the generator optimizer's Adam moments and count (the warmup
        schedule is keyed on the count, so it resumes where it was), the
        discriminator's weights and moments, and the step.

        Each multiscale discriminator loads on the JAX package's
        best-effort rule: the reference takes any user module there, so a
        scale whose weights are not the reference ``Discriminator``'s, or do
        not fit the configured scale, or are absent, keeps its weights with
        a warning, and its moments are zero unless they were imported with
        its weights; every discriminator optimizer takes the main one's
        count. The torch warmup and scheduler states are not read (the
        count replaces them). Every rank reads the same file, so all end
        with the same state. Like the reference's own ``load`` this
        unpickles the package: load only packages you trust."""
        from magvit2_pytorch_tpu_torch.models.torch_import import (
            discr_adam_moments, generator_adam_moments,
            load_torch_discr_state_dict,
            load_torch_multiscale_discr_state_dict,
            load_torch_tokenizer_state_dict, multiscale_discr_adam_moments,
            multiscale_discr_indices)

        pkg = torch.load(str(path), map_location='cpu', weights_only=False)
        model_sd = pkg['model']
        load_torch_tokenizer_state_dict(self.module, model_sd)
        # ema_pytorch's EMA(include_online_model=False) keeps the shadow
        # under 'ema_model.' beside its 'initted' / 'step' buffers
        load_torch_tokenizer_state_dict(self.ema_module, {
            k[len('ema_model.'):]: v for k, v in pkg['ema_model'].items()
            if k.startswith('ema_model.')})
        mu, nu, count = generator_adam_moments(self.module, model_sd,
                                               pkg['optimizer'])
        if self._tp:
            self._tp.scatter_params()
            mu, nu = self._tp.cut(mu), self._tp.cut(nu)
        self.optimizer.load_moments(mu, nu, count)

        if self.has_gan:
            load_torch_discr_state_dict(self.discr, model_sd)
            dmu, dnu, dcount = discr_adam_moments(
                self.discr, model_sd, pkg['discr_optimizer'])
            moments = [(dmu, dnu)]
            scales = multiscale_discr_indices(model_sd)
            if len(scales) > len(self.multiscale):
                warnings.warn(
                    f'checkpoint has {len(scales)} multiscale '
                    f'discriminators but the trainer only has '
                    f'{len(self.multiscale)}; extra scales are ignored')
            for i, ms in enumerate(self.multiscale):
                zeros = {n: torch.zeros_like(p)
                         for n, p in ms.named_parameters()}
                moments.append((zeros, zeros))
                if i not in scales:
                    warnings.warn(
                        f'multiscale discriminator {i} is not present in '
                        f'the checkpoint; keeping initialized params')
                    continue
                try:
                    load_torch_multiscale_discr_state_dict(ms, model_sd, i)
                except (KeyError, ValueError) as e:
                    warnings.warn(
                        f'multiscale discriminator {i} is not reference-'
                        f'Discriminator-shaped or does not match the '
                        f'configured scale ({type(e).__name__}); keeping '
                        f'initialized params')
                    continue
                key = f'multiscale_discr_optimizer_{i}'
                if key in pkg:
                    moments[-1] = multiscale_discr_adam_moments(
                        ms, model_sd, pkg[key], i)[:2]
            for opt, (mu, nu) in zip(self.discr_optimizers, moments):
                opt.load_moments(mu, nu, dcount)

        self.step = int(pkg['step'])
        self._write_back()
