"""Host-side datasets and the loader feeding the trainer (the port's copy of
``magvit2_pytorch_tpu/data/datasets.py``; reference data.py:74-308):
``ImageDataset`` (jpg/jpeg/png, resize + random hflip + center crop),
``VideoDataset`` (gif/mp4, resize + center crop + cast to ``num_frames``),
and a ``DataLoader`` with background-thread prefetch (decode releases the
GIL inside PIL/OpenCV, so threads overlap with the card's steps).

Arrays are channels-last, float32 in [0, 1] or raw uint8: image ``(H, W,
C)``, video ``(T, H, W, C)``. uint8 batches stay uint8 through collate and
are normalized on the device by ``normalize_u8`` (the JAX package's
``native.normalize_u8``: ``/ 255``, optionally BGR -> RGB), which moves a
quarter of the bytes to the card. PIL and OpenCV are imported where a file
is decoded.
"""

from __future__ import annotations

import queue
import threading
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np

from magvit2_pytorch_tpu_torch.data.video_io import (
    CHANNEL_TO_MODE,
    cast_num_frames,
    gif_to_array,
    video_to_array,
)
from magvit2_pytorch_tpu_torch.utils.helpers import default, exists


def normalize_u8(batch, bgr_to_rgb: bool = False):
    """A uint8 tensor ``(..., c)`` as float32 in [0, 1], optionally BGR ->
    RGB, on its own device (the JAX package's ``native.normalize_u8``)."""
    out = batch.float() / 255.0
    if bgr_to_rgb and out.shape[-1] == 3:
        out = out.flip(-1)
    return out


def _resize_shorter_side(img, size: int):
    from PIL import Image
    w, h = img.size
    if w < h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), Image.BILINEAR)


def _center_crop_pil(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


class ImageDataset:
    """reference data.py:74-112."""

    def __init__(self, folder, image_size: int, channels: int = 3,
                 convert_image_to: Optional[str] = None,
                 exts=('jpg', 'jpeg', 'png'), random_hflip: bool = True,
                 seed: int = 0, output_dtype: str = 'float32'):
        folder = Path(folder)
        assert folder.is_dir(), f'{folder} must be a folder containing images'
        assert output_dtype in ('float32', 'uint8')
        self.folder = folder
        self.image_size = image_size
        self.random_hflip = random_hflip
        self.output_dtype = output_dtype
        self._rng = np.random.default_rng(seed)

        exts = list(exts) + [e.upper() for e in exts]
        self.paths = [p for ext in exts for p in folder.glob(f'**/*.{ext}')]
        print(f'{len(self.paths)} training samples found at {folder}')

        self.convert_image_to = default(
            convert_image_to, CHANNEL_TO_MODE.get(channels))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index) -> np.ndarray:
        from PIL import Image
        img = Image.open(self.paths[index])
        if exists(self.convert_image_to) and img.mode != self.convert_image_to:
            img = img.convert(self.convert_image_to)
        img = _resize_shorter_side(img, self.image_size)
        if self.random_hflip and self._rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = _center_crop_pil(img, self.image_size)
        if self.output_dtype == 'uint8':
            # normalized later, a batch at a time on the device
            arr = np.asarray(img, dtype=np.uint8)
        else:
            arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr


def _resize_crop_video(arr: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) -> resize shorter side to ``size`` + center crop.
    dtype-preserving (uint8 in -> uint8 out: 4x less host memory traffic)."""
    import cv2

    t, h, w, c = arr.shape
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    out = np.empty((t, nh, nw, c), arr.dtype)
    for i in range(t):
        frame = cv2.resize(arr[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
        out[i] = frame.reshape(nh, nw, c)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return out[:, top:top + size, left:left + size]


class VideoDataset:
    """reference data.py:234-284."""

    def __init__(self, folder, image_size: int, channels: int = 3,
                 num_frames: int = 17, force_num_frames: bool = True,
                 exts=('gif', 'mp4'), output_dtype: str = 'float32'):
        folder = Path(folder)
        assert folder.is_dir(), f'{folder} must be a folder containing videos'
        assert output_dtype in ('float32', 'uint8')
        self.folder = folder
        self.image_size = image_size
        self.channels = channels
        self.output_dtype = output_dtype
        self.paths = [p for ext in exts for p in folder.glob(f'**/*.{ext}')]
        print(f'{len(self.paths)} training samples found at {folder}')

        self.cast_num_frames_fn = (
            partial(cast_num_frames, frames=num_frames)
            if force_num_frames else (lambda arr: arr))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index) -> np.ndarray:
        path = self.paths[index]
        ext = path.suffix
        normalize = self.output_dtype == 'float32'
        if ext == '.gif':
            arr = gif_to_array(str(path), channels=self.channels,
                               normalize=normalize)
        elif ext == '.mp4':
            arr = video_to_array(str(path), normalize=normalize)
        else:
            raise ValueError(f'unknown extension {ext}')
        arr = _resize_crop_video(arr, self.image_size)
        return self.cast_num_frames_fn(arr)


def collate_arrays_and_strings(items):
    """Stack arrays (uint8 stays uint8: see ``normalize_u8``); pass string
    tuples through (reference collate_tensors_and_strings,
    data.py:288-305)."""
    if all(isinstance(it, np.ndarray) for it in items):
        return (np.stack(items),)

    out = []
    for datum in zip(*items):
        if all(isinstance(d, np.ndarray) for d in datum):
            out.append(np.stack(datum))
        elif all(isinstance(d, str) for d in datum):
            out.append(list(datum))
        else:
            raise ValueError('detected invalid type being passed from dataset')
    return tuple(out)


class DataLoader:
    """Shuffled, batched, background-prefetched loader.

    Multi-host sharding (torch DistributedSampler equivalent): with
    ``num_shards > 1`` every process draws the SAME seeded shuffle order,
    slices each global batch of ``batch_size`` into ``num_shards`` contiguous
    chunks, and yields only chunk ``shard_id`` — so each process decodes
    ``batch_size // num_shards`` samples and the union across processes is
    exactly the global batch the single-host loader would have produced.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, collate_fn=collate_arrays_and_strings,
                 num_shards: int = 1, shard_id: int = 0):
        assert len(dataset) > 0, 'dataset is empty'
        assert not (drop_last and len(dataset) < batch_size), (
            f'dataset has {len(dataset)} samples — fewer than batch_size '
            f'{batch_size} with drop_last: every epoch would be empty')
        assert 0 <= shard_id < num_shards
        assert batch_size % num_shards == 0, (
            f'batch_size {batch_size} must divide evenly over {num_shards} '
            f'shards')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        end = (len(order) // bs) * bs if self.drop_last else len(order)
        for start in range(0, end, bs):
            idx = order[start:start + bs]
            if len(idx) == 0:
                continue
            if self.num_shards > 1:
                if len(idx) % self.num_shards:
                    # partial tail batch (drop_last=False): pad by repeating
                    # leading samples so every shard sees the same count and
                    # no sample is silently dropped (DistributedSampler-style
                    # padding — a few tail samples appear twice that epoch)
                    pad = -len(idx) % self.num_shards
                    idx = np.concatenate([idx, idx[:pad]])
                per = len(idx) // self.num_shards
                idx = idx[self.shard_id * per:(self.shard_id + 1) * per]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for batch in self._batches():
                    q.put(batch)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def random_split(dataset, lengths, seed: int = 42):
    """Deterministic random split (reference uses torch random_split seeded 42,
    trainer.py:136)."""
    assert sum(lengths) == len(dataset)
    order = np.random.default_rng(seed).permutation(len(dataset))

    class _Subset:
        def __init__(self, ds, indices):
            self.ds, self.indices = ds, indices

        def __len__(self):
            return len(self.indices)

        def __getitem__(self, i):
            return self.ds[int(self.indices[i])]

    out = []
    offset = 0
    for n in lengths:
        out.append(_Subset(dataset, order[offset:offset + n]))
        offset += n
    return out


def cycle(dl):
    while True:
        got_any = False
        for data in dl:
            got_any = True
            yield data
        if not got_any:
            raise RuntimeError(
                'dataloader produced no batches (dataset smaller than '
                'batch_size with drop_last?) — refusing to spin forever')
