"""Host-side video/image codecs: gif <-> array, mp4 <-> array (the port's
copy of ``magvit2_pytorch_tpu/data/video_io.py``; reference data.py:114-230)
on numpy channels-last arrays ``(T, H, W, C)``, float32 in [0, 1] or raw
uint8. PIL and OpenCV are imported where a file is decoded or written, so
the package imports on a machine that has neither.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from magvit2_pytorch_tpu_torch.utils.helpers import cast_tuple, exists

CHANNEL_TO_MODE = {1: 'L', 3: 'RGB', 4: 'RGBA'}


def append_if_no_suffix(path: str, suffix: str) -> str:
    path = Path(path)
    if path.suffix == '':
        path = path.parent / (path.name + suffix)
    assert path.suffix == suffix, f'{path} needs suffix {suffix}'
    return str(path)


def seek_all_images(img, channels: int = 3):
    mode = CHANNEL_TO_MODE.get(channels)
    assert exists(mode), f'channels {channels} invalid'
    i = 0
    while True:
        try:
            img.seek(i)
            yield img.convert(mode)
        except EOFError:
            break
        i += 1


def video_array_to_gif(array, path: str, duration: int = 120, loop: int = 0,
                       optimize: bool = True):
    """(T, H, W, C) float [0,1] -> animated gif (reference
    video_tensor_to_gif, data.py:134-146)."""
    path = append_if_no_suffix(path, '.gif')
    frames = (np.clip(np.asarray(array), 0, 1) * 255).astype(np.uint8)
    if frames.shape[-1] == 1:
        frames = frames[..., 0]
    from PIL import Image
    images = [Image.fromarray(f) for f in frames]
    first, *rest = images
    first.save(path, save_all=True, append_images=rest, duration=duration,
               loop=loop, optimize=optimize)
    return images


# channel-first alias matching the reference name (accepts (C, T, H, W))
def video_tensor_to_gif(tensor, path: str, **kwargs):
    arr = np.asarray(tensor)
    arr = np.moveaxis(arr, 0, -1)  # (T, H, W, C)
    return video_array_to_gif(arr, path, **kwargs)


def gif_to_array(path: str, channels: int = 3,
                 normalize: bool = True) -> np.ndarray:
    """gif -> (T, H, W, C) float32 [0,1] (reference gif_to_tensor,
    data.py:150-157). ``normalize=False`` keeps raw uint8 — the batch
    trainer normalizes whole batches on the device
    (``data.datasets.normalize_u8``)."""
    from PIL import Image
    img = Image.open(path)
    dtype = np.float32 if normalize else np.uint8
    frames = [np.asarray(f, dtype=dtype)
              for f in seek_all_images(img, channels=channels)]
    arr = np.stack(frames)
    if normalize:
        arr = arr / np.float32(255.0)
    if arr.ndim == 3:
        arr = arr[..., None]
    return arr


def crop_center(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """(H, W, C) center crop (reference crop_center, data.py:222-230)."""
    y, x = img.shape[:2]
    startx = x // 2 - cropx // 2
    starty = y // 2 - cropy // 2
    return img[starty:starty + cropy, startx:startx + cropx]


def video_to_array(path: str, num_frames: int = -1, crop_size=None,
                   normalize: bool = True) -> np.ndarray:
    """mp4 -> (T, H, W, C) RGB (reference video_to_tensor, data.py:161-191;
    BGR->RGB flip preserved). float32 [0,1] by default; ``normalize=False``
    keeps uint8, normalized later on the device."""
    import cv2

    video = cv2.VideoCapture(path)
    frames = []
    while True:
        check, frame = video.read()
        if not check:
            break
        if exists(crop_size):
            frame = crop_center(frame, *cast_tuple(crop_size, 2))
        frames.append(frame)
    video.release()

    arr = np.stack(frames)
    if num_frames > 0:
        arr = arr[:num_frames]
    arr = arr[..., ::-1]  # BGR -> RGB
    if normalize:
        return arr.astype(np.float32) / np.float32(255.0)
    return np.ascontiguousarray(arr)


def array_to_video(array, path: str, fps: int = 25, video_format: str = 'MP4V'):
    """(T, H, W, C) float [0,1] -> mp4 (reference tensor_to_video,
    data.py:193-220)."""
    import cv2

    path = append_if_no_suffix(path, '.mp4')
    arr = (np.clip(np.asarray(array), 0, 1) * 255).astype(np.uint8)
    t, h, w = arr.shape[:3]

    fourcc = cv2.VideoWriter_fourcc(*video_format)
    writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
    for idx in range(t):
        frame = arr[idx]
        if frame.shape[-1] == 3:
            frame = frame[..., ::-1]  # RGB -> BGR
        writer.write(np.ascontiguousarray(frame))
    writer.release()
    return path


def cast_num_frames(arr: np.ndarray, *, frames: int) -> np.ndarray:
    """Truncate or zero-pad (T, H, W, C) to exactly ``frames``
    (reference cast_num_frames, data.py:37-46)."""
    t = arr.shape[0]
    if t == frames:
        return arr
    if t > frames:
        return arr[:frames]
    pad = [(0, frames - t)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)
