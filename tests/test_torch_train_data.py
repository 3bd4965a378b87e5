"""The port's data modules on the CPU against the JAX package's, on GIF,
PNG and MP4 files the test writes: the codecs, ``VideoDataset`` and
``ImageDataset`` in float32 and uint8, the loader's batches and order from
the same seed, ``random_split``, ``cycle``, ``cast_num_frames``, and the
uint8 batch normalized on the batch's device as the JAX package's native
assembler normalizes it. Decoded arrays must be equal; normalized ones
equal to float32 rounding.
"""

import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu import data as jd
from magvit2_pytorch_tpu.native import normalize_u8 as jax_normalize_u8
from magvit2_pytorch_tpu_torch import data as pd


def _video(t=5, h=24, w=20, c=3, seed=0):
    return np.random.default_rng(seed).uniform(size=(t, h, w, c)).astype(
        np.float32)


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp('data')
    videos, images = root / 'videos', root / 'images'
    videos.mkdir()
    images.mkdir()
    for i in range(5):
        jd.video_array_to_gif(_video(t=3 + i, seed=i), str(videos / f'v{i}.gif'))
    from PIL import Image
    for i in range(4):
        arr = (_video(t=1, h=20 + i, w=18, seed=10 + i)[0] * 255).astype(
            np.uint8)
        Image.fromarray(arr).save(images / f'i{i}.png')
    return videos, images


def test_gif_codec_matches_jax(folders, tmp_path):
    videos, _ = folders
    for path in sorted(videos.glob('*.gif')):
        for normalize in (True, False):
            got = pd.gif_to_array(str(path), normalize=normalize)
            want = jd.gif_to_array(str(path), normalize=normalize)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)
    video = _video(seed=3)
    pd.video_array_to_gif(video, str(tmp_path / 'port'))
    jd.video_array_to_gif(video, str(tmp_path / 'jax'))
    assert np.array_equal(pd.gif_to_array(str(tmp_path / 'port.gif')),
                          jd.gif_to_array(str(tmp_path / 'jax.gif')))


def test_mp4_codec_matches_jax(tmp_path):
    video = _video(t=6, h=32, w=32)
    path = pd.array_to_video(video, str(tmp_path / 'clip'))
    for normalize in (True, False):
        got = pd.video_to_array(path, normalize=normalize)
        want = jd.video_to_array(path, normalize=normalize)
        assert got.shape[0] == 6 and np.array_equal(got, want)
    assert np.array_equal(pd.video_to_array(path, crop_size=16),
                          jd.video_to_array(path, crop_size=16))


@pytest.mark.parametrize('output_dtype', ['float32', 'uint8'])
@pytest.mark.parametrize('frames', [4, 9])
def test_video_dataset_matches_jax(folders, output_dtype, frames):
    videos, _ = folders
    kw = dict(image_size=16, num_frames=frames, output_dtype=output_dtype)
    ds, jds = pd.VideoDataset(videos, **kw), jd.VideoDataset(videos, **kw)
    assert len(ds) == len(jds) == 5
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got.dtype == want.dtype and got.shape == (frames, 16, 16, 3)
        assert np.array_equal(got, want)


@pytest.mark.parametrize('output_dtype', ['float32', 'uint8'])
def test_image_dataset_matches_jax(folders, output_dtype):
    _, images = folders
    kw = dict(image_size=16, output_dtype=output_dtype, seed=3)
    ds, jds = pd.ImageDataset(images, **kw), jd.ImageDataset(images, **kw)
    for i in range(len(ds)):        # the same flips from the same seed
        assert np.array_equal(ds[i], jds[i])


def test_loader_batches_and_normalization_match_jax(folders):
    """The same seeded order and batches; the port keeps uint8 batches and
    normalizes them on the device (``normalize_u8``) to what the JAX
    package's assembler returns."""
    videos, _ = folders
    kw = dict(image_size=16, num_frames=4, output_dtype='uint8')
    ds, jds = pd.VideoDataset(videos, **kw), jd.VideoDataset(videos, **kw)
    dl = pd.DataLoader(ds, batch_size=2, seed=5)
    jdl = jd.DataLoader(jds, batch_size=2, seed=5)
    assert len(dl) == len(jdl) == 2
    for _ in range(2):              # two epochs: the shuffle moves on
        for (got,), (want,) in zip(dl, jdl):
            assert got.dtype == np.uint8 and want.dtype == np.float32
            norm = pd.normalize_u8(torch.from_numpy(got))
            np.testing.assert_allclose(norm.numpy(), want, rtol=0, atol=1e-7)
    frame = np.random.default_rng(1).integers(0, 256, (3, 4, 3), np.uint8)
    for bgr in (False, True):
        np.testing.assert_allclose(
            pd.normalize_u8(torch.from_numpy(frame), bgr_to_rgb=bgr).numpy(),
            jax_normalize_u8(frame, bgr_to_rgb=bgr), rtol=0, atol=1e-7)


def test_split_cycle_and_cast_match_jax(folders):
    videos, _ = folders
    ds = pd.VideoDataset(videos, image_size=16, num_frames=4)
    jds = jd.VideoDataset(videos, image_size=16, num_frames=4)
    for (a, b) in zip(pd.random_split(ds, [3, 2], seed=42),
                      jd.random_split(jds, [3, 2], seed=42)):
        assert np.array_equal(a.indices, b.indices)
    it = pd.cycle(pd.DataLoader(ds, batch_size=2, prefetch=0))
    assert len([next(it) for _ in range(5)]) == 5   # past one epoch
    v = _video(t=5)
    for frames in (3, 5, 8):
        assert np.array_equal(pd.cast_num_frames(v, frames=frames),
                              jd.cast_num_frames(v, frames=frames))
    with pytest.raises(AssertionError):
        pd.DataLoader(ds, batch_size=8)     # drop_last would yield nothing


def test_data_modules_import_without_pil_or_cv2():
    """The card's machine has neither: the modules import them at use."""
    import subprocess
    import sys
    code = ('import sys; sys.modules["PIL"] = None; sys.modules["cv2"] = None\n'
            'from magvit2_pytorch_tpu_torch.data import datasets, video_io\n'
            'from magvit2_pytorch_tpu_torch.training import trainer\n'
            'print("ok")')
    from pathlib import Path
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.stdout.strip() == 'ok', out.stderr
