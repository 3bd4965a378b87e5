"""Chunked causal streaming in the port on the CPU (``models/streaming.py``).

The cases of tests/test_streaming.py, against the port: streamed codes
equal the whole clip's exactly, and a streamed decode its reconstruction
within 1e-5 (float32), with spatial attention, the time kv-cache, GateLoop's
state, conditioned layers and ``streaming_kv_window``, and the refusals at
construction. Then the port's streamed codes against the JAX package's
streamed codes on the same weights (exactly), and two sessions over one
tokenizer that do not disturb each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magvit2_pytorch_tpu.models import VideoTokenizer as JaxTokenizer
from magvit2_pytorch_tpu.models import streaming as jax_streaming
from magvit2_pytorch_tpu_torch import VideoTokenizer
from magvit2_pytorch_tpu_torch.models.jax_import import (
    jax_params_from_state_dict)
from magvit2_pytorch_tpu_torch.models.streaming import (
    StreamingSession, decode_streaming, tokenize_streaming)
from magvit2_pytorch_tpu_torch.ops.attention import Attention

torch.set_num_threads(1)
SERVE = dict(use_gan=False, perceptual_loss_weight=0.0)


def _tok(**kwargs):
    return VideoTokenizer(device='cpu', seed=0, **SERVE, **kwargs)


def _video(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope='module')
def tok():
    return _tok(image_size=16, init_dim=8, codebook_size=64,
                layers=('residual', ('compress_space', 12),
                        ('compress_time', 12), ('compress_time', 16)))


def test_streaming_encode_matches_full(tok):
    assert tok.time_downsample_factor == 4
    video = _video(0, (1, 17, 16, 16, 3))
    codes_full = tok.tokenize(video)
    codes_stream = tokenize_streaming(tok, video, chunk_frames=8)
    assert codes_stream.shape == codes_full.shape
    assert torch.equal(codes_stream, codes_full)


def test_streaming_decode_matches_full(tok):
    video = _video(1, (1, 17, 16, 16, 3))
    codes = tok.tokenize(video)
    recon_full = tok.decode_from_code_indices(codes)
    recon_stream = decode_streaming(tok, codes, chunk_latents=2)
    assert recon_stream.shape == recon_full.shape
    np.testing.assert_allclose(recon_stream.numpy(), recon_full.numpy(),
                               atol=1e-5, rtol=0)


def test_streaming_session_incremental(tok):
    """Uneven chunk sizes; the outputs still agree with the full pass."""
    video = _video(2, (2, 13, 16, 16, 3))
    sess = StreamingSession(tok)
    parts = [sess.encode_chunk(video[:, :5]),     # 1 + 4 frames
             sess.encode_chunk(video[:, 5:9]),    # 4
             sess.encode_chunk(video[:, 9:13])]   # 4
    assert torch.equal(torch.cat(parts, dim=1), tok.tokenize(video))


def test_streaming_with_spatial_attention():
    """attend_space / linear_attend_space are per-frame, so they stream."""
    tok = _tok(image_size=16, init_dim=8, codebook_size=64,
               layers=('residual', ('compress_space', 12),
                       'linear_attend_space', 'attend_space',
                       ('compress_time', 12)),
               attn_heads=2, linear_attn_heads=2)
    video = _video(3, (1, 5, 16, 16, 3))
    assert torch.equal(tokenize_streaming(tok, video, chunk_frames=2),
                       tok.tokenize(video))


def test_streaming_with_time_attention_kv_cache():
    """Causal time attention streams through its kv-cache and TokenShift
    carries its frame: chunked equals whole-clip."""
    tok = _tok(image_size=8, init_dim=8, codebook_size=64,
               layers=('residual', 'attend_time', ('compress_time', 12)),
               attn_dim_head=8, attn_heads=2, flash_attn=False)
    video = _video(4, (1, 5, 8, 8, 3))
    assert torch.equal(tokenize_streaming(tok, video, chunk_frames=2),
                       tok.tokenize(video))


def test_streaming_with_gateloop_state_carry():
    tok = _tok(image_size=8, init_dim=8, codebook_size=64,
               layers=('residual', 'gateloop_time', ('compress_time', 12)))
    video = _video(5, (1, 5, 8, 8, 3))
    assert torch.equal(tokenize_streaming(tok, video, chunk_frames=2),
                       tok.tokenize(video))


def test_streaming_with_cond_layers():
    """cond_* layers stream with one cond vector for the session."""
    tok = _tok(image_size=16, init_dim=8, codebook_size=64, dim_cond=6,
               layers=('residual', 'cond_residual', ('compress_time', 12)))
    rng = np.random.default_rng(3)
    video = rng.uniform(size=(2, 9, 16, 16, 3)).astype(np.float32)
    cond = rng.uniform(size=(2, 6)).astype(np.float32)
    codes_full = tok.tokenize(video, cond=cond)
    assert torch.equal(
        tokenize_streaming(tok, video, chunk_frames=4, cond=cond), codes_full)
    recon_full = tok.decode_from_code_indices(codes_full, cond=cond)
    recon_stream = decode_streaming(tok, codes_full, chunk_latents=2,
                                    cond=cond)
    np.testing.assert_allclose(recon_stream.numpy(), recon_full.numpy(),
                               atol=1e-5, rtol=0)


def test_streaming_rejects_separate_first_frame_at_construction():
    tok = _tok(image_size=16, init_dim=8, codebook_size=64,
               layers=(('compress_time', 12),),
               separate_first_frame_encoding=True)
    with pytest.raises(AssertionError, match='separate_first_frame'):
        StreamingSession(tok)


def test_streaming_cond_required_at_construction():
    tok = _tok(image_size=16, init_dim=8, codebook_size=64, dim_cond=6,
               layers=('cond_residual', ('compress_time', 12)))
    with pytest.raises(AssertionError, match='cond'):
        StreamingSession(tok)


def _kv_window_tok(window):
    return _tok(image_size=8, init_dim=8, codebook_size=64,
                layers=('residual', 'attend_time', ('compress_time', 12)),
                attn_dim_head=8, attn_heads=2, flash_attn=False,
                streaming_kv_window=window)


def test_streaming_kv_window_covering_is_exact():
    """A window that covers the stream: the bounded cache is exact."""
    tok = _kv_window_tok(window=64)
    video = _video(7, (1, 9, 8, 8, 3))
    assert torch.equal(tokenize_streaming(tok, video, chunk_frames=2),
                       tok.tokenize(video))


def test_streaming_kv_window_bounds_cache():
    """A small window: the attend_time caches stay within it, and the first
    chunk's codes (which saw the whole history) match the full pass."""
    tok = _kv_window_tok(window=2)
    video = _video(8, (1, 13, 8, 8, 3))
    session = StreamingSession(tok)
    chunks = [video[:, :3], video[:, 3:7], video[:, 7:11], video[:, 11:13]]
    outs = [session.encode_chunk(c) for c in chunks]
    caches = [v for m, v in session._enc_state.items()
              if isinstance(m, Attention)]
    assert caches, 'expected an attend_time kv cache'
    assert all(c['k'].shape[1] <= 2 and c['v'].shape[1] <= 2
               for c in caches)
    # the frames the layer saw: 13, and one of time padding in front
    assert all(c['pos'] == 14 for c in caches)
    codes_full = tok.tokenize(video)
    got = torch.cat(outs, dim=1)
    assert got.shape == codes_full.shape
    assert torch.equal(got[:, :1], codes_full[:, :1])


# ---- beyond the JAX package's cases -------------------------------------------

STREAM_STACK = dict(
    image_size=8, init_dim=8, codebook_size=64, dim_cond=4,
    layers=('residual', 'cond_residual', 'attend_space', 'attend_time',
            ('compress_time', 12), 'gateloop_time', 'cond_attend_time',
            'linear_attend_space', ('compress_time', 16)),
    attn_dim_head=8, attn_heads=2, linear_attn_heads=2,
    use_rotary_pos_emb=True, **SERVE)


def test_port_streams_the_jax_packages_codes():
    """Every time-causal op that carries state (causal convs, the temporal
    downsampler, TokenShift, the kv-cache with rotary positions, GateLoop,
    the modulated conv) in one tiny config: the port's streamed codes equal
    the JAX package's streamed codes on the same weights, and the port's
    streamed decode tracks the JAX package's within 1e-4."""
    port = VideoTokenizer(device='cpu', seed=5, **STREAM_STACK)
    jtok = JaxTokenizer(params=jax.tree.map(jnp.asarray, (
        jax_params_from_state_dict(port.config, port.state_dict()))),
        **STREAM_STACK)
    rng = np.random.default_rng(9)
    video = rng.uniform(size=(2, 9, 8, 8, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 4)).astype(np.float32)
    jcodes = jax_streaming.tokenize_streaming(
        jtok, jnp.asarray(video), chunk_frames=4, cond=jnp.asarray(cond))
    codes = tokenize_streaming(port, video, chunk_frames=4, cond=cond)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert torch.equal(codes, port.tokenize(video, cond=cond))
    jrecon = jax_streaming.decode_streaming(
        jtok, jcodes, chunk_latents=1, cond=jnp.asarray(cond))
    recon = decode_streaming(port, codes, chunk_latents=1, cond=cond)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=1e-4,
                               rtol=0)


def test_two_sessions_do_not_share_state():
    """Two streams over one tokenizer, their chunks interleaved, each give
    what it gives alone; the module holds no stream state."""
    tok = VideoTokenizer(device='cpu', seed=6, **STREAM_STACK)
    rng = np.random.default_rng(10)
    videos = [rng.uniform(size=(1, 9, 8, 8, 3)).astype(np.float32)
              for _ in range(2)]
    conds = [rng.normal(size=(1, 4)).astype(np.float32) for _ in range(2)]
    alone = [tokenize_streaming(tok, v, chunk_frames=4, cond=c)
             for v, c in zip(videos, conds)]
    buffers = {k: v.clone() for k, v in tok.module.state_dict().items()}
    sessions = [StreamingSession(tok, cond=c) for c in conds]
    parts = [[], []]
    for lo, hi in ((0, 5), (5, 9)):
        for i in (0, 1):
            parts[i].append(sessions[i].encode_chunk(videos[i][:, lo:hi]))
    for i in (0, 1):
        assert torch.equal(torch.cat(parts[i], dim=1), alone[i])
    assert all(torch.equal(v, tok.module.state_dict()[k])
               for k, v in buffers.items())
    decoders = [StreamingSession(tok, cond=c) for c in conds]
    frames = [[], []]
    for lo, hi in ((0, 2), (2, 3)):
        for i in (0, 1):
            frames[i].append(decoders[i].decode_chunk(alone[i][:, lo:hi]))
    for i in (0, 1):
        assert torch.equal(
            torch.cat(frames[i], dim=1),
            decode_streaming(tok, alone[i], chunk_latents=1, cond=conds[i]))
