"""Chunked causal streaming tokenize / decode (BASELINE config 5; PyTorch
counterpart of ``magvit2_pytorch_tpu/models/streaming.py``).

A long video goes through the tokenizer chunk by chunk, in memory that
does not grow with the clip. Every time-causal op keeps its history in the
session's state: the last ``k_t - 1`` input frames of each causal conv and
modulated conv, the carried frames of the temporal downsamplers, the frame
of each TokenShift, each causal attention's kv-cache and each GateLoop's
recurrence state. The state is a dict keyed by module that the session owns
and hands down (``TokenizerModule.encode`` / ``decode``, ``streaming=True``),
never module buffers, so sessions over one tokenizer do not share it.
Chunked results are those of one whole-clip pass: on the CPU codes are
equal (tests/test_torch_streaming.py); on the card the fused ResidualUnit
and time-attention kernels run whole-clip but not on streamed chunks (they
keep no state), so the two differ there by those kernels' rounding. A
stream runs in the working dtype with ``MAGVIT2_TPU_INT8_CONV=1`` too: the
JAX package's gate refuses its causal convs (``conv.py:389-391``), and a
per-chunk scale could not give the whole clip's numbers, so here no int8
site quantizes in a stream (``int8_scope(streaming=True)``).

Chunk grammar (the JAX package's): the first chunk holds the first frame
plus a multiple of ``time_downsample_factor`` frames (e.g. 1 + 16); every
later chunk a multiple of ``time_downsample_factor``. Conditioned layers
stream with one cond vector fixed for the session.
``separate_first_frame_encoding`` does not stream (its first-frame stem
works on the whole clip) and is refused when the session is made, as is a
conditioned config without ``cond``.
"""

from __future__ import annotations

from typing import Optional

import torch

from magvit2_pytorch_tpu_torch.ops.conv import int8_scope
from magvit2_pytorch_tpu_torch.utils.helpers import divisible_by


class StreamingSession:
    """One stateful encode and/or decode stream over a ``VideoTokenizer``."""

    def __init__(self, tokenizer, cond=None):
        assert not tokenizer.config.separate_first_frame_encoding, (
            'streaming does not support separate_first_frame_encoding: its '
            'first-frame stem has whole-clip packing semantics — construct '
            'the tokenizer without it to stream')
        if tokenizer.config.parsed().has_cond:
            assert cond is not None, (
                'this tokenizer has conditioned (cond_*) layers — pass the '
                'per-sample `cond` vector to StreamingSession(tokenizer, '
                'cond=...); it is fixed for the life of the stream')
        self.tokenizer = tokenizer
        self.module = tokenizer.module
        self.cond = tokenizer._cond(cond)
        self.tp = tokenizer.time_padding
        self.tdf = tokenizer.time_downsample_factor
        self._enc_state, self._dec_state = {}, {}
        self._enc_chunks = self._dec_chunks = 0

    def encode_chunk(self, chunk, quantize: bool = True):
        """chunk ``(B, T, H, W, C)``: the first holds ``1 + k * tdf``
        frames, a later one ``k * tdf``. Returns its code indices (its
        latents with ``quantize=False``)."""
        chunk = self.tokenizer._video(chunk, channel_first=False)
        if self._enc_chunks == 0:
            assert divisible_by(chunk.shape[1] - 1, self.tdf), (
                f'first chunk must hold 1 + k*{self.tdf} frames')
            chunk = torch.nn.functional.pad(
                chunk, (0, 0, 0, 0, 0, 0, self.tp, 0))
        else:
            assert divisible_by(chunk.shape[1], self.tdf), (
                f'chunks must hold multiples of {self.tdf} frames')
        with torch.inference_mode(), int8_scope(streaming=True):
            latents = self.module.encode(
                chunk, cond=self.cond, video_contains_first_frame=False,
                streaming=True, state=self._enc_state)
            self._enc_chunks += 1
            if not quantize:
                return latents
            return self.module.quantize(latents).indices

    def decode_chunk(self, codes):
        """codes ``(B, T', H', W')``: one chunk of integer indices (the
        first holds ``(tp + 1 + k * tdf) / tdf`` latent frames). Returns its
        frames, the first chunk's time padding cut off."""
        codes = torch.as_tensor(codes, device=self.tokenizer.device)
        with torch.inference_mode(), int8_scope(streaming=True):
            quantized = self.module.indices_to_codes(codes.long(),
                                                     self.tokenizer.dtype)
            recon = self.module.decode(
                quantized, cond=self.cond, video_contains_first_frame=False,
                streaming=True, state=self._dec_state)
        first = self._dec_chunks == 0
        self._dec_chunks += 1
        return recon[:, self.tp:] if first else recon


def tokenize_streaming(tokenizer, video, chunk_frames: Optional[int] = None,
                       cond=None):
    """The codes of a whole ``(B, T, H, W, C)`` video, tokenized in chunks
    of ``chunk_frames`` frames after the first (a multiple of
    ``time_downsample_factor``; default ``4 * tdf``)."""
    tdf = tokenizer.time_downsample_factor
    chunk_frames = chunk_frames or 4 * tdf
    assert divisible_by(chunk_frames, tdf)
    t = video.shape[1]
    assert divisible_by(t - 1, tdf), (
        'video must hold 1 + k*tdf frames (first-frame convention)')
    session = StreamingSession(tokenizer, cond=cond)
    first_len = 1 + min(chunk_frames, t - 1)
    codes = [session.encode_chunk(video[:, :first_len])]
    for pos in range(first_len, t, chunk_frames):
        codes.append(session.encode_chunk(video[:, pos:pos + chunk_frames]))
    return torch.cat(codes, dim=1)


def decode_streaming(tokenizer, codes, chunk_latents: Optional[int] = None,
                     cond=None):
    """The frames of ``(B, T', H', W')`` code indices, decoded in chunks of
    ``chunk_latents`` latent frames after the first (default 4)."""
    tdf, tp = tokenizer.time_downsample_factor, tokenizer.time_padding
    chunk_latents = chunk_latents or 4
    t = codes.shape[1]
    session = StreamingSession(tokenizer, cond=cond)
    first_len = min(chunk_latents + (tp + 1) // tdf, t)
    frames = [session.decode_chunk(codes[:, :first_len])]
    for pos in range(first_len, t, chunk_latents):
        frames.append(session.decode_chunk(codes[:, pos:pos + chunk_latents]))
    return torch.cat(frames, dim=1)
