"""The msgpack encoding of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``, in Python and numpy alone, for the subset a tokenizer
checkpoint of the JAX package holds: maps with string keys, strings, ints,
floats, bools, ``None``, lists (tuples are written as lists), numpy arrays as
ext type 1 (a packed ``(shape, dtype name, C-order bytes)``) and numpy
scalars as ext type 3. Map keys are written sorted, as flax writes them.
Arrays over ``MAX_CHUNK_SIZE`` bytes are written as flax writes them, as a
dict of flat chunks, and read back whole.

The port carries its own codec so that it reads and writes the JAX package's
checkpoints without ``msgpack`` or ``flax``. Anything outside that subset
(bfloat16 or object arrays, complex numbers, other ext types, keys that are
not strings) is refused with a ``ValueError``, never misread.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax's limit for one array leaf; larger arrays are split into chunks
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = '__msgpack_chunked_array__'


# -- encoding -----------------------------------------------------------------


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: fixed form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit)) that holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f'msgpack: length {n} too large')


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                                 (0xce, '>I', 1 << 32),
                                 (0xcf, '>Q', 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f'msgpack: int {v} too large')
    else:
        for code, fmt, limit in ((0xd0, '>b', 1 << 7), (0xd1, '>h', 1 << 15),
                                 (0xd2, '>i', 1 << 31),
                                 (0xd3, '>q', 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f'msgpack: int {v} too small')


def _pack_str(out: bytearray, s: str):
    data = s.encode('utf-8')
    _head(out, len(data), 0xa0, 32, ((0xd9, '>B', 1 << 8),
                                     (0xda, '>H', 1 << 16),
                                     (0xdb, '>I', 1 << 32)))
    out += data


def _pack_bin(out: bytearray, data: bytes):
    _head(out, len(data), None, 0, ((0xc4, '>B', 1 << 8),
                                    (0xc5, '>H', 1 << 16),
                                    (0xc6, '>I', 1 << 32)))
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(out, len(data), None, 0, ((0xc7, '>B', 1 << 8),
                                        (0xc8, '>H', 1 << 16),
                                        (0xc9, '>I', 1 << 32)))
    out.append(code)
    out += data


def _array_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.kind in (
            'c', 'V', 'U', 'S', 'O'):
        raise ValueError(f'msgpack: arrays of dtype {arr.dtype} are not '
                         'supported')
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes('C')])
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a flat array in pieces of at most MAX_CHUNK_SIZE
    bytes, shape and chunks as dicts keyed '0', '1', ..."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            'shape': {str(i): d for i, d in enumerate(arr.shape)},
            'chunks': {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: bytearray, v, sort: bool = True):
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack('>d', v)
    elif isinstance(v, str):
        _pack_str(out, v)
    elif isinstance(v, (bytes, bytearray)):
        _pack_bin(out, bytes(v))
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, ((0xdc, '>H', 1 << 16),
                                      (0xdd, '>I', 1 << 32)))
        for item in v:
            _pack(out, item, sort)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, ((0xde, '>H', 1 << 16),
                                      (0xdf, '>I', 1 << 32)))
        if not all(isinstance(key, str) for key in v):
            raise ValueError(f'msgpack: map keys {list(v)} are not all '
                             'strings')
        # flax writes a map's keys sorted (its pytree copy sorts them), and
        # the chunked form of an array, made after that copy, as built
        for key, item in (sorted(v.items()) if sort else v.items()):
            _pack_str(out, key)
            if (isinstance(item, np.ndarray)
                    and item.size * item.dtype.itemsize > MAX_CHUNK_SIZE):
                _pack(out, _chunk(item), sort=False)
            else:
                _pack(out, item, sort)
    else:
        raise ValueError(f'msgpack: cannot encode {type(v).__name__}')


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for
    ``tree``."""
    out = bytearray()
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        _pack(out, _chunk(tree), sort=False)
    else:
        _pack(out, tree)
    return bytes(out)


# -- decoding -----------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError('msgpack: truncated data')
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
          0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
_LENGTHS = {0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
            0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
            0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
            0xde: ('map', '>H'), 0xdf: ('map', '>I'),
            0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I')}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(r: _Reader, raw: bool):
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b]
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xa0 <= b <= 0xbf:
        kind, n = 'str', b & 0x1f
    elif 0x90 <= b <= 0x9f:
        kind, n = 'array', b & 0x0f
    elif 0x80 <= b <= 0x8f:
        kind, n = 'map', b & 0x0f
    elif b in _FIXEXT:
        kind, n = 'ext', _FIXEXT[b]
    elif b in _LENGTHS:
        kind, fmt = _LENGTHS[b]
        n = r.unpack(fmt)
    else:
        raise ValueError(f'msgpack: unsupported type byte {b:#x}')
    if kind == 'str':
        data = r.take(n)
        return data if raw else data.decode('utf-8')
    if kind == 'bin':
        return r.take(n)
    if kind == 'array':
        return [_unpack(r, raw) for _ in range(n)]
    if kind == 'map':
        out = {}
        for _ in range(n):
            key = _unpack(r, raw)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f'msgpack: map key {key!r} is not a string')
            out[key] = _unpack(r, raw)
        return out
    code = r.unpack('>b')
    return _ext(code, r.take(n))


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f'msgpack: unsupported ext type {code}')
    r = _Reader(data)
    shape, name, buf = _unpack(r, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == 'bfloat16':
        raise ValueError('msgpack: bfloat16 arrays are not supported; save '
                         'the checkpoint in float32')
    dtype = np.dtype(name)
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(d: dict) -> np.ndarray:
    try:
        shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
        chunks = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    except (KeyError, TypeError) as e:
        raise ValueError(f'msgpack: malformed chunked array ({e})') from None
    if (set(d) != {CHUNKED, 'shape', 'chunks'}
            or not all(isinstance(c, np.ndarray) and c.ndim == 1
                       for c in chunks)):
        raise ValueError('msgpack: malformed chunked array')
    flat = np.concatenate(chunks)
    if flat.size != int(np.prod(shape)):
        raise ValueError(f'msgpack: chunked array of {flat.size} elements '
                         f'does not fill its shape {shape}')
    return flat.reshape(shape)


def _restore_chunks(v):
    if isinstance(v, dict):
        if CHUNKED in v:
            return _unchunk(v)
        return {k: _restore_chunks(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_restore_chunks(x) for x in v]
    return v


def msgpack_restore(data: bytes):
    """What ``flax.serialization.msgpack_restore`` gives for ``data``:
    numpy arrays (read-only views of the buffer), chunked arrays joined."""
    r = _Reader(data)
    tree = _unpack(r, raw=False)
    if r.pos != len(r.data):
        raise ValueError(f'msgpack: {len(r.data) - r.pos} bytes after the '
                         'object')
    return _restore_chunks(tree)
