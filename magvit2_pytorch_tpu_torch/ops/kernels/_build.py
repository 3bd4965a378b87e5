"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

At first use, every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``)
into one shared library with a plain C interface, under
``magvit2_pytorch_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and the command, so an edited source rebuilds and an unchanged one
is reused. Nothing here includes PyTorch's headers: a build takes seconds.
Pointers and the CUDA stream cross as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-shared', '-Xcompiler',
                           '-fPIC', '-Xptxas=-v', '-lineinfo')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C entry points (csrc/*.cu) and their argument types
SIGNATURES = {
    # x, gamma, wqkv, mem_k, mem_v, wout, out, xn, qkv, attn,
    # dtype, rows, C, heads, dim_head, M, groups, L, inner_groups,
    # outer_stride, pos_stride, causal, stream
    'mv2_attention_block': [_P] * 10 + [_I] * 9 + [_L, _L, _I, _P],
    # x, gamma, wqkv, wout, out, xn, qkv, attn,
    # dtype, frames, N, C, heads, dim_head, eps, stream
    'mv2_taylor_attention': [_P] * 8 + [_I] * 6 + [_F, _P],
}

_lib = None
build_info: dict = {}


def sources():
    return sorted(SOURCE_DIR.glob('*.cu')) + sorted(SOURCE_DIR.glob('*.cuh'))


def find_nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [shutil.which('nvcc')]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, 'bin', 'nvcc'))
    candidates.append('/usr/local/cuda/bin/nvcc')
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                       'CUDA toolkit (set CUDA_HOME or put nvcc on PATH)')


def nvcc_command(nvcc: str, out: Path) -> list:
    cu = [str(p) for p in sorted(SOURCE_DIR.glob('*.cu'))]
    return [nvcc, *NVCC_FLAGS, '-I', str(SOURCE_DIR), '-o', str(out), *cu]


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'libmagvit2_kernels_{h.hexdigest()[:16]}.so'


def load_library():
    """Build (once) and load the kernel library; returns the ctypes handle.
    ``build_info`` records the build time and the compiler's output."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = nvcc_command(find_nvcc(), tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n'
                f'{proc.stdout}\n{proc.stderr}')
        os.replace(tmp, out)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr, command=cmd)
    else:
        build_info.update(seconds=0.0, log='(cached)', command=None)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mv2_error_string.argtypes = [ctypes.c_int]
    lib.mv2_error_string.restype = ctypes.c_char_p
    build_info['path'] = str(out)
    _lib = lib
    return lib


def check(lib, code: int, what: str):
    if code != 0:
        msg = lib.mv2_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')


# csrc/common.cuh DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f'kernels take float32 or bfloat16, got {t.dtype}')
    return DTYPE_CODES[t.dtype]


def check_cuda_inputs(what: str, x, params):
    """The wrapper's guards before a launch: every tensor on x's CUDA
    device, x float32 or bfloat16, and no autograd (the kernels have no
    backward yet)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            f'{what}: the CUDA kernel is forward-only; run under '
            'torch.inference_mode() or torch.no_grad() (backward passes '
            'are ROADMAP.md queue B work)')
    for t in (x, *params):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'{what}: every tensor must be on {x.device}')
    dtype_code(x)


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
