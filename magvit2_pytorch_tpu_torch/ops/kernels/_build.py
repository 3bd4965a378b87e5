"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

At first use, every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``)
by its own ``nvcc``, all started together, and the objects are linked into
one shared library with a plain C interface, under
``magvit2_pytorch_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and the command, so an edited source rebuilds and an unchanged one
is reused. Nothing here includes PyTorch's headers: a build takes seconds.
Pointers and the CUDA stream cross as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import contextlib
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
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas=-v', '-lineinfo')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# C entry points (csrc/*.cu) and their argument types
SIGNATURES = {
    # x, gamma, out, dtype, rows, C, stream
    'mv2_rmsnorm': [_P] * 3 + [_I] * 3 + [_P],
    # a, w, c, dtype, M, N, K, route, scaled_cols, col_scale, stream
    'mv2_gemm_nt': [_P] * 3 + [_I] * 6 + [_F, _P],
    # qkv, mem_k, mem_v, attn, dtype, groups, L, heads, dim_head, M,
    # inner_groups, outer_stride, pos_stride, causal, route, stream
    'mv2_attention_core': [_P] * 4 + [_I] * 7 + [_L, _L, _I, _I, _P],
    # x, gamma, wqkv, mem_k, mem_v, wout, out, dtype, B, T, S, C, heads,
    # dim_head, M, pixels, causal, route, stream
    'mv2_time_attention_block': [_P] * 7 + [_I] * 11 + [_P],
    # T, pixels, C, heads, M, out (2 ints)
    'mv2_time_block_plan': [_I] * 5 + [_P],
    # out (4 ints)
    'mv2_time_block_attributes': [_P],
    # qkv, attn, dtype, frames, N, heads, dim_head, eps, route, stream
    'mv2_taylor_core': [_P] * 2 + [_I] * 5 + [_F, _I, _P],
    # a, w, bias, out, dtype, B, T, H, W, C, conv, route, stream
    'mv2_ru_gemm': [_P] * 4 + [_I] * 8 + [_P],
    # y, k_w, k_b, logits, dtype, M, C, stream
    'mv2_ru_se_logits': [_P] * 4 + [_I, _L, _I, _P],
    # y, logits, gi_w, gi_b, go_w, go_b, stats, partial, gates, dtype,
    # frames, HW, C, hidden, slices, stream
    'mv2_ru_se_gates': [_P] * 9 + [_I] * 6 + [_P],
    # out, x, gates, dtype, M, HW, C, stream
    'mv2_ru_gate_residual': [_P] * 3 + [_I, _L, _I, _I, _P],
    # q, k, v, bias, out, lse, dtype, bh, n, m, d, bias_groups, causal,
    # scale, route, stream
    'mv2_flash_attention_fwd': [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, bias, dout, lse, delta, dq, dbias, then as the forward
    'mv2_flash_attention_bwd_dq': [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, bias, dout, lse, delta, dk, dv, then as the forward
    'mv2_flash_attention_bwd_dkv': [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    # kernel, dim_head, out (4 ints)
    'mv2_flash_mma_attributes': [_I, _I, _P],
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


def nvcc_commands(nvcc: str, out: Path):
    """One compile command per ``csrc/*.cu`` (object next to ``out``) and
    the command that links the objects into ``out``."""
    compiles, objects = [], []
    for src in sorted(SOURCE_DIR.glob('*.cu')):
        obj = out.with_name(f'{out.stem}.{src.stem}.o')
        compiles.append([nvcc, *NVCC_FLAGS, '-I', str(SOURCE_DIR), '-c',
                         '-o', str(obj), str(src)])
        objects.append(str(obj))
    return compiles, [nvcc, *ARCH_FLAGS, '-shared', '-o', str(out), *objects]


def _run_all(cmds) -> str:
    """Run the commands at once; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{log}')
    return ''.join(logs)


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
        tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp')
        compiles, link = nvcc_commands(find_nvcc(), tmp)
        t0 = time.perf_counter()
        try:
            log = _run_all(compiles) + _run_all([link])
            os.replace(tmp, out)
        finally:
            # the objects always, and the library unless it was moved
            for path in (*(c[c.index('-o') + 1] for c in compiles), tmp):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path)
        build_info.update(seconds=time.perf_counter() - t0, log=log,
                          command=[*compiles, link])
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
    """The guards of a wrapper before a launch: every tensor on x's CUDA
    device, x float32 or bfloat16, and no autograd. The launches inside a
    block have no backward of their own, so they refuse a tensor that needs
    a gradient; the blocks B1-B5 call this inside the forward of their
    ``torch.autograd.Function``, where autograd is off, and differentiate
    in its backward (:func:`recompute_grads`). Flash attention has backward
    kernels and does not come through here."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            f'{what}: this CUDA launch has no backward of its own; call '
            'the block it belongs to (whose backward recomputes through '
            'its plain version) or run under torch.no_grad()')
    for t in (x, *params):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'{what}: every tensor must be on {x.device}')
    dtype_code(x)


def recompute_grads(plain, inputs, needs, grad_out):
    """The backward of a kernel whose JAX custom VJP saves its inputs and
    differentiates its XLA twin (B1-B5): ``plain`` (the port's counterpart
    of that twin) runs again on the saved ``inputs`` under autograd, and
    its gradients for the inputs flagged in ``needs`` come back, None for
    the others (an input that is None gets None). Inside a backward that
    builds a graph (``create_graph=True``, as R1's penalty does) the
    recompute runs on the saved tensors themselves, so the gradients it
    returns can be differentiated again, as JAX differentiates its
    ``_bwd``."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        leaves = inputs if create_graph else tuple(
            None if t is None else t.detach().requires_grad_(n)
            for t, n in zip(inputs, needs))
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n and t is not None]
        grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                         create_graph=create_graph)
                     if wanted else ())
    return tuple(next(grads) if n and t is not None else None
                 for t, n in zip(leaves, needs))


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
