"""Build and time variants of one kernel source of the port, each with some
of its ``constexpr`` constants set otherwise: the shared part of the tile
sweeps in this folder (``flash_fwd_variants.py``, ``flash_bwd_variants.py``,
``taylor_core_variants.py``), which keep their constants, their checks and
what they time. Needs ``nvcc`` and a GPU; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path


def build(source: str, constants: dict, variants, entries, source_dir=None,
          tag: str = 'variant'):
    """One shared library per variant of ``csrc/<source>``, one nvcc each,
    all started together, into ``magvit2_pytorch_tpu_torch/_build/variants/``.

    ``constants`` maps each ``constexpr int kName = value;`` line of the
    source to the macro that takes its value's place (two lines may share a
    macro); a variant is a tuple of the macros' values, in the order they
    first appear in ``constants``. Returns ``{variant: (library, nvcc's
    log)}`` with ``entries`` typed from ``_build.SIGNATURES``. Exits when a
    line is no longer in the source or nvcc fails. ``source_dir`` builds
    another checkout's ``csrc`` instead (its headers from the same folder),
    and ``tag`` names the build's files, so that two builds may run at
    once."""
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    path = Path(source_dir or _build.SOURCE_DIR) / source
    text = path.read_text()
    for line, macro in constants.items():
        if line not in text:
            sys.exit(f'{line!r} not in {path}: update the constants')
        text = text.replace(line, line.split('=')[0] + f'= {macro};')
    macros = list(dict.fromkeys(constants.values()))
    out_dir = _build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f'{path.stem}_{tag}.cu'
    src.write_text(text)
    nvcc = _build.find_nvcc()
    procs = {}
    for values in variants:
        lib = out_dir / f'{path.stem}_{tag}_{"x".join(map(str, values))}.so'
        cmd = [nvcc, *_build.NVCC_FLAGS, '-shared', '-I', str(path.parent),
               *(f'-D{m}={v}' for m, v in zip(macros, values)), '-o',
               str(lib), str(src)]
        procs[values] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for values, (lib_path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'nvcc failed for {"x".join(map(str, values))}:\n{log}')
        lib = ctypes.CDLL(str(lib_path))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        built[values] = (lib, log)
    return built


def median_ms(torch, fn, calls: int = 1) -> float:
    """The median of 20 CUDA-event timings of ``calls`` back-to-back calls
    of ``fn``, a call each, after 3 calls to warm up."""
    for _ in range(3):
        fn()
    samples = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return sorted(samples)[10]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
