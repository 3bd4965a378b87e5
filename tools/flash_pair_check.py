"""A quick card check of the Hopper wide and paired flash-attention kernels
(csrc/flash_attention.cu: the forward, dQ and dK/dV at bf16 heads of 257
to 512, and their 2-block clusters at 513 to 1024) on one NVIDIA GPU,
shorter than chip_smoke.py's flash phase:

1. builds the package's kernels and prints ptxas's lines of the six wide
   and paired kernels, and the attributes of the kernels a head of 512,
   1024 and 1032 runs;
2. holds them against the plain versions in bf16 at small shapes (heads of
   512, 520, 776, 1024 and 1032, causal and not, with fewer keys than
   queries, with each bias kind), as chip_smoke.py's ``flash_errors``
   measures and ``FLASH_TOL`` bounds; fails past it;
3. at (17, 1, 4096, 1024) / 4100 keys bf16: the forward, dQ and dK/dV
   twice, bit-identical, and their medians beside SDPA's forward;
4. with ``--sass NAME=DIR`` (the root of another checkout, e.g. the parent
   commit unpacked by ``git archive`` into a git-ignored folder; may be
   given more than once): csrc/flash_attention.cu of each checkout and of
   this tree compiled to cubins with the package's flags, and the SASS of
   the Hopper wide and paired kernels compared instruction for
   instruction, and again with register numbers, predicates and branch
   targets left out (``normalized``), the differences written under
   ``--out``.

Run from the repo root: ``python3 tools/flash_pair_check.py [--sass
parent=DIR] [--out DIR]``.
"""
import argparse
import difflib
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = 'magvit2_pytorch_tpu_torch/csrc'
KERNELS = ('fwd_wg_wide_kernel', 'bwd_dkv_wg_wide_kernel',
           'bwd_dq_wg_wide_kernel', 'fwd_wg_pair_kernel',
           'bwd_dkv_wg_pair_kernel', 'bwd_dq_wg_pair_kernel')
CASES = (  # b, h, n, m, d, causal, bias
    (2, 2, 300, 260, 512, True, 'bhnm'),
    (2, 2, 130, 70, 512, True, 'hnm'),
    (2, 2, 300, 260, 520, False, 'bhnm'),
    (2, 2, 130, 70, 520, True, 'nm'),
    (2, 2, 300, 260, 776, False, 'bhnm'),
    (2, 2, 300, 260, 776, True, 'bhnm'),
    (2, 2, 130, 70, 776, True, 'hnm'),
    (2, 2, 300, 260, 1024, True, 'bhnm'),
    (2, 2, 130, 70, 1024, True, 'nm'),
    (2, 2, 130, 134, 1024, False, None),
    (2, 2, 300, 260, 1032, True, 'bhnm'),
    (2, 2, 130, 70, 1032, True, None))


def cubin(nvcc, root, out):
    """The nvcc process compiling root's flash_attention.cu to `out`."""
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    csrc = os.path.join(root, SRC)
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-Xcompiler', '-fPIC')]
    return subprocess.Popen(
        [nvcc, *flags, '-cubin', '-I', csrc, '-o', out,
         os.path.join(csrc, 'flash_attention.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sass(path):
    """{function: [instruction, ...]} of a cubin, by cuobjdump."""
    text = subprocess.run(['cuobjdump', '-sass', path], capture_output=True,
                          text=True, check=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        hit = re.match(r'\s*Function : (\S+)', line)
        if hit:
            current = out.setdefault(hit[1], [])
            continue
        hit = re.match(r'\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;', line)
        if current is not None and hit:
            current.append(hit[1])
    return out


def normalized(code):
    """Instructions with register numbers, predicates, barriers and
    addresses left out: what is left when two builds differ only in
    register allocation and layout."""
    return [re.sub(r'\b(U?R|U?P|B)\d+\b|0x[0-9a-f]+', '#', line)
            for line in code]


def compare_sass(others, out_dir):
    """Each kernel of KERNELS in this tree's cubin against each other
    checkout's: instructions, and whether they are identical."""
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    nvcc = _build.find_nvcc()
    os.environ['PATH'] = (os.path.dirname(nvcc) + os.pathsep
                          + os.environ.get('PATH', ''))
    trees = {'this tree': REPO, **others}
    procs = {name: cubin(nvcc, root, os.path.join(out_dir, f'{i}.cubin'))
             for i, (name, root) in enumerate(trees.items())}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f'{name}: nvcc failed\n{log[-4000:]}')
    code = {name: sass(os.path.join(out_dir, f'{i}.cubin'))
            for i, name in enumerate(trees)}
    for other in others:
        for kernel in KERNELS:
            mine = [v for k, v in code['this tree'].items() if kernel in k]
            theirs = [v for k, v in code[other].items() if kernel in k]
            if len(mine) != 1 or len(theirs) != 1:
                print(f'[sass] {kernel}: not in both ({other})', flush=True)
                continue
            a, b = theirs[0], mine[0]
            na, nb = normalized(a), normalized(b)
            moved = sum(tag != 'equal' and max(i2 - i1, j2 - j1)
                        for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
                            None, na, nb, autojunk=False).get_opcodes())
            print(f'[sass] {kernel}: {other} {len(a)} instructions, this '
                  f'tree {len(b)}, identical {a == b}; normalized identical '
                  f'{na == nb}, {moved} differ', flush=True)
            if na != nb:
                diff = difflib.unified_diff(na, nb, other, 'this tree', n=1,
                                            lineterm='')
                name = kernel + '_' + re.sub(r'\W', '_', other) + '.norm.diff'
                with open(os.path.join(out_dir, name), 'w') as f:
                    f.write('\n'.join(diff))
            if a != b:
                diff = difflib.unified_diff(a, b, other, 'this tree', n=1,
                                            lineterm='')
                name = kernel + '_' + re.sub(r'\W', '_', other) + '.diff'
                with open(os.path.join(out_dir, name), 'w') as f:
                    f.write('\n'.join(diff))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--sass', action='append', default=[],
                        metavar='NAME=DIR')
    parser.add_argument('--out', default=os.path.join(REPO, '_proof',
                                                      'flash_pair_check'),
                        help='folder for the cubins and SASS differences '
                             '(default: a git-ignored one in the repo)')
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from magvit2_pytorch_tpu_torch.ops.kernels import _build
    from magvit2_pytorch_tpu_torch.ops.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        sys.exit('flash_pair_check: no CUDA device')

    start = time.perf_counter()
    _build.load_library()
    log = _build.build_info.get('log', '')
    print(f'build {time.perf_counter() - start:.1f} s', flush=True)
    for name in KERNELS:
        print(name, cs.ptxas_lines(log, name), flush=True)
    for d in (512, 1024, 1032):
        for kernel in fa.MMA_KERNELS:
            print(d, kernel, fa.mma_kernel(kernel, d),
                  fa.mma_attributes(kernel, d), flush=True)
    if args.sass:
        compare_sass(dict(s.split('=', 1) for s in args.sass), args.out)

    smi = cs.nvidia_smi()
    dev = torch.device('cuda', 0)
    worst = 0.0
    for b, h, n, m, d, causal, bias in CASES:
        *qkvo, bb = cs.flash_inputs(torch, dev, torch.bfloat16, b, h, n, m,
                                    d, bias, 3)
        errs, peaks, finite, _ = cs.flash_errors(torch, fa, *qkvo, bb, causal)
        rel = cs.flash_relative(errs, peaks)
        print((b, h, n, m, d, causal, bias), finite, rel, flush=True)
        if not finite:
            sys.exit(f'{(b, h, n, m, d)}: not finite')
        worst = max(worst, *(v for k, v in rel.items() if k != 'lse'))
    print('worst', worst, 'tol', cs.FLASH_TOL['bfloat16'], flush=True)
    if worst > cs.FLASH_TOL['bfloat16']:
        sys.exit('past FLASH_TOL')

    q, k, v, dout, _ = cs.flash_inputs(torch, dev, torch.bfloat16, 17, 1,
                                       4096, 4100, 1024, None, 99)
    scale = 1024 ** -0.5
    out, lse = fa.flash_forward(q, k, v, None, False, scale)
    delta = fa.row_delta(dout, out)
    again = fa.flash_forward(q, k, v, None, False, scale)
    grads = [fa.flash_backward_dkv(q, k, v, None, dout, lse, delta, False,
                                   scale)
             + fa.flash_backward_dq(q, k, v, None, dout, lse, delta, False,
                                    scale)[:1] for _ in range(2)]
    same = (torch.equal(again[0], out), torch.equal(again[1], lse),
            all(torch.equal(x, y) for x, y in zip(*grads)))
    print('bit-identical', *same, flush=True)
    if not all(same):
        sys.exit('two calls differ')
    fwd = cs.median_ms(lambda: fa.flash_forward(q, k, v, None, False, scale),
                       20)
    dkv = cs.median_ms(lambda: fa.flash_backward_dkv(
        q, k, v, None, dout, lse, delta, False, scale), 10)
    dq = cs.median_ms(lambda: fa.flash_backward_dq(
        q, k, v, None, dout, lse, delta, False, scale), 10)
    sdpa = cs.median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10)
    print(f'(17, 1, 4096, 1024) / 4100: forward {fwd:.4f} ms, dQ {dq:.4f} '
          f'ms, dK/dV {dkv:.4f} ms, SDPA forward {sdpa:.4f} on {smi}',
          flush=True)


if __name__ == '__main__':
    main()
