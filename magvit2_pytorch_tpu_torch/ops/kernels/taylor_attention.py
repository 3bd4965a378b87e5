"""Second-order Taylor linear attention block.

Replaces the TPU kernel ``magvit2_pytorch_tpu/ops/pallas/taylor_attention.py``
``_taylor_kernel`` / ``_taylor_frame`` (``_taylor_fused``, :245; entry
``taylor_linear_attention``, :325). Per frame and head, with
phi(t) = [t, t (x) t / sqrt2] (d + d^2 features; the constant feature is
folded in as sum v and N):

    x -> RMSNorm(gamma) -> qkv (float32) -> q = (q * d^-1/2) cast, k, v cast
    [A | S] = phi(k)^T [v | 1]        float32 sums, then cast (A, S)
    num = phi(q) A + sum_n v,  den = phi(q) S + N      (float32)
    out = cast(num * cast(1 / (den + eps))) Wout

With ``gamma=None`` the block skips the norm: the input is normed already
(``apply_norm=False`` of the TPU kernel, :245-322, which the conditioned
``LinearAttention`` reaches after its ``AdaptiveRMSNorm``). That route
makes three launches, the qkv GEMM reading x itself.

The casts are ``_taylor_frame``'s (:74-107): in bf16 every phi entry rounds
twice (the product ``t_i t_j``, then ``* inv_sqrt2``, whose constant is the
bf16 0.70703125), A and S round after their float32 sums, sum v and N stay
float32, and ``1 / (den + eps)`` rounds before it scales num. In float32
every cast is the identity.

The CUDA version makes four launches on scratch the wrapper allocates
(:func:`taylor_launches`): the row RMSNorm and the qkv GEMM of
``csrc/gemm.cu`` (its epilogue scales q by d^-1/2 in float32 and casts q, k
and v once to the working dtype), the moment core of
``csrc/taylor_attention.cu``, and the out GEMM. The core has two routes,
picked by a static rule (:func:`taylor_core_route`) and counted apart:

- ``'mma'`` (bf16): tensor cores. A block of eight warps owns one frame and
  four heads; it streams the frame's k and v, then q, through a
  three-stage shared-memory ring in chunks of 128 tokens (64 bytes of each
  a token for the four heads, 16-byte ``cp.async``), builds phi(k) in bf16
  registers and accumulates [A | S] = phi(k)^T [v | 1] on ``mma.sync``
  m16n8k16 (80 feature rows: 72, the constant that gives sum v, padding).
  Two warps share a head, each over every other 16-token tile; their
  partials meet in shared memory in a fixed order (no atomics: a frame's
  output does not depend on its batch). Then A and S round to bf16, and
  per 16-token tile [num | den] = phi(q) [A | S] on the tensor cores,
  r = bf16(1 / (den + eps)), out = bf16(num r). Four heads a block keep
  the loads 64 bytes wide and give 640 blocks at the flagship (160 frames
  x 16 heads), ~2.4 waves of two blocks an SM; all 16 heads would give 160
  blocks (1.2 waves on 132 SMs) and 64 KB stages of k and v.
- ``'mma'`` at every other head (16 to 256; the conditioned stack's linear
  attention takes the full attention's heads, 32 x 8 or 64 x 4): two
  launches on ``wgmma``, counted as ``taylor_core_wide_mma``, built at the
  padded widths 16, 32, 64, 128 and 256 (:data:`WG_WIDTHS`) with the true
  head size at run time. phi_ij == phi_ji to the bit, so each feature row
  is built once: the constant, k_j and phi_ij for i <= j, in the order of
  :func:`feature_pairs` (F = 1 + d + d (d + 1) / 2 features in at most
  1.05 F rows from d = 32 on), which the wrapper hands both launches as a
  table (:func:`pair_table`). The first launch streams the (frame, head)'s
  k and v by TMA and accumulates [A | S] = phi(k)^T [v | 1] with phi(k)
  built in registers as ``wgmma``'s A operand, then writes it in bf16 (the
  JAX kernel's cast; an off-diagonal row doubled, exact, since it stands
  for phi_ij and phi_ji) and sum v in float32 to scratch the wrapper
  allocates (:func:`wide_scratch_bytes`); the second streams [A | S] by TMA
  and runs [num | den] = phi(q) [A | S] with phi(q) built in registers from
  q in shared memory, with the same epilogue.
- ``'f32'`` (float32): one block per (frame, head) on the CUDA cores, each
  moment with one owner thread, then one thread per token; counted as
  ``taylor_core_f32`` at heads of 8, 16 and 32 (173 KB of shared memory at
  32).
- ``'f32'`` at every other head up to 256: two launches on the CUDA cores
  on float32 scratch (:func:`wide_scratch_bytes`), counted as
  ``taylor_core_wide_f32``: the first writes a head's [A | S] (features
  k_j, then phi_ij for every i and j, the constant last), the second
  streams it in feature chunks against phi(q) built from q in shared
  memory.

A head that is no multiple of 8 runs zero-padded to the next (q, k and v
columns, the scale the true head's), which adds exact zeros: the block pads
its weights' heads (:func:`pad_block_weights`) and the out projection reads
the zero columns against zero weights.

What bounds it on the H100: at the flagship shape (160 frames x 1024 tokens
x 256 channels, 16 heads x 8, batch 8) the two projections hold most of the
FLOPs (the ``'wgmma'`` route of ``gemm.py``); the core alone is bound by
bytes (bf16 q, k, v in and the attention out, ~168 MB, 0.05 ms). Fusing
the out projection into the core's second phase is later work. At heads
of 32 (the conditioned stack: 160 frames x 1024 tokens, 8 heads x 32) the
core is bound by operations, barely: phi_ij == phi_ji, so the function
needs 1 + d + d (d + 1) / 2 = 561 features a head, 99.8 GFLOP, 0.101 ms at
the bf16 peak against 0.100 ms of bytes; the wgmma core builds 576 rows by
40 columns. At 4 heads of 64 (the conditioned stack at the README
flagship's 64 x 4) the function needs 2145 features a head, 371 GFLOP,
0.375 ms, against 0.100 ms of bytes; the wgmma core builds 2176 rows by 72
columns.

On the CPU the wrappers run the plain versions below, and autograd
differentiates them. On a CUDA tensor they launch the kernel or raise; the
backward recomputes through :func:`taylor_attention_twin`, the counterpart
of the JAX custom VJP's XLA twin. A head size the cores do not take never
reaches them: :func:`taylor_eligible` sends it to the plain version on both
devices (``ops/attention.py``). Every head of 1 to 256 reaches them, a
superset of the JAX package's kernel, which takes any head whose phi fits
its VMEM (d <= 221 in bf16, ``taylor_attention.py:337-354``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from magvit2_pytorch_tpu_torch.ops.kernels import _build, gemm

# launches of the block and of each core route since the last reset (see
# ops/kernels); the block's GEMMs count in gemm.LAUNCHES
LAUNCHES = {'taylor_attention_block': 0,
            'taylor_attention_block_no_norm': 0, 'taylor_core_mma': 0,
            'taylor_core_f32': 0, 'taylor_core_wide_mma': 0,
            'taylor_core_wide_f32': 0, 'taylor_attention_block_backward': 0}

MAX_DIM_HEAD = 256              # csrc/taylor_attention.cu: every route
ONE_LAUNCH_F32 = (8, 16, 32)    # taylor_core_f32_kernel's heads
WG_WIDTHS = (16, 32, 64, 128, 256)  # WgTc: the bf16 wgmma core's widths
CORES = {'f32': 0, 'mma': 1}  # csrc/taylor_attention.cu TaylorRoute
INV_SQRT2 = 0.5 ** 0.5
ONE, ZERO = -1, -2   # feature_pairs: the factors 1 and 0


def taylor_eligible(dim_head: int) -> bool:
    """Static gate of the Taylor block: a head size the CUDA cores take,
    1 to 256. It does not look at the device, so a module routes the same
    way on the CPU and the card; an ineligible module takes the plain
    version on both (the JAX package takes its XLA reference for the calls
    its kernel does not take, ``taylor_attention.py:337-361``)."""
    return 1 <= dim_head <= MAX_DIM_HEAD


def taylor_core_route(dtype, dim_head: int) -> str:
    """The moment core of a block call: ``'mma'`` (tensor cores) for bf16,
    ``'f32'`` (CUDA cores) for float32. No route gives way to another; a
    head size neither takes raises."""
    if not taylor_eligible(dim_head):
        raise ValueError(f'taylor core: dim_head {dim_head} not in 1 .. '
                         f'{MAX_DIM_HEAD}')
    if dtype == torch.bfloat16:
        return 'mma'
    if dtype == torch.float32:
        return 'f32'
    raise TypeError(f'taylor core: kernels take float32 or bfloat16, got '
                    f'{dtype}')


def kernel_dim_head(dim_head: int) -> int:
    """The head size the cores run: the next multiple of 8
    (:func:`pad_block_weights` zero-pads the others)."""
    return -(-dim_head // 8) * 8


def core_counter(route: str, dim_head: int) -> str:
    """The launch counter of a core call at the cores' head size: the
    two-launch cores (bf16 past 8, float32 past the one-launch core's
    heads) count apart from the one-launch ones."""
    if route == 'mma' and dim_head != 8:
        return 'taylor_core_wide_mma'
    if route == 'f32' and dim_head not in ONE_LAUNCH_F32:
        return 'taylor_core_wide_f32'
    return f'taylor_core_{route}'


def core_width(dim_head: int) -> int:
    """The padded width of the bf16 wgmma core a head runs at."""
    return next(w for w in WG_WIDTHS if dim_head <= w)


@functools.lru_cache(maxsize=None)
def feature_pairs(dim_head: int):
    """The feature rows of the bf16 wgmma core at a head of ``dim_head``
    (the cores' head size, a multiple of 8), in kernel order: each row is
    the pair of factors (x, y) whose product is its feature, ``ONE`` and
    ``ZERO`` standing for 1 and 0. First the constant (ONE, ONE) and the
    k_j (ONE, j), zeros (ONE, ZERO) up to a multiple of 16; then phi_ij
    for every i <= j once (phi_ij == phi_ji to the bit), zeros up to a
    multiple of 64, the M tile. Rows r and r + 8 of every 16-row step share
    their first factor (a lane's two rows in launch 1, a lane's features
    f and f + 8 in launch 2), so a lane loads it once: the products go in
    twins (i, j), (i, j + 1) along each i, the last of an odd run of i as
    (d - 1, i) twinned with another such. Returns the rows (a tuple:
    cached, since the wrapper sizes its scratch by them at every call) and
    the first product row (every 16-row step holds one kind)."""
    d = dim_head

    def slices(twins):      # twin t: rows 16 (t // 8) + t % 8 and + 8
        rows = [None] * (2 * len(twins))
        for t, (first, second) in enumerate(twins):
            base = 16 * (t // 8) + t % 8
            rows[base], rows[base + 8] = first, second
        return rows

    def twins_of(entries, pad):
        entries = entries + [pad] * (-len(entries) % 16)
        return list(zip(entries[::2], entries[1::2]))

    linear = slices(twins_of([(ONE, ONE)] + [(ONE, j) for j in range(d)],
                             (ONE, ZERO)))
    products, last = [], []
    for i in range(d):
        run = [(i, j) for j in range(i, d)]
        if len(run) % 2:
            last.append((d - 1, run.pop()[0]))
        products += run
    products += last + [(d - 1, ZERO)] * (len(last) % 2)
    products += [(ZERO, ZERO)] * (-(len(linear) + len(products)) % 64)
    return (tuple(linear + slices(twins_of(products, (ZERO, ZERO)))),
            len(linear))


def pair_table(dim_head: int):
    """:func:`feature_pairs` as the kernel reads it, one word a row: the
    staged rows of the two factors, x_i | x_j << 16 (a factor j < d is row
    j, ONE row D and ZERO row D + 1 at the core's width D), bit 31 set on
    the product rows and the zeros after them (the factor bf16(1/sqrt2);
    the others take 1). As signed 32-bit ints."""
    rows, linear = feature_pairs(dim_head)
    width = core_width(dim_head)
    staged = {ONE: width, ZERO: width + 1}
    words = [staged.get(i, i) | staged.get(j, j) << 16
             | (1 << 31 if r >= linear else 0)
             for r, (i, j) in enumerate(rows)]
    return [w - (1 << 32) if w >> 31 else w for w in words]


_PAIR_TABLES: dict = {}


def _pair_table_on(device, dim_head: int):
    key = (device, dim_head)
    if key not in _PAIR_TABLES:
        _PAIR_TABLES[key] = torch.tensor(pair_table(dim_head),
                                         dtype=torch.int32, device=device)
    return _PAIR_TABLES[key]


def wide_scratch_bytes(frames: int, heads: int, dim_head: int,
                       route: str = 'mma') -> int:
    """Scratch of a two-launch core at the cores' head size (0 for the
    one-launch ones). bf16 past 8 (``launch_taylor_core_wg``): per (frame,
    head) its [A | S] transposed in bf16, d + 8 columns of the
    :func:`feature_pairs` rows, then sum v, d floats; float32
    (``launch_taylor_core_stream_f32``): d + d^2 + 1 features (the last the
    constant) of d + 1 columns padded to a multiple of 32, in float32."""
    d = dim_head
    if route == 'f32':
        if d in ONE_LAUNCH_F32:
            return 0
        return frames * heads * 4 * (d + d * d + 1) * (-(-(d + 1) // 32) * 32)
    if d == 8:
        return 0
    rows = len(feature_pairs(d)[0])
    return frames * heads * (2 * (d + 8) * rows + 4 * d)


def taylor_core_ref(qkv, frames: int, heads: int, dim_head: int,
                    eps: float = 1e-5):
    """Plain version of :func:`taylor_core`: qkv ``(frames * N, 3 * heads *
    dim_head)`` in the working dtype, q already scaled by d^-1/2, to attn
    ``(frames * N, heads * dim_head)``, with ``_taylor_frame``'s casts."""
    dt = qkv.dtype
    n = qkv.shape[0] // frames
    hd = heads * dim_head
    q, k, v = (qkv[:, i * hd:(i + 1) * hd].reshape(frames, n, heads,
                                                   dim_head)
               for i in range(3))
    inv_sqrt2 = torch.tensor(INV_SQRT2, dtype=dt,
                             device=qkv.device)    # bf16: 0.70703125

    def phi(t):     # each product rounds, then the product with inv_sqrt2
        outer = t[..., :, None] * t[..., None, :] * inv_sqrt2
        return torch.cat([t, outer.flatten(-2)], dim=-1).float()

    pq, pk = phi(q), phi(k)
    v32 = v.float()
    a = torch.einsum('gnhf,gnhe->ghfe', pk, v32).to(dt).float()
    s = pk.sum(dim=1).to(dt).float()                      # (g, h, f)
    num = torch.einsum('gnhf,ghfe->gnhe', pq, a) + v32.sum(dim=1)[:, None]
    den = torch.einsum('gnhf,ghf->gnh', pq, s) + n
    r = (1.0 / (den + eps)).to(dt).float()
    return (num * r[..., None]).to(dt).reshape(frames * n, hd)


def taylor_attention_ref(x, gamma, wqkv, wout, heads: int, dim_head: int,
                         eps: float = 1e-5):
    """Plain version on ``(B, N, C)``. gamma ``(C,)``, or None for the
    no-norm route; wqkv ``(3 * heads * dim_head, C)`` in (qkv, head, d) row
    order, wout ``(C, heads * dim_head)``."""
    dt = x.dtype
    b, n, c = x.shape
    hd = heads * dim_head
    xn = x.reshape(b * n, c)
    if gamma is not None:
        xn = gemm.rmsnorm_ref(xn, gamma)
    qkv = gemm.gemm_nt_ref(xn, wqkv.to(dt), scaled_cols=hd,
                           col_scale=dim_head ** -0.5)
    attn = taylor_core_ref(qkv, b, heads, dim_head, eps)
    return gemm.gemm_nt_ref(attn, wout.to(dt)).reshape(b, n, c)


def taylor_core(qkv, frames: int, heads: int, dim_head: int,
                eps: float = 1e-5):
    """The moment core of a block (see :func:`taylor_core_ref`); on the card
    on the route :func:`taylor_core_route` picks, at a head size that is a
    multiple of 8 (:func:`taylor_launches` pads any other)."""
    if not qkv.is_cuda:
        return taylor_core_ref(qkv, frames, heads, dim_head, eps)
    route = taylor_core_route(qkv.dtype, dim_head)
    rows, cols = qkv.shape
    hd = heads * dim_head
    if dim_head % 8:
        raise ValueError(f'taylor core: dim_head {dim_head} is not a '
                         'multiple of 8 (taylor_launches pads it)')
    if cols != 3 * hd or rows % frames or not qkv.is_contiguous():
        raise ValueError(f'taylor core: qkv {tuple(qkv.shape)} is not '
                         f'{frames} frames of contiguous rows of {3 * hd}')
    attn = torch.empty((rows, hd), dtype=qkv.dtype, device=qkv.device)
    size = wide_scratch_bytes(frames, heads, dim_head, route)
    scratch = (torch.empty(size, dtype=torch.uint8, device=qkv.device)
               if size else None)
    pairs = (_pair_table_on(qkv.device, dim_head)
             if route == 'mma' and dim_head != 8 else None)
    lib = _build.load_library()
    code = lib.mv2_taylor_core(
        qkv.data_ptr(), attn.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if pairs is None else pairs.data_ptr(),
        _build.dtype_code(qkv), frames, rows // frames, heads, dim_head,
        0 if pairs is None else pairs.numel(), float(eps), CORES[route],
        _build.stream_handle(qkv.device))
    _build.check(lib, code, f'taylor core ({route}, dim_head {dim_head})')
    LAUNCHES[core_counter(route, dim_head)] += 1
    return attn


def core_attributes(launch: str, width: int) -> dict:
    """What the CUDA runtime reports for the bf16 wgmma core at one of
    :data:`WG_WIDTHS`: launch ``'moments'`` or ``'apply'``, registers and
    local (spilled) bytes a thread, static and dynamic shared memory, and
    blocks an SM."""
    out = (ctypes.c_int * 5)()
    lib = _build.load_library()
    _build.check(lib, lib.mv2_taylor_core_attributes(
        ('moments', 'apply').index(launch), width, out),
        f'taylor core {launch} attributes at {width}')
    return dict(zip(('registers', 'local_bytes', 'static_smem_bytes',
                     'dynamic_smem_bytes', 'blocks_per_sm'), out))


def taylor_launches(x, gamma, wqkv, wout, heads: int, dim_head: int,
                    eps: float = 1e-5):
    """The four launches of the block on ``(B, N, C)``: RMSNorm (none when
    ``gamma`` is None), the qkv GEMM (q scaled in its epilogue), the core,
    the out GEMM. A head that is no multiple of 8 runs on weights whose
    heads are zero-padded to the next (:func:`pad_block_weights`): the GEMMs
    then see even widths and the core the head size it takes. On CPU
    tensors each launch takes its plain version, so the composition is
    testable there."""
    dt = x.dtype
    b, n, c = x.shape
    d = kernel_dim_head(dim_head)
    if d != dim_head:
        wqkv, wout = pad_block_weights(wqkv, wout, heads, dim_head, d)
    xn = x.reshape(b * n, c)
    if gamma is not None:
        xn = gemm.rmsnorm(xn, gamma)
    qkv = gemm.gemm_nt(xn, wqkv.to(dt), scaled_cols=heads * d,
                       col_scale=dim_head ** -0.5)
    attn = taylor_core(qkv, b, heads, d, eps)
    return gemm.gemm_nt(attn, wout.to(dt)).reshape(b, n, c)


def pad_block_weights(wqkv, wout, heads: int, dim_head: int, width: int):
    """wqkv ``(3 * heads * dim_head, C)`` and wout ``(C, heads *
    dim_head)`` with each head zero-padded to ``width``: the qkv GEMM then
    gives each head's q, k and v zero columns past ``dim_head``, which add
    exact zeros in the core (its output columns there are 0), and the out
    GEMM reads them against zero weights."""
    c = wqkv.shape[1]
    wqkv = F.pad(wqkv.reshape(3, heads, dim_head, c),
                 (0, 0, 0, width - dim_head)).reshape(3 * heads * width, c)
    wout = F.pad(wout.reshape(c, heads, dim_head),
                 (0, width - dim_head)).reshape(c, heads * width)
    return wqkv, wout


def taylor_attention_twin(x, gamma, wqkv, wout, heads: int, dim_head: int,
                          eps: float = 1e-5):
    """What the block's backward differentiates on the card: the port's
    counterpart of ``_taylor_reference`` (``taylor_attention.py:173-205``),
    the twin the JAX custom VJP recomputes through, with its cast points:
    qkv in the working dtype, ``q * d^-1/2`` rounded, phi = [1, t, t (x) t /
    sqrt2] in the working dtype (both constants rounded to it first, as a
    Python scalar is in JAX), the moments summed in float32 and rounded
    before the products with phi(q), ``num / (den + eps)`` rounded once.
    ``gamma`` None: no norm (``apply_norm=False``)."""
    dt = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    if gamma is not None:
        x = gemm.rmsnorm_ref(x, gamma)
    qkv = F.linear(x, wqkv.to(dt)).reshape(b, n, 3, heads, dim_head)
    scale, inv_sqrt2 = torch.tensor([dim_head ** -0.5, INV_SQRT2],
                                    dtype=dt).tolist()
    q, k, v = qkv[:, :, 0] * scale, qkv[:, :, 1], qkv[:, :, 2]

    def phi(t):
        outer = t[..., :, None] * t[..., None, :] * inv_sqrt2
        return torch.cat([torch.ones_like(t[..., :1]), t,
                          outer.flatten(-2)], dim=-1).float()

    pq, pk = phi(q), phi(k)
    kv = torch.einsum('bnhf,bnhe->bhfe', pk, v.float()).to(dt).float()
    num = torch.einsum('bnhf,bhfe->bnhe', pq, kv)
    den = torch.einsum('bnhf,bhf->bnh', pq, pk.sum(dim=1).to(dt).float())
    out = (num / (den[..., None] + eps)).to(dt).reshape(b, n, hd)
    return F.linear(out, wout.to(dt))


def _block_launch(x, gamma, wqkv, wout, heads, dim_head, eps):
    name = 'taylor_attention_block'
    _build.check_cuda_inputs(
        name, x, tuple(t for t in (gamma, wqkv, wout) if t is not None))
    if not taylor_eligible(dim_head):
        raise ValueError(f'{name}: dim_head {dim_head} not in 1 .. '
                         f'{MAX_DIM_HEAD}')
    c = x.shape[-1]
    hd = heads * dim_head
    if wqkv.shape != (3 * hd, c) or wout.shape != (c, hd):
        raise ValueError(f'{name}: wqkv {tuple(wqkv.shape)} / wout '
                         f'{tuple(wout.shape)} do not fit C={c}, '
                         f'heads*dim_head={hd}')
    out = taylor_launches(x, gamma, wqkv, wout, heads, dim_head, eps)
    LAUNCHES[name] += 1
    if gamma is None:
        LAUNCHES['taylor_attention_block_no_norm'] += 1
    return out


class _TaylorBlock(torch.autograd.Function):
    """The block on the card: the forward launches the kernels; the backward
    recomputes through :func:`taylor_attention_twin` and differentiates it,
    as the JAX custom VJP does (``taylor_attention.py:304-319``). Without a
    norm there is no gamma, so no dgamma (the JAX ``_bwd`` returns zeros
    for the ones it passes in its place)."""

    @staticmethod
    def forward(ctx, x, gamma, wqkv, wout, heads, dim_head, eps):
        ctx.save_for_backward(x, gamma, wqkv, wout)
        ctx.args = (heads, dim_head, eps)
        return _block_launch(x, gamma, wqkv, wout, heads, dim_head, eps)

    @staticmethod
    def backward(ctx, grad):
        LAUNCHES['taylor_attention_block_backward'] += 1
        grads = _build.recompute_grads(
            lambda *a: taylor_attention_twin(*a, *ctx.args),
            ctx.saved_tensors, ctx.needs_input_grad[:4], grad)
        return (*grads, None, None, None)


def taylor_attention(x, gamma, wqkv, wout, heads: int, dim_head: int,
                     eps: float = 1e-5):
    """Taylor attention block on ``(B, N, C)`` (see ``taylor_attention_ref``);
    differentiable on both devices."""
    if not x.is_cuda:
        return taylor_attention_ref(x, gamma, wqkv, wout, heads, dim_head,
                                    eps)
    return _TaylorBlock.apply(x, gamma, wqkv, wout, heads, dim_head, eps)
