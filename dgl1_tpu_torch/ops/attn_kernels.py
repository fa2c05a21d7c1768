"""Wrappers of the fused GAT attention's CUDA kernels, each beside its
plain torch version.

Kernel (``csrc/attn_kernels.cu``)   replaces (``dgl1_tpu/ops/attention.py``)
---------------------------------   -----------------------------------------
K6 :func:`attn_fwd`                 ``_attn_fwd_kernel`` / ``_attn_fwd_call``
K7 :func:`attn_bwd_src`             ``_attn_bwd_kernel`` / ``_attn_bwd_call``
                                    with ``to_src=True``
K7 :func:`attn_bwd_grp`             the same with ``to_src=False`` (g-major)
K8 :func:`ger_reduce`               ``_ger_reduce_kernel`` / its call

A wrapper given CPU tensors computes its plain version (``*_torch``);
given CUDA tensors it launches its kernel or raises. It checks devices,
types, shapes and contiguity, allocates the outputs, and adds one to
``LAUNCHES[name]`` for each call that launches its kernel and nowhere
else; the launch runs in the span ``kernel.<name>``.

Outputs are narrow: the reference pads ``den``, ``mraw``, ``gel`` and the
per-chunk partials to 128 lanes (the TPU's tiling) and ``num``/``gft`` to
a multiple of 128 features; its callers read only ``[:, :H]`` and
``[:, :H*D]``, and those are the columns returned here. Node operands
(``el``, ``ft``) are unpadded (num_src rows): real slots never point past
them.

Attention dropout regenerates a per-(edge, head) keep mask from the seed
and the original edge id with :func:`_mix32`, bit for bit the
reference's hash, so forward, backward, tail and diagonal agree without a
mask tensor.

K6 and both K7 modes take ``bf16`` (``ops/precision.py``'s bf16 mode):
they round to bfloat16 exactly what the reference casts to ``dt`` (each
plain version says what) and accumulate in float32; such launches count
under ``"<name>.bf16"``. K8 has no ``dt`` in the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.nn.functional import leaky_relu

from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.ops.hub_kernels import (_check, _chunk_rows, _f32,
                                            _int32, _kernel_span)
from dgl1_tpu_torch.ops.precision import round_bf16, rounding

__all__ = ["attn_fwd", "attn_bwd_src", "attn_bwd_grp", "ger_reduce",
           "attn_fwd_torch", "attn_bwd_src_torch", "attn_bwd_grp_torch",
           "ger_reduce_torch", "drop_mask", "LAUNCHES", "reset_launches",
           "KERNELS", "MAX_HEAD_DIM", "fwd_plan", "grp_plan"]

_BF16 = ("attn_fwd", "attn_bwd_src", "attn_bwd_grp")
KERNELS = _BF16 + ("ger_reduce",) + tuple(f"{k}.bf16" for k in _BF16)
LAUNCHES = {k: 0 for k in KERNELS}
# K6 and K7 (to_src) given a layout with no chunk (a partition of a
# sharded build without a hub edge of its own, once its forced no-op
# chunks are dropped) return the plain versions' values for no slot
# (zeros; mraw -1e30) without a launch, on either device, and count here.
# K7 g-major and K8 launch on such a layout and write zeros.
NO_WORK = {"attn_fwd": 0, "attn_bwd_src": 0}

NEG = -1e30  # the reference's -inf stand-in
# Widest head the kernels take: a head's features share one shared-memory
# stripe of 128 rows (128 * 384 * 4 B = 192 KB). The fused attention
# declines wider heads (``attention.can_fuse_attention``).
MAX_HEAD_DIM = 384

# Largest chunk K7 (attn_bwd_src) takes on the card: it sorts a batch of
# a window's chunks (4,096 slots, 1,024 for heads wider than 128) by
# window row in shared memory. The layouts' chunks hold 1,024.
MAX_SRC_CHUNK = 1024

_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in NO_WORK:
        NO_WORK[k] = 0
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Dropout hash: the reference's int32 arithmetic, in int64 masked to 32
# bits (torch's >> on int32 is arithmetic, the reference's is logical).
# ----------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32 without int64 overflow."""
    hi, lo = x >> 16, x & 0xFFFF
    return (((hi * c) & 0xFFFF) << 16) + lo * c & _M32


def _mix32(x, seed):
    """``attention._mix32`` on uint32 images held in int64: returns the
    hashed value in [0, 2^32)."""
    x = (_mul32(x & _M32, 0x9E3779B9) + (seed & _M32)) & _M32
    x = x ^ (x >> 15)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 13)


def _drop_keys(eid, h: int):
    """int32 keys ``eid * 131 + head`` (wrapping), as uint32 images."""
    head = torch.arange(h, device=eid.device, dtype=torch.int64)
    return (eid.long()[:, None] * 131 + head[None, :]) & _M32


def drop_mask(eid, seed, drop: float, h: int):
    """(len(eid), h) float32 keep mask pre-divided by the keep
    probability; ``seed`` an int32 (1,) tensor. Equal bit for bit to the
    reference's ``_drop_mask(eid * 131 + head, seed, drop)``."""
    keep = 1.0 - drop
    bits = _mix32(_drop_keys(eid, h), seed.long().reshape(()))
    bits = bits & 0x7FFFFFFF
    thresh = int(keep * 2147483647.0)
    scale = torch.tensor(1.0 / keep, dtype=torch.float32)
    return (bits < thresh).to(torch.float32) * scale.to(eid.device)


# ----------------------------------------------------------------------
# Plain torch versions
# ----------------------------------------------------------------------

def attn_fwd_torch(lay, el, er_g, ft, h: int, d: int, slope: float,
                   drop: float, seed, n_groups: int, bf16: bool = False):
    """K6 over the forward (group-major) layout. ``el`` (num_src, h),
    ``er_g`` (n_groups*128, h) the hub rows' er, ``ft`` (num_src, h*d).
    Returns num (n_groups*128, h*d), den and mraw (n_groups*128, h):
    mraw is the per-(group, head) max of el over the group's real slots,
    broadcast over its 128 rows; with ``mz = leaky(er + mraw)`` and
    ``p = exp(leaky(el_s + er_b) - mz)``, den sums p and num sums
    ``p * mask * ft_s`` per hub row. The reference reaches the same sums
    with an online max; this takes the group's max first.

    ``bf16`` computes what the reference computes with ``dt=bfloat16``,
    whose online softmax rounds each chunk's p against the running max of
    the group's chunks so far: per chunk t, p is taken against ``run_t``;
    ``p`` (in den), ``p * mask`` and the product ``(p * mask) * ft`` are
    rounded, and so is ``ft`` (el and er stay float32); a later chunk that
    raises the max rescales what came before by ``scale = exp(leaky(er +
    run_old) - leaky(er + run_new))``, den by the float32 scale and num by
    the scale rounded to bf16. A term of chunk t therefore carries the
    product of the later chunks' scales, :func:`online_factors`."""
    rnd = rounding(bf16)
    rows_in, rows_out, valid = _chunk_rows(lay)
    ri, ro = rows_in[valid], rows_out[valid]
    grp = ro // BLK
    el_e = el.index_select(0, ri)
    mx = torch.full((n_groups, h), NEG, dtype=el.dtype, device=el.device)
    mx = mx.scatter_reduce(0, grp[:, None].expand(-1, h), el_e, "amax")
    er_e = er_g.index_select(0, ro)
    if bf16:
        n_chunks = lay["in_id"].shape[0]
        tc = torch.arange(n_chunks, device=el.device).repeat_interleave(
            lay["a"].shape[0] // max(n_chunks, 1))[valid]
        cmax = torch.full((n_chunks, h), NEG, dtype=el.dtype,
                          device=el.device).scatter_reduce(
            0, tc[:, None].expand(-1, h), el_e, "amax")
        run, fden, fnum = online_factors(lay, cmax, er_g, slope)
        shift = run.index_select(0, tc)
        slot = tc * BLK + ro % BLK
        fden, fnum = fden.index_select(0, slot), fnum.index_select(0, slot)
    else:
        shift = mx.index_select(0, grp)
        fden = fnum = 1.0
    p = torch.exp(leaky_relu(el_e + er_e, slope)
                  - leaky_relu(er_e + shift, slope))
    den = el.new_zeros((n_groups * BLK, h)).index_add_(0, ro, rnd(p) * fden)
    if drop > 0.0:
        p = p * drop_mask(lay["eid"][valid], seed, drop, h)
    msg = rnd(rnd(p)[:, :, None]
              * rnd(ft.index_select(0, ri)).reshape(-1, h, d))
    if bf16:
        msg = msg * fnum[:, :, None]
    num = ft.new_zeros((n_groups * BLK, h * d)).index_add_(
        0, ro, msg.reshape(-1, h * d))
    return num, den, mx.repeat_interleave(BLK, dim=0)


def online_factors(lay, cmax, er_g, slope: float):
    """The reference's online softmax over the forward layout, whose
    chunks come group by group: ``cmax`` (n_chunks, h) each chunk's max of
    el over its real slots (NEG if none). Returns ``run`` (n_chunks, h),
    the running max of the group's chunks up to and including each one,
    and per chunk t, hub row r of its group and head k (n_chunks*128, h):
    ``fden``, the product of the float32 scales ``exp(leaky(er_r +
    run_{u-1}) - leaky(er_r + run_u))`` of the group's later chunks u, and
    ``fnum``, the product of the same scales rounded to bf16."""
    n_chunks, h = cmax.shape
    out_id = lay["out_id"].long()
    run = torch.empty_like(cmax)
    fden = torch.ones((n_chunks, BLK, h), dtype=cmax.dtype,
                      device=cmax.device)
    fnum = torch.ones_like(fden)
    bounds = torch.nonzero(torch.diff(out_id)).squeeze(1) + 1
    starts = [0] + bounds.tolist()
    ends = bounds.tolist() + [n_chunks]
    for t0, t1 in zip(starts, ends):
        if t0 == t1:
            continue
        run[t0:t1] = torch.cummax(cmax[t0:t1], dim=0).values
        if t1 - t0 == 1:
            continue
        er = er_g.view(-1, BLK, h)[int(out_id[t0])]
        old, new = run[t0:t1 - 1, None, :], run[t0 + 1:t1, None, :]
        s = torch.exp(leaky_relu(er + old, slope) - leaky_relu(er + new,
                                                               slope))
        # Exclusive suffix products: chunk t takes the scales of t+1...
        for f, sc in ((fden, s), (fnum, round_bf16(s))):
            f[t0:t1 - 1] = torch.flip(torch.cumprod(torch.flip(sc, (0,)), 0),
                                      (0,))
    return run, fden.reshape(-1, h), fnum.reshape(-1, h)


def _bwd_terms(el, er_g, lse_g, rho_g, ft, ct_g, eid, rg, rs, h, d, slope,
               drop, seed, bf16):
    """K7's per-slot terms for real slots with hub rows ``rg`` and source
    rows ``rs``: (q, the gft message ``a_exp * ct``). ``bf16`` rounds
    ``ft``, ``ct``, the product ``ft * ct`` before the head sum, ``acoef *
    mask`` (a_exp), ``a_exp * ct`` and q, and lse and rho when 3h > 128
    (the reference packs [er | lse | rho] into one float32 block
    otherwise); el and er stay float32."""
    rnd = rounding(bf16)
    rnd_stats = rounding(bf16 and 3 * h > BLK)
    s = el.index_select(0, rs) + er_g.index_select(0, rg)
    acoef = torch.exp(leaky_relu(s, slope)
                      - rnd_stats(lse_g.index_select(0, rg)))
    dl = torch.where(s >= 0, torch.ones_like(s), torch.full_like(s, slope))
    ft_e = rnd(ft.index_select(0, rs)).reshape(-1, h, d)
    ct_e = rnd(ct_g.index_select(0, rg)).reshape(-1, h, d)
    g = rnd(ft_e * ct_e).sum(dim=2)
    a_num = acoef
    if drop > 0.0:
        m = drop_mask(eid, seed, drop, h)
        a_num, g = acoef * m, g * m
    q = rnd(acoef * (g - rnd_stats(rho_g.index_select(0, rg))) * dl)
    return q, rnd(rnd(a_num)[:, :, None] * ct_e).reshape(-1, h * d)


def attn_bwd_src_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h: int,
                       d: int, slope: float, drop: float, seed, n_win: int,
                       bf16: bool = False):
    """K7, ``to_src=True``, over the backward (window-major) layout, where
    ``a`` picks hub rows of group ``in_id`` and ``b`` source rows of
    window ``out_id``. Per real slot: ``acoef = exp(leaky(el_s + er_b) -
    lse_b)``, ``g = <ft_s, ct_b>`` per head and ``q = acoef * (g * mask -
    rho_b) * leaky'``. Returns gft (n_win*128, h*d) (sum of ``acoef *
    mask * ct_b``), gel (n_win*128, h) (sum of q) and the per-chunk
    partials gerp (n_chunks*128, h) (q summed onto each chunk's hub
    rows). Rows no slot reaches are zero. ``bf16``: see
    :func:`_bwd_terms`."""
    rows_g, rows_w, valid = _chunk_rows(lay)
    n_chunks = lay["in_id"].shape[0]
    chunk = lay["a"].shape[0] // max(n_chunks, 1)
    rows_p = (torch.arange(n_chunks, device=el.device).repeat_interleave(
        chunk) * BLK + lay["a"].long())[valid]
    rw = rows_w[valid]
    q, msg = _bwd_terms(el, er_g, lse_g, rho_g, ft, ct_g, lay["eid"][valid],
                        rows_g[valid], rw, h, d, slope, drop, seed, bf16)
    gft = ft.new_zeros((n_win * BLK, h * d)).index_add_(0, rw, msg)
    gel = el.new_zeros((n_win * BLK, h)).index_add_(0, rw, q)
    gerp = el.new_zeros((n_chunks * BLK, h)).index_add_(0, rows_p, q)
    return gft, gel, gerp


def attn_bwd_grp_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h: int,
                       d: int, slope: float, drop: float, seed,
                       n_groups: int, bf16: bool = False):
    """K7, ``to_src=False`` (g-major), over the forward (group-major)
    layout, where ``a`` picks source rows of window ``in_id`` and ``b``
    hub rows of group ``out_id``: grad_er (n_groups*128, h), the sum of
    each real slot's q (as :func:`attn_bwd_src_torch`) onto its hub row;
    rows no slot reaches are zero. ``bf16``: see :func:`_bwd_terms`."""
    rows_s, rows_g, valid = _chunk_rows(lay)
    rg = rows_g[valid]
    q, _ = _bwd_terms(el, er_g, lse_g, rho_g, ft, ct_g, lay["eid"][valid],
                      rg, rows_s[valid], h, d, slope, drop, seed, bf16)
    return el.new_zeros((n_groups * BLK, h)).index_add_(0, rg, q)


def ger_reduce_torch(lay, gerp, n_groups: int):
    """K8: per-group grad_er (n_groups*128, h), the sum of the per-chunk
    partial blocks ``gerp[gperm[k]]`` onto group ``gout[k]``."""
    h = gerp.shape[1]
    n_chunks = lay["gperm"].shape[0]
    blocks = gerp.reshape(n_chunks, BLK, h).index_select(
        0, lay["gperm"].long())
    out = gerp.new_zeros((n_groups, BLK, h)).index_add_(
        0, lay["gout"].long(), blocks)
    return out.reshape(n_groups * BLK, h)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _lib():
    from dgl1_tpu_torch import cuda_build

    return cuda_build.load("attn_kernels")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _done(name, rc, bf16=False):
    if rc != 0:
        raise RuntimeError(f"attention kernel {name}: CUDA error {rc} at "
                           "launch")
    LAUNCHES[f"{name}.bf16" if bf16 else name] += 1


def _check_layout(lay, dev, keys):
    for k in keys:
        _int32(k, lay[k], dev)
    n_chunks = lay["in_id"].shape[0]
    n_slots = lay["a"].shape[0]
    if lay["b"].shape[0] != n_slots or lay["eid"].shape[0] != n_slots or (
            n_chunks and n_slots % n_chunks):
        raise ValueError("chunk layout slots do not match its chunk count")
    return n_chunks, n_slots // max(n_chunks, 1)


def _check_rows(name, t, rows, cols, dev):
    _f32(name, t, dev)
    if t.shape[1] != cols or t.shape[0] < rows:
        raise ValueError(f"{name}: expected at least ({rows}, {cols}), got "
                         f"{tuple(t.shape)}")


def _drop_args(drop, seed, dev):
    """(seed pointer or None, int threshold, float32 1/keep)."""
    if not 0.0 <= drop < 1.0:
        raise ValueError(f"drop must be in [0, 1), got {drop}")
    if drop == 0.0:
        return None, 0, 1.0
    if seed is None:
        raise ValueError("drop > 0 needs a seed tensor")
    _int32("seed", seed, dev)
    keep = 1.0 - drop
    return seed.data_ptr(), int(keep * 2147483647.0), 1.0 / keep


def _check_heads(h, d, dev):
    if not 1 <= h <= BLK:
        raise ValueError(f"heads must be in [1, {BLK}], got {h}")
    if dev.type == "cuda" and d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the attention kernels take heads of at most {MAX_HEAD_DIM} "
            f"features, got {d}")


# K6 on the card (csrc/attn_kernels.cu): a block owns a stripe of at most
# FWD_COLS feature columns and stages 128-row windows of it in shared
# memory, two at a time; it may opt into FWD_SMEM_MAX bytes.
FWD_COLS = 128
FWD_SMEM_MAX = 227 * 1024


class FwdPlan(NamedTuple):
    """K6's stripes: ``nhs`` heads a stripe (1 when d > 128, each head then
    cut into ``nsub`` pieces of up to 128 columns), staged rows ``ws``
    floats apart, ``g`` lanes a slot, ``n_stripes`` stripes and the
    block's ``smem`` bytes."""
    nhs: int
    nsub: int
    ws: int
    g: int
    n_stripes: int
    smem: int


_FWD_WARPS = 16  # warps of a K6 block


def _fwd_smem(nhs: int, ws: int) -> int:
    # Two ft and two el windows, er and the shift, and each warp's p and
    # staged rows of 32 slots.
    return 4 * (BLK * (2 * ws + 4 * nhs) + _FWD_WARPS * 32 * (nhs + 1))


def fwd_plan(h: int, d: int) -> FwdPlan:
    """K6's plan for h heads of d features: whole heads a stripe (at most
    32) while they fit FWD_COLS columns, halved while the block would pass
    FWD_SMEM_MAX
    (narrow heads bring per-head arrays); a head wider than FWD_COLS is
    cut into FWD_COLS-column pieces."""
    if d > FWD_COLS:
        nhs, nsub, widest = 1, -(-d // FWD_COLS), FWD_COLS
    else:
        # At most 32 heads: lane k of a warp keeps head k's den.
        nhs, nsub = min(h, FWD_COLS // d, 32), 1
        while nhs > 1 and _fwd_smem(nhs, -(-nhs * d // 4) * 4 + 4) \
                > FWD_SMEM_MAX:
            nhs = (nhs + 1) // 2
        widest = nhs * d
    ws = -(-widest // 4) * 4 + 4
    g = 1
    while 4 * g < widest:
        g *= 2
    stripes = h * nsub if d > FWD_COLS else -(-h // nhs)
    return FwdPlan(nhs, nsub, ws, g, stripes, _fwd_smem(nhs, ws))


# K7 g-major on the card (csrc/attn_kernels.cu attn_bwd_grp_kernel): a
# 16-warp block owns a stripe of whole heads, at most GRP_STRIPE_COLS
# columns (one head when wider), stages each batch of chunks (its 128-row
# window and its slots' a, b and eid; two batches at a time where they
# fit), the group's ct rows where they fit too, and keeps a (128 x heads)
# partial of q per warp; a lane holds at most GRP_COLS features of one
# head's row.
GRP_COLS = 32
GRP_STRIPE_COLS = 128
_GRP_WARPS = 16


class GrpPlan(NamedTuple):
    """K7 g-major's stripes: ``hs`` heads a stripe, ``g`` lanes a head of
    ``cpl`` features each, staged rows ``ws`` floats apart, ``nbuf``
    batches staged at once, of at most ``abcap`` slots, ``ctsh`` 1 where
    the group's ct rows are staged too, ``n_stripes`` stripes and the
    block's ``smem`` bytes."""
    hs: int
    g: int
    cpl: int
    ws: int
    nbuf: int
    abcap: int
    ctsh: int
    n_stripes: int
    smem: int


def _grp_smem(hs: int, ws: int, nbuf: int, abcap: int, ctsh: int) -> int:
    # nbuf staged batches (window, el, the slots' a, b and eid), the
    # group's ct rows, its er, lse and rho, and each warp's partial of q.
    return 4 * (nbuf * (BLK * (ws + hs) + 3 * abcap) + ctsh * BLK * ws
                + (3 + _GRP_WARPS) * BLK * hs)


# K7 g-major's stagings (batches at once, slots a batch, ct rows staged),
# best first; a batch holds at least one chunk.
_GRP_STAGING = ((2, 4096, 1), (2, 2048, 1), (2, 4096, 0), (2, 2048, 0),
                (2, 1024, 1), (2, 1024, 0), (1, 4096, 0), (1, 2048, 0),
                (1, 1024, 0))


def grp_plan(h: int, d: int, chunk: int = 1024) -> GrpPlan:
    """K7 g-major's plan for h heads of d features over chunks of
    ``chunk`` slots: g (a power of two) lanes a head, so that each holds
    at most GRP_COLS features; whole heads a stripe (a power of two, hs *
    g <= 32 lanes) while they fit GRP_STRIPE_COLS columns, halved while no
    staging of _GRP_STAGING that holds a chunk fits FWD_SMEM_MAX. Rows of
    a multiple of 4 floats are staged 16 bytes at a time, a multiple of 32
    floats apart where they are that wide (the lanes' 16-byte reads then
    fall in distinct bank groups), else 4 floats more; other rows at an
    odd stride. Raises for chunks no staging holds."""
    g = 1
    while GRP_COLS * g < d:
        g *= 2
    cpl = -(-(-(-d // g)) // 4) * 4
    cap = min(32 // g, max(1, GRP_STRIPE_COLS // d), h)
    hs = 1
    while 2 * hs <= cap:
        hs *= 2
    while True:
        w = hs * d
        if d % 4 == 0:
            ws = w if w % 32 == 0 else -(-w // 4) * 4 + 4
        else:
            ws = w | 1
        fits = [stg for stg in _GRP_STAGING if stg[1] >= chunk
                and _grp_smem(hs, ws, *stg) <= FWD_SMEM_MAX]
        if fits:
            break
        if hs == 1:
            raise ValueError(f"attn_bwd_grp stages a chunk in shared "
                             f"memory: no plan for h={h}, d={d} and chunks "
                             f"of {chunk} slots")
        hs //= 2
    return GrpPlan(hs, g, cpl, ws, *fits[0], -(-h // hs),
                   _grp_smem(hs, ws, *fits[0]))


def attn_fwd(lay, el, er_g, ft, h: int, d: int, slope: float,
             drop: float = 0.0, seed=None, n_groups: int = 1,
             bf16: bool = False):
    """K6. ``lay``: the forward chunk layout (a, b, eid, in_id, out_id
    int32); ``el`` (num_src, h), ``er_g`` (n_groups*128, h), ``ft``
    (num_src, h*d) float32; ``seed`` an int32 (1,) tensor when
    ``drop`` > 0. Returns (num, den, mraw) as :func:`attn_fwd_torch`.
    ``bf16``: see :func:`attn_fwd_torch`; on the card it needs scratch of
    2 * n_chunks * 128 * h floats for the rescale factors (and a little
    more for their segment products)."""
    dev = ft.device
    n_chunks, chunk = _check_layout(lay, dev, ("a", "b", "eid", "in_id",
                                               "out_id"))
    _check_heads(h, d, dev)
    _check_rows("el", el, 0, h, dev)
    _check_rows("er_g", er_g, n_groups * BLK, h, dev)
    _check_rows("ft", ft, el.shape[0], h * d, dev)
    seed_p, thresh, inv_keep = _drop_args(drop, seed, dev)
    if n_chunks == 0:
        # No slot: what the plain version gives, without a launch.
        NO_WORK["attn_fwd"] += 1
        z = torch.zeros((n_groups * BLK, h), dtype=torch.float32,
                        device=dev)
        return (torch.zeros((n_groups * BLK, h * d), dtype=torch.float32,
                            device=dev), z, torch.full_like(z, NEG))
    if dev.type == "cpu":
        return attn_fwd_torch(lay, el, er_g, ft, h, d, slope, drop, seed,
                              n_groups, bf16)
    pl = fwd_plan(h, d)
    # Every element of the outputs is written.
    num = torch.empty((n_groups * BLK, h * d), dtype=torch.float32,
                      device=dev)
    den = torch.empty((n_groups * BLK, h), dtype=torch.float32, device=dev)
    mraw = torch.empty((n_groups * BLK, h), dtype=torch.float32, device=dev)
    mkey = torch.empty((n_groups, h), dtype=torch.int32, device=dev)
    plan = (pl.nhs, pl.nsub, pl.ws, pl.g)
    with torch.cuda.device(dev), _kernel_span("attn_fwd", bf16):
        lib = _lib()
        n = lib.attn_fwd_scratch(n_chunks, h, d, *plan, n_groups,
                                 int(drop > 0.0), int(bf16))
        if n < 0:
            raise RuntimeError(f"attention kernel attn_fwd: no launch for "
                               f"h={h}, d={d}")
        scratch = torch.empty((max(n, 1),), dtype=torch.float32, device=dev)
        rc = lib.attn_fwd(
            lay["a"].data_ptr(), lay["b"].data_ptr(), lay["eid"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, el.data_ptr(), el.shape[0], er_g.data_ptr(),
            ft.data_ptr(), h, d, *plan, ctypes.c_float(slope), seed_p,
            thresh, ctypes.c_float(inv_keep), n_groups, mkey.data_ptr(),
            int(bf16), scratch.data_ptr(), num.data_ptr(), den.data_ptr(),
            mraw.data_ptr(), _stream(dev))
    _done("attn_fwd", rc, bf16)
    return num, den, mraw


def _check_bwd(lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, drop, seed):
    """K7's checks (both modes): (device, n_chunks, chunk, seed pointer,
    threshold, 1/keep)."""
    dev = ft.device
    n_chunks, chunk = _check_layout(lay, dev, ("a", "b", "eid", "in_id",
                                               "out_id"))
    _check_heads(h, d, dev)
    _check_rows("el", el, 0, h, dev)
    rows_g = er_g.shape[0]
    for name, x in (("er_g", er_g), ("lse_g", lse_g), ("rho_g", rho_g)):
        _check_rows(name, x, rows_g, h, dev)
    _check_rows("ft", ft, el.shape[0], h * d, dev)
    _check_rows("ct_g", ct_g, rows_g, h * d, dev)
    return (dev, n_chunks, chunk) + _drop_args(drop, seed, dev)


def attn_bwd_src(lay, el, er_g, lse_g, rho_g, ft, ct_g, h: int, d: int,
                 slope: float, drop: float = 0.0, seed=None,
                 n_win: int = 1, bf16: bool = False):
    """K7 (``to_src=True``). ``lay``: the backward chunk layout;
    ``el`` (num_src, h); ``er_g``, ``lse_g``, ``rho_g`` (n_groups*128, h);
    ``ft`` (num_src, h*d); ``ct_g`` (n_groups*128, h*d). Returns (gft,
    gel, gerp) as :func:`attn_bwd_src_torch`. ``bf16``: see
    :func:`_bwd_terms`."""
    dev, n_chunks, chunk, seed_p, thresh, inv_keep = _check_bwd(
        lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, drop, seed)
    if dev.type == "cuda" and chunk > MAX_SRC_CHUNK:
        raise ValueError(
            f"attn_bwd_src sorts each batch of chunks in shared memory: "
            f"chunks of at most {MAX_SRC_CHUNK} slots, got {chunk}")
    if n_chunks == 0:
        NO_WORK["attn_bwd_src"] += 1
        return (torch.zeros((n_win * BLK, h * d), dtype=torch.float32,
                            device=dev),
                torch.zeros((n_win * BLK, h), dtype=torch.float32,
                            device=dev),
                torch.zeros((0, h), dtype=torch.float32, device=dev))
    if dev.type == "cpu":
        return attn_bwd_src_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h,
                                  d, slope, drop, seed, n_win, bf16)
    gft = torch.empty((n_win * BLK, h * d), dtype=torch.float32, device=dev)
    gel = torch.empty((n_win * BLK, h), dtype=torch.float32, device=dev)
    gerp = torch.empty((n_chunks * BLK, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), _kernel_span("attn_bwd_src", bf16):
        rc = _lib().attn_bwd_src(
            lay["a"].data_ptr(), lay["b"].data_ptr(), lay["eid"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, el.data_ptr(), er_g.data_ptr(), lse_g.data_ptr(),
            rho_g.data_ptr(), ft.data_ptr(), ct_g.data_ptr(), h, d,
            ctypes.c_float(slope), seed_p, thresh, ctypes.c_float(inv_keep),
            n_win, int(bf16), gft.data_ptr(), gel.data_ptr(),
            gerp.data_ptr(), _stream(dev))
    _done("attn_bwd_src", rc, bf16)
    return gft, gel, gerp


def attn_bwd_grp(lay, el, er_g, lse_g, rho_g, ft, ct_g, h: int, d: int,
                 slope: float, drop: float = 0.0, seed=None,
                 n_groups: int = 1, bf16: bool = False):
    """K7 g-major (``to_src=False``). ``lay``: the forward chunk layout;
    the other operands as :func:`attn_bwd_src`. Returns grad_er
    (n_groups*128, h) as :func:`attn_bwd_grp_torch`. On the card the sums
    run in a fixed order (per-block partials folded in block order), so
    two runs give the same bits."""
    dev, n_chunks, chunk, seed_p, thresh, inv_keep = _check_bwd(
        lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, drop, seed)
    if er_g.shape[0] < n_groups * BLK:
        raise ValueError("the group rows must cover n_groups * 128 rows")
    if dev.type == "cpu":
        return attn_bwd_grp_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h,
                                  d, slope, drop, seed, n_groups, bf16)
    # Every element of the output is written.
    ger = torch.empty((n_groups * BLK, h), dtype=torch.float32, device=dev)
    if n_groups == 0:
        return ger  # the C entry would launch nothing
    pl = grp_plan(h, d, max(chunk, 1))
    plan = pl[:7]
    with torch.cuda.device(dev), _kernel_span("attn_bwd_grp", bf16):
        lib = _lib()
        n = lib.attn_grp_scratch(n_chunks, chunk, n_groups, h, d, *plan)
        if n < 0:
            raise RuntimeError(f"attention kernel attn_bwd_grp: no launch "
                               f"for h={h}, d={d}")
        scratch = torch.empty((max(n, 1),), dtype=torch.float32, device=dev)
        rc = lib.attn_bwd_grp(
            lay["a"].data_ptr(), lay["b"].data_ptr(), lay["eid"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, el.data_ptr(), el.shape[0], er_g.data_ptr(),
            lse_g.data_ptr(), rho_g.data_ptr(), ft.data_ptr(),
            ct_g.data_ptr(), h, d, *plan, ctypes.c_float(slope), seed_p,
            thresh, ctypes.c_float(inv_keep), n_groups, int(bf16),
            scratch.data_ptr(), ger.data_ptr(), _stream(dev))
    _done("attn_bwd_grp", rc, bf16)
    return ger


def ger_reduce(lay, gerp, n_groups: int):
    """K8. ``lay``: the backward layout's gperm/gout (int32, one entry per
    chunk, gout sorted); ``gerp`` (n_chunks*128, h) float32. Returns
    (n_groups*128, h); groups no chunk reaches are zero (the reference
    leaves them unspecified). On the card the kernel reads ``gerp`` 16
    bytes at a time (a ``gerp`` off a 16-byte boundary is copied once) and
    writes every output element, summing in a fixed order."""
    dev = gerp.device
    _int32("gperm", lay["gperm"], dev)
    _int32("gout", lay["gout"], dev)
    _check("gerp", gerp, (torch.float32,), 2, dev)
    n_chunks = lay["gperm"].shape[0]
    if lay["gout"].shape[0] != n_chunks or gerp.shape[0] != n_chunks * BLK:
        raise ValueError("gerp must hold 128 rows per chunk of gperm")
    if dev.type == "cpu":
        return ger_reduce_torch(lay, gerp, n_groups)
    h = gerp.shape[1]
    if n_groups == 0 or h == 0:
        return gerp.new_empty((n_groups * BLK, h))
    if gerp.data_ptr() % 16:
        gerp = gerp.clone()
    n_out = n_groups * BLK * h
    with torch.cuda.device(dev), _kernel_span("ger_reduce"):
        lib = _lib()
        # The output, then the scratch slots, in one allocation.
        buf = torch.empty((n_out + lib.attn_ger_scratch(n_chunks, n_groups,
                                                        h),),
                          dtype=torch.float32, device=dev)
        out, part = buf[:n_out].view(n_groups * BLK, h), buf[n_out:]
        rc = lib.attn_ger_reduce(lay["gperm"].data_ptr(),
                                 lay["gout"].data_ptr(), n_chunks, n_groups,
                                 gerp.data_ptr(), h, part.data_ptr(),
                                 out.data_ptr(), _stream(dev))
    _done("ger_reduce", rc)
    return out
