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
else.

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

import torch
from torch.nn.functional import leaky_relu

from dgl1_tpu_torch.hub_format import BLK
from dgl1_tpu_torch.ops.hub_kernels import _check, _chunk_rows, _f32, _int32
from dgl1_tpu_torch.ops.precision import round_bf16, rounding

__all__ = ["attn_fwd", "attn_bwd_src", "attn_bwd_grp", "ger_reduce",
           "attn_fwd_torch", "attn_bwd_src_torch", "attn_bwd_grp_torch",
           "ger_reduce_torch", "drop_mask", "LAUNCHES", "reset_launches",
           "KERNELS", "MAX_HEAD_DIM"]

_BF16 = ("attn_fwd", "attn_bwd_src", "attn_bwd_grp")
KERNELS = _BF16 + ("ger_reduce",) + tuple(f"{k}.bf16" for k in _BF16)
LAUNCHES = {k: 0 for k in KERNELS}

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


def attn_fwd(lay, el, er_g, ft, h: int, d: int, slope: float,
             drop: float = 0.0, seed=None, n_groups: int = 1,
             bf16: bool = False):
    """K6. ``lay``: the forward chunk layout (a, b, eid, in_id, out_id
    int32); ``el`` (num_src, h), ``er_g`` (n_groups*128, h), ``ft``
    (num_src, h*d) float32; ``seed`` an int32 (1,) tensor when
    ``drop`` > 0. Returns (num, den, mraw) as :func:`attn_fwd_torch`.
    ``bf16``: see :func:`attn_fwd_torch`; on the card it needs scratch of
    2 * n_chunks * 128 * h floats for the rescale factors."""
    dev = ft.device
    n_chunks, chunk = _check_layout(lay, dev, ("a", "b", "eid", "in_id",
                                               "out_id"))
    _check_heads(h, d, dev)
    _check_rows("el", el, 0, h, dev)
    _check_rows("er_g", er_g, n_groups * BLK, h, dev)
    _check_rows("ft", ft, el.shape[0], h * d, dev)
    seed_p, thresh, inv_keep = _drop_args(drop, seed, dev)
    if dev.type == "cpu":
        return attn_fwd_torch(lay, el, er_g, ft, h, d, slope, drop, seed,
                              n_groups, bf16)
    num = torch.zeros((n_groups * BLK, h * d), dtype=torch.float32,
                      device=dev)
    den = torch.zeros((n_groups * BLK, h), dtype=torch.float32, device=dev)
    mraw = torch.empty((n_groups * BLK, h), dtype=torch.float32, device=dev)
    mkey = torch.empty((n_groups, h), dtype=torch.int32, device=dev)
    # bf16 scratch: each chunk's max and running max, and the online
    # rescale factors per (chunk, hub row, head).
    scratch = [None] * 4
    if bf16:
        scratch = [torch.empty((n, h), dtype=torch.float32, device=dev)
                   for n in (n_chunks, n_chunks, n_chunks * BLK,
                             n_chunks * BLK)]
    ptrs = [None if x is None else x.data_ptr() for x in scratch]
    with torch.cuda.device(dev):
        rc = _lib().attn_fwd(
            lay["a"].data_ptr(), lay["b"].data_ptr(), lay["eid"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, el.data_ptr(), er_g.data_ptr(), ft.data_ptr(), h, d,
            ctypes.c_float(slope), seed_p, thresh, ctypes.c_float(inv_keep),
            n_groups, mkey.data_ptr(), int(bf16), *ptrs, num.data_ptr(),
            den.data_ptr(), mraw.data_ptr(), _stream(dev))
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
    if dev.type == "cpu":
        return attn_bwd_src_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h,
                                  d, slope, drop, seed, n_win, bf16)
    gft = torch.empty((n_win * BLK, h * d), dtype=torch.float32, device=dev)
    gel = torch.empty((n_win * BLK, h), dtype=torch.float32, device=dev)
    gerp = torch.empty((n_chunks * BLK, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
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
    (n_groups*128, h) as :func:`attn_bwd_grp_torch`."""
    dev, n_chunks, chunk, seed_p, thresh, inv_keep = _check_bwd(
        lay, el, er_g, lse_g, rho_g, ft, ct_g, h, d, drop, seed)
    if er_g.shape[0] < n_groups * BLK:
        raise ValueError("the group rows must cover n_groups * 128 rows")
    if dev.type == "cpu":
        return attn_bwd_grp_torch(lay, el, er_g, lse_g, rho_g, ft, ct_g, h,
                                  d, slope, drop, seed, n_groups, bf16)
    ger = torch.zeros((n_groups * BLK, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().attn_bwd_grp(
            lay["a"].data_ptr(), lay["b"].data_ptr(), lay["eid"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, el.data_ptr(), er_g.data_ptr(), lse_g.data_ptr(),
            rho_g.data_ptr(), ft.data_ptr(), ct_g.data_ptr(), h, d,
            ctypes.c_float(slope), seed_p, thresh, ctypes.c_float(inv_keep),
            int(bf16), ger.data_ptr(), _stream(dev))
    _done("attn_bwd_grp", rc, bf16)
    return ger


def ger_reduce(lay, gerp, n_groups: int):
    """K8. ``lay``: the backward layout's gperm/gout (int32, one entry per
    chunk); ``gerp`` (n_chunks*128, h) float32. Returns (n_groups*128, h);
    groups no chunk reaches are zero (the reference leaves them
    unspecified)."""
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
    out = torch.zeros((n_groups * BLK, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().attn_ger_reduce(lay["gperm"].data_ptr(),
                                    lay["gout"].data_ptr(), n_chunks,
                                    gerp.data_ptr(), h, out.data_ptr(),
                                    _stream(dev))
    _done("ger_reduce", rc)
    return out
