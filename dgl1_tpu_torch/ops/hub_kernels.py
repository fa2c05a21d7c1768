"""Wrappers of the hub engine's CUDA kernels, each beside its plain torch
version.

Kernel (``csrc/hub_kernels.cu``)   replaces (``dgl1_tpu/ops/engine_hub.py``)
--------------------------------   ------------------------------------------
K1  :func:`dense_fwd`              ``_dense_fwd_kernel`` / ``_dense_fwd_call``
K2  :func:`chunk_sum`              ``_chunk_kernel`` (plain) / ``_chunk_call``
K3  :func:`expand`                 ``_expand_kernel`` / ``_expand_call``
K4a :func:`dense_bwd_fused`        ``_dense_bwd_fused_kernel`` / its call
K4b :func:`dense_bwd`              ``_dense_bwd_kernel`` / ``_dense_bwd_call``
K2  :func:`chunk_weighted`         ``_chunk_kernel`` (mul, rhs) / ``_chunk_call``
K5  :func:`edge_grad`              ``_edge_grad_kernel`` / ``_edge_grad_call``

A wrapper given CPU tensors computes its plain version (``*_torch``);
given CUDA tensors it launches its kernel or raises. It checks devices,
types, shapes and contiguity, allocates the output, and adds one to
``LAUNCHES[name]`` for each kernel launch and nowhere else: where there
is nothing to compute (no chunk, no row or a zero width) it returns the
output without calling the kernel. Each launch runs in the span
``kernel.<name>`` (``utils/profiler.py``).

Feature widths need no padding to 128 and the source operands may stop at
``num_src`` rows: the kernels mask the ragged edges (the plain versions
give the same values on the reference's padded arrays).

The weighted modes take the per-edge operand ``e2`` (E, he) and the
layout's ``eid`` where the reference takes the gathered, transposed
weights ``wt`` (H_pad, n_slots) and the 0/1 spread matrix ``R``: the
kernel gathers ``e2[eid]`` itself, so the glue builds no per-slot tensor.
Head h covers features ``h*rep : (h+1)*rep``. K5 returns (n_slots, he),
the transpose of the reference's ``(H_pad, n_slots)[:he]``, zero on
padding slots. Their launches count per mode: ``chunk_mul``,
``chunk_rhs``, ``edge_grad_mul``, ``edge_grad_rhs``.

Every kernel but K3 takes ``bf16`` (``ops/precision.py``'s bf16 mode): it
rounds to bfloat16 exactly what the reference casts to ``dt`` (each plain
version says what) and accumulates in float32; such launches count under
``"<name>.bf16"``.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.hub_format import (BLK, CHUNK, DENSE_RB, EXPAND_PACK,
                                       EXPAND_RB)
from dgl1_tpu_torch.ops.precision import rounding as _rnd
from dgl1_tpu_torch.utils.profiler import span

__all__ = ["dense_fwd", "chunk_sum", "expand", "dense_bwd_fused",
           "dense_bwd", "chunk_weighted", "edge_grad", "dense_fwd_torch",
           "chunk_sum_torch", "expand_torch", "dense_bwd_fused_torch",
           "dense_bwd_torch", "chunk_weighted_torch", "edge_grad_torch",
           "LAUNCHES", "reset_launches", "KERNELS", "edge_grad_plan"]

# Every kernel but K3 has a bf16 instantiation, counted as "<name>.bf16".
_BASE = ("dense_fwd", "chunk_sum", "expand", "dense_bwd_fused", "dense_bwd",
         "chunk_mul", "chunk_rhs", "edge_grad_mul", "edge_grad_rhs")
KERNELS = _BASE + tuple(f"{k}.bf16" for k in _BASE if k != "expand")
_MODES = {"mul": 0, "rhs": 1}
LAUNCHES = {k: 0 for k in KERNELS}

_C_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Plain torch versions
# ----------------------------------------------------------------------

def dense_fwd_torch(c, u, bf16: bool = False):
    """K1: (kd, f) = C[:n]^T @ U for U of n <= rows_pad rows; ``bf16``
    rounds C (counts above 256 lose bits, as in the reference) and U."""
    r = _rnd(bf16)
    return r(c[: u.shape[0]].to(u.dtype)).t() @ r(u)


def _chunk_rows(lay):
    """Per-slot (input row, output row) and the valid-slot mask."""
    n_chunks = lay["in_id"].shape[0]
    chunk = lay["a"].shape[0] // max(n_chunks, 1)
    a, b = lay["a"].long(), lay["b"].long()
    rows_in = lay["in_id"].long().repeat_interleave(chunk) * BLK + a
    rows_out = lay["out_id"].long().repeat_interleave(chunk) * BLK + b
    return rows_in, rows_out, (a >= 0) & (b >= 0)


def chunk_sum_torch(lay, inp, n_out_blocks: int, bf16: bool = False):
    """K2, plain mode: out[out_id*128 + b] += in[in_id*128 + a] over the
    real slots; (n_out_blocks*128, f), zero where no chunk writes.
    ``bf16`` rounds the gathered rows."""
    rows_in, rows_out, valid = _chunk_rows(lay)
    valid = valid & (rows_in < inp.shape[0])
    out = inp.new_zeros((n_out_blocks * BLK, inp.shape[1]))
    return out.index_add_(0, rows_out[valid],
                          _rnd(bf16)(inp.index_select(0, rows_in[valid])))


def chunk_weighted_torch(mode: str, lay, e2, inp, n_out_blocks: int,
                         he: int, rep: int, bf16: bool = False):
    """K2, mul and rhs modes: for every real slot whose edge id lies in
    ``e2`` (and, in mul mode, whose input row lies in ``inp``),
    ``out[out_id*128 + b] += msg`` with msg ``inp[in_id*128 + a] *
    e2[eid]`` spread per head (mul, width he*rep) or ``e2[eid]`` (rhs,
    width he); (n_out_blocks*128, width), zero where no slot writes.
    ``bf16`` rounds the message before its sum and, in mul mode, the
    gathered input row before the product (not the weight)."""
    r = _rnd(bf16)
    rows_in, rows_out, valid = _chunk_rows(lay)
    eid = lay["eid"].long()
    valid = valid & (eid >= 0) & (eid < e2.shape[0])
    if mode == "mul":
        valid = valid & (rows_in < inp.shape[0])
    msg = e2.index_select(0, eid[valid])
    if mode == "mul":
        msg = (r(inp.index_select(0, rows_in[valid]))
               * msg.repeat_interleave(rep, dim=1))
    out = msg.new_zeros((n_out_blocks * BLK, msg.shape[1]))
    return out.index_add_(0, rows_out[valid], r(msg))


def edge_grad_torch(mode: str, lay, u, ct, he: int, rep: int,
                    bf16: bool = False):
    """K5: per slot and head, ``sum over the head's features of
    u[in_id*128 + a] * ct[out_id*128 + b]`` (mul) or ``ct[out_id*128 +
    b, h]`` (rhs); (n_slots, he), zero on padding slots. ``bf16`` rounds
    the gathered ct and u rows and, in mul mode, their product before the
    head sum."""
    r = _rnd(bf16)
    rows_in, rows_out, valid = _chunk_rows(lay)
    valid = valid & (rows_out < ct.shape[0])
    if mode == "mul":
        valid = valid & (rows_in < u.shape[0])
    idx = valid.nonzero().squeeze(1)
    c = r(ct.index_select(0, rows_out[idx]))
    if mode == "mul":
        c = r(r(u.index_select(0, rows_in[idx])) * c).reshape(
            -1, he, rep).sum(2)
    out = ct.new_zeros((lay["a"].shape[0], he))
    out[idx] = c[:, :he]
    return out


def _decode(starts, desc, rows_per_block: int):
    """Packed descriptors -> (global row, source row) of every entry."""
    n_blocks = starts.shape[0] - 1
    s = starts.long()
    counts = s[1:] - s[:-1]
    d = desc[: int(s[-1])].long()
    block = torch.repeat_interleave(
        torch.arange(n_blocks, device=desc.device), counts)
    local = torch.div(d, EXPAND_PACK, rounding_mode="floor")
    return block * rows_per_block + local, d - local * EXPAND_PACK


def expand_torch(merged, x_starts, x_desc, num_dst: int, diag_w=None,
                 diag_u=None):
    """K3: out[v] = merged[t_inv[v]] through the packed descriptors, zero
    rows elsewhere; (num_dst, f). With ``diag_w`` (n, he), the diagonal
    epilogue on the first n rows: plus ``diag_w[v, j // rep] *
    diag_u[v, j]`` (rep = f // he), or ``diag_w[v, j // rep]`` without
    ``diag_u``: the engine's extracted self-loop term, rounded as the
    engine rounded it (product, then sum)."""
    n_rb = -(-num_dst // EXPAND_RB)
    rows, src = _decode(x_starts[: n_rb + 1], x_desc, EXPAND_RB)
    out = merged.new_zeros((num_dst, merged.shape[1]))
    out[rows] = merged.index_select(0, src)
    if diag_w is not None:
        out[: diag_w.shape[0]] += _diag_share(diag_w, diag_u,
                                              merged.shape[1])
    return out


def _diag_share(diag_w, diag_u, f: int):
    """(n, f): ``diag_w`` (n, he) spread over rep = f // he columns a
    head, times ``diag_u[:n]`` where given."""
    n, he = diag_w.shape
    if diag_u is None:
        return diag_w.repeat_interleave(f // he, dim=1)
    return (diag_u[:n].reshape(n, he, f // he)
            * diag_w[:, :, None]).reshape(n, f)


def dense_bwd_torch(c, ct, n_out=None, bf16: bool = False):
    """K4b: (n_out, f) = C[:n_out] @ ct; ``bf16`` rounds C and ct."""
    n_out = c.shape[0] if n_out is None else n_out
    r = _rnd(bf16)
    return r(c[:n_out].to(ct.dtype)) @ r(ct)


def dense_bwd_fused_torch(c, ct, tail, gb_starts, gb_desc, n_out=None,
                          bf16: bool = False):
    """K4a: K4b plus tail[t] on every row a descriptor names (the tail is
    not rounded in bf16 mode)."""
    out = dense_bwd_torch(c, ct, n_out, bf16)
    n_rb = c.shape[0] // DENSE_RB
    rows, src = _decode(gb_starts[: n_rb + 1], gb_desc, DENSE_RB)
    keep = rows < out.shape[0]
    return out.index_add_(0, rows[keep], tail.index_select(0, src[keep]))


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check(name, t, dtypes, dim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32(name, t, device):
    _check(name, t, (torch.int32,), 1, device)


def _f32(name, t, device):
    _check(name, t, (torch.float32,), 2, device)


def _lib():
    from dgl1_tpu_torch import cuda_build

    return cuda_build.load("hub_kernels")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _kernel_span(name, bf16=False):
    """The span of one launch, named as its ``LAUNCHES`` key."""
    return span(f"kernel.{name}.bf16" if bf16 else f"kernel.{name}")


def _done(name, rc, bf16=False):
    if rc != 0:
        raise RuntimeError(f"hub kernel {name}: CUDA error {rc} at launch")
    LAUNCHES[f"{name}.bf16" if bf16 else name] += 1


def _rows16(x):
    """``x`` (n, f) f32 and its row stride: as it is where its rows are a
    multiple of 4 floats on a 16-byte boundary, else copied once into
    zero-padded rows that are (K1 and K2 copy rows 16 bytes at a time)."""
    f = x.shape[1]
    if f % 4 == 0 and x.data_ptr() % 16 == 0:
        return x, f
    ld = -(-f // 4) * 4
    padded = torch.zeros((x.shape[0], ld), dtype=x.dtype, device=x.device)
    padded[:, :f] = x
    return padded, ld


def _aligned16(what, *ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what} 16 bytes at a time: each must start on a "
                         f"16-byte boundary")


def dense_fwd(c, u, bf16: bool = False):
    """K1. ``c``: (rows_pad, kd) int8/bf16/f32 counts; ``u``: (n, f) f32,
    n <= rows_pad. Returns (kd, f) f32. On the card ``c`` must start on a
    16-byte boundary with kd a multiple of 4 (every layout's kd is 128 x
    its dense groups); a ``u`` whose width is not a multiple of 4, or that
    starts off a 16-byte boundary, is copied once into padded rows.
    ``bf16``: see :func:`dense_fwd_torch`."""
    dev = u.device
    _check("c", c, tuple(_C_DTYPES), 2, dev)
    _f32("u", u, dev)
    if u.shape[0] > c.shape[0]:
        raise ValueError("u has more rows than the count matrix")
    if dev.type == "cpu":
        return dense_fwd_torch(c, u, bf16)
    kd, f = c.shape[1], u.shape[1]
    out = torch.zeros((kd, f), dtype=torch.float32, device=dev)
    if u.shape[0] == 0 or kd == 0 or f == 0:
        return out
    if kd % 4:
        raise ValueError("K1 loads four counts of a row at a time: the "
                         "count matrix needs a multiple of 4 columns")
    _aligned16("K1 loads the count matrix", c)
    u, ld = _rows16(u)
    with torch.cuda.device(dev), _kernel_span("dense_fwd", bf16):
        rc = _lib().hub_dense_fwd(c.data_ptr(), _C_DTYPES[c.dtype],
                                  u.data_ptr(), out.data_ptr(), u.shape[0],
                                  kd, f, ld, int(bf16), _stream(dev))
    _done("dense_fwd", rc, bf16)
    return out


def chunk_sum(lay, inp, n_out_blocks: int, bf16: bool = False):
    """K2, plain mode. ``lay``: chunk layout (a, b, in_id, out_id int32);
    ``inp``: (n_in, f) f32. Returns (n_out_blocks*128, f) f32. On the
    card it takes chunks of at most 1024 slots, a multiple of 4, with
    ``a`` and ``b`` on 16-byte boundaries, and copies an ``inp`` whose
    width is not a multiple of 4, or that starts off a 16-byte boundary,
    once into padded rows. ``bf16``: see :func:`chunk_sum_torch`."""
    dev = inp.device
    _f32("inp", inp, dev)
    n_chunks, chunk = _chunk_layout(lay, dev, ("a", "b", "in_id", "out_id"))
    if dev.type == "cpu":
        return chunk_sum_torch(lay, inp, n_out_blocks, bf16)
    f = inp.shape[1]
    out = torch.zeros((n_out_blocks * BLK, f), dtype=torch.float32,
                      device=dev)
    if n_chunks == 0 or f == 0:
        return out  # nothing to launch
    _walkable("K2", lay, chunk, ("a", "b"))
    inp, ld = _rows16(inp)
    with torch.cuda.device(dev), _kernel_span("chunk_sum", bf16):
        rc = _lib().hub_chunk_sum(
            lay["a"].data_ptr(), lay["b"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, inp.data_ptr(), inp.shape[0], ld, out.data_ptr(),
            out.shape[0], f, int(bf16), _stream(dev))
    _done("chunk_sum", rc, bf16)
    return out


def expand(merged, x_starts, x_desc, num_dst: int, diag_w=None,
           diag_u=None):
    """K3. ``merged``: (m, f) f32; packed descriptors as
    ``hub_format.build_hub_format`` emits them. Returns (num_dst, f) f32.
    ``diag_w`` (n <= num_dst, he) f32 with he dividing f, and optionally
    ``diag_u`` (>= n, f) f32: the diagonal epilogue of
    :func:`expand_torch`, added in the kernel's output pass. On the card
    rows that are not a multiple of 4 floats, or operands off a 16-byte
    boundary, take the kernel's scalar-load path."""
    dev = merged.device
    _f32("merged", merged, dev)
    _int32("x_starts", x_starts, dev)
    _int32("x_desc", x_desc, dev)
    if x_starts.shape[0] < -(-num_dst // EXPAND_RB) + 1:
        raise ValueError("x_starts is shorter than the output blocks")
    f = merged.shape[1]
    n_diag = he = 0
    if diag_w is not None:
        _f32("diag_w", diag_w, dev)
        n_diag, he = diag_w.shape
        if n_diag > num_dst or he == 0 or f % he:
            raise ValueError("diag_w must be (n <= num_dst, he) with he "
                             "dividing the row width")
        if diag_u is not None:
            _f32("diag_u", diag_u, dev)
            if diag_u.shape[1] != f or diag_u.shape[0] < n_diag:
                raise ValueError("diag_u must have the output's width and "
                                 "at least diag_w's rows")
    elif diag_u is not None:
        raise ValueError("diag_u needs diag_w")
    if dev.type == "cpu":
        return expand_torch(merged, x_starts, x_desc, num_dst, diag_w,
                            diag_u)
    out = torch.empty((num_dst, f), dtype=torch.float32, device=dev)
    if num_dst == 0 or f == 0:
        return out
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev), _kernel_span("expand"):
        rc = _lib().hub_expand(x_starts.data_ptr(), x_desc.data_ptr(),
                               merged.data_ptr(), merged.shape[0],
                               out.data_ptr(), num_dst, f, ptr(diag_w),
                               max(he, 1), f // max(he, 1), ptr(diag_u),
                               n_diag, _stream(dev))
    _done("expand", rc)
    return out


def _dense_bwd_args(c, ct, n_out):
    dev = ct.device
    _check("c", c, tuple(_C_DTYPES), 2, dev)
    _f32("ct", ct, dev)
    if ct.shape[0] != c.shape[1]:
        raise ValueError("ct rows must equal the count matrix columns")
    n_out = c.shape[0] if n_out is None else int(n_out)
    if n_out > c.shape[0]:
        raise ValueError("n_out exceeds the count matrix rows")
    return dev, n_out


def dense_bwd(c, ct, n_out=None, bf16: bool = False):
    """K4b. ``c``: (rows_pad, kd); ``ct``: (kd, f) f32. Returns
    (n_out, f) f32, n_out defaulting to rows_pad. ``bf16``: see
    :func:`dense_bwd_torch`."""
    dev, n_out = _dense_bwd_args(c, ct, n_out)
    if dev.type == "cpu":
        return dense_bwd_torch(c, ct, n_out, bf16)
    f = ct.shape[1]
    out = torch.empty((n_out, f), dtype=torch.float32, device=dev)
    if n_out == 0 or f == 0:
        return out
    with torch.cuda.device(dev), _kernel_span("dense_bwd", bf16):
        rc = _lib().hub_dense_bwd(c.data_ptr(), _C_DTYPES[c.dtype],
                                  ct.data_ptr(), out.data_ptr(), n_out,
                                  c.shape[1], f, None, None, None,
                                  int(bf16), _stream(dev))
    _done("dense_bwd", rc, bf16)
    return out


def dense_bwd_fused(c, ct, tail, gb_starts, gb_desc, n_out=None,
                    bf16: bool = False):
    """K4a. As :func:`dense_bwd`, plus the compact tail-src stack rows
    ``tail`` (m, f) f32 added through the packed descriptors (not rounded
    in bf16 mode)."""
    dev, n_out = _dense_bwd_args(c, ct, n_out)
    _f32("tail", tail, dev)
    _int32("gb_starts", gb_starts, dev)
    _int32("gb_desc", gb_desc, dev)
    if tail.shape[1] != ct.shape[1]:
        raise ValueError("tail and ct widths differ")
    if gb_starts.shape[0] < c.shape[0] // DENSE_RB + 1:
        raise ValueError("gb_starts is shorter than the row blocks")
    if dev.type == "cpu":
        return dense_bwd_fused_torch(c, ct, tail, gb_starts, gb_desc, n_out,
                                     bf16)
    f = ct.shape[1]
    out = torch.empty((n_out, f), dtype=torch.float32, device=dev)
    if n_out == 0 or f == 0:
        return out
    with torch.cuda.device(dev), _kernel_span("dense_bwd_fused", bf16):
        rc = _lib().hub_dense_bwd(c.data_ptr(), _C_DTYPES[c.dtype],
                                  ct.data_ptr(), out.data_ptr(), n_out,
                                  c.shape[1], f, gb_starts.data_ptr(),
                                  gb_desc.data_ptr(), tail.data_ptr(),
                                  int(bf16), _stream(dev))
    _done("dense_bwd_fused", rc, bf16)
    return out


def _chunk_layout(lay, dev, keys=("a", "b", "eid", "in_id", "out_id")):
    """Check a chunk layout; returns (n_chunks, slots per chunk)."""
    for k in keys:
        _int32(k, lay[k], dev)
    n_chunks, n_slots = lay["in_id"].shape[0], lay["a"].shape[0]
    per_slot = [k for k in keys if k not in ("in_id", "out_id")]
    if any(lay[k].shape[0] != n_slots for k in per_slot) \
            or lay["out_id"].shape[0] != n_chunks \
            or (n_chunks and n_slots % n_chunks):
        raise ValueError("chunk layout slots do not match its chunk count")
    return n_chunks, n_slots // max(n_chunks, 1)


def _mode(mode):
    if mode not in _MODES:
        raise ValueError(f"mode must be 'mul' or 'rhs', got {mode!r}")


def _walkable(name, lay, chunk, keys):
    """The staged chunk walk (K2 plain and mul) loads four slots at a time
    from each of ``keys``."""
    if chunk > CHUNK or chunk % 4:
        raise ValueError(f"{name} takes chunks of at most {CHUNK} slots, "
                         f"a multiple of 4")
    _aligned16(f"{name} loads {', '.join(keys)}", *(lay[k] for k in keys))


def chunk_weighted(mode: str, lay, e2, inp, n_out_blocks: int, he: int,
                   rep: int, bf16: bool = False):
    """K2, mul and rhs modes. ``lay``: chunk layout (a, b, eid, in_id,
    out_id int32); ``e2``: (E, he) f32 per-edge operand; ``inp``:
    (n_in, he*rep) f32 in mul mode, None in rhs mode. Returns
    (n_out_blocks*128, he*rep) f32 (mul) or (n_out_blocks*128, he) f32
    (rhs). Slots whose edge id falls outside ``e2`` are skipped. On the
    card, mul mode takes chunks of at most 1024 slots, a multiple of 4,
    and copies an ``inp`` whose width is not a multiple of 4, or that
    starts off a 16-byte boundary, once into padded rows.
    ``bf16``: see :func:`chunk_weighted_torch`."""
    _mode(mode)
    dev = e2.device
    _f32("e2", e2, dev)
    if e2.shape[1] != he:
        raise ValueError(f"e2 has {e2.shape[1]} columns, expected he={he}")
    if mode == "mul":
        _f32("inp", inp, dev)
        if inp.shape[1] != he * rep:
            raise ValueError("inp width must be he * rep")
    elif inp is not None:
        raise ValueError("rhs mode takes no inp")
    n_chunks, chunk = _chunk_layout(lay, dev)
    if dev.type == "cpu":
        return chunk_weighted_torch(mode, lay, e2, inp, n_out_blocks, he,
                                    rep, bf16)
    width = he * rep if mode == "mul" else he
    ld = width
    if mode == "mul":
        _walkable("K2 mul", lay, chunk, ("a", "b", "eid"))
        inp, ld = _rows16(inp)
    out = torch.zeros((n_out_blocks * BLK, width), dtype=torch.float32,
                      device=dev)
    if n_chunks == 0 or width == 0 or e2.shape[0] == 0:
        return out  # the C entry would launch nothing
    with torch.cuda.device(dev), _kernel_span(f"chunk_{mode}", bf16):
        rc = _lib().hub_chunk_weighted(
            _MODES[mode], lay["a"].data_ptr(), lay["b"].data_ptr(),
            lay["eid"].data_ptr(), lay["in_id"].data_ptr(),
            lay["out_id"].data_ptr(), n_chunks, chunk, e2.data_ptr(),
            e2.shape[0], he, rep,
            inp.data_ptr() if mode == "mul" else None,
            inp.shape[0] if mode == "mul" else 0, ld, out.data_ptr(),
            out.shape[0], width, int(bf16), _stream(dev))
    _done(f"chunk_{mode}", rc, bf16)
    return out


# K5 mul's staged walk (csrc/hub_kernels.cu edge_grad_mul_kernel) stages
# u's 128-row windows full width: rows of at most EG_MAX_COLS floats.
EG_MAX_COLS = 384


def edge_grad_plan(he: int, rep: int) -> int:
    """K5 mul's launch on the card: the floats between staged rows (each
    head's columns padded to a multiple of 4, plus 4) for the staged walk,
    or 0 for the thread-per-(slot, head) kernel. The walk takes rows of at
    most EG_MAX_COLS floats of one head, or of heads whose rep is a
    multiple of 4 (each head's columns then start on a 16-byte
    boundary)."""
    if he * rep > EG_MAX_COLS or (he > 1 and rep % 4):
        return 0
    return 4 * he * -(-rep // 4) + 4


def edge_grad(mode: str, lay, u, ct, he: int, rep: int,
              bf16: bool = False):
    """K5. ``lay``: the forward chunk layout (a, b, in_id, out_id int32);
    ``u``: (n_src, he*rep) f32 in mul mode, None in rhs mode; ``ct``: the
    compact hub cotangent rows (n_groups*128, he*rep) f32 (mul) or
    (n_groups*128, he) f32 (rhs). Returns (n_slots, he) f32, zero on
    padding slots. On the card, mul mode copies a ``u`` or ``ct`` whose
    width is not a multiple of 4, or that starts off a 16-byte boundary,
    once into padded rows. ``bf16``: see :func:`edge_grad_torch`."""
    _mode(mode)
    dev = ct.device
    _f32("ct", ct, dev)
    if mode == "mul":
        _f32("u", u, dev)
        if u.shape[1] != he * rep or ct.shape[1] != he * rep:
            raise ValueError("u and ct widths must be he * rep")
    else:
        if u is not None:
            raise ValueError("rhs mode takes no u")
        if ct.shape[1] != he:
            raise ValueError("ct width must be he in rhs mode")
    n_chunks, chunk = _chunk_layout(lay, dev, ("a", "b", "in_id", "out_id"))
    if dev.type == "cpu":
        return edge_grad_torch(mode, lay, u, ct, he, rep, bf16)
    # Both modes write every element, padding slots as 0.
    out = torch.empty((lay["a"].shape[0], he), dtype=torch.float32,
                      device=dev)
    if n_chunks == 0 or he == 0:
        return out.zero_()  # the C entry would launch nothing
    ws = ldu = ldc = 0
    if mode == "mul":
        ws = edge_grad_plan(he, rep)
        u, ldu = _rows16(u)
        ct, ldc = _rows16(ct)
    with torch.cuda.device(dev), _kernel_span(f"edge_grad_{mode}", bf16):
        rc = _lib().hub_edge_grad(
            _MODES[mode], lay["a"].data_ptr(), lay["b"].data_ptr(),
            lay["in_id"].data_ptr(), lay["out_id"].data_ptr(), n_chunks,
            chunk, u.data_ptr() if mode == "mul" else None,
            u.shape[0] if mode == "mul" else 0, ldu, ct.data_ptr(),
            ct.shape[0], ldc, out.data_ptr(), he, rep, ws, int(bf16),
            _stream(dev))
    _done(f"edge_grad_{mode}", rc, bf16)
    return out
