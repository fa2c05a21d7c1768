"""Wrappers of the tile engine's CUDA kernels, each beside its plain torch
version.

Kernel (``csrc/tile_kernels.cu``)   replaces (``dgl1_tpu/ops/engine_pallas.py``)
---------------------------------   -------------------------------------------
K9  :func:`tile_sum`                ``_reduce_kernel`` / ``_segment_sum_tiles``
K10 :func:`tile_minmax`             ``_minmax_kernel`` /
                                    ``_segment_minmax_tiles``

Both reduce a message tensor ``msg`` (one row per tile slot,
``n_tiles * 1024`` rows) into ``n_row_blocks * 128`` output rows through
the tile layout of ``graph._build_tiles`` (``rows``, ``first``, ``lid``).
The output has exactly ``msg``'s columns (no 128-lane padding). Padding
slots (lid = -1) are never read, so ``msg`` needs no masking there. Rows
that no live tile reaches hold the identity: 0 for the sum, -inf / +inf
for max / min (the reference leaves tile-less row blocks uninitialised;
the engine masks them with ``block_mask`` either way). The kernels take
the layouts of ``graph._build_tiles`` and ``graph._pad_tiles``, where
every tile whose slot 0 is padding is empty and trails the real tiles of
its row block: they cut such tiles off by a search instead of walking
them.

A wrapper given CPU tensors computes its plain version (``*_torch``);
given CUDA tensors it launches its kernel or raises. It checks devices,
types, shapes and contiguity, allocates the output, and adds one to
``LAUNCHES[name]`` for each kernel launch and nowhere else.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.graph import TILE_EDGES, TILE_ROWS

__all__ = ["tile_sum", "tile_minmax", "tile_sum_torch", "tile_minmax_torch",
           "LAUNCHES", "reset_launches", "KERNELS"]

KERNELS = ("tile_sum", "tile_minmax")
LAUNCHES = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Plain torch versions
# ----------------------------------------------------------------------

def _live_slots(rows, first, lid):
    """Flat indices of the slots that count, and their output rows. A tile
    counts when no later tile of its row block is flagged ``first`` (the
    reference initialises the block at a ``first`` tile and accumulates
    after it); a slot counts when its tile does and lid >= 0."""
    n_tiles = lid.shape[0]
    rows_l = rows.long()
    t = torch.arange(n_tiles, device=lid.device)
    n_rb = int(rows_l.max()) + 1 if n_tiles else 1
    is_first = first == 1
    last_first = torch.full((n_rb,), -1, dtype=torch.long,
                            device=lid.device).scatter_reduce(
        0, rows_l[is_first], t[is_first], "amax")
    live = t >= last_first[rows_l]
    lid_l = lid.long()
    ok = (lid_l >= 0) & live[:, None]
    slots = ok.reshape(-1).nonzero().squeeze(1)
    target = (rows_l[:, None] * TILE_ROWS + lid_l).reshape(-1)
    return slots, target.index_select(0, slots)


def tile_sum_torch(rows, first, lid, msg, n_row_blocks: int):
    """K9: out[rows[t] * 128 + lid[t, s]] += msg[t * 1024 + s] over the
    live slots; (n_row_blocks * 128, f), zero where nothing lands."""
    slots, target = _live_slots(rows, first, lid)
    keep = target < n_row_blocks * TILE_ROWS
    out = msg.new_zeros((n_row_blocks * TILE_ROWS, msg.shape[1]))
    return out.index_add_(0, target[keep],
                          msg.index_select(0, slots[keep]))


def tile_minmax_torch(is_max: bool, rows, first, lid, msg,
                      n_row_blocks: int):
    """K10: per tile and row, the max (min) of the row's slots, taken as 0
    when it is not finite (a NaN in the run, or +-inf); tiles combine by
    max (min) into (n_row_blocks * 128, f); rows that no live tile reaches
    hold -inf (+inf)."""
    ident = float("-inf") if is_max else float("inf")
    red = "amax" if is_max else "amin"
    slots, target = _live_slots(rows, first, lid)
    f = msg.shape[1]
    tile_of = torch.div(slots, TILE_EDGES, rounding_mode="floor")
    # One segment per (tile, row): key = tile * 128 + row within block.
    key = tile_of * TILE_ROWS + target % TILE_ROWS
    n_seg = lid.shape[0] * TILE_ROWS
    vals = msg.index_select(0, slots)
    nan = torch.isnan(vals)
    idx = key[:, None].expand(-1, f)
    seg = msg.new_full((n_seg, f), ident).scatter_reduce(
        0, idx, torch.where(nan, torch.full_like(vals, ident), vals), red)
    seg_nan = msg.new_zeros((n_seg, f)).index_add_(0, key,
                                                   nan.to(msg.dtype)) > 0
    hit = torch.zeros((n_seg,), dtype=torch.bool, device=msg.device)
    hit[key] = True
    part = torch.where(seg_nan | ~torch.isfinite(seg),
                       torch.zeros_like(seg), seg)
    # Combine the hit segments of every tile into their output rows.
    seg_ids = hit.nonzero().squeeze(1)
    seg_rows = (rows.long()[torch.div(seg_ids, TILE_ROWS,
                                      rounding_mode="floor")] * TILE_ROWS
                + seg_ids % TILE_ROWS)
    keep = seg_rows < n_row_blocks * TILE_ROWS
    out = msg.new_full((n_row_blocks * TILE_ROWS, f), ident)
    return out.scatter_reduce_(
        0, seg_rows[keep][:, None].expand(-1, f),
        part.index_select(0, seg_ids[keep]), red)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check(name, t, dtype, dim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(rows, first, lid, msg, n_row_blocks):
    dev = msg.device
    _check("msg", msg, torch.float32, 2, dev)
    _check("rows", rows, torch.int32, 1, dev)
    _check("first", first, torch.int32, 1, dev)
    _check("lid", lid, torch.int32, 2, dev)
    n_tiles = lid.shape[0]
    if lid.shape[1] != TILE_EDGES:
        raise ValueError(f"lid must be (n_tiles, {TILE_EDGES})")
    if rows.shape[0] != n_tiles or first.shape[0] != n_tiles:
        raise ValueError("rows, first and lid disagree on the tile count")
    if msg.shape[0] != n_tiles * TILE_EDGES:
        raise ValueError("msg must have one row per tile slot")
    if n_row_blocks < 1:
        raise ValueError("n_row_blocks must be at least 1")
    return dev


def _lib():
    from dgl1_tpu_torch import cuda_build

    return cuda_build.load("tile_kernels")


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"tile kernel {name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def tile_sum(rows, first, lid, msg, n_row_blocks: int):
    """K9. ``rows``/``first`` (n_tiles,), ``lid`` (n_tiles, 1024) int32;
    ``msg`` (n_tiles * 1024, f) float32. Returns (n_row_blocks * 128, f)
    float32."""
    dev = _check_layout(rows, first, lid, msg, n_row_blocks)
    if dev.type == "cpu":
        return tile_sum_torch(rows, first, lid, msg, n_row_blocks)
    f = msg.shape[1]
    out = torch.empty((n_row_blocks * TILE_ROWS, f), dtype=torch.float32,
                      device=dev)
    if f == 0:
        return out
    with torch.cuda.device(dev):
        _launch("tile_sum", _lib().tile_sum, rows.data_ptr(),
                first.data_ptr(), lid.data_ptr(), lid.shape[0],
                msg.data_ptr(), f, out.data_ptr(), n_row_blocks,
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def tile_minmax(is_max: bool, rows, first, lid, msg, n_row_blocks: int):
    """K10, max (``is_max``) or min. Arguments and result as
    :func:`tile_sum`."""
    dev = _check_layout(rows, first, lid, msg, n_row_blocks)
    if dev.type == "cpu":
        return tile_minmax_torch(is_max, rows, first, lid, msg, n_row_blocks)
    f = msg.shape[1]
    out = torch.empty((n_row_blocks * TILE_ROWS, f), dtype=torch.float32,
                      device=dev)
    if f == 0:
        return out
    with torch.cuda.device(dev):
        _launch("tile_minmax", _lib().tile_minmax, int(bool(is_max)),
                rows.data_ptr(), first.data_ptr(), lid.data_ptr(),
                lid.shape[0], msg.data_ptr(), f, out.data_ptr(),
                n_row_blocks, torch.cuda.current_stream(dev).cuda_stream)
    return out
