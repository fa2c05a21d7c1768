"""Wrappers of the tile engine's CUDA kernels, each beside its plain torch
version.

Kernel (``csrc/tile_kernels.cu``)   replaces (``dgl1_tpu/ops/engine_pallas.py``)
---------------------------------   -------------------------------------------
K9  :func:`tile_sum`                ``_reduce_kernel`` / ``_segment_sum_tiles``
K10 :func:`tile_minmax`             ``_minmax_kernel`` /
                                    ``_segment_minmax_tiles``

Both reduce source rows into ``n_row_blocks * 128`` output rows through
the tile layout of ``graph._build_tiles`` (``rows``, ``first``, ``lid``).
Slot s (of ``n_tiles * 1024``) reads row s of ``src`` (message mode,
``idx`` None: ``src`` has a row per slot) or row ``clamp(idx[s], 0,
len(src) - 1)`` (gather mode: ``idx`` is the layout's ``gather`` or
``eid``, which is ``gather_rows``' semantics), so a copy op needs no
message tensor. The output has exactly ``src``'s columns (no 128-lane
padding). Padding slots (lid = -1) are never read, so neither ``src``
nor ``idx`` needs masking there. Rows that no live tile reaches hold the
identity: 0 for the sum, -inf / +inf for max / min (the reference leaves
tile-less row blocks uninitialised; the engine masks K10's). The kernels
take the layouts of ``graph._build_tiles`` and ``graph._pad_tiles``: in
each tile the real slots come first, sorted by lid, and every tile whose
slot 0 is padding is empty and trails the real tiles of its row block.

A wrapper given CPU tensors computes its plain version (``*_torch``);
given CUDA tensors it launches its kernel with the plan of
:func:`tile_plan_for` or raises. It checks devices, types, shapes and
contiguity, allocates the output, and adds one to ``LAUNCHES[name]`` for
each kernel launch and nowhere else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dgl1_tpu_torch.graph import TILE_EDGES, TILE_ROWS

__all__ = ["tile_sum", "tile_minmax", "tile_sum_torch", "tile_minmax_torch",
           "tile_plan", "tile_plan_for", "TilePlan", "LAUNCHES",
           "reset_launches", "KERNELS"]

KERNELS = ("tile_sum", "tile_minmax")
LAUNCHES = {k: 0 for k in KERNELS}

# The grid a plan aims at, in blocks an SM of the card: four (fewer,
# larger blocks stage fewer tiles and timed faster than eight or twelve on
# the sampled Reddit layouts), and the least it may have where the row
# blocks allow it: two.
TILE_WAVE_PER_SM = 4
TILE_MIN_PER_SM = 2
# Chunks of 32 * vec columns a warp holds of one slot, by vec: 8 or 10
# floats a lane, 4 or 3 slots a batch (32 floats of loads in flight); the
# kernel is built for these pairs only. A stripe of 256 or 320 columns
# timed faster than 128 on every sampled Reddit shape, forward layouts
# (tens of slots a row) included: fewer stripes repeat each slot's index
# and address work fewer times.
_NC = {4: 2, 2: 5, 1: 8}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TilePlan(NamedTuple):
    vec: int             # floats a lane loads at once (16, 8 or 4 bytes)
    nc: int              # chunks of 32 * vec columns a stripe
    rows_per_block: int  # rows of one row block a block owns
    blocks: int          # the grid
    stripes: int         # stripes a row: ceil(f / (32 * vec * nc))


def tile_plan(n_row_blocks: int, f: int, align: int = 16, *, sms: int,
              warps: int) -> TilePlan:
    """K9/K10's launch plan for ``f`` columns of a source at address
    ``align`` (any number with the same remainder modulo 16 will do; the
    default is aligned), on a card of ``sms`` SMs, for the kernel's
    ``warps`` warps a block. Loads are 16 bytes where f and the source
    allow, else 8, else 4. A block owns 128 rows, halved while the grid is
    under four blocks an SM and every warp still has a (row, stripe) item,
    then halved while it is under two blocks an SM."""
    a = align % 16
    vec = (4 if f % 4 == 0 and a == 0 else
           2 if f % 2 == 0 and a % 8 == 0 else 1)
    nc = _NC[vec]
    stripes = -(-f // (32 * vec * nc))
    rpb = TILE_ROWS
    while (rpb > 1
           and n_row_blocks * (TILE_ROWS // rpb) < TILE_WAVE_PER_SM * sms
           and (rpb // 2) * stripes >= warps):
        rpb //= 2
    while (rpb > 1
           and n_row_blocks * (TILE_ROWS // rpb) < TILE_MIN_PER_SM * sms):
        rpb //= 2
    return TilePlan(vec, nc, rpb, n_row_blocks * (TILE_ROWS // rpb),
                    stripes)


def tile_plan_for(src, n_row_blocks: int) -> TilePlan:
    """The plan the wrappers launch with for the CUDA tensor ``src``: the
    SM count of its card, the warps a block the built kernel has."""
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    return tile_plan(n_row_blocks, src.shape[1], src.data_ptr(), sms=sms,
                     warps=_lib().tile_warps())


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


def _slot_rows(slots, idx, n_src: int):
    """The rows of ``src`` that ``slots`` read: the slots themselves, or
    their clamped entries of ``idx``."""
    if idx is None:
        return slots
    return idx.long().index_select(0, slots).clamp(0, n_src - 1)


def tile_sum_torch(rows, first, lid, src, n_row_blocks: int, idx=None):
    """K9: out[rows[t] * 128 + lid[t, s]] += src[row of slot t * 1024 + s]
    over the live slots; (n_row_blocks * 128, f), zero where nothing
    lands."""
    slots, target = _live_slots(rows, first, lid)
    keep = target < n_row_blocks * TILE_ROWS
    slots, target = slots[keep], target[keep]
    out = src.new_zeros((n_row_blocks * TILE_ROWS, src.shape[1]))
    return out.index_add_(0, target, src.index_select(
        0, _slot_rows(slots, idx, src.shape[0])))


def tile_minmax_torch(is_max: bool, rows, first, lid, src,
                      n_row_blocks: int, idx=None):
    """K10: per tile and row, the max (min) of the row's slots, taken as 0
    when it is not finite (a NaN in the run, or +-inf); tiles combine by
    max (min) into (n_row_blocks * 128, f); rows that no live tile reaches
    hold -inf (+inf)."""
    ident = float("-inf") if is_max else float("inf")
    red = "amax" if is_max else "amin"
    slots, target = _live_slots(rows, first, lid)
    f = src.shape[1]
    tile_of = torch.div(slots, TILE_EDGES, rounding_mode="floor")
    # One segment per (tile, row): key = tile * 128 + row within block.
    key = tile_of * TILE_ROWS + target % TILE_ROWS
    n_seg = lid.shape[0] * TILE_ROWS
    vals = src.index_select(0, _slot_rows(slots, idx, src.shape[0]))
    nan = torch.isnan(vals)
    seg_idx = key[:, None].expand(-1, f)
    seg = src.new_full((n_seg, f), ident).scatter_reduce(
        0, seg_idx, torch.where(nan, torch.full_like(vals, ident), vals),
        red)
    seg_nan = src.new_zeros((n_seg, f)).index_add_(0, key,
                                                   nan.to(src.dtype)) > 0
    hit = torch.zeros((n_seg,), dtype=torch.bool, device=src.device)
    hit[key] = True
    part = torch.where(seg_nan | ~torch.isfinite(seg),
                       torch.zeros_like(seg), seg)
    # Combine the hit segments of every tile into their output rows.
    seg_ids = hit.nonzero().squeeze(1)
    seg_rows = (rows.long()[torch.div(seg_ids, TILE_ROWS,
                                      rounding_mode="floor")] * TILE_ROWS
                + seg_ids % TILE_ROWS)
    keep = seg_rows < n_row_blocks * TILE_ROWS
    out = src.new_full((n_row_blocks * TILE_ROWS, f), ident)
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


def _check_layout(rows, first, lid, src, n_row_blocks, idx):
    dev = src.device
    _check("src", src, torch.float32, 2, dev)
    _check("rows", rows, torch.int32, 1, dev)
    _check("first", first, torch.int32, 1, dev)
    _check("lid", lid, torch.int32, 2, dev)
    n_tiles = lid.shape[0]
    if lid.shape[1] != TILE_EDGES:
        raise ValueError(f"lid must be (n_tiles, {TILE_EDGES})")
    if rows.shape[0] != n_tiles or first.shape[0] != n_tiles:
        raise ValueError("rows, first and lid disagree on the tile count")
    if idx is None:
        if src.shape[0] != n_tiles * TILE_EDGES:
            raise ValueError("src must have one row per tile slot")
    else:
        _check("idx", idx, torch.int32, 1, dev)
        if idx.shape[0] != n_tiles * TILE_EDGES:
            raise ValueError("idx must have one entry per tile slot")
        if src.shape[0] < 1:
            raise ValueError("src has no row to gather")
    if n_row_blocks < 1:
        raise ValueError("n_row_blocks must be at least 1")
    return dev


def _lib():
    from dgl1_tpu_torch import cuda_build

    return cuda_build.load("tile_kernels")


def _reduce(name, head, rows, first, lid, src, n_row_blocks, idx):
    """Launch ``name`` (after the arguments ``head``) with its plan and
    count the launch; a zero-width output needs none."""
    dev = src.device
    f = src.shape[1]
    out = torch.empty((n_row_blocks * TILE_ROWS, f), dtype=torch.float32,
                      device=dev)
    if f == 0:
        return out
    p = tile_plan_for(src, n_row_blocks)
    with torch.cuda.device(dev):
        rc = getattr(_lib(), name)(
            *head, rows.data_ptr(), first.data_ptr(), lid.data_ptr(),
            lid.shape[0], src.data_ptr(),
            None if idx is None else idx.data_ptr(), src.shape[0], f,
            out.data_ptr(), n_row_blocks, p.vec, p.nc, p.rows_per_block,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile kernel {name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
    return out


def tile_sum(rows, first, lid, src, n_row_blocks: int, idx=None):
    """K9. ``rows``/``first`` (n_tiles,), ``lid`` (n_tiles, 1024) int32;
    ``src`` float32, (n_tiles * 1024, f) without ``idx``, else (n, f) read
    through ``idx`` (n_tiles * 1024,) int32. Returns (n_row_blocks * 128,
    f) float32."""
    dev = _check_layout(rows, first, lid, src, n_row_blocks, idx)
    if dev.type == "cpu":
        return tile_sum_torch(rows, first, lid, src, n_row_blocks, idx)
    return _reduce("tile_sum", (), rows, first, lid, src, n_row_blocks, idx)


def tile_minmax(is_max: bool, rows, first, lid, src, n_row_blocks: int,
                idx=None):
    """K10, max (``is_max``) or min. Arguments and result as
    :func:`tile_sum`."""
    dev = _check_layout(rows, first, lid, src, n_row_blocks, idx)
    if dev.type == "cpu":
        return tile_minmax_torch(is_max, rows, first, lid, src,
                                 n_row_blocks, idx)
    return _reduce("tile_minmax", (int(bool(is_max)),), rows, first, lid,
                   src, n_row_blocks, idx)
