"""Wrapper of the block-dense engine's CUDA kernel, beside its plain torch
version.

Kernel (``csrc/bdense_kernels.cu``)   replaces (``ops/engine_bdense.py``)
-----------------------------------   ----------------------------------
K11 :func:`block_mm`                  ``_block_kernel`` / ``_block_call``
                                      (forward and transpose)

K11 multiplies the layout's 128 x 128 count blocks (``bdense_format.py``)
into feature rows. Forward (``transpose=False``, over ``a``, ``row_ptr``
and ``cb``): ``out[rb*128 + i] += sum_j A_k[i, j] x[cb_k*128 + j]`` over
the run of blocks of each dst block row. Transpose (over ``ab``,
``col_ptr`` and ``rbb``): ``out[cb*128 + j] += sum_i A_k[i, j]
x[rbb_k*128 + i]`` over each src block column's run. ``x`` is unpadded
(rows past its end count as zero) and the result has ``num_out`` rows and
exactly ``x``'s columns, zero on rows no block reaches (the reference's
mask pass). Counts are bf16 or float32; the sums are float32. ``bf16``
(the bf16 matmul mode, ``ops/precision.py``) rounds A and x to bfloat16
as the reference's ``dt`` cast does; such launches count under
``"block_fwd.bf16"`` and ``"block_bwd.bf16"``.

What bounds it, and what the kernel does about it: see the note at the
top of ``csrc/bdense_kernels.cu`` (bytes; bf16 tensor-core products over
the occupied 16 x 16 sub-tiles with x split into three exact bf16 planes,
one thread block per output block row and stripe of up to 128 columns, A
and the input stripe staged in shared memory by ``cp.async``, no atomics,
a fixed order of summation).

The wrapper given CPU tensors computes the plain version
(:func:`block_mm_torch`); given CUDA tensors it launches the kernel or
raises. It checks devices, types, shapes and contiguity, allocates the
output, and adds one to ``LAUNCHES["block_fwd"]`` or
``LAUNCHES["block_bwd"]`` (transpose) for each launch and nowhere else;
the launch runs in the span ``kernel.<that name>``.
"""

from __future__ import annotations

import torch

from dgl1_tpu_torch.bdense_format import BLK
from dgl1_tpu_torch.ops.precision import round_bf16
from dgl1_tpu_torch.utils.profiler import span

__all__ = ["block_mm", "block_mm_torch", "LAUNCHES", "reset_launches",
           "KERNELS"]

KERNELS = ("block_fwd", "block_bwd", "block_fwd.bf16", "block_bwd.bf16")
LAUNCHES = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_mm_torch(transpose: bool, a, ptr, in_blocks, x, num_out: int,
                   bf16: bool = False):
    """K11's plain version, in ``x``'s dtype: one batched product of the
    blocks with their input blocks, summed into the output block rows by
    ``index_add_``. ``bf16`` rounds A (exact up to 256) and x."""
    if bf16:
        x = round_bf16(x)
    n_out_b = ptr.shape[0] - 1
    n_blocks = int(ptr[-1])
    f = x.shape[1]
    out = x.new_zeros((n_out_b * BLK, f))
    if n_blocks and f:
        ib = in_blocks[:n_blocks].long()
        n_in_b = max(int(ib.max()) + 1, -(-x.shape[0] // BLK))
        xp = x.new_zeros((n_in_b * BLK, f))
        xp[: x.shape[0]] = x
        xb = xp.view(n_in_b, BLK, f).index_select(0, ib)
        a3 = a[: n_blocks * BLK].view(n_blocks, BLK, BLK).to(x.dtype)
        if bf16:
            a3 = round_bf16(a3)
        if transpose:
            a3 = a3.transpose(1, 2)
        ob = torch.repeat_interleave(
            torch.arange(n_out_b, device=x.device), torch.diff(ptr.long()))
        out.view(n_out_b, BLK, f).index_add_(0, ob, torch.bmm(a3, xb))
    return out[:num_out]


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


def _lib():
    from dgl1_tpu_torch import cuda_build

    return cuda_build.load("bdense_kernels")


def _stripe(f: int) -> int:
    """The columns a thread block covers: 64 up to F=64 (half the
    accumulators and shared memory; faster than 128 at F=32 and 40 on
    the H100), else 128 (wider inputs take several 128-column
    stripes)."""
    return 64 if f <= 64 else 128


def block_mm(transpose: bool, a, ptr, in_blocks, x, num_out: int,
             bf16: bool = False):
    """K11. ``a``: (K*128, 128) bf16/float32 count blocks in iteration
    order (``a`` forward, ``ab`` transpose); ``ptr``: (n_out_blocks+1,)
    int32 run pointers (``row_ptr`` / ``col_ptr``), n_out_blocks =
    ceil(num_out/128); ``in_blocks``: (K,) int32 input block of each block
    (``cb`` / ``rbb``); ``x``: (n_in, f) float32. Returns (num_out, f)
    float32. ``bf16``: see :func:`block_mm_torch`."""
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("a", a, (torch.bfloat16, torch.float32), 2, dev)
    _check("ptr", ptr, (torch.int32,), 1, dev)
    _check("in_blocks", in_blocks, (torch.int32,), 1, dev)
    if a.shape[1] != BLK or a.shape[0] != BLK * in_blocks.shape[0]:
        raise ValueError(f"a must be ({BLK} * len(in_blocks), {BLK}), got "
                         f"{tuple(a.shape)}")
    if ptr.shape[0] - 1 != max(-(-num_out // BLK), 1):
        raise ValueError(f"ptr has {ptr.shape[0] - 1} runs for {num_out} "
                         f"output rows")
    if dev.type == "cpu":
        return block_mm_torch(transpose, a, ptr, in_blocks, x, num_out,
                              bf16)
    if a.data_ptr() % 16:
        raise ValueError("a must start on a 16-byte boundary: the kernel "
                         "stages count blocks by 16-byte copies")
    f = x.shape[1]
    out = torch.empty((num_out, f), dtype=torch.float32, device=dev)
    if f == 0 or num_out == 0:
        return out
    name = "block_bwd" if transpose else "block_fwd"
    name = f"{name}.bf16" if bf16 else name
    with torch.cuda.device(dev), span(f"kernel.{name}"):
        rc = _lib().block_mm(
            int(bool(transpose)), int(a.dtype == torch.bfloat16),
            a.data_ptr(), ptr.data_ptr(), in_blocks.data_ptr(),
            x.data_ptr(), x.shape[0], f, out.data_ptr(), num_out,
            ptr.shape[0] - 1, _stripe(f), int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bdense kernel block_mm: CUDA error {rc} at "
                           f"launch")
    LAUNCHES[name] += 1
    return out
