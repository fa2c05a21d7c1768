"""``kernel_ms`` (ms a step, Kernels): device time in the program's hand
kernels, the ``__global__`` functions of ``dgl1_tpu_torch/csrc/*.cu``."""

from gnnbench.trace import kernel_id

HAND_KERNELS = frozenset((
    # hub_kernels.cu
    "dense_fwd_walk_kernel", "chunk_walk_kernel", "chunk_rhs_kernel",
    "expand_kernel", "dense_bwd_kernel", "edge_grad_mul_kernel",
    "edge_grad_items_kernel", "edge_grad_rhs_kernel",
    # attn_kernels.cu
    "attn_max_kernel", "attn_fwd_kernel", "attn_fold_kernel",
    "attn_run_kernel", "attn_seg_kernel", "attn_segscan_kernel",
    "attn_segapply_kernel", "attn_init_kernel", "attn_bcast_kernel",
    "attn_bwd_src_kernel", "attn_bwd_grp_kernel", "attn_grp_fold_kernel",
    "ger_part_kernel", "ger_fold_kernel",
    # tile_kernels.cu, bdense_kernels.cu
    "tile_reduce_kernel", "block_mm_kernel"))


def is_hand(name: str) -> bool:
    return kernel_id(name) in HAND_KERNELS


def read(ctx):
    if not ctx.stretch.device:
        return None
    return ctx.stretch.seconds_where(is_hand) * 1e3 / ctx.stretch.steps
