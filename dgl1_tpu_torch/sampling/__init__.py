"""Sampling (the port's ``dgl1_tpu/sampling``): the numpy neighbor
sampler, the fused native sampler and negative sampling."""

from dgl1_tpu_torch.sampling.fused import sample_block_fused, supports_fused
from dgl1_tpu_torch.sampling.negative import global_uniform_negative_sampling
from dgl1_tpu_torch.sampling.neighbor import (sample_neighbors,
                                              sample_neighbors_arrays,
                                              select_topk)

__all__ = ["sample_neighbors", "sample_neighbors_arrays", "select_topk",
           "sample_block_fused", "supports_fused",
           "global_uniform_negative_sampling"]
