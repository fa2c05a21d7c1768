"""Sampling (the port's ``dgl1_tpu/sampling``): the numpy neighbor
sampler, the fused native sampler, negative sampling, random walks and
PinSAGE's walk-based neighbours."""

from dgl1_tpu_torch.sampling.fused import sample_block_fused, supports_fused
from dgl1_tpu_torch.sampling.negative import global_uniform_negative_sampling
from dgl1_tpu_torch.sampling.neighbor import (sample_neighbors,
                                              sample_neighbors_arrays,
                                              select_topk)
from dgl1_tpu_torch.sampling.pinsage import (PinSAGESampler,
                                             RandomWalkNeighborSampler)
from dgl1_tpu_torch.sampling.randomwalks import (node2vec_random_walk,
                                                 random_walk)

__all__ = ["sample_neighbors", "sample_neighbors_arrays", "select_topk",
           "sample_block_fused", "supports_fused",
           "global_uniform_negative_sampling", "random_walk",
           "node2vec_random_walk", "PinSAGESampler",
           "RandomWalkNeighborSampler"]
