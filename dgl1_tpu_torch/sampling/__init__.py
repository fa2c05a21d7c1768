"""Sampling (the port's ``dgl1_tpu/sampling``): the fused native
neighbor sampler. The numpy ``sample_neighbors`` path is not ported
yet."""

from dgl1_tpu_torch.sampling.fused import sample_block_fused, supports_fused

__all__ = ["sample_block_fused", "supports_fused"]
