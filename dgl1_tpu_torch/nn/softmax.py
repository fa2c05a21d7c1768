"""``edge_softmax`` under ``dgl1_tpu_torch.nn`` (the port's
``dgl1_tpu/nn/softmax.py``)."""

from dgl1_tpu_torch.ops.edge_softmax import edge_softmax

__all__ = ["edge_softmax"]
