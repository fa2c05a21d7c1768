"""User-defined-function batch types (``from dgl.udf import EdgeBatch``).

``EdgeBatch`` and ``NodeBatch`` live in ``core.py`` beside the UDF
dispatch that builds them; this module is the reference's import
location."""

from dgl1_tpu_torch.core import EdgeBatch, NodeBatch

__all__ = ["EdgeBatch", "NodeBatch"]
