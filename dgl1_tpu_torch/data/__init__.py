"""Synthetic datasets of the port (numpy generators, same seeds as the
reference's)."""

from dgl1_tpu_torch.data.synthetic import (  # noqa: F401
    minibatch_graph, powerlaw_graph, synthetic_classification_graph)

__all__ = ["powerlaw_graph", "synthetic_classification_graph",
           "minibatch_graph"]
