"""Synthetic datasets of the port (numpy generators, same seeds as the
reference's)."""

from dgl1_tpu_torch.data.synthetic import (  # noqa: F401
    geometric_graph, minibatch_graph, powerlaw_graph, sort_by_relation,
    synthetic_classification_graph, synthetic_mag_heterograph,
    typed_powerlaw_graph)

__all__ = ["powerlaw_graph", "geometric_graph", "typed_powerlaw_graph",
           "sort_by_relation", "synthetic_classification_graph",
           "minibatch_graph", "synthetic_mag_heterograph"]
