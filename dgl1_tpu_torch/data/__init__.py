"""Data of the port: the synthetic generators (numpy, the reference's
seeds), the host feature store and the graph files (``save_graphs`` /
``load_graphs``)."""

from dgl1_tpu_torch.data.feature_store import (HostFeatureStore,
                                               prefetch_to_device)
from dgl1_tpu_torch.data.serialize import load_graphs, save_graphs
from dgl1_tpu_torch.data.synthetic import (  # noqa: F401
    geometric_graph, minibatch_graph, powerlaw_graph, sort_by_relation,
    synthetic_classification_graph, synthetic_mag_heterograph,
    typed_powerlaw_graph)

__all__ = ["powerlaw_graph", "geometric_graph", "typed_powerlaw_graph",
           "sort_by_relation", "synthetic_classification_graph",
           "minibatch_graph", "synthetic_mag_heterograph",
           "HostFeatureStore", "prefetch_to_device", "save_graphs",
           "load_graphs"]
