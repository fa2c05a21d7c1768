"""Graph files (the port's ``dgl1_tpu/data/serialize.py``):
``save_graphs`` / ``load_graphs``.

The file is the reference's: one ``np.savez_compressed`` archive of named
arrays (``g{i}/src``, ``g{i}/ndata/{key}``, ``g{i}/rel{r}/...``,
``labels/{key}``) with a ``__meta__`` entry holding a JSON header, so a
file written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, block, graph, resolve_device

__all__ = ["save_graphs", "load_graphs"]


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _pack(g: Graph, idx: int, arrays: Dict[str, np.ndarray], headers: list):
    e = g.num_edges()
    arrays[f"g{idx}/src"] = _np(g.src[:e])
    arrays[f"g{idx}/dst"] = _np(g.dst[:e])
    hdr = {"num_src_nodes": g.num_src_nodes(),
           "num_dst_nodes": g.num_dst_nodes(), "is_block": g.is_block,
           "ndata": list(g.ndata.keys()), "edata": list(g.edata.keys())}
    for k, v in g.ndata.items():
        arrays[f"g{idx}/ndata/{k}"] = _np(v)
    for k, v in g.edata.items():
        arrays[f"g{idx}/edata/{k}"] = _np(v[:e])
    if g.is_block:
        hdr["srcdata"] = list(g.srcdata.keys())
        hdr["dstdata"] = list(g.dstdata.keys())
        for k, v in g.srcdata.items():
            arrays[f"g{idx}/srcdata/{k}"] = _np(v)
        for k, v in g.dstdata.items():
            arrays[f"g{idx}/dstdata/{k}"] = _np(v)
    headers.append(hdr)


def _pack_hetero(hg, idx: int, arrays: Dict[str, np.ndarray],
                 headers: list) -> None:
    if hg.is_block:
        raise ValueError("save_graphs does not serialize hetero blocks; "
                         "save the parent heterograph instead")
    rels = []
    for r, (c, rel) in enumerate(sorted(hg.rel_graphs.items())):
        e = rel.num_edges()
        arrays[f"g{idx}/rel{r}/src"] = _np(rel.src[:e])
        arrays[f"g{idx}/rel{r}/dst"] = _np(rel.dst[:e])
        for k, v in rel.edata.items():
            arrays[f"g{idx}/rel{r}/edata/{k}"] = _np(v[:e])
        rels.append({"canonical": list(c), "edata": list(rel.edata.keys())})
    for nt, frame in hg.nframes.items():
        for k, v in frame.items():
            arrays[f"g{idx}/nframes/{nt}/{k}"] = _np(v)
    headers.append({"hetero": True, "num_nodes": dict(hg._num_nodes),
                    "rels": rels,
                    "nframes": {nt: list(f.keys())
                                for nt, f in hg.nframes.items()}})


def save_graphs(path: str, graphs, labels: Optional[Dict] = None) -> None:
    """Save one graph, heterograph or block, or a list of them, with an
    optional dict of label arrays, to ``path`` (``.npz`` is appended when
    missing, by numpy). A heterograph keeps its relations' edge order,
    its node frames and its relations' edge frames; a hetero block
    raises."""
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if isinstance(graphs, (Graph, HeteroGraph)):
        graphs = [graphs]
    arrays: Dict[str, np.ndarray] = {}
    headers: list = []
    for i, g in enumerate(graphs):
        if isinstance(g, HeteroGraph):
            _pack_hetero(g, i, arrays, headers)
        else:
            _pack(g, i, arrays, headers)
    meta = {"num_graphs": len(graphs), "headers": headers,
            "labels": list(labels.keys()) if labels else []}
    for k, v in (labels or {}).items():
        arrays[f"labels/{k}"] = _np(v)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_graphs(path: str, device=None) -> Tuple[List, Dict]:
    """``(graphs, labels)`` from a file of :func:`save_graphs` (either
    package's), built on the host and placed on ``device`` (default
    ``cuda``)."""
    from dgl1_tpu_torch.heterograph import heterograph

    dev = resolve_device(device)

    def tensor(z, key):
        return torch.from_numpy(np.array(z[key])).to(dev)

    path = str(path)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        out = []
        for i, hdr in enumerate(meta["headers"]):
            if hdr.get("hetero"):
                rels = [(tuple(rh["canonical"]), r, rh)
                        for r, rh in enumerate(hdr["rels"])]
                hg = heterograph(
                    {c: (z[f"g{i}/rel{r}/src"], z[f"g{i}/rel{r}/dst"])
                     for c, r, _ in rels},
                    num_nodes_dict=hdr["num_nodes"], device=dev)
                for c, r, rh in rels:
                    for k in rh["edata"]:
                        hg.rel_graphs[c].edata[k] = tensor(
                            z, f"g{i}/rel{r}/edata/{k}")
                for nt, keys in hdr["nframes"].items():
                    for k in keys:
                        hg.nframes[nt][k] = tensor(z, f"g{i}/nframes/{nt}/{k}")
                out.append(hg)
                continue
            src, dst = z[f"g{i}/src"], z[f"g{i}/dst"]
            if hdr["is_block"]:
                g = block((src, dst), num_src_nodes=hdr["num_src_nodes"],
                          num_dst_nodes=hdr["num_dst_nodes"], device=dev)
                for k in hdr.get("srcdata", []):
                    g.srcdata[k] = tensor(z, f"g{i}/srcdata/{k}")
                for k in hdr.get("dstdata", []):
                    g.dstdata[k] = tensor(z, f"g{i}/dstdata/{k}")
            else:
                g = graph((src, dst), num_nodes=hdr["num_src_nodes"],
                          device=dev)
            for k in hdr["ndata"]:
                g.ndata[k] = tensor(z, f"g{i}/ndata/{k}")
            for k in hdr["edata"]:
                g.edata[k] = tensor(z, f"g{i}/edata/{k}")
            out.append(g)
        labels = {k: tensor(z, f"labels/{k}") for k in meta["labels"]}
    return out, labels
