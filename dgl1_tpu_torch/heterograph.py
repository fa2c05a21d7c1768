"""Heterogeneous graphs: several node and edge types (the port's
``dgl1_tpu/heterograph.py``).

A :class:`HeteroGraph` holds one relation :class:`Graph` per canonical
edge type ``(srctype, etype, dsttype)`` (a block in that pair's node
spaces, :func:`dgl1_tpu_torch.graph.block`) and a feature dict per node
type. Relations run through the same engines as homogeneous graphs; the
modules combine their results per destination type
(``nn.HeteroGraphConv``). ``HeteroGraph.to(device)`` moves every
relation and frame.

Block mode (``num_src_nodes_dict`` given) keeps separate source and
destination node spaces per type: ``srcframes`` holds the source side,
``nframes`` the destination side.

Message passing (``apply_edges``, ``update_all``, ``multi_update_all``)
wires the type frames into each relation block and runs ``core.py`` on
it, combining the relations' results per destination type with a cross
reducer (``sum``, ``mean``, ``max``, ``min`` or ``stack``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, _tree_to, block, resolve_device

__all__ = ["HeteroGraph", "heterograph", "node_type_subgraph",
           "edge_type_subgraph"]

CanonicalEtype = Tuple[str, str, str]

class _TypeDataProxy:
    """``.data`` handle of one node or edge type."""

    __slots__ = ("data",)

    def __init__(self, frame):
        self.data = frame


class _TypeView:
    """``hg.nodes[ntype]`` / ``hg.edges[etype]`` indexer."""

    __slots__ = ("_get",)

    def __init__(self, get):
        self._get = get

    def __getitem__(self, t):
        return _TypeDataProxy(self._get(t))


class _MultiTypeFrameView:
    """ndata/edata of a graph with several types: a key reads as ``{type:
    value}`` over the types that carry it, and is set from such a dict."""

    __slots__ = ("_frames",)

    def __init__(self, frames):
        self._frames = frames

    def __getitem__(self, key):
        out = {t: f[key] for t, f in self._frames.items() if key in f}
        if not out:
            raise KeyError(key)
        return out

    def __setitem__(self, key, value):
        if not isinstance(value, dict):
            raise TypeError(
                "multi-type assignment takes a {type: value} dict")
        for t, v in value.items():
            self._frames[t][key] = v

    def __delitem__(self, key):
        found = False
        for f in self._frames.values():
            found |= f.pop(key, None) is not None
        if not found:
            raise KeyError(key)

    def __contains__(self, key):
        return any(key in f for f in self._frames.values())

    def keys(self):
        out = set()
        for f in self._frames.values():
            out |= set(f.keys())
        return out


class HeteroGraph:
    """Relation graphs keyed by canonical edge type, plus per-type frames.
    See the module docstring."""

    def __init__(self, rel_graphs: Dict[CanonicalEtype, Graph],
                 num_nodes_dict: Dict[str, int],
                 node_frames: Optional[Dict[str, Dict]] = None,
                 num_src_nodes_dict: Optional[Dict[str, int]] = None,
                 src_node_frames: Optional[Dict[str, Dict]] = None):
        self.rel_graphs = dict(rel_graphs)
        self._num_nodes = dict(num_nodes_dict)
        self.nframes: Dict[str, Dict] = (
            {nt: {} for nt in num_nodes_dict} if node_frames is None
            else {nt: dict(f) for nt, f in node_frames.items()})
        self._num_src = (dict(num_src_nodes_dict)
                         if num_src_nodes_dict is not None else None)
        if self._num_src is not None:
            self.srcframes: Dict[str, Dict] = (
                {nt: {} for nt in self._num_src} if src_node_frames is None
                else {nt: dict(f) for nt, f in src_node_frames.items()})
        else:
            self.srcframes = self.nframes
        # Host-side bookkeeping (real-prefix lengths of a sampled block).
        self.meta: Dict = {}

    # -- types and counts ------------------------------------------------
    @property
    def is_block(self) -> bool:
        return self._num_src is not None

    @property
    def device(self) -> torch.device:
        for g in self.rel_graphs.values():
            return g.device
        return torch.device("cpu")

    @property
    def dstframes(self) -> Dict[str, Dict]:
        return self.nframes

    @property
    def build_s(self) -> Dict[str, float]:
        """Host seconds of the relations' layout builds and copies, by
        format, summed over the relations (``Graph.build_s``)."""
        out: Dict[str, float] = {}
        for g in self.rel_graphs.values():
            for fmt, sec in g.build_s.items():
                out[fmt] = out.get(fmt, 0.0) + sec
        return out

    @property
    def ntypes(self):
        if self._num_src is not None:
            return sorted(set(self._num_nodes) | set(self._num_src))
        return sorted(self._num_nodes)

    @property
    def etypes(self):
        return [et for (_, et, _) in self.canonical_etypes]

    @property
    def canonical_etypes(self):
        return sorted(self.rel_graphs)

    @property
    def srctypes(self):
        if self._num_src is not None:
            return sorted(self._num_src)
        return sorted({c[0] for c in self.canonical_etypes})

    @property
    def dsttypes(self):
        if self._num_src is not None:
            return sorted(self._num_nodes)
        return sorted({c[2] for c in self.canonical_etypes})

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        if self._num_src is not None:
            raise ValueError("num_nodes() is ambiguous on a hetero block; "
                             "use num_src_nodes(ntype) / "
                             "num_dst_nodes(ntype)")
        if ntype is None:
            return sum(self._num_nodes.values())
        return self._num_nodes[ntype]

    def num_src_nodes(self, ntype: Optional[str] = None) -> int:
        src = self._num_src if self._num_src is not None else self._num_nodes
        if ntype is None:
            return sum(src.values())
        return src.get(ntype, 0)

    def num_dst_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None:
            return sum(self._num_nodes.values())
        return self._num_nodes.get(ntype, 0)

    number_of_src_nodes = num_src_nodes
    number_of_dst_nodes = num_dst_nodes

    def num_edges(self, etype=None) -> int:
        if etype is None:
            return sum(g.num_edges() for g in self.rel_graphs.values())
        return self[etype].num_edges()

    def get_ntype_id(self, ntype: str) -> int:
        """Index into the sorted node types."""
        try:
            return self.ntypes.index(ntype)
        except ValueError:
            raise KeyError(f"unknown node type {ntype!r}") from None

    def get_etype_id(self, etype) -> int:
        """Index into the sorted canonical edge types."""
        return self.canonical_etypes.index(self.to_canonical_etype(etype))

    def has_nodes(self, vid, ntype: str):
        v = np.asarray(vid)
        n = (self._num_nodes.get(ntype, 0) if self._num_src is None
             else self._num_src.get(ntype, 0))
        out = (v >= 0) & (v < n)
        return bool(out) if out.ndim == 0 else out

    def to_canonical_etype(self, etype) -> CanonicalEtype:
        if isinstance(etype, tuple):
            return etype
        matches = [c for c in self.rel_graphs if c[1] == etype]
        if len(matches) != 1:
            raise KeyError(f"edge type {etype!r} is "
                           f"{'ambiguous' if matches else 'unknown'}")
        return matches[0]

    def __getitem__(self, etype) -> Graph:
        """The relation graph of an edge type."""
        return self.rel_graphs[self.to_canonical_etype(etype)]

    def _one_etype(self, etype):
        if etype is None:
            if len(self.rel_graphs) != 1:
                raise ValueError("etype is required: multiple edge types")
            etype = self.canonical_etypes[0]
        return self[etype]

    def in_degrees(self, v=None, etype=None):
        return self._one_etype(etype).in_degrees(v)

    def out_degrees(self, u=None, etype=None):
        return self._one_etype(etype).out_degrees(u)

    def metagraph(self):
        """The (ntype -> ntype) relation multigraph as a networkx
        MultiDiGraph."""
        import networkx as nx

        mg = nx.MultiDiGraph()
        mg.add_nodes_from(self.ntypes)
        for (st, et, dt) in self.canonical_etypes:
            mg.add_edge(st, dt, key=et)
        return mg

    # -- frames ------------------------------------------------------------
    def nodes_data(self, ntype: str) -> Dict:
        return self.nframes[ntype]

    def edges_data(self, etype) -> Dict:
        return self[etype].edata

    @property
    def nodes(self):
        """``hg.nodes[ntype].data``."""
        return _TypeView(lambda t: self.nframes[t])

    @property
    def edges(self):
        """``hg.edges[etype].data``."""
        return _TypeView(lambda t: self[t].edata)

    @property
    def srcnodes(self):
        return _TypeView(lambda t: self.srcframes[t])

    @property
    def dstnodes(self):
        return _TypeView(lambda t: self.nframes[t])

    @property
    def ndata(self):
        """One node type: its frame. Several: ``hg.ndata['h']`` reads
        ``{ntype: value}`` and is set from such a dict."""
        if len(self._num_nodes) == 1:
            return self.nframes[self.ntypes[0]]
        return _MultiTypeFrameView(self.nframes)

    @property
    def edata(self):
        """One edge type: its frame. Several: a view keyed by canonical
        edge type."""
        if len(self.rel_graphs) == 1:
            return self.rel_graphs[self.canonical_etypes[0]].edata
        return _MultiTypeFrameView(
            {c: g.edata for c, g in self.rel_graphs.items()})

    @property
    def srcdata(self):
        st = self.srctypes
        if len(st) != 1:
            raise ValueError("srcdata is ambiguous: multiple source types")
        return self.srcframes[st[0]]

    @property
    def dstdata(self):
        dt = self.dsttypes
        if len(dt) != 1:
            raise ValueError("dstdata is ambiguous: multiple dest types")
        return self.nframes[dt[0]]

    def node_attr_schemes(self, ntype: str):
        return {k: (tuple(v.shape[1:]), v.dtype)
                for k, v in self.nframes.get(ntype, {}).items()}

    def edge_attr_schemes(self, etype=None):
        g = self._one_etype(etype) if etype is not None else \
            self[self.canonical_etypes[0]]
        return {k: (tuple(v.shape[1:]), v.dtype) for k, v in g.edata.items()}

    def apply_nodes(self, func, ntype: Optional[str] = None):
        """``func`` on one node type's frame (it gets ``.data`` and
        ``.nodes()``); the fields it returns are written back."""
        from dgl1_tpu_torch.core import NodeBatch

        if ntype is None:
            if len(self._num_nodes) != 1:
                raise ValueError("ntype is required: multiple node types")
            ntype = self.ntypes[0]
        frame = self.nframes[ntype]
        nodes = torch.arange(self.num_dst_nodes(ntype), device=self.device)
        out = func(NodeBatch(frame, {}, nodes))
        frame.update(out)
        return out

    def _wired(self, c) -> Graph:
        """Relation ``c``'s block with its source and destination type
        frames wired in."""
        st, _, dt = c
        rel = self.rel_graphs[c]
        rel.srcdata.clear()
        rel.srcdata.update(self.srcframes[st])
        rel.dstdata.clear()
        rel.dstdata.update(self.nframes[dt])
        return rel

    def apply_edges(self, func, etype=None):
        """``apply_edges`` on one relation (required when there are
        several), reading its type frames."""
        c = (self.to_canonical_etype(etype) if etype is not None
             else self._one_canonical())
        return self._wired(c).apply_edges(func)

    def _one_canonical(self):
        if len(self.rel_graphs) != 1:
            raise ValueError("etype is required: multiple edge types")
        return self.canonical_etypes[0]

    def update_all(self, mfunc, rfunc, etype=None):
        """Message passing on one relation, or on every relation summed per
        destination type."""
        if etype is not None:
            return self.multi_update_all(
                {self.to_canonical_etype(etype): (mfunc, rfunc)}, "sum")
        return self.multi_update_all(
            {c: (mfunc, rfunc) for c in self.canonical_etypes}, "sum")

    def multi_update_all(self, etype_dict, cross_reducer: str = "sum"):
        """Message passing on each relation of ``etype_dict`` ({etype:
        (message, reduce)}), the results combined per destination type by
        ``cross_reducer`` (``sum``, ``mean``, ``max``, ``min`` or
        ``stack``, which stacks on axis 1 in the dict's order) and written
        into its frame. Returns {(dsttype, field): value}."""
        from dgl1_tpu_torch import core

        if cross_reducer not in ("sum", "mean", "max", "min", "stack"):
            raise ValueError(f"unknown cross reducer {cross_reducer!r}")
        per_dst: Dict[str, Dict[str, list]] = {}
        for c, spec in etype_dict.items():
            c = self.to_canonical_etype(c)
            result = core.message_passing(self._wired(c), spec[0], spec[1],
                                          None)
            for k, v in result.items():
                per_dst.setdefault(c[2], {}).setdefault(k, []).append(v)
        out = {}
        for dt, fields in per_dst.items():
            for k, vs in fields.items():
                if cross_reducer == "stack":
                    v = torch.stack(vs, dim=1)
                elif cross_reducer in ("sum", "mean"):
                    v = vs[0]
                    for w in vs[1:]:
                        v = v + w
                    if cross_reducer == "mean":
                        v = v / len(vs)
                else:
                    op = torch.maximum if cross_reducer == "max" \
                        else torch.minimum
                    v = vs[0]
                    for w in vs[1:]:
                        v = op(v, w)
                self.nframes[dt][k] = v
                out[(dt, k)] = v
        return out

    # -- copies and devices ----------------------------------------------
    def _rebuild(self, rels, frames, srcframes):
        new = HeteroGraph(rels, self._num_nodes, frames,
                          self._num_src, srcframes)
        new.meta = dict(self.meta)
        return new

    def to(self, device) -> "HeteroGraph":
        """A new HeteroGraph with every relation and frame on ``device``."""
        dev = resolve_device(device)
        return self._rebuild(
            {c: g.to(dev) for c, g in self.rel_graphs.items()},
            _tree_to(self.nframes, dev),
            _tree_to(self.srcframes, dev) if self.is_block else None)

    def clone(self) -> "HeteroGraph":
        """Shallow copy: the same relation arrays, new frame dicts."""
        return self._rebuild(
            dict(self.rel_graphs),
            {nt: dict(f) for nt, f in self.nframes.items()},
            ({nt: dict(f) for nt, f in self.srcframes.items()}
             if self.is_block else None))

    local_var = clone

    def local_scope(self):
        """Context manager: frame writes inside are rolled back on exit."""

        @contextlib.contextmanager
        def scope():
            saved_n = {nt: dict(fr) for nt, fr in self.nframes.items()}
            saved_s = ({nt: dict(fr) for nt, fr in self.srcframes.items()}
                       if self.is_block else None)
            saved_e = {c: dict(g.edata) for c, g in self.rel_graphs.items()}
            try:
                yield self
            finally:
                for nt, fr in self.nframes.items():
                    fr.clear()
                    fr.update(saved_n[nt])
                if saved_s is not None:
                    for nt, fr in self.srcframes.items():
                        fr.clear()
                        fr.update(saved_s[nt])
                for c, g in self.rel_graphs.items():
                    g.edata.clear()
                    g.edata.update(saved_e[c])

        return scope()

    def __repr__(self):
        kind = "HeteroBlock" if self.is_block else "HeteroGraph"
        edges = ", ".join(f"{c}: {g.num_edges()}"
                          for c, g in sorted(self.rel_graphs.items()))
        return f"{kind}(num_nodes={self._num_nodes}, num_edges={{{edges}}})"


def node_type_subgraph(hg: HeteroGraph, ntypes) -> HeteroGraph:
    """The relations whose two ends are both among ``ntypes``, with those
    types' frames (arrays shared)."""
    keep = set([ntypes] if isinstance(ntypes, str) else ntypes)
    unknown = keep - set(hg.ntypes)
    if unknown:
        raise KeyError(f"unknown node types: {sorted(unknown)}")
    rels = {c: g for c, g in hg.rel_graphs.items()
            if c[0] in keep and c[2] in keep}
    counts = {nt: hg.num_nodes(nt) for nt in keep}
    frames = {nt: dict(hg.nframes[nt]) for nt in keep}
    return HeteroGraph(rels, counts, frames)


def edge_type_subgraph(hg: HeteroGraph, etypes) -> HeteroGraph:
    """Only the given edge types; every node type at an end of one of them
    is kept whole."""
    if isinstance(etypes, (str, tuple)):
        etypes = [etypes]
    canon = [hg.to_canonical_etype(e) for e in etypes]
    rels = {c: hg.rel_graphs[c] for c in canon}
    keep = set()
    for st, _, dt in canon:
        keep.update((st, dt))
    counts = {nt: hg.num_nodes(nt) for nt in keep}
    frames = {nt: dict(hg.nframes[nt]) for nt in keep}
    return HeteroGraph(rels, counts, frames)


def heterograph(data_dict, num_nodes_dict: Optional[Dict[str, int]] = None,
                *, device=None) -> HeteroGraph:
    """A heterograph from ``{(srctype, etype, dsttype): (src, dst)}``
    (``dgl.heterograph``): each relation a :func:`block` in its type
    pair's node spaces, with every layout its in-degrees earn, built on
    the host and placed on ``device`` (default ``cuda``). A type's node
    count is the larger of ``num_nodes_dict``'s and its largest id + 1."""
    dev = resolve_device(device)
    counts: Dict[str, int] = dict(num_nodes_dict or {})
    for (st, _, dt), (src, dst) in data_dict.items():
        src = np.asarray(src)
        dst = np.asarray(dst)
        counts[st] = max(counts.get(st, 0), int(src.max(initial=-1)) + 1)
        counts[dt] = max(counts.get(dt, 0), int(dst.max(initial=-1)) + 1)
    rels = {}
    for c, (src, dst) in data_dict.items():
        st, _, dt = c
        rels[c] = block((np.asarray(src), np.asarray(dst)),
                        num_src_nodes=counts[st], num_dst_nodes=counts[dt],
                        device=dev)
    return HeteroGraph(rels, counts)
