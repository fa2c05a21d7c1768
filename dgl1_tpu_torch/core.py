"""Message-passing core: ``update_all`` / ``apply_edges`` lowered to
g-SpMM and g-SDDMM, with a UDF fallback (the port's ``dgl1_tpu/core.py``;
parity: ``python/dgl/core.py`` and the 0.4-era scheduler).

A builtin (message, reduce) pair becomes one :func:`~dgl1_tpu_torch.ops.
gspmm` call, so it runs on whichever engine serves the graph's layout
(the hub kernels K1-K5, the tile kernels K9/K10, the block-dense K11, or
the oracle); a message touching the destination goes through
:func:`~dgl1_tpu_torch.ops.gsddmm` first. A UDF reduce reads the graph's
ELL layout as its mailbox plan where the graph has one (no host sync:
each bucket's mailbox is zero-padded, ``NodeBatch.mailbox_mask`` marks the
real messages and ``degrees`` holds the in-degrees); otherwise it buckets
the nodes by exact in-degree on the host. Writes back into frames are
out-of-place (``index_put``), so gradients flow through them.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import numpy as np
import torch

from dgl1_tpu_torch.function import BinaryMessage, CopyMessage, Reducer
from dgl1_tpu_torch.graph import Graph
from dgl1_tpu_torch.ops.engine_xla import _binary, gather_rows, take_fill
from dgl1_tpu_torch.ops.sddmm import gsddmm
from dgl1_tpu_torch.ops.spmm import gspmm

__all__ = ["EdgeBatch", "NodeBatch", "invoke_gspmm", "invoke_gsddmm",
           "invoke_udf_reduce", "invoke_udf_reduce_ell", "message_passing",
           "update_all", "apply_edges", "apply_nodes", "send_and_recv",
           "filter_nodes", "filter_edges", "pull", "push", "prop_nodes",
           "prop_nodes_topo", "topo_schedule", "prop_nodes_topo_compiled",
           "prop_nodes_bfs", "prop_edges", "prop_edges_dfs"]

# ELL slots at or past this index are padding (the builders' sentinel is
# 1 << 30).
_ELL_PAD = 1 << 29


class _LazyDataView(dict):
    """Node data gathered onto edges on access (``EdgeBatch.src`` /
    ``.dst``); out-of-range ids (padded edges) read the last row."""

    def __init__(self, data: Dict, index):
        super().__init__()
        self._data = data
        self._index = index

    def __getitem__(self, key):
        x = self._data[key]
        return x if self._index is None else gather_rows(x, self._index)

    def keys(self):
        return self._data.keys()

    def __contains__(self, key):
        return key in self._data


class _FillDataView(_LazyDataView):
    """As :class:`_LazyDataView`, with out-of-range ids reading zeros (the
    compiled topological path's padded mailbox slots)."""

    def __getitem__(self, key):
        x = self._data[key]
        return x if self._index is None else take_fill(x, self._index, 0.0)


class EdgeBatch:
    """The edges handed to an edge UDF (``dgl.udf.EdgeBatch``):
    ``src``/``dst`` node data per edge, ``data`` the edge data."""

    def __init__(self, g: Graph, src_idx, dst_idx, edata: Dict):
        self.src = _LazyDataView(g.srcdata, src_idx)
        self.dst = _LazyDataView(g.dstdata, dst_idx)
        self.data = edata
        self._g = g

    def edges(self):
        return self._g.src, self._g.dst


class NodeBatch:
    """The nodes handed to a node UDF (``dgl.udf.NodeBatch``): ``data``,
    and for a reduce ``mailbox`` {field: (n, k, *f)}. On the ELL plan the
    mailbox is zero-padded to its bucket's width, ``mailbox_mask`` (n, k)
    marks the real messages and ``degrees`` holds each node's in-degree
    (sum-style UDFs are exact as they are; order statistics mask through
    ``mailbox_mask``); host buckets have exact widths and neither."""

    def __init__(self, data: Dict, mailbox: Dict, nodes, mailbox_mask=None,
                 degrees=None):
        self.data = data
        self.mailbox = mailbox
        self._nodes = nodes
        self.mailbox_mask = mailbox_mask
        self.degrees = degrees

    def nodes(self):
        return self._nodes


def _ids(x, device) -> torch.Tensor:
    """Ids (a list, numpy array or tensor; a bool mask -> its nonzeros) as
    a long tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    arr = np.asarray(x)
    if arr.dtype == bool:
        arr = np.nonzero(arr)[0]
    return torch.as_tensor(arr.astype(np.int64).reshape(-1), device=device)


def _put_rows(base, rows, values):
    """``base`` with ``rows`` replaced by ``values`` (out of place)."""
    return base.index_put((rows,), values.to(base.dtype))


def _spmm_target_ok(m: Union[CopyMessage, BinaryMessage]) -> bool:
    if isinstance(m, CopyMessage):
        return m.target in ("u", "e")
    return {m.lhs, m.rhs} <= {"u", "e"}


def _fetch(g: Graph, target: str, field: str):
    store = {"u": g.srcdata, "v": g.dstdata, "e": g.edata}[target]
    if field not in store:
        raise KeyError(f"field {field!r} not found in {target}-data")
    return store[field]


def invoke_gspmm(g: Graph, mfunc, rfunc: Reducer):
    """A builtin (message, reduce) pair as one g-SpMM call."""
    if isinstance(mfunc, CopyMessage):
        if mfunc.target == "u":
            return gspmm(g, "copy_lhs", rfunc.op,
                         _fetch(g, "u", mfunc.in_field), None)
        return gspmm(g, "copy_rhs", rfunc.op, None,
                     _fetch(g, "e", mfunc.in_field))
    lhs_data = _fetch(g, mfunc.lhs, mfunc.lhs_field)
    rhs_data = _fetch(g, mfunc.rhs, mfunc.rhs_field)
    op = mfunc.binary_op
    if mfunc.lhs == "u" and mfunc.rhs == "e":
        return gspmm(g, op, rfunc.op, lhs_data, rhs_data)
    if mfunc.lhs == "e" and mfunc.rhs == "u":
        if op in ("add", "mul"):  # commutes: g-SpMM's lhs is the u-data
            return gspmm(g, op, rfunc.op, rhs_data, lhs_data)
        # e - u and e / u: the messages through g-SDDMM, then copy_rhs.
        msg = gsddmm(g, op, lhs_data, rhs_data, lhs_target="e",
                     rhs_target="u")
        return gspmm(g, "copy_rhs", rfunc.op, None, msg)
    raise ValueError(f"{mfunc.name} is not a g-SpMM message")


def invoke_gsddmm(g: Graph, mfunc):
    """A builtin message function as one g-SDDMM call (per-edge values in
    user edge order)."""
    if isinstance(mfunc, CopyMessage):
        if mfunc.target == "u":
            return gsddmm(g, "copy_lhs", _fetch(g, "u", mfunc.in_field),
                          None, lhs_target="u")
        return _fetch(g, "e", mfunc.in_field)
    return gsddmm(g, mfunc.binary_op, _fetch(g, mfunc.lhs, mfunc.lhs_field),
                  _fetch(g, mfunc.rhs, mfunc.rhs_field),
                  lhs_target=mfunc.lhs, rhs_target=mfunc.rhs)


def invoke_udf_reduce_ell(g: Graph, msg: Dict[str, torch.Tensor],
                          rfunc: Callable):
    """The UDF reduce over the graph's ELL layout as the mailbox plan: one
    call a bucket, padded slots zero-filled and flagged in
    ``mailbox_mask``, rows returned in bucket order and put back in node
    order by one gather (zero-degree nodes get zeros)."""
    meta, ell = g.ell_dst_meta, g.ell_dst
    num_dst = g.num_dst_nodes()
    idx, eid, inv_perm = ell["idx"], ell["eid"], ell["inv_perm"]
    if inv_perm.numel() == 0:  # uniform blocks: row == node id
        perm = torch.arange(num_dst, device=idx.device)
    else:
        perm = torch.argsort(inv_perm.long(), stable=True)
    out_fields, chunks = None, {}
    slot_off = row_off = 0
    for k, n_b in meta:
        sl_idx = idx[slot_off: slot_off + n_b * k]
        sl_eid = eid[slot_off: slot_off + n_b * k]
        valid = (sl_idx < _ELL_PAD).reshape(n_b, k)
        mailbox = {}
        for f, v in msg.items():
            m = gather_rows(v, sl_eid).reshape((n_b, k) + tuple(v.shape[1:]))
            vm = valid.reshape((n_b, k) + (1,) * (v.dim() - 1))
            mailbox[f] = torch.where(vm, m, torch.zeros_like(m))
        nodes = perm[row_off: row_off + n_b]
        ndata = {f: gather_rows(v, nodes) for f, v in g.dstdata.items()}
        ret = rfunc(NodeBatch(ndata, mailbox, nodes, mailbox_mask=valid,
                              degrees=valid.sum(dim=1)))
        if out_fields is None:
            out_fields = list(ret)
        for f, v in ret.items():
            chunks.setdefault(f, []).append(v)
        slot_off += n_b * k
        row_off += n_b
    out = {}
    for f in out_fields or []:
        stacked = torch.cat(chunks[f], dim=0)
        out[f] = (stacked if inv_perm.numel() == 0
                  else take_fill(stacked, inv_perm, 0.0))
    return out


def _udf_reduce_buckets(g: Graph, msg: Dict[str, torch.Tensor],
                        rfunc: Callable):
    """The UDF reduce over host buckets of exact in-degree: one call a
    degree, rows written back to their nodes only; zero-degree nodes get
    zeros."""
    num_dst = g.num_dst_nodes()
    dev = g.csc_indptr.device
    indptr = g.csc_indptr.cpu().numpy().astype(np.int64)
    deg = np.diff(indptr[: num_dst + 1])
    eid_by_dst = g.csc_eid.long()
    out_fields, pieces = None, {}
    for d in np.unique(deg):
        if d == 0:
            continue
        nodes_np = np.nonzero(deg == d)[0]
        slots = indptr[nodes_np][:, None] + np.arange(d)[None, :]
        eids = eid_by_dst[torch.as_tensor(slots, device=dev)]
        mailbox = {f: v.index_select(0, eids.reshape(-1)).reshape(
            tuple(eids.shape) + tuple(v.shape[1:])) for f, v in msg.items()}
        nodes = torch.as_tensor(nodes_np, device=dev)
        ndata = {f: v.index_select(0, nodes) for f, v in g.dstdata.items()}
        ret = rfunc(NodeBatch(ndata, mailbox, nodes))
        if out_fields is None:
            out_fields = list(ret)
        for f, v in ret.items():
            pieces.setdefault(f, []).append((nodes, v))
    out = {}
    for f in out_fields or []:
        rows = torch.cat([n for n, _ in pieces[f]])
        vals = torch.cat([v for _, v in pieces[f]], dim=0)
        buf = vals.new_zeros((num_dst,) + tuple(vals.shape[1:]))
        out[f] = _put_rows(buf, rows, vals)
    return out


def invoke_udf_reduce(g: Graph, msg: Dict[str, torch.Tensor],
                      rfunc: Callable):
    """Degree-bucketed UDF reduce (``core.py :: invoke_udf_reduce``): the
    ELL mailbox plan where the graph has an ELL layout, else host buckets
    of exact width."""
    if g.ell_dst is not None:
        return invoke_udf_reduce_ell(g, msg, rfunc)
    return _udf_reduce_buckets(g, msg, rfunc)


def message_passing(g: Graph, mfunc, rfunc, afunc=None):
    """Messages, reduce and node apply (``core.py :: message_passing``);
    returns {field: (num_dst, ...)} without writing it."""
    builtin_m = isinstance(mfunc, (CopyMessage, BinaryMessage))
    builtin_r = isinstance(rfunc, Reducer)
    if builtin_m and builtin_r:
        if _spmm_target_ok(mfunc):
            out = invoke_gspmm(g, mfunc, rfunc)
        else:  # the message reads v (u_dot_v, ...): g-SDDMM, then reduce
            out = gspmm(g, "copy_rhs", rfunc.op, None, invoke_gsddmm(g, mfunc))
        result = {rfunc.out_field: out}
    else:
        if builtin_m:
            msg = {mfunc.out_field: invoke_gsddmm(g, mfunc)}
        else:
            msg = mfunc(EdgeBatch(g, g.src, g.dst, g.edata))
        if builtin_r:
            result = {rfunc.out_field: gspmm(g, "copy_rhs", rfunc.op, None,
                                             msg[rfunc.msg_field])}
        else:
            result = invoke_udf_reduce(g, msg, rfunc)
    if afunc is not None:
        ndata = dict(g.dstdata)
        ndata.update(result)
        result.update(afunc(NodeBatch(ndata, {}, None)))
    return result


def _unwrap(out: Dict):
    return next(iter(out.values())) if len(out) == 1 else out


def update_all(g: Graph, mfunc, rfunc, afunc=None):
    result = message_passing(g, mfunc, rfunc, afunc)
    g.dstdata.update(result)
    return _unwrap(result)


def apply_edges(g: Graph, func, edges="__ALL__"):
    """An edge function over every edge, or over the edge ids ``edges``
    (rows written back into ``edata``); returns the computed values."""
    if not (isinstance(edges, str) and edges == "__ALL__"):
        eids = _ids(edges, g.device)
        sub_src, sub_dst = g.src[eids], g.dst[eids]
        sub_edata = {k: v[eids] for k, v in g.edata.items()}
        if isinstance(func, CopyMessage):
            out = {func.out_field: (
                gather_rows(_fetch(g, "u", func.in_field), sub_src)
                if func.target == "u" else sub_edata[func.in_field])}
        elif isinstance(func, BinaryMessage):
            def get(target, field):
                if target == "u":
                    return gather_rows(_fetch(g, "u", field), sub_src)
                if target == "v":
                    return gather_rows(_fetch(g, "v", field), sub_dst)
                return sub_edata[field]

            out = {func.out_field: _binary(
                func.binary_op, get(func.lhs, func.lhs_field),
                get(func.rhs, func.rhs_field))}
        else:
            out = func(EdgeBatch(g, sub_src, sub_dst, sub_edata))
        for k, v in out.items():
            base = g.edata.get(k)
            if base is None:
                base = v.new_zeros((g.num_edges_padded(),)
                                   + tuple(v.shape[1:]))
            g.edata[k] = _put_rows(base, eids, v)
        return _unwrap(out)
    if isinstance(func, (CopyMessage, BinaryMessage)):
        out = {func.out_field: invoke_gsddmm(g, func)}
    else:
        out = func(EdgeBatch(g, g.src, g.dst, g.edata))
    g.edata.update(out)
    return _unwrap(out)


def apply_nodes(g: Graph, func, v="__ALL__"):
    """A node UDF over every destination node, or over the ids (or bool
    mask) ``v``, its rows written back into the frame. Returns the UDF's
    output, the bare value when it has one field (as ``apply_edges``)."""
    if isinstance(v, str) and v == "__ALL__":
        out = func(NodeBatch(g.dstdata, {},
                             torch.arange(g.num_dst_nodes(),
                                          device=g.device)))
        g.dstdata.update(out)
        return _unwrap(out)
    vj = _ids(v, g.device)
    ndata = {k: val.index_select(0, vj) for k, val in g.dstdata.items()}
    out = func(NodeBatch(ndata, {}, vj))
    for k, val in out.items():
        base = g.dstdata.get(k)
        if base is None:
            base = val.new_zeros((g.num_dst_nodes(),) + tuple(val.shape[1:]))
        g.dstdata[k] = _put_rows(base, vj, val)
    return _unwrap(out)


def send_and_recv(g: Graph, edges, mfunc, rfunc, afunc=None):
    """Message passing over the edge ids ``edges`` (an edge subgraph in the
    parent's node space); writes and returns the reduced fields."""
    from dgl1_tpu_torch.transform import edge_subgraph

    sub = edge_subgraph(g, edges, relabel_nodes=False)
    result = message_passing(sub, mfunc, rfunc, afunc)
    g.dstdata.update(result)
    return _unwrap(result)


def filter_nodes(g: Graph, predicate) -> torch.Tensor:
    """Ids of the nodes where ``predicate(NodeBatch)`` is true."""
    nb = NodeBatch(g.dstdata, {}, torch.arange(g.num_dst_nodes(),
                                               device=g.device))
    return torch.as_tensor(predicate(nb)).nonzero().reshape(-1)


def filter_edges(g: Graph, predicate) -> torch.Tensor:
    """Ids of the real edges where ``predicate(EdgeBatch)`` is true."""
    mask = torch.as_tensor(predicate(EdgeBatch(g, g.src, g.dst, g.edata)))
    return mask[: g.num_edges()].nonzero().reshape(-1)


def _merge_received(g: Graph, result: Dict, recv: torch.Tensor):
    """Write ``result``'s rows of the receiving nodes ``recv`` into
    ``g.dstdata``; the other rows keep their values where the field
    already has this shape."""
    mask = torch.zeros(g.num_dst_nodes(), dtype=torch.bool, device=g.device)
    mask[recv] = True
    for k, col in result.items():
        old = g.dstdata.get(k)
        if old is not None and tuple(old.shape) == tuple(col.shape):
            m = mask.reshape((-1,) + (1,) * (col.dim() - 1))
            col = torch.where(m, col, old)
        g.dstdata[k] = col


def _apply_on(g: Graph, nodes: torch.Tensor, apply_node_func):
    ndata = {k: x.index_select(0, nodes) for k, x in g.dstdata.items()}
    out = apply_node_func(NodeBatch(ndata, {}, nodes))
    n = g.num_dst_nodes()
    for k, val in out.items():
        old = g.dstdata.get(k)
        if old is None or tuple(old.shape) != (n,) + tuple(val.shape[1:]):
            old = val.new_zeros((n,) + tuple(val.shape[1:]))
        g.dstdata[k] = _put_rows(old, nodes, val)


def pull(g: Graph, v, message_func, reduce_func, apply_node_func=None):
    """Messages into the nodes ``v`` along their in-edges
    (``DGLHeteroGraph.pull``): only the receiving rows change, and
    ``apply_node_func`` runs on all of ``v``, receivers or not, which
    makes stateful topological propagation (Tree-LSTM) right."""
    from dgl1_tpu_torch.transform import edge_subgraph

    vj = _ids(v, g.device)
    e = g.num_edges()
    dst = g.dst[:e].cpu().numpy()
    eids = np.nonzero(np.isin(dst, vj.cpu().numpy()))[0]
    if len(eids):
        formats = (("ell",) if isinstance(reduce_func, Reducer)
                   else ("csc",))
        sub = edge_subgraph(g, eids, relabel_nodes=False, formats=formats)
        result = message_passing(sub, message_func, reduce_func, None)
        recv = torch.as_tensor(np.unique(dst[eids]), device=g.device)
        _merge_received(g, result, recv)
    if apply_node_func is not None:
        _apply_on(g, vj, apply_node_func)
    return g


def push(g: Graph, u, message_func, reduce_func, apply_node_func=None):
    """Messages along the out-edges of ``u``, reduced at their
    destinations (``DGLHeteroGraph.push``)."""
    from dgl1_tpu_torch.transform import edge_subgraph

    uj = _ids(u, g.device)
    e = g.num_edges()
    src = g.src[:e].cpu().numpy()
    eids = np.nonzero(np.isin(src, uj.cpu().numpy()))[0]
    if len(eids) == 0:
        return g
    recv = torch.as_tensor(np.unique(g.dst[:e].cpu().numpy()[eids]),
                           device=g.device)
    sub = edge_subgraph(g, eids, relabel_nodes=False)
    _merge_received(g, message_passing(sub, message_func, reduce_func, None),
                    recv)
    if apply_node_func is not None:
        _apply_on(g, recv, apply_node_func)
    return g


def prop_nodes(g: Graph, nodes_generator, message_func, reduce_func,
               apply_node_func=None):
    """One :func:`pull` a node frontier (``dgl.prop_nodes``)."""
    for frontier in nodes_generator:
        pull(g, np.asarray(frontier), message_func, reduce_func,
             apply_node_func)
    return g


def prop_nodes_topo(g: Graph, message_func, reduce_func, reverse=False,
                    apply_node_func=None):
    """Propagation in topological frontier order (``dgl.prop_nodes_topo``,
    the Tree-LSTM driver); ``reverse`` propagates against the edges."""
    from dgl1_tpu_torch import traversal

    if reverse:
        rg = g.reverse(copy_edata=True)
        rg.ndata = g.ndata
        rg.srcdata = g.srcdata
        rg.dstdata = g.dstdata
        prop_nodes(rg, traversal.topological_nodes_generator(rg),
                   message_func, reduce_func, apply_node_func)
        return g
    return prop_nodes(g, traversal.topological_nodes_generator(g),
                      message_func, reduce_func, apply_node_func)


def topo_schedule(g: Graph, reverse: bool = False, pad_levels: int = None,
                  pad_width: int = None, pad_k: int = None):
    """The static (L, W, K) topological schedule of
    :func:`prop_nodes_topo_compiled` (host numpy, once a structure): the
    levels of the topological frontiers, each padded to the widest
    frontier W, each node's mailbox to the largest in-degree K; ``pad_*``
    round the dimensions up. Returns numpy arrays ``ids`` (L, W) node ids
    (N where padding), ``msrc``/``meid`` (L, W, K) mailbox source node /
    edge ids (num_src / 0 where padding), ``mmask`` (L, W, K) and ``deg``
    (L, W)."""
    from dgl1_tpu_torch import traversal

    gg = g.reverse(copy_edata=True) if reverse else g
    fronts = [np.asarray(f, dtype=np.int64)
              for f in traversal.topological_nodes_generator(gg)]
    n_dst, n_src = gg.num_dst_nodes(), gg.num_src_nodes()
    indptr = gg.csc_indptr.cpu().numpy().astype(np.int64)[: n_dst + 1]
    srcs = gg.csc_src.cpu().numpy()
    eids = gg.csc_eid.cpu().numpy()
    deg_all = np.diff(indptr)
    L = len(fronts)
    W = max((len(f) for f in fronts), default=1)
    K = int(deg_all.max(initial=1))
    if pad_levels is not None:
        L = max(L, pad_levels)
    if pad_width is not None:
        W = -(-W // pad_width) * pad_width
    if pad_k is not None:
        K = -(-K // pad_k) * pad_k
    ids = np.full((L, W), n_dst, np.int32)
    msrc = np.full((L, W, K), n_src, np.int32)
    meid = np.zeros((L, W, K), np.int32)
    mmask = np.zeros((L, W, K), bool)
    deg = np.zeros((L, W), np.int32)
    for lvl, f in enumerate(fronts):
        ids[lvl, : len(f)] = f
        counts = deg_all[f]
        deg[lvl, : len(f)] = counts
        total = int(counts.sum())
        if total == 0:
            continue
        owner = np.repeat(np.arange(len(f)), counts)
        slot = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        flat = np.repeat(indptr[f], counts) + slot
        msrc[lvl, owner, slot] = srcs[flat]
        meid[lvl, owner, slot] = eids[flat]
        mmask[lvl, owner, slot] = True
    return {"ids": ids, "msrc": msrc, "meid": meid, "mmask": mmask,
            "deg": deg}


def prop_nodes_topo_compiled(g: Graph, schedule, message_func, reduce_func,
                             apply_node_func=None):
    """Topological propagation over a static :func:`topo_schedule`: a
    level's mailbox is a (W, K) zero-filled gather from the running
    frames, the UDFs see the padded-mailbox :class:`NodeBatch`, and the
    writes are masked: reduce fields land only on real frontier nodes with
    in-edges, ``apply_node_func`` on every real frontier node. A
    ``reverse=True`` schedule propagates against the edges with no graph
    reversal here (it carries the structure); only ``g.dstdata`` and
    ``g.edata`` are read."""
    dev = g.device
    arr = {k: torch.as_tensor(np.asarray(v), device=dev)
           for k, v in schedule.items()}
    n_lvl, w, k = schedule["msrc"].shape
    n = g.num_dst_nodes()

    def write(frames, key, ids, mask, v):
        base = frames.get(key)
        if base is None:
            base = v.new_zeros((n,) + tuple(v.shape[1:]))
        sel = mask.nonzero().reshape(-1)
        frames[key] = _put_rows(base, ids.long()[sel], v[sel])

    frames = dict(g.dstdata)
    for lvl in range(n_lvl):
        ids = arr["ids"][lvl]
        mmask = arr["mmask"][lvl]
        degs = arr["deg"][lvl]
        nmask = ids < n
        eb = EdgeBatch.__new__(EdgeBatch)
        eb.src = _FillDataView(frames, arr["msrc"][lvl].reshape(-1))
        eb.dst = _FillDataView(frames, ids.repeat_interleave(k))
        eb.data = _FillDataView(g.edata, arr["meid"][lvl].reshape(-1))
        eb._g = g
        flat_mask = mmask.reshape(-1)
        mailbox = {}
        for key, v in message_func(eb).items():
            m = flat_mask.reshape((-1,) + (1,) * (v.dim() - 1))
            v = torch.where(m, v, torch.zeros_like(v))
            mailbox[key] = v.reshape((w, k) + tuple(v.shape[1:]))
        red = reduce_func(NodeBatch(_FillDataView(frames, ids), mailbox, ids,
                                    mailbox_mask=mmask, degrees=degs))
        for key, v in red.items():
            write(frames, key, ids, nmask & (degs > 0), v)
        if apply_node_func is not None:
            out = apply_node_func(NodeBatch(_FillDataView(frames, ids), {},
                                            ids))
            for key, v in out.items():
                write(frames, key, ids, nmask, v)
    g.dstdata.update(frames)
    return g


def prop_nodes_bfs(g: Graph, source, message_func, reduce_func,
                   apply_node_func=None):
    """Propagation along the BFS frontiers from ``source``."""
    from dgl1_tpu_torch import traversal

    return prop_nodes(g, traversal.bfs_nodes_generator(g, source),
                      message_func, reduce_func, apply_node_func)


def prop_edges(g: Graph, edges_generator, message_func, reduce_func,
               apply_node_func=None):
    """One :func:`send_and_recv` an edge frontier (``dgl.prop_edges``)."""
    for eids in edges_generator:
        send_and_recv(g, np.asarray(eids), message_func, reduce_func,
                      apply_node_func)
    return g


def prop_edges_dfs(g: Graph, source, message_func, reduce_func,
                   apply_node_func=None):
    """Propagation along the DFS edge order from ``source``."""
    from dgl1_tpu_torch import traversal

    return prop_edges(g, traversal.dfs_edges_generator(g, source),
                      message_func, reduce_func, apply_node_func)
