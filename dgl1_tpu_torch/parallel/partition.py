"""Graph partitioning for multi-device training (numpy, host side).

The port's copy of ``dgl1_tpu/parallel/partition.py``: the same
partitioners give the same assignments for the same seed, array for
array. METIS is not bundled: the quality partitioner is a batched
LDG-style greedy stream with label-propagation sweeps, beside a
multilevel heavy-edge-matching scheme with FM refinement
(:func:`metis_partition_assignment` keeps the lower edge cut), with a
random assignment as the cheap fallback.

On disk (the reference's contract): ``{out_path}/{name}.json`` +
``{out_path}/part{i}/graph.npz`` + ``part{i}/node_feat.npz``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from dgl1_tpu_torch.graph import Graph, graph

__all__ = [
    "random_partition_assignment",
    "greedy_partition_assignment",
    "metis_partition_assignment",
    "multilevel_partition_assignment",
    "edge_cut_fraction",
    "partition_graph",
    "load_partition",
    "load_global_feats",
    "metis_partition",
]


def _coo(g: Graph):
    """Real (unpadded) COO as int64 numpy."""
    e = g.num_edges()
    return (g.src[:e].cpu().numpy().astype(np.int64),
            g.dst[:e].cpu().numpy().astype(np.int64))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def random_partition_assignment(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=g.num_nodes()).astype(np.int32)


def greedy_partition_assignment(
    g: Graph, k: int, batch: int = 1024, slack: float = 1.1,
    sweeps: int = 6, seed: int = 0, balance_edges: bool = False,
) -> np.ndarray:
    """Batched LDG streaming partitioner with refinement sweeps.

    Sweep 0 streams nodes in descending-degree order, assigning each batch
    to the part holding most of its already-assigned neighbors, discounted
    by part fullness (the classic LDG score). Later sweeps revisit every
    node in random order with full neighborhood information — effectively
    size-constrained label propagation — which converges to cuts far below
    the initial stream on structured graphs.

    ``balance_edges=True`` balances *edge ownership* (each node weighted
    by in-degree + 1) instead of node counts — parity with
    ``dgl.distributed.partition_graph(balance_edges=...)`` and essential
    on power-law graphs, where hub parts otherwise own nearly all edges
    (edges live on their destination's part).
    """
    n = g.num_nodes()
    e = g.num_edges()
    src, dst = _coo(g)
    # Undirected adjacency in CSR form for neighbor queries.
    us = np.concatenate([src, dst])
    vs = np.concatenate([dst, src])
    order = np.argsort(us, kind="stable")
    us, vs = us[order], vs[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(us, minlength=n), out=indptr[1:])

    deg = np.diff(indptr)
    if balance_edges:
        in_deg = np.bincount(dst, minlength=n).astype(np.float64)
        w = in_deg + 1.0  # +1 keeps isolated nodes from piling into one part
    else:
        w = np.ones(n, dtype=np.float64)
    W = float(w.sum())
    cap = slack * W / k

    part = np.full(n, -1, dtype=np.int32)
    rng = np.random.default_rng(seed)

    def batch_hist(nodes):
        counts = deg[nodes]
        total = int(counts.sum())
        if total == 0:
            return np.zeros((len(nodes), k), dtype=np.float64)
        flat_cols = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        flat_nbrs = vs[np.repeat(indptr[nodes], counts) + flat_cols]
        owner = np.repeat(np.arange(len(nodes)), counts)
        nbr_part = part[flat_nbrs]
        valid = nbr_part >= 0
        hist = np.zeros((len(nodes), k), dtype=np.float64)
        np.add.at(hist, (owner[valid], nbr_part[valid]), 1.0)
        return hist

    # Fennel-style additive balance penalty (Tsourakakis et al.): score =
    # |N(v) in S| - alpha * gamma * |S|^(gamma-1). Unlike a multiplicative
    # fullness factor, this cannot let parts collapse to empty (an empty
    # part has zero penalty and eventually wins ties).
    gamma = 1.5
    m = max(e, 1)
    alpha = m * (k ** (gamma - 1)) / (W ** gamma)

    # The capacity check uses sizes from the start of a batch, so a batch
    # must not carry more than a small fraction of a part's capacity —
    # otherwise it stampedes into one part (catastrophic in weighted mode,
    # where a few hubs carry huge weight). Split the visit order at BOTH
    # a node-count stride and a weight budget, whichever comes first.
    batch = max(64, min(batch, n // 8))
    budget = max(W / (k * 16.0), 1.0)

    def weight_batches(visit):
        gid_w = (np.cumsum(w[visit]) / budget).astype(np.int64)
        gid_n = np.arange(len(visit)) // batch
        gid = np.maximum(gid_w, gid_n)
        cuts = np.nonzero(np.diff(gid))[0] + 1
        return np.split(visit, cuts)

    for sweep in range(sweeps):
        visit = (np.argsort(-deg, kind="stable") if sweep == 0
                 else rng.permutation(n))
        for nodes in weight_batches(visit):
            hist = batch_hist(nodes)
            assigned = part >= 0
            sizes = np.bincount(part[assigned], weights=w[assigned],
                                minlength=k).astype(np.float64)
            # A node being reassigned shouldn't count its own seat.
            cur = part[nodes]
            np.subtract.at(sizes, cur[cur >= 0], w[nodes][cur >= 0])
            penalty = alpha * gamma * np.power(sizes[None, :], gamma - 1.0)
            # Hard cap: parts at capacity are ineligible.
            penalty = np.where(sizes[None, :] >= cap, np.inf, penalty)
            score = hist + 1e-3 * rng.random(hist.shape) - penalty
            part[nodes] = score.argmax(axis=1).astype(np.int32)

    # Repair pass: batch staleness can still overfill or empty parts; move
    # the least-attached (weighted) nodes of overfull parts into the
    # smallest ones.
    sizes = np.bincount(part, weights=w, minlength=k)
    floor = max(W / k / slack, 1.0)
    for _ in range(k):
        donor = int(np.argmax(sizes))
        receiver = int(np.argmin(sizes))
        if sizes[donor] <= cap and sizes[receiver] >= floor:
            break
        need = float(min(sizes[donor] - W / k,
                         max(floor - sizes[receiver],
                             sizes[donor] - cap)))
        need = max(need, 1.0)
        cand = np.nonzero(part == donor)[0]
        hist = batch_hist(cand)
        attach = hist[np.arange(len(cand)), donor]
        order_m = np.argsort(attach, kind="stable")
        take = np.searchsorted(np.cumsum(w[cand[order_m]]), need) + 1
        movers = cand[order_m[:take]]
        part[movers] = receiver
        sizes = np.bincount(part, weights=w, minlength=k)
    return part


def metis_partition_assignment(g: Graph, k: int, **kw) -> np.ndarray:
    """Parity name for ``dgl.distributed.metis_partition_assignment``.

    METIS itself is not bundled; this runs BOTH from-scratch
    partitioners — the LDG-greedy/label-prop stream (wins on
    community-structured graphs) and the multilevel
    heavy-edge-matching scheme (wins on geometric/local graphs) — and
    keeps the lower edge cut.
    """
    a = greedy_partition_assignment(g, k, **kw)
    b = multilevel_partition_assignment(
        g, k, seed=kw.get("seed", 0),
        balance_edges=kw.get("balance_edges", False))
    return a if edge_cut_fraction(g, a) <= edge_cut_fraction(g, b) else b


def edge_cut_fraction(g: Graph, part: np.ndarray) -> float:
    src, dst = _coo(g)
    if len(src) == 0:
        return 0.0
    return float(np.mean(part[src] != part[dst]))


def partition_graph(
    g: Graph,
    graph_name: str,
    num_parts: int,
    out_path: str,
    part_method: str = "greedy",
    balance_edges: bool = False,
    seed: int = 0,
    save_global_feats: bool = True,
    save_structure: bool = True,
    save_part_feats: bool = True,
) -> np.ndarray:
    """Partition + persist (parity: ``dgl.distributed.partition_graph``).

    Each part stores its *destination-owned* edges plus 1-hop halo source
    nodes, with ``inner_node`` / ``inner_edge`` flags and original ids —
    the same artifact shape as the reference's ``PartitionWithHalo``.
    Returns the assignment array.

    Multi-host feature contract (the KVStore-pull replacement): with
    ``save_global_feats`` the FULL feature matrices are also written once
    as raw ``.bin`` files that every host ``np.memmap``s read-only
    (replicated store): a local mmap gather beats a per-batch cross-host
    pull; ``save_part_feats`` also writes each part's rows for the
    sharded store (``parallel/kvstore.py``).
    ``save_structure`` writes the full COO once so any host can sample
    any seed without forwarding (``DistGraph.from_partition`` reads it).

    Heterographs dispatch to :func:`~dgl1_tpu_torch.parallel.hetero.
    partition_hetero_graph` (``metis`` for ``metis`` and ``greedy``, as the
    reference maps them).
    """
    from dgl1_tpu_torch.heterograph import HeteroGraph

    if isinstance(g, HeteroGraph):
        from dgl1_tpu_torch.parallel.hetero import partition_hetero_graph

        return partition_hetero_graph(
            g, graph_name, num_parts, out_path,
            part_method=("metis" if part_method in ("metis", "greedy")
                         else part_method),
            balance_edges=balance_edges, seed=seed)
    if part_method == "random":
        part = random_partition_assignment(g, num_parts, seed)
    elif part_method == "greedy":
        part = greedy_partition_assignment(g, num_parts, seed=seed,
                                           balance_edges=balance_edges)
    elif part_method == "multilevel":
        part = multilevel_partition_assignment(
            g, num_parts, seed=seed, balance_edges=balance_edges)
    elif part_method == "metis":  # best-of-both (METIS-parity quality)
        part = metis_partition_assignment(g, num_parts, seed=seed,
                                          balance_edges=balance_edges)
    else:
        raise ValueError(f"unknown part_method {part_method!r}")

    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    e = g.num_edges()
    src, dst = _coo(g)

    node_map = []
    edge_map = []
    for p in range(num_parts):
        own_nodes = np.nonzero(part == p)[0]
        own_edges = np.nonzero(part[dst] == p)[0]
        halo = np.setdiff1d(np.unique(src[own_edges]), own_nodes)
        local_nodes = np.concatenate([own_nodes, halo])
        relabel = np.full(g.num_nodes(), -1, dtype=np.int64)
        relabel[local_nodes] = np.arange(len(local_nodes))
        pdir = out / f"part{p}"
        pdir.mkdir(exist_ok=True)
        np.savez_compressed(
            pdir / "graph.npz",
            src=relabel[src[own_edges]].astype(np.int32),
            dst=relabel[dst[own_edges]].astype(np.int32),
            orig_nid=local_nodes.astype(np.int64),
            orig_eid=own_edges.astype(np.int64),
            inner_node=(np.arange(len(local_nodes)) < len(own_nodes)),
            inner_edge=np.ones(len(own_edges), dtype=bool),
            num_nodes=np.asarray([len(local_nodes)]),
        )
        feats = {k: _host(v)[own_nodes] for k, v in g.ndata.items()}
        np.savez_compressed(pdir / "node_feat.npz", **feats)
        if save_part_feats and feats:
            # Raw mmap-able shards for the KVStore-parity pull service
            # (parallel/kvstore.py): features beyond one host's storage
            # stay partition-sharded; remote rows are pulled by book.
            from dgl1_tpu_torch.parallel.kvstore import (
                write_part_feature_shards)

            part_feat_meta = write_part_feature_shards(
                out, graph_name, p, feats)
        node_map.append(own_nodes)
        edge_map.append(own_edges)

    book = {
        "graph_name": graph_name,
        "num_parts": num_parts,
        "num_nodes": g.num_nodes(),
        "num_edges": e,
        "part_method": part_method,
        "edge_cut_fraction": edge_cut_fraction(g, part),
        "node_map": [m.tolist() if len(m) < 100000 else None
                     for m in node_map],
    }
    if save_part_feats and g.ndata:
        book["part_feats"] = part_feat_meta
    if save_global_feats and g.ndata:
        fdir = out / f"{graph_name}_feat"
        fdir.mkdir(exist_ok=True)
        book["global_feats"] = {}
        for k, v in g.ndata.items():
            arr = np.ascontiguousarray(_host(v))
            arr.tofile(fdir / f"{k}.bin")
            book["global_feats"][k] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype)}
    if save_structure:
        np.savez(out / f"{graph_name}_structure.npz",
                 src=src.astype(np.int32), dst=dst.astype(np.int32),
                 num_nodes=np.asarray([g.num_nodes()]))
    np.save(out / "node_part.npy", part)
    with open(out / f"{graph_name}.json", "w") as f:
        json.dump(book, f)
    return part


def load_global_feats(out_path: str, graph_name: str, mmap: bool = True,
                      device=None):
    """Open the replicated global feature store written by
    :func:`partition_graph` — ``{field: HostFeatureStore}``, any host can
    pull any node's rows (the DistDGL KVStore-pull replacement);
    ``device`` (None: cuda) is where their ``pull_to_device`` puts rows."""
    from dgl1_tpu_torch.data.feature_store import HostFeatureStore

    out = Path(out_path)
    with open(out / f"{graph_name}.json") as f:
        book = json.load(f)
    stores = {}
    for k, meta in book.get("global_feats", {}).items():
        stores[k] = HostFeatureStore(
            out / f"{graph_name}_feat" / f"{k}.bin",
            shape=tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]),
            mmap=mmap, device=device,
        )
    return stores


def load_partition(out_path: str, graph_name: str, part_id: int,
                   device=None):
    """Load one partition (parity: ``dgl.distributed.load_partition``)
    onto ``device`` (None: cuda).

    Returns (local_graph, node_feats, book_metadata).
    """
    out = Path(out_path)
    with open(out / f"{graph_name}.json") as f:
        book = json.load(f)
    pdir = out / f"part{part_id}"
    with np.load(pdir / "graph.npz") as z:
        lg = graph((z["src"], z["dst"]), num_nodes=int(z["num_nodes"][0]),
                   device=device)
        lg.ndata["orig_id"] = torch.as_tensor(
            z["orig_nid"].astype(np.int64), device=lg.device)
        lg.ndata["inner_node"] = torch.as_tensor(z["inner_node"],
                                                 device=lg.device)
        lg.edata["orig_id"] = torch.as_tensor(
            z["orig_eid"].astype(np.int64), device=lg.device)
    with np.load(pdir / "node_feat.npz") as z:
        feats = {k: np.array(z[k]) for k in z.files}
    book["part_assignment"] = np.load(out / "node_part.npy")
    return lg, feats, book


def metis_partition(g: Graph, k: int, extra_cached_hops: int = 0,
                    **kw):
    """Parity: ``dgl.transform.metis_partition`` — returns
    ``{part_id: node-induced subgraph}`` with ``ndata['inner_node']``
    flags (1 for owned nodes, 0 for the ``extra_cached_hops``-hop halo),
    original ids in ``ndata['_ID']``. Assignment by
    :func:`metis_partition_assignment` (METIS is not bundled)."""
    from dgl1_tpu_torch.transform import node_subgraph

    part = metis_partition_assignment(g, k, **kw)
    src, dst = _coo(g)
    out = {}
    for p in range(k):
        inner = part == p
        nodes = inner.copy()
        for _ in range(extra_cached_hops):
            touched = np.zeros_like(nodes)
            sel = nodes[dst]
            touched[src[sel]] = True
            sel = nodes[src]
            touched[dst[sel]] = True
            nodes |= touched
        ids = np.flatnonzero(nodes)
        sub = node_subgraph(g, ids)
        sub.ndata["inner_node"] = torch.as_tensor(
            inner[ids].astype(np.int32), device=sub.device)
        out[p] = sub
    return out


# ----------------------------------------------------------------------
# Multilevel partitioner (METIS-architecture: heavy-edge-matching
# coarsening -> coarsest Fennel -> project + weighted label-prop
# refinement per level): the quality gap the LDG stream leaves on
# structured graphs.
# ----------------------------------------------------------------------

def _hem_match(us, vs, ew, nw, n, rng, max_w):
    """One heavy-edge-matching round: mutual heaviest-neighbor proposals
    under a node-weight cap. Returns cid (coarse id per node)."""
    sel = us != vs
    u, v, w = us[sel], vs[sel], ew[sel]
    # Heaviest incident edge per node: sort by (u, w), take the last.
    # Uniform-weight graphs (grids/meshes) need a random tie-break:
    # deterministic ties make the mutual-proposal matching stall at the
    # very first round (<5% matched -> no coarsening -> no per-level
    # refinement at all).
    w = w * (1.0 + 0.01 * rng.random(len(w)))
    order = np.lexsort((w, u))
    uu, vv = u[order], v[order]
    last = np.zeros(n, dtype=np.int64) - 1
    prop = np.full(n, -1, dtype=np.int64)
    np.maximum.at(last, uu, np.arange(len(uu)))
    has = last >= 0
    prop[has] = vv[last[has]]
    # Mutual proposals, weight-capped; tie-break by id to avoid cycles.
    ok = (prop >= 0)
    idx = np.arange(n)
    mutual = ok & (prop[np.clip(prop, 0, n - 1)] == idx) & (idx < prop)
    mutual &= (nw + nw[np.clip(prop, 0, n - 1)]) <= max_w
    cid = np.full(n, -1, dtype=np.int64)
    pairs = np.flatnonzero(mutual)
    cid[pairs] = np.arange(len(pairs))
    cid[prop[pairs]] = cid[pairs]
    singles = np.flatnonzero(cid < 0)
    cid[singles] = len(pairs) + np.arange(len(singles))
    return cid, len(pairs) + len(singles)


def _coarsen(us, vs, ew, nw, cid, nc):
    cu, cv = cid[us], cid[vs]
    keep = cu != cv
    key = cu[keep] * nc + cv[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    cew = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(cew, inv, ew[keep])
    cus = (uniq // nc).astype(np.int64)
    cvs = (uniq % nc).astype(np.int64)
    cnw = np.zeros(nc, dtype=np.float64)
    np.add.at(cnw, cid, nw)
    return cus, cvs, cew, cnw


def _lp_refine(us, vs, ew, nw, part, k, sweeps, slack, rng,
               batch=1024):
    """Size-constrained weighted label propagation (Fennel penalty)."""
    n = len(nw)
    order = np.argsort(us, kind="stable")
    su, sv, se = us[order], vs[order], ew[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(su, minlength=n), out=indptr[1:])
    deg = np.diff(indptr)
    W = float(nw.sum())
    cap = slack * W / k
    m = max(float(ew.sum()), 1.0)
    gamma = 1.5
    alpha = m * (k ** (gamma - 1)) / (W ** gamma)
    bs = max(64, min(batch, max(n // 8, 1)))

    for _ in range(sweeps):
        visit = rng.permutation(n)
        for i in range(0, n, bs):
            nodes = visit[i: i + bs]
            counts = deg[nodes]
            total = int(counts.sum())
            hist = np.zeros((len(nodes), k), dtype=np.float64)
            if total:
                flat = np.arange(total) - np.repeat(
                    np.cumsum(counts) - counts, counts)
                pos = np.repeat(indptr[nodes], counts) + flat
                owner = np.repeat(np.arange(len(nodes)), counts)
                np.add.at(hist, (owner, part[sv[pos]]), se[pos])
            sizes = np.bincount(part, weights=nw, minlength=k)
            sizes = sizes.astype(np.float64)
            np.subtract.at(sizes, part[nodes], nw[nodes])
            pen = alpha * gamma * np.power(sizes[None, :], gamma - 1.0)
            pen = np.where(sizes[None, :] >= cap, np.inf, pen)
            score = hist - pen + 1e-6 * rng.random(hist.shape)
            part[nodes] = score.argmax(axis=1).astype(np.int32)
    return part


def _fm_refine(us, vs, ew, nw, part, k, passes, slack,
               move_cap: int = 40000, boundary_cap: int = 200000,
               min_gain_frac: float = 1e-4):
    """Boundary Fiduccia–Mattheyses refinement (the KL/FM pass METIS
    runs after projection). Unlike the batched
    label-prop above (a LOCAL optimum by construction: it only takes
    positive-penalized moves), FM hill-climbs: it sequentially moves
    the current best-gain boundary node even at NEGATIVE gain, locks
    it, tracks the running cut, and finally rolls back to the best
    prefix — escaping ragged-boundary optima.
    """
    import heapq

    n = len(nw)
    order = np.argsort(us, kind="stable")
    su, sv, se = us[order], vs[order], ew[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(su, minlength=n), out=indptr[1:])
    W = float(nw.sum())
    cap = slack * W / k

    total_w = max(float(ew.sum()), 1.0)
    for _ in range(passes):
        sizes = np.bincount(part, weights=nw, minlength=k
                            ).astype(np.float64)
        boundary = np.unique(su[part[su] != part[sv]])
        if len(boundary) == 0 or len(boundary) > boundary_cap:
            # Host-side sequential refinement: past the cap the python
            # move loop costs more than the cut it saves (big graphs
            # rely on the coarser levels, where FM did run).
            break
        # Per-node weight-to-part histograms, maintained incrementally.
        hist = {}
        heap = []
        locked = np.zeros(n, dtype=bool)

        def node_hist(v):
            h = np.zeros(k, dtype=np.float64)
            lo, hi = indptr[v], indptr[v + 1]
            np.add.at(h, part[sv[lo:hi]], se[lo:hi])
            return h

        def push(v):
            h = hist.get(v)
            if h is None:
                h = node_hist(v)
                hist[v] = h
            own = int(part[v])
            g = h - h[own]
            g[own] = -np.inf
            p_new = int(np.argmax(g))
            heapq.heappush(heap, (-g[p_new], int(v), p_new))

        for v in boundary:
            push(v)

        moves = []  # (v, p_old, p_new)
        cum = best_cum = 0.0
        best_len = 0
        while heap and len(moves) < move_cap:
            neg_g, v, p_new = heapq.heappop(heap)
            if locked[v]:
                continue
            h = hist[v]
            own = int(part[v])
            # Stale entry: re-derive and re-push if the gain changed.
            g = h - h[own]
            g[own] = -np.inf
            p_best = int(np.argmax(g))
            if p_best != p_new or -neg_g != g[p_best]:
                heapq.heappush(heap, (-g[p_best], v, p_best))
                continue
            if sizes[p_new] + nw[v] > cap:
                locked[v] = True  # balance-blocked this pass
                continue
            # Commit the move.
            locked[v] = True
            sizes[own] -= nw[v]
            sizes[p_new] += nw[v]
            part[v] = p_new
            moves.append((v, own, p_new))
            cum += g[p_new]
            if cum > best_cum:
                best_cum, best_len = cum, len(moves)
            # Update neighbor histograms FIRST, then (re)push each
            # unique neighbor once: pushing inside the update loop
            # lazily creates a fresh histogram at the first duplicate
            # adjacency entry and the second entry then double-applies
            # the delta on top of it (the multigraph/doubled-edge case).
            lo, hi = indptr[v], indptr[v + 1]
            nbrs = sv[lo:hi]
            for u, w in zip(nbrs, se[lo:hi]):
                hu = hist.get(int(u))
                if hu is not None:
                    hu[own] -= w
                    hu[p_new] += w
            for u in np.unique(nbrs):
                if not locked[u]:
                    push(int(u))
        # Roll back past the best prefix.
        for v, p_old, p_new in reversed(moves[best_len:]):
            part[v] = p_old
        if best_len == 0 or best_cum < min_gain_frac * total_w:
            break
    return part


def multilevel_partition_assignment(
    g: Graph, k: int, seed: int = 0, balance_edges: bool = False,
    slack: float = 1.1, sweeps: int = 4,
) -> np.ndarray:
    """Multilevel k-way partitioner: heavy-edge-matching coarsening to
    ~40k nodes, Fennel-refined coarsest assignment, then projection +
    size-constrained weighted label-prop refinement at every level —
    the METIS architecture without METIS. Typically beats the LDG stream on
    structured graphs; same contract as
    :func:`greedy_partition_assignment`.
    """
    n = g.num_nodes()
    src, dst = _coo(g)
    rng = np.random.default_rng(seed)
    us = np.concatenate([src, dst])
    vs = np.concatenate([dst, src])
    ew = np.ones(len(us), dtype=np.float64)
    if balance_edges:
        nw = np.bincount(dst, minlength=n).astype(np.float64) + 1.0
    else:
        nw = np.ones(n, dtype=np.float64)

    levels = []
    cur = (us, vs, ew, nw)
    floor_nodes = max(40 * k, 512)
    max_w = 2.0 * float(nw.sum()) / max(n, 1) * 8
    while len(cur[3]) > floor_nodes and len(levels) < 30:
        cn = len(cur[3])
        cid, nc = _hem_match(cur[0], cur[1], cur[2], cur[3], cn, rng,
                             max_w)
        if nc > 0.95 * cn:  # matching stalled
            break
        levels.append((cur, cid))
        cur = _coarsen(cur[0], cur[1], cur[2], cur[3], cid, nc)
        max_w *= 2.0

    # Coarsest assignment: weighted Fennel STREAM in descending-weight
    # order (neighbor-affinity + balance penalty — a structure-blind
    # round-robin init leaves label-prop stuck in bad optima), then
    # refine.
    cus, cvs, cew, cnw = cur
    nc = len(cnw)
    order_e = np.argsort(cus, kind="stable")
    su, sv, se = cus[order_e], cvs[order_e], cew[order_e]
    indptr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(np.bincount(su, minlength=nc), out=indptr[1:])
    Wc = float(cnw.sum())
    capc = slack * Wc / k
    mc = max(float(cew.sum()), 1.0)
    alphac = mc * (k ** 0.5) / (Wc ** 1.5)
    part = np.full(nc, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.float64)
    for v in np.argsort(-cnw, kind="stable"):  # nc is small: loop is fine
        lo, hi = indptr[v], indptr[v + 1]
        hist = np.zeros(k, dtype=np.float64)
        npart = part[sv[lo:hi]]
        ok = npart >= 0
        if ok.any():
            np.add.at(hist, npart[ok], se[lo:hi][ok])
        pen = alphac * 1.5 * np.sqrt(np.maximum(sizes, 0.0))
        pen = np.where(sizes + cnw[v] > capc, np.inf, pen)
        part[v] = int(np.argmax(hist - pen))
        sizes[part[v]] += cnw[v]
    part = _lp_refine(cus, cvs, cew, cnw, part, k, sweeps + 4, slack, rng)

    for (lus, lvs, lew, lnw), cid in reversed(levels):
        part = part[cid].astype(np.int32)
        part = _lp_refine(lus, lvs, lew, lnw, part, k, sweeps, slack, rng)
        # Exact-gain boundary FM pass on top of the batched LP (METIS's
        # refinement shape).
        part = _fm_refine(lus, lvs, lew, lnw, part, k, passes=2,
                          slack=slack)
    # Final hill-climb on the ORIGINAL graph — also covers the case
    # where coarsening stalled and the level loop never ran.
    part = _fm_refine(us, vs, ew, nw, part, k, passes=4, slack=slack)
    return part
