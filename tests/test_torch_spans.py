"""The program's spans and counters (``dgl1_tpu_torch/utils/profiler.py``)
on the CPU: off they record nothing and call no ``record_function``; on,
the profiler's trace nests them, each ``train`` call leaves one record
with its steps and parents, the ELL stack's slot counters and the layout
build times match hand counts, and tracing changes no loss. Also the
union of device intervals that ``device_ms`` takes for busy time."""

import contextlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.models import GAT, HeteroRGCN
from dgl1_tpu_torch.ops import get_engine, gspmm, set_engine
from dgl1_tpu_torch.train import train
from dgl1_tpu_torch.utils import profiler as P

# Four nodes, eight edges: in-degrees 5, 1, 2, 0 and out-degrees 1, 2, 2,
# 3. Degrees round up the ELL ladder (1, 2, 3, 4, 6, ...) and buckets
# under E // 4 = 2 slots join the next rung: by destination rows of 2
# slots (nodes 1, 2) and one of 6 (node 0), 10 slots; by source rows of
# 2 (nodes 0, 1, 2) and one of 3 (node 3), 9 slots.
HAND_SRC = np.array([1, 2, 3, 3, 2, 0, 3, 1])
HAND_DST = np.array([0, 0, 0, 0, 0, 1, 2, 2])


@contextlib.contextmanager
def engine(name):
    old = get_engine()
    set_engine(name)
    try:
        yield
    finally:
        set_engine(old)


def hub_graph(n=300, e=3000, seed=0):
    """Half Zipf, half uniform destinations and a self-loop a node (the
    parity tests' mixed graph), so GAT takes the fused hub attention with
    a tail and a diagonal."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.concatenate([rng.zipf(1.7, e // 2) % n,
                          rng.integers(0, n, e - e // 2)])
    loops = np.arange(n)
    g = tdgl.graph((np.concatenate([src, loops]),
                    np.concatenate([dst, loops])), num_nodes=n, hub=300,
                   hub_dense_floor=1000, device="cpu")
    assert tdgl.ops.can_fuse_attention(g) and g.hub_dst_meta.has_diag
    return g


def gat_case(steps=2, seed=0):
    g = hub_graph()
    n = g.num_nodes()
    gen = torch.Generator().manual_seed(seed)
    feat = torch.randn(n, 12, generator=gen)
    labels = torch.randint(0, 5, (n,), generator=gen)
    model = GAT(12, 6, 5, heads=2, feat_drop=0.0, attn_drop=0.0,
                residual=True, device="cpu",
                generator=torch.Generator().manual_seed(seed + 1))
    return lambda: train(g, feat, labels, model, steps=steps, lr=1e-2)


class _FullGraphRGCN(torch.nn.Module):
    """HeteroRGCN over the whole heterograph, as a full-graph trainer
    calls a model: learnt rows for type ``a``, features for ``p``."""

    def __init__(self, hg, seed):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.emb = torch.nn.Parameter(
            torch.randn(hg.num_nodes("a"), 6, generator=gen))
        self.rgcn = HeteroRGCN(hg.canonical_etypes, {"a": 6, "p": 8}, 5, 4,
                               out_ntype="p", device="cpu", generator=gen)

    def forward(self, hg, feat, generator=None):
        return self.rgcn([hg, hg], {"a": self.emb, "p": feat})


def rgcn_case(steps=2, seed=0):
    rng = np.random.default_rng(seed)

    def rel(ns, nd, e):
        return rng.integers(0, ns, e), rng.integers(0, nd, e)

    hg = tdgl.heterograph({("a", "writes", "p"): rel(30, 20, 60),
                           ("p", "cites", "p"): rel(20, 20, 50),
                           ("p", "written", "a"): rel(20, 30, 60)},
                          device="cpu")
    gen = torch.Generator().manual_seed(seed)
    feat = torch.randn(20, 8, generator=gen)
    labels = torch.randint(0, 4, (20,), generator=gen)
    model = _FullGraphRGCN(hg, seed + 1)
    return lambda: train(hg, feat, labels, model, steps=steps, lr=1e-2)


CASES = {"gat": gat_case, "rgcn": rgcn_case}


def test_span_off_records_nothing(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not P.tracing()
    a, b = P.span("train.step"), P.span("ell.stack", k=3)
    assert a is b
    with a:
        P.count("ell.slots", 7)
    before = len(P.records())
    gat_case(steps=1)()
    assert len(P.records()) == before


def _trace_events(tmp_path, run):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"][6:], float(e["ts"]), float(e["ts"]) + e["dur"])
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("dgl1::")]


@pytest.mark.parametrize("case,inner", [
    ("gat", {"train.forward": ["gat.project", "gat.attention",
                               "gat.residual", "attn.fwd.hub",
                               "attn.fwd.tail_max", "attn.fwd.tail",
                               "attn.fwd.merge", "attn.fwd.diag",
                               "attn.fwd.normalize"],
             "train.backward": ["attn.bwd.hub", "attn.bwd.ger",
                                "attn.bwd.tail", "attn.bwd.merge",
                                "attn.bwd.diag", "ell.permute"],
             "train.step": ["ell.stack"]}),
    ("rgcn", {"train.forward": ["model.layer[0]", "model.layer[1]",
                                "hetero.rel[a,writes,p]",
                                "hetero.rel[p,written,a]"]}),
])
def test_chrome_trace_nests_trainer_spans(tmp_path, case, inner):
    spans = _trace_events(tmp_path, CASES[case](steps=2))
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == 2

    def within(child, parents):
        return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)

    for name in ("train.zero_grad", "train.forward", "train.loss",
                 "train.backward", "train.optimizer", "train.readback"):
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == 2 and all(within(s, steps) for s in mine)
    for outer, names in inner.items():
        parents = [s for s in spans if s[0] == outer]
        for name in names:
            mine = [s for s in spans if s[0] == name]
            assert mine and all(within(s, parents) for s in mine), name


def _parent_names(rec, name):
    return {rec.spans[s["parent"]]["name"] if s["parent"] is not None
            else None for s in rec.spans if s["name"] == name}


@pytest.mark.parametrize("case,parents", [
    ("gat", {"train.forward": {"train.step"},
             "gat.attention": {"train.forward"},
             "attn.fwd.hub": {"gat.attention"},
             "attn.bwd.tail": {"train.backward"},
             "ell.stack": {"attn.fwd.tail_max", "attn.fwd.tail",
                           "attn.bwd.tail"}}),
    ("rgcn", {"model.layer": {"train.forward"},
              "hetero.rel": {"model.layer"}}),
])
def test_records_one_per_train_call(case, parents):
    with P.collect() as made:
        CASES[case](steps=3)()
        CASES[case](steps=2)()
    assert [r.steps for r in made] == [3, 2]
    assert made == P.records()[-2:]
    rec = made[0]
    assert rec.table["train.step"]["calls"] == 3
    assert rec.table["train.step"]["device_s"] is None  # no card
    assert rec.table["train.step"]["host_s"] > 0
    for name, want in parents.items():
        assert _parent_names(rec, name) == want, name
    if case == "rgcn":
        rels = [s for s in rec.spans if s["name"] == "hetero.rel"]
        assert {(s["attrs"]["src"], s["attrs"]["etype"], s["attrs"]["dst"])
                for s in rels} == {("a", "writes", "p"), ("p", "cites", "p"),
                                   ("p", "written", "a")}
        layers = {rec.spans[s["parent"]]["attrs"]["index"] for s in rels}
        assert layers == {0, 1}


def test_backward_thread_span_takes_the_backward_span():
    seen = []

    def worker():
        with P.span("ell.stack"):
            seen.append(True)

    with P.collect() as made:
        with P.train_record("cpu"):
            with P.span(P.STEP):
                with P.span(P.BACKWARD):
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
                assert not t.is_alive() and seen
                # Outside the backward span a thread's span has no parent.
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
    rec = made[0]
    stacks = [s for s in rec.spans if s["name"] == "ell.stack"]
    assert [rec.spans[s["parent"]]["name"] if s["parent"] is not None
            else None for s in stacks] == [P.BACKWARD, None]


def test_span_decorator_and_dropped_span():
    @P.span("model.layer", index=7)
    def layer(x):
        with P.span("dispatch.hub") as sp:
            sp.drop()
            with P.span("ell.stack"):
                return x + 1

    assert layer(1) == 2  # off: runs the function
    with P.collect() as made:
        with P.train_record("cpu"):
            layer(1)
    spans = made[0].spans
    assert [s["name"] for s in spans] == ["model.layer", "ell.stack"]
    assert spans[0]["attrs"] == {"index": 7} and spans[1]["parent"] == 0


@pytest.mark.parametrize("kind,slots,real,reads", [
    # Forward over ell_dst (10 slots), backward over ell_src (9 slots).
    ("graph", 10 + 9, 8 + 8, {"layout.read.ell": 1}),
    # A uniform block: one rung of 6 slots for its 4 rows; no ell_src, so
    # the backward takes the reverse tiles.
    ("uniform", 6 * 4, 8, {"layout.read.ell": 1, "layout.read.tile": 1}),
])
def test_ell_slot_counters_by_hand(kind, slots, real, reads):
    if kind == "graph":
        g = tdgl.graph((HAND_SRC, HAND_DST), num_nodes=4, device="cpu")
    else:
        g = tdgl.block((HAND_SRC, HAND_DST), num_src_nodes=4,
                       num_dst_nodes=4, uniform_ell_k=5, device="cpu")
    u = torch.randn(4, 3, requires_grad=True)
    with engine("ell"), P.collect() as made:
        with P.train_record("cpu"):
            gspmm(g, "copy_lhs", "sum", u, None).sum().backward()
    counters = made[0].counters
    assert counters["ell.slots"] == slots
    assert counters["ell.real"] == real
    for k, v in reads.items():
        assert counters[k] == v


@pytest.mark.parametrize("formats,built", [
    (None, {"adj", "ell", "tile", "hub"}),
    (("csc",), {"adj"}),
    (("csr", "ell"), {"adj", "ell"}),
    (("csr", "tile"), {"adj", "tile"}),
    (("coo", "csr", "csc", "bdense"), {"adj", "bdense"}),
])
def test_build_s_names_the_built_formats(formats, built):
    g = tdgl.graph((HAND_SRC, HAND_DST), num_nodes=4, formats=formats,
                   device="cpu")
    assert set(g.build_s) == built
    assert all(v >= 0 for v in g.build_s.values())
    moved = g.to("cpu")
    assert set(moved.build_s) == built
    assert all(moved.build_s[k] >= g.build_s[k] for k in built)


def test_heterograph_build_s_sums_its_relations():
    hg = tdgl.heterograph({("a", "r", "b"): (HAND_SRC, HAND_DST),
                           ("b", "s", "a"): (HAND_DST, HAND_SRC)},
                          device="cpu")
    total = hg.build_s
    for fmt in ("adj", "ell", "tile"):
        assert total[fmt] == pytest.approx(
            sum(g.build_s[fmt] for g in hg.rel_graphs.values()))


@pytest.mark.parametrize("case", ["gat", "rgcn"])
def test_losses_bitwise_equal_with_tracing(case):
    off = CASES[case](steps=3)()["losses"]
    with P.collect() as made:
        on = CASES[case](steps=3)()["losses"]
    assert made and made[0].steps == 3
    assert on == off


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0.0, 10.0), (5.0, 15.0), (20.0, 30.0)], 25.0),  # overlapping
    ([(0.0, 100.0), (10.0, 20.0), (30.0, 40.0)], 100.0),  # nested
    ([(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)], 3.0),  # unsorted, touching
])
def test_union_length(intervals, length):
    assert P.union_length(intervals) == length


def test_device_ms_counts_the_union_of_kernels():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, lo, hi, dev=cuda, note=False):
        return SimpleNamespace(name=name, device_type=dev,
                               is_user_annotation=note,
                               time_range=SimpleNamespace(start=lo, end=hi))

    events = [ev("k1", 0, 1000), ev("k2", 500, 1500),  # two streams
              ev("k3", 3000, 3500),
              ev("dgl1::train.step", 0, 5000, note=True),  # annotation
              ev("aten::mm", 0, 5000, dev=cpu),
              ev("aten::mm", 2000, 2500)]  # a host op's device range
    prof = SimpleNamespace(events=lambda: events)
    busy, top = P.device_ms(prof, top=2)
    assert busy == pytest.approx(2.0)
    assert top == [("k1", 1.0, 1), ("k2", 1.0, 1)]
