"""The readers of the program's spans and counters, worked by hand from
made-up records: each reader's arithmetic, the choice of the device
stretch's record (the first traced ``train`` call) and None where a cell
or a program has nothing to read."""

from types import SimpleNamespace

import pytest

from gnnbench import bench
from dgl1_tpu_torch.utils import profiler

NAMES = ("attn_glue_ms", "ell_ms", "ell_slot_use", "dead_rel_ms",
         "host_issue_ms", "layout_unread_s")


def _record(steps, rows, counters):
    """A record of ``rows``: (name, parent, device s, host start, attrs),
    the parent an index into ``rows``."""
    spans = [{"name": n, "parent": p, "device_s": d, "host_start": h,
              "host_end": h + 0.001, "attrs": a or {}}
             for n, p, d, h, a in rows]
    return SimpleNamespace(steps=steps, spans=spans, counters=counters)


def _gat_step(t0):
    """One step of a GAT-like record starting at host time ``t0``."""
    return [
        ("train.step", None, 0.2, t0, None),                   # 0
        ("train.forward", 0, 0.05, t0 + 0.01, None),           # 1
        ("gat.attention", 1, 0.04, t0 + 0.02, None),           # 2
        ("attn.fwd.hub", 2, 0.010, t0 + 0.02, None),           # 3
        ("kernel.attn_fwd", 3, 0.004, t0 + 0.02, None),        # 4
        ("attn.fwd.tail", 2, 0.020, t0 + 0.03, None),          # 5
        ("ell.stack", 5, 0.015, t0 + 0.03, None),              # 6
        ("train.backward", 0, 0.06, t0 + 0.05, None),          # 7
        ("attn.bwd.hub", 7, 0.030, t0 + 0.05, None),           # 8
        ("kernel.attn_bwd_src", 8, 0.012, t0 + 0.05, None),    # 9
        ("attn.bwd.ger", 7, 0.002, t0 + 0.06, None),           # 10
        ("kernel.ger_reduce", 10, 0.002, t0 + 0.06, None),     # 11
        ("attn.bwd.tail", 7, 0.008, t0 + 0.07, None),          # 12
        ("ell.stack", 12, 0.005, t0 + 0.07, None),             # 13
        ("ell.permute", 12, 0.001, t0 + 0.08, None),           # 14
        ("kernel.chunk_sum", 1, 0.003, t0 + 0.09, None),       # 15
    ]


def _gat_record(issue=(0.15, 0.17)):
    rows = []
    for k, gap in enumerate(issue):
        base = len(rows)
        step = [(n, None if p is None else p + base, d, h, a)
                for n, p, d, h, a in _gat_step(float(k))]
        step.append(("train.readback", base, 0.001, k + gap, None))
        rows += step
    return _record(len(issue), rows, {"ell.slots": 40, "ell.real": 30,
                                      "layout.read.hub": 6})


def _mag_record():
    rows = [
        ("train.step", None, 0.3, 0.0, None),                             # 0
        ("train.forward", 0, 0.1, 0.0, None),                             # 1
        ("model.layer", 1, 0.05, 0.0, {"index": 0}),                      # 2
        ("hetero.rel", 2, 0.004, 0.0, {"src": "p", "etype": "w",
                                       "dst": "a"}),                      # 3
        ("model.layer", 1, 0.05, 0.0, {"index": 1}),                      # 4
        ("hetero.rel", 4, 0.010, 0.0, {"src": "a", "etype": "w",
                                       "dst": "paper"}),                  # 5
        ("hetero.rel", 4, 0.003, 0.0, {"src": "p", "etype": "x",
                                       "dst": "a"}),                      # 6
        ("dispatch.ell", 6, 0.002, 0.0, None),                            # 7
        ("hetero.rel", 4, 0.002, 0.0, {"src": "p", "etype": "t",
                                       "dst": "f"}),                      # 8
        ("train.readback", 0, 0.001, 0.2, None),                          # 9
    ]
    return _record(1, rows, {"ell.slots": 10, "ell.real": 9,
                             "layout.read.ell": 14})


def _ctx(steps, target=None, build_s=None):
    return SimpleNamespace(stretch=SimpleNamespace(steps=steps),
                           cfg={"target": target} if target else {},
                           graph=SimpleNamespace(build_s=build_s or {}))


@pytest.fixture
def program(monkeypatch):
    """Makes ``profiler.records`` return the given records."""
    def use(*recs):
        monkeypatch.setattr(profiler, "records", lambda: list(recs))
    return use


def _read(name, ctx):
    return bench.load_reader(name).read(ctx)


def test_gat_record_by_hand(program):
    # The host stretch's record comes second and must not be read.
    program(_gat_record(), _gat_record(issue=(0.5, 0.5)))
    ctx = _ctx(2, build_s={"adj": 5.0, "ell": 1.0, "tile": 2.0, "hub": 3.0})
    # attn.* a step: 10 + 20 + 30 + 2 + 8 ms, less K6 4, K7 12, K8 2; the
    # chunk_sum kernel outside the attention stays out.
    assert _read("attn_glue_ms", ctx) == pytest.approx(70 - 18)
    assert _read("ell_ms", ctx) == pytest.approx(15 + 5 + 1)
    assert _read("ell_slot_use", ctx) == pytest.approx(75.0)
    assert _read("host_issue_ms", ctx) == pytest.approx(160.0)
    # Read: hub; unread: ell and tile (adj never counts).
    assert _read("layout_unread_s", ctx) == pytest.approx(3.0)
    assert _read("dead_rel_ms", ctx) is None  # no target type


def test_mag_record_by_hand(program):
    program(_mag_record())
    ctx = _ctx(1, target="paper",
               build_s={"adj": 9.0, "ell": 4.0, "tile": 6.0, "hub": 0.5})
    # The last layer's relations into a and f, 3 + 2 ms; layer 0's relation
    # into a is read by layer 1.
    assert _read("dead_rel_ms", ctx) == pytest.approx(5.0)
    assert _read("attn_glue_ms", ctx) is None  # no hub attention
    assert _read("ell_ms", ctx) is None  # no ELL span in this record
    assert _read("ell_slot_use", ctx) == pytest.approx(90.0)
    assert _read("host_issue_ms", ctx) == pytest.approx(200.0)
    assert _read("layout_unread_s", ctx) == pytest.approx(6.5)


@pytest.mark.parametrize("name", NAMES)
def test_none_when_steps_differ(program, name):
    program(_gat_record())
    assert _read(name, _ctx(3, target="paper", build_s={"ell": 1.0})) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_program_records(monkeypatch, name):
    # A program with no ``records`` (the parent of this change): nothing
    # to read, and no error.
    monkeypatch.delattr(profiler, "records")
    assert _read(name, _ctx(2, target="paper", build_s={"ell": 1.0})) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_traced_calls(program, name):
    program()
    assert _read(name, _ctx(2, target="paper", build_s={"ell": 1.0})) is None


def test_unread_layouts_need_build_times(program):
    program(_gat_record())
    assert _read("layout_unread_s", _ctx(2)) is None
