"""The manifest check passes on BENCHMARK.json and names each fault of a
broken copy."""

import copy

from gnnbench import bench, manifest


def test_benchmark_json_passes():
    assert manifest.problems(bench.load_benchmark(), bench.ROOT) == []


def _broken(edit):
    b = copy.deepcopy(bench.load_benchmark())
    edit(b)
    return manifest.problems(b, bench.ROOT)


def test_bad_names_and_units():
    def edit(b):
        b["workloads"][0]["name"] = "has space"
        b["end_to_end"][0]["unit"] = "tokens per second"
    found = _broken(edit)
    assert any("bad name 'has space'" in p for p in found)
    assert any("bad unit" in p for p in found)


def test_missing_files():
    def edit(b):
        b["workloads"][0]["traffic"] = "nowhere"
        b["configs"][0]["file"] = "gnnbench/configs/nowhere.json"
        b["per_layer"][0]["name"] = "no_reader"
    found = _broken(edit)
    assert any("no traffic file" in p for p in found)
    assert any("no file gnnbench/configs/nowhere.json" in p for p in found)
    assert any("no reader" in p for p in found)


def test_moves_must_be_reported_by_its_cells():
    def edit(b):
        b["end_to_end"][0]["workloads"] = [b["workloads"][1]["name"]]
    found = _broken(edit)
    assert any("does not report epoch_ms" in p for p in found)


def test_every_cell_on_one_chip():
    found = _broken(lambda b: b["workloads"][0].update(chips=4))
    assert any("chips 4" in p for p in found)
