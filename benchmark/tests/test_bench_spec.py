"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import os
import re

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_and_entry_keys():
    assert set(SPEC) == KEYS
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in SPEC["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert 1 <= SPEC["run_seconds"] <= 51 and len(SPEC["command"]) <= 32
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_text_fields():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [x["why"] for x in SPEC["configs"] + SPEC["workloads"]]
    texts += [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p and not p.startswith("/")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = run.load_cell(cell, ROOT)
    assert c.config["name"] == c.entry["config"] and c.config["reduced"] == []
    assert os.path.exists(os.path.join(ROOT, "benchmark", "entries", f"{c.mix['entry']}.py"))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(run.reader(m["name"]))
        if m in c.per_layer:
            assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert set(c.cell["limits"]) and c.cell["engine"] in ("accurate", "fast")


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))


@pytest.mark.parametrize("name", ["equigspr-3dmatch", "equigspr-kitti"])
def test_configurations_are_the_presets(name):
    from se3_equi_graph_registration_tpu_torch.train import config, engine

    from benchmark.entries.common import ENGINE_KEYS, engine_config
    c = json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")))
    preset = config.preset(name.split("-")[1]).engine
    for path in ("accurate", "fast"):
        e = engine_config(c, path)
        assert all(getattr(e, k) == getattr(preset, k) for k in ENGINE_KEYS)
        assert e.loss_weights == preset.loss_weights
    fast = engine.fast_tpu_config()
    assert (c["egnn_window"], c["egnn_tile"]) == (fast.egnn_window, fast.egnn_tile)
