"""Cells, configurations, traffic mixes and per-layer metrics are found by
name: adding one is adding files; and BENCHMARK.json keeps to its form."""

import json
import os
import re
import shutil

from benchmark import harness as HN

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_dropped_in_cell_is_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copy(os.path.join(HN.HERE, "configs", "rdt1b.json"), bench / "configs" / "newcfg.json")
    (bench / "traffic" / "newmix.json").write_text(json.dumps({"kind": "serve", "robots": 2}))
    (bench / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    (bench / "metrics" / "silent.metric.py").write_text("def read(ctx):\n    return None\n")
    (bench / "limits" / "newcfg.newmix.json").write_text(json.dumps({"limits": {"g": 1}}))
    spec = HN.spec()
    spec["configs"].append({"name": "newcfg", "source": "https://example.org/x",
                            "file": "benchmark/configs/newcfg.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "newcfg.newmix", "config": "newcfg", "traffic": "newmix",
                              "chips": 1, "why": "x"})
    spec["per_layer"] += [
        {"name": "new.metric", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "pool: runtime/serving_pool.py", "moves": "chunks_per_s",
         "workloads": ["newcfg.newmix"]},
        {"name": "silent.metric", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "pool: runtime/serving_pool.py", "moves": "chunks_per_s",
         "workloads": ["newcfg.newmix", "rdt1b.serve8"]}]
    spec["end_to_end"][0]["workloads"].append("newcfg.newmix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(HN, "HERE", str(bench))
    monkeypatch.setattr(HN, "ROOT", str(tmp_path))
    cell = HN.cell("newcfg.newmix")
    assert cell["traffic"] == {"kind": "serve", "robots": 2}
    assert cell["config"]["name"] == "rdt1b"
    assert cell["limits"] == {"limits": {"g": 1}}
    assert [m["name"] for m in cell["end_to_end"]] == ["chunks_per_s", "setup_s"]
    names = [m["name"] for m in cell["per_layer"]]
    assert "new.metric" in names and "silent.metric" in names
    assert HN.driver(cell["traffic"]["kind"]).run
    got = HN.read_per_layer([m for m in cell["per_layer"] if m["name"].endswith(".metric")],
                            {"x": 21})
    assert got == {"new.metric": {"value": 42.0, "unit": "ms"}}


def test_benchmark_json_keeps_its_form():
    spec = HN.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(HN.ROOT, c["file"]))
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    # the harness reads a per-layer metric in the cells its entry lists
    assert all(m["workloads"] for m in spec["per_layer"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = HN.cell(w["name"])
        moved = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in moved and len(moved) >= 2 and cell["per_layer"]
        assert cell["limits"]["limits"]
        for m in cell["per_layer"]:
            assert m["moves"] in moved
            assert os.path.exists(os.path.join(HN.HERE, "metrics", m["name"] + ".py"))
    assert len(json.dumps(spec)) < 64 * 1024
