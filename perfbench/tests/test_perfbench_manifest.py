"""The manifest keeps to the contract's characters and keys, its per-layer
metrics agree with their modules, and a cell added as new files alone is
found and runs."""

import ast
import json
import re
import shutil
import types

import pytest

import run as bench_run
from harness import spec

ROOT = bench_run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert all(_line(w) for w in bench["command"])


def test_config_files_hold_what_is_reduced(bench):
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            config = json.load(f)
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert all(k in config for k in c["reduced"])


def test_every_cell_reports_what_its_layers_move(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.per_layer(bench, w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)


def test_metric_modules_agree_with_the_manifest(bench):
    for m in bench["per_layer"]:
        mod = spec.metric_module(ROOT, m["name"])
        assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (m["layer"], m["moves"],
                                                      m["source"])


def test_every_file_of_the_manifest_exists(bench):
    for w in bench["workloads"]:
        assert (ROOT / spec.TRAFFIC_DIR / f"{w['traffic']}.json").exists()
    for c in bench["configs"]:
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_no_jax_and_no_jax_package_anywhere_under_perfbench():
    forbidden = set(bench_run.FORBIDDEN)
    for path in (ROOT / "perfbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & forbidden, f"{path} imports {tops & forbidden}"


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "corpus.py", "check.py", "roofline.py"):
        src = (ROOT / "perfbench" / "harness" / name).read_text()
        for node in ast.walk(ast.parse(src)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not any(m and m.split(".")[0] == "repro_torch"
                           for m in mods), name


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as new
    files and new manifest entries, run through the harness unchanged."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load(ROOT)
    (tmp_path / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(
        dict(json.loads((ROOT / "perfbench/configs/corpus_1m.json")
                        .read_text()), chunks=1500, sessions=30)))
    mix = json.loads((ROOT / "perfbench/traffic/composed_diverse.json")
                     .read_text())
    mix.update(clients=2, warmup=1)
    (tmp_path / "perfbench" / "traffic" / "tiny_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "answered.tiny.py").write_text(
        'LAYER = "harness"\nMOVES = "query_p50_ms"\n'
        'SOURCE = "program_counter"\n\n\n'
        'def read(ctx):\n    return float(ctx.completed)\n')
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.mix", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "query_p50_ms":
            m["workloads"].append("tiny.mix")
    bench["per_layer"].append({"name": "answered.tiny", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "query_p50_ms",
                               "workloads": ["tiny.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    found = spec.load(tmp_path)
    cell = spec.cell(found, "tiny.mix")
    out = bench_run.run_cell(tmp_path, found, cell, 2**31 + 5, 0.3, False,
                             "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"query_p50_ms", "setup_s"}
    layers = spec.per_layer(found, "tiny.mix")
    assert [m["name"] for m in layers] == ["answered.tiny"]
    metric = spec.metric_module(tmp_path, "answered.tiny")
    assert metric.read(types.SimpleNamespace(completed=3)) == 3.0
