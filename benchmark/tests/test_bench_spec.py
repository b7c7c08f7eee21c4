"""BENCHMARK.json against the format's rules that a file can show, and
a cell, a configuration, a mix and a metric added by new files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec

from .tiny import ROOT_FILES, TINY_CONFIG, run_tiny, tiny_cell

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$")


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = len(BENCH["workloads"])
    assert 2 + 14 * cells <= 2 + 14 * 24  # the full budget is checked at 24 cells
    assert 338 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
        # The port's block departs from the source's; a departure is no cut
        # of scale, and the key it concerns is not held at the top level.
        for d in cfg["departures"]:
            assert d["published"] != d["run"] and d["what"]
            assert d["key"] is None or (d["key"] not in cfg and d["key"] not in c["reduced"])


def test_workloads():
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))


def test_metrics_match_their_readers():
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            meta = spec.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py").META
            for key in ("unit", "better", "source"):
                assert meta[key] == m[key], (m["name"], key)
            if kind == "per_layer":
                assert meta["layer"] == m["layer"] and meta["moves"] == m["moves"]
                assert m["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
            else:
                assert 0.01 <= m["bound"] <= 0.25
                assert m["source"] in ("host_clock", "device_trace")
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    assert [m["name"] for m in BENCH["end_to_end"] if m["name"] == "setup_s"] == ["setup_s"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(w):
    e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"], False)}
    per = spec.metrics_for(BENCH, w["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e
    cell = spec.Cell(w["name"])
    assert cell.kind.RUNNER in ("serve", "train")


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A configuration, a mix of an existing kind, a cell and a per-layer
    metric, each a new file, and their entries in BENCHMARK.json: the
    harness finds them all and runs the cell; no existing file changes."""
    for name in ROOT_FILES:
        src = ROOT / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, tmp_path / name)
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    d = tmp_path / "benchmark"
    cfg = {**json.loads((d / "configs" / "pythia-1.4b.json").read_text()), **TINY_CONFIG,
           "name": "toy-gqa", "num_key_value_heads": 2}
    (d / "configs" / "toy-gqa.json").write_text(json.dumps(cfg))
    (d / "traffic" / "chat.json").write_text(json.dumps({
        "kind": "closed_loop", "clients": 3, "pool": 8192, "greedy": True,
        "prompt_len": {"law": "fixed", "value": 20}, "new_tokens": {"law": "fixed", "value": 9}}))
    (d / "cells" / "toy-gqa.chat.json").write_text(json.dumps({
        "engine": {"slots": 3, "page_size": 8, "chunk": 4, "prompt_bucket": 16,
                   "pipelined": False},
        "check": {"sample": 2, "limits": {"max_gap": 1e-3}}}))
    (d / "metrics" / "engine.prefill_sweeps.py").write_text(
        'META = {"unit": "sweeps", "better": "lower", "source": "program_counter",\n'
        '        "layer": "Engine (serve.py)", "moves": "output_tokens_per_s"}\n\n\n'
        'def read(run):\n    return run["counters"]["prefill_sweeps"]\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-gqa", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy-gqa.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy-gqa.chat", "config": "toy-gqa", "traffic": "chat",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("toy-gqa.chat")
    bench["per_layer"].append({"name": "engine.prefill_sweeps", "unit": "sweeps",
                               "better": "lower", "source": "program_counter",
                               "layer": "Engine (serve.py)", "moves": "output_tokens_per_s",
                               "workloads": ["toy-gqa.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("toy-gqa.chat", root=tmp_path)
    for trace in (0, 1):
        rc, res, err = run_tiny(cell, trace=trace)
        assert rc == 0 and res["correct"], err
        want = {"output_tokens_per_s", "setup_s"} if not trace else {"engine.prefill_sweeps"}
        assert set(res["metrics"]) == want
    assert all(p.read_bytes() == b for p, b in before.items())
    # The old cells still resolve beside the new one.
    assert spec.Cell("pythia-6.9b.generate", root=tmp_path).config["hidden_size"] == 4096
    assert tiny_cell("pythia-6.9b.generate").config["hidden_size"] == 64
