"""The port's busy probe (workloads_torch.busy_probe): the JAX probe's
contracts on the CPU (tests/test_workloads.py's calibration and
aggregation cases), its barrier, its bursts' token counts and
refusals, its CLI flags against the JAX probe's, and ``aggregate`` over
seeded random reports held to the JAX package's output, frozen in
tests/test_torch_busy_golden.json (``write_busy_goldens()`` in
tests/test_torch_parity.py rewrites it; a slow test there compares the
two packages live).

torch and numpy only, so it runs in the fast tier; the JAX probe is
read as text, never imported.
"""

from __future__ import annotations

import ast
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from workloads_torch import busy_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUSY_GOLDEN = os.path.join(ROOT, "tests", "test_torch_busy_golden.json")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def busy_reports() -> dict[str, list[dict]]:
    """Seeded report files for ``aggregate``: pods on one and on several
    chips with overlapping and disjoint windows, rows without chips,
    rows mixing both, rows without ``t_end``, gang rows naming two chips,
    token counts, and an empty report."""
    out = {}
    for seed in range(6):
        rng = np.random.default_rng(seed)
        chips = [f"tpu-{i}" for i in range(1 + seed % 3)]
        rows = []
        for _ in range(2 + seed):
            wall = float(rng.uniform(1.0, 8.0))
            row = {"busy_secs": float(wall * rng.uniform(0.2, 1.1)), "wall_secs": wall,
                   "t_end": float(100.0 + rng.uniform(0.0, 12.0))}
            if seed % 2 == 0:
                row["chips"] = sorted(rng.choice(chips, 1 + int(rng.integers(0, 2)),
                                                 replace=False).tolist())
            else:
                row["chips"] = [chips[int(rng.integers(0, len(chips)))]]
            if seed >= 3:
                row["tokens"] = int(rng.integers(0, 5000))
            if seed == 4 and len(rows) == 1:
                del row["t_end"]
            rows.append(row)
        out[f"seed{seed}"] = rows
    rng = np.random.default_rng(10)
    out["unattributed"] = [{"busy_secs": float(rng.uniform(0, 3)), "wall_secs": 3.0,
                            "t_end": float(50 + rng.uniform(0, 2))} for _ in range(3)]
    out["mixed"] = out["unattributed"][:2] + out["seed0"][:2]
    out["disjoint"] = [{"chips": ["a"], "busy_secs": 1.0, "wall_secs": 2.0, "t_end": 10.0},
                       {"chips": ["a"], "busy_secs": 1.5, "wall_secs": 2.0, "t_end": 20.0}]
    out["empty"] = []
    return out


def aggregate_rows(aggregate, rows: list[dict], path: str) -> dict:
    """``aggregate`` over ``rows`` written as a report at ``path``, as a
    JSON round trip (the golden's form)."""
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return json.loads(json.dumps(aggregate(path)))


def test_aggregate_matches_the_frozen_jax_output(tmp_path):
    with open(BUSY_GOLDEN) as f:
        golden = json.load(f)
    reports = busy_reports()
    assert sorted(golden) == sorted(reports)
    for name, rows in reports.items():
        got = aggregate_rows(busy_probe.aggregate, rows, str(tmp_path / f"{name}.jsonl"))
        assert got == golden[name], name


def test_burst_calibration_floors_and_caps(monkeypatch):
    """A jitter-dominated (or degenerate) slope must not size an
    hours-long lease-holding burst: the per-step estimate is floored and
    the step count capped."""
    monkeypatch.setattr("workloads_torch.perfbench.measure_slope_secs",
                        lambda *a, **k: 1e-9)
    assert busy_probe._calibrate_steps(lambda n: None, 1.0) == 100_000
    monkeypatch.setattr("workloads_torch.perfbench.measure_slope_secs",
                        lambda *a, **k: 0.01)
    assert busy_probe._calibrate_steps(lambda n: None, 1.0) == 100


def test_busy_probe_aggregation(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "tpu-0")
    monkeypatch.setenv("TPU_SHARED_LEASE_DIR", str(tmp_path / "leases"))
    report = str(tmp_path / "stats.jsonl")
    stats = busy_probe.run_probe(0.5, report, matrix_dim=64, device="cpu")
    assert stats["bursts"] >= 1
    assert 0 < stats["busy_fraction"] <= 1
    assert stats["chips"] == ["tpu-0"] and "tokens" not in stats
    agg = busy_probe.aggregate(report)
    assert agg["pods"] == 1
    assert agg["aggregate_busy_fraction"] > 0


def test_start_barrier_releases_at_its_count(tmp_path):
    """Each pod drops one ready-file; the barrier opens when ``count``
    are there, not before."""
    barrier = str(tmp_path / "barrier")
    os.makedirs(barrier)
    done = threading.Event()

    def wait():
        busy_probe._start_barrier(barrier, 2, timeout_secs=30.0)
        done.set()

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.3)
    assert not done.is_set()
    open(os.path.join(barrier, "ready-sibling"), "w").close()
    t.join(timeout=10.0)
    assert not t.is_alive() and done.is_set()
    assert sorted(os.listdir(barrier)) == [f"ready-{os.getpid()}", "ready-sibling"]


def test_start_barrier_releases_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    busy_probe._start_barrier(str(tmp_path / "barrier"), 3, timeout_secs=0.3)
    assert 0.3 <= time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("builder, per_step", [("make_train_burst_fn", 8 * 127),
                                               ("make_serve_burst_fn", 32)])
def test_tokens_per_burst_follows_the_jax_formula(monkeypatch, builder, per_step):
    """Train bursts count steps x batch 8 x 127 predicted positions,
    serve bursts requests x 32 new tokens, as the JAX probe's."""
    monkeypatch.setattr("workloads_torch.perfbench.measure_slope_secs",
                        lambda *a, **k: 0.01)
    entered = []

    def section():
        entered.append(1)
        return torch.no_grad()

    _, tokens = getattr(busy_probe, builder)(1.0, timed_section=section, device="cpu")
    assert tokens == 100 * per_step
    assert entered == [1]


def test_unknown_workload_is_refused_with_the_jax_text(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_SHARED_LEASE_DIR", str(tmp_path / "leases"))
    with pytest.raises(ValueError) as err:
        busy_probe.run_probe(0.1, None, workload="decode", device="cpu")
    assert str(err.value) == "workload must be 'matmul', 'train' or 'serve', got 'decode'"


def _flags(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("--")}


@pytest.mark.parametrize("module", ["busy_probe", "oversubscribe"])
def test_cli_accepts_every_jax_flag(module):
    jax_flags = _flags(os.path.join(ROOT, "workloads", f"{module}.py"))
    port_flags = _flags(os.path.join(ROOT, "workloads_torch", f"{module}.py"))
    assert jax_flags and jax_flags <= port_flags, sorted(jax_flags - port_flags)
    assert port_flags - jax_flags == {"--device"}


def test_cli_probes_on_the_cpu_and_aggregates(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "tpu-0")
    monkeypatch.setenv("TPU_SHARED_LEASE_DIR", str(tmp_path / "leases"))
    report = str(tmp_path / "stats.jsonl")
    assert busy_probe.main(["--device", "cpu", "--duration", "0.3", "--matrix-dim", "32",
                            "--report", report]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bursts"] >= 1 and row["chips"] == ["tpu-0"]
    assert busy_probe.main(["--aggregate", "--report", report]) == 0
    agg = json.loads(capsys.readouterr().out.strip())
    assert agg["pods"] == 1 and agg["chips"] == 1


def test_cli_reports_the_pods_k1_launches_to_stderr(tmp_path, monkeypatch, capsys):
    """A pod counts K1 from its start (the counter reset) and prints the
    count to stderr, where the harness reads it."""
    from workloads_torch.ops.paged_attention import paged_attention

    def probe(*args):
        paged_attention.launches += 5
        return {"bursts": 1}

    monkeypatch.setattr(busy_probe, "run_probe", probe)
    monkeypatch.setattr(paged_attention, "launches", 99)
    assert busy_probe.main(["--device", "cpu", "--duration", "0.1"]) == 0
    err = capsys.readouterr().err
    assert "busy_probe: K1 launches 5\n" in err
    assert "peak device memory" not in err  # off the card


def test_busy_golden_fixture_stays_small():
    assert os.path.getsize(BUSY_GOLDEN) < 64 * 1024
