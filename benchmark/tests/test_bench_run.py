"""Tiny runs of every traffic kind on the CPU, through ``run.main``: the
result line's keys, the exit codes, and ``correct`` coming out false when
the timed path is broken underneath."""

import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import run as bench_run

from .tiny import ROOT_FILES, run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["pythia-6.9b.generate", "pythia-1.4b.train"]
# Each traffic kind: the serving cell under its closed loop and under the open loop.
KINDS = [("pythia-6.9b.generate", False), ("pythia-1.4b.train", False),
         ("pythia-6.9b.generate", True)]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name,open_loop", KINDS)
def test_a_tiny_run_prints_the_result_keys(name, open_loop, trace):
    cell = tiny_cell(name, open_loop)
    rc, res, err = run_tiny(cell, trace=trace)
    assert rc == 0, err
    keys = KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == keys
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in cell.metrics(bool(trace))}
    # The CPU has no device trace: those readers find nothing and stay out.
    device_only = {m["name"] for m in cell.bench["per_layer"] if m["source"] == "device_trace"}
    assert want - device_only <= set(res["metrics"]) <= want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    # The compared numbers close standard error, beside their limits.
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split(":")[0] for line in tail] == [f"check {k}" for k in res["checks"]]
    assert json.dumps(res)  # no NaN or infinity


MIX = {"clients": 2, "pool": 256, "arrivals": "poisson",
       "prompt_len": {"law": "log_uniform", "lo": 4, "hi": 40},
       "new_tokens": {"law": "log_uniform", "lo": 4, "hi": 16}}


def _feeds(kind, seeds, seconds=30.0):
    from benchmark import spec

    module = spec.load_module(spec.HERE / "traffic" / f"{kind}.py")
    feeds = [module.Feed({**MIX, "kind": kind}, {"rate_per_s": 3.0}, s, 256, seconds)
             for s in seeds]
    for f in feeds:
        f.start(0.0)
    return feeds


@pytest.mark.parametrize("kind", ["closed_loop", "open_loop"])
def test_seeds_give_the_same_work_in_another_order(kind):
    a, b = _feeds(kind, (1, 2**31 + 77))
    work = [sorted((len(x.prompt), x.max_new) for x in f.asks) for f in (a, b)]
    assert work[0] == work[1]
    assert [len(x.prompt) for x in a.asks] != [len(x.prompt) for x in b.asks]
    assert [x.prompt for x in a.asks[:8]] != [x.prompt for x in b.asks[:8]]
    assert all(4 <= len(x.prompt) <= 40 and 4 <= x.max_new <= 16 for x in a.asks)
    if kind == "open_loop":  # the window's gaps, the stretch after its last arrival too
        gaps = [np.diff([0.0, *[o for o in f.offsets if o < 30.0], 30.0]) for f in (a, b)]
        assert len(gaps[0]) == len(gaps[1]) and not np.allclose(gaps[0], gaps[1])
        assert np.allclose(np.sort(gaps[0]), np.sort(gaps[1]))


def test_arrivals_are_a_poisson_process():
    """Independent exponential gaps: counts over equal stretches vary as
    much as their mean (a stratified or evenly spaced schedule varies far
    less), and the gaps' spread equals their mean."""
    from benchmark import draws

    rate, seconds = 2.0, 20000.0
    arrivals = np.cumsum(draws.poisson_gaps(draws.rng(5, "t"), rate, seconds))[:-1]
    assert abs(len(arrivals) - rate * seconds) < 4 * (rate * seconds) ** 0.5
    counts = np.histogram(arrivals, bins=int(seconds / 10), range=(0, seconds))[0]
    assert 0.9 < counts.var() / counts.mean() < 1.1
    gaps = np.diff(arrivals)
    assert 0.95 < gaps.std() / gaps.mean() < 1.05
    sizes = np.array(draws.sizes(draws.rng(6, "t"), {"law": "log_uniform", "lo": 16,
                                                     "hi": 128}, 20000))
    assert sizes.min() == 16 and sizes.max() == 128
    # log-uniform: each doubling of the size holds a third of the draws
    for lo, hi in ((16, 32), (32, 64), (64, 128)):
        assert abs(((sizes >= lo) & (sizes < hi)).mean() - 1 / 3) < 0.02


def test_the_slice_after_the_window_changes_nothing_it_saw(tmp_path):
    """The traced slice steps the window's requests on; what the window's
    metrics read stays as it was at the close, and the slice's decode
    positions come from the tokens its chunks emitted."""
    from benchmark.serving import ServeRun

    cell = tiny_cell("pythia-6.9b.generate")
    r = ServeRun(cell, 2**31 + 11, 2.0, True, "cpu", str(tmp_path))
    r.setup()
    r.window()
    run, sl = r.run, r.run["slice"]
    assert sum(a.seen for a in r.asks) > sum(a.seen for a in run["asks"])
    eng = cell.settings["engine"]
    assert 0 < len(sl["decode_positions"]) <= eng["chunk"] * sl["chunks"] * eng["slots"]
    ends = max(len(a.prompt) + len(a.req.tokens) for a in r.asks)
    assert all(0 < p < ends for p in sl["decode_positions"])


def _break_emitted_token(monkeypatch):
    from workloads_torch.serve import ServeEngine

    emit = ServeEngine._emit

    def altered(self, req, toks_row):
        emit(self, req, toks_row)
        if len(req.tokens) > 3:
            req.tokens[3] = (req.tokens[3] + 1) % self.config.vocab_size

    monkeypatch.setattr(ServeEngine, "_emit", altered)


@pytest.mark.parametrize("open_loop", [False, True])
def test_an_altered_token_is_not_correct(open_loop, monkeypatch):
    _break_emitted_token(monkeypatch)
    rc, res, _ = run_tiny(tiny_cell("pythia-6.9b.generate", open_loop))
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["max_gap"]["value"] > res["checks"]["max_gap"]["limit"]


def _unchanged_state(monkeypatch):
    import workloads_torch.train as train

    monkeypatch.setattr(train, "adamw", lambda params, grads, state, opt=None: state)


def _half_batch(monkeypatch):
    import workloads_torch.train as train

    make = train.make_sharded_train_step

    def halved(loss_fn, mesh, optimizer, batch_specs=None, frozen=None):
        step = make(loss_fn, mesh, optimizer, batch_specs, frozen)
        return lambda params, state, tokens: step(params, state, tokens[: tokens.shape[0] // 2])

    monkeypatch.setattr(train, "make_sharded_train_step", halved)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, res, _ = run_tiny(tiny_cell("pythia-1.4b.train"))
    assert rc == 0 and res["correct"] is False


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_a_loaded_jax_means_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = run_tiny(tiny_cell("pythia-1.4b.train"))
    assert rc == 3 and res is None and "jax" in err


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("jaxtyping_like"))
    assert "jaxtyping_like" not in bench_run.forbidden_modules()
    assert all(m.split(".")[0] != "workloads" for m in sys.modules) == \
        ("workloads" not in bench_run.forbidden_modules())


def test_only_the_benchmarks_files_make_no_result(tmp_path):
    """A checkout holding BENCHMARK.json and the benchmark's folder alone
    exits with an error and prints no result."""
    for name in ROOT_FILES:
        src = bench_run.ROOT / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, tmp_path / name)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "3",
         "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_fresh_process_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark.tests.tiny import tiny_cell, run_tiny\n"
        "rc, res, err = run_tiny(tiny_cell('pythia-6.9b.generate'))\n"
        "loaded = {m.split('.')[0] for m in sys.modules}\n"
        "print(rc, sorted(loaded & {'jax', 'jaxlib', 'flax', 'workloads'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.stdout.split()[-2:] == ["0", "[]"], proc.stderr[-2000:]
