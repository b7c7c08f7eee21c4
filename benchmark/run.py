"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Set-up (weights from the seed, the system under test, warm-up of every
shape the cell uses, kernel builds on a first run) counts as ``setup_s``;
then the window runs for ``--seconds``; then the outputs are checked
against the plain reference.  ``--trace 1`` profiles a slice of the
window and reports the per-layer metrics instead of the end-to-end ones.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers are the last lines on standard error.  Exit
codes: 0 with a result; 2 without the CUDA cards the cell needs; 3 when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``workloads`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRATCH = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "workloads")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(SCRATCH / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(SCRATCH / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in (name.split(".")[0] for name in list(sys.modules))
                   if m in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, args, device: str) -> tuple[dict, dict]:
    """Set up, run the window and check: (the run's readings, checks)."""
    from benchmark.serving import ServeRun
    from benchmark.training import TrainRun

    SCRATCH.mkdir(parents=True, exist_ok=True)
    runner_cls = ServeRun if cell.kind.RUNNER == "serve" else TrainRun
    runner = runner_cls(cell, args.seed, args.seconds, bool(args.trace), device, str(SCRATCH))
    runner.setup()
    setup_s = time.perf_counter() - T_START
    runner.window()
    checks = runner.finish()
    runner.run["setup_s"] = setup_s
    return runner.run, checks


def result(cell, run: dict, checks: dict, trace: bool, device: str) -> dict:
    import torch

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": all(passes(c) for c in checks.values()),
           "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": dev}
    sl = run.get("slice")
    if trace and sl is not None:
        tr = sl["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.wall_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def passes(check: dict) -> bool:
    v = check["value"]
    return v is not None and v == v and v <= check["limit"]


def main(argv=None, *, cell=None, device: str | None = None) -> int:
    """``cell`` and ``device`` let a test drive a run of a cell it built
    on the CPU; a run from the command line takes neither."""
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    _fixed_caches()
    import torch

    from benchmark import spec

    cell = cell if cell is not None else spec.Cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"run.py: cell {cell.name} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    run, checks = measure(cell, args, device)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    out = result(cell, run, checks, bool(args.trace), device)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
