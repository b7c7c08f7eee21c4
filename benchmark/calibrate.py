"""The readings that a cell's limits are set from, on the chip at the
cell's own size: for each seed, the program's numbers beside the
control's, and for a training cell the faults' too.  The benchmark's own
runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> SEED [SEED ...]

- Serving: a run's window and sample as ``run.py`` makes them; the
  program's widest gap, and the control's: the family's reference in
  float8 (its ``fp8``) at each position of the same prompts
  and served tokens, the gap of the token it puts first.
- Training: the program's numbers after its first steps; the control
  (the reference in float8 in the program's place); and the fault "half
  of the batch left out, the mean over the rest" (the reference on the
  first half of each batch in the program's place), and "a step that
  returns its state unchanged" (the program with its update left out).

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(runner) -> dict:
    import torch

    from benchmark.reference import model as ref

    runner.setup()
    runner.window()
    sample = runner.close()
    checks = runner.check(sample)
    control = []
    with torch.no_grad():
        for ask in sample:
            served = list(ask.req.tokens)
            exact = runner.family.served_logits(runner.params, ask.prompt, served,
                                                runner.cfg, runner.device)
            low = runner.family.served_logits(runner.params, ask.prompt, served,
                                              runner.cfg, runner.device, fp8=True)
            control.append(ref.widest_gap(exact, low.argmax(dim=-1)))
    return {"program": {"max_gap": checks["max_gap"]["value"]},
            "control": {"max_gap": max(control) if control else None},
            "compared_tokens": runner.run["compared_tokens"],
            "memory_peak_bytes": runner.run["memory_peak_bytes"]}


def train_readings(runner) -> dict:
    from benchmark import training

    runner.setup()
    runner.window()
    runner.finish()
    r = runner.reading
    steps = int(runner.settings["check"]["steps"])

    def in_place(reading):
        return training.compare(r, reading["losses"], reading["grad_norms"],
                                reading["change_norms"])

    control = training.reference_reading(runner.cfg, runner.seed, runner.batch, runner.opt,
                                         steps, runner.device, fp8=True)
    half = training.reference_reading(runner.cfg, runner.seed, runner.batch, runner.opt,
                                      steps, runner.device,
                                      rows_of=lambda t: list(range(t.shape[0] // 2)))
    return {"program": runner.run["readings"], "control": in_place(control),
            "half_batch": in_place(half), "unchanged_state": unchanged_state(runner),
            "memory_peak_bytes": runner.run["memory_peak_bytes"]}


def unchanged_state(runner) -> dict:
    """The program's first steps with its update left out (the state comes
    back unchanged), against the reading already taken."""
    import workloads_torch.train as train

    from benchmark import training

    adamw = train.adamw
    train.adamw = lambda params, grads, state, optimizer=None: state
    try:
        runner.setup()
    finally:
        train.adamw = adamw
    return training.compare(runner.reading, runner.losses, runner.grad_norms,
                            runner.change_norms)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a cell's program, control and fault readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as bench_run
    from benchmark import spec
    from benchmark.serving import ServeRun
    from benchmark.training import TrainRun

    bench_run._fixed_caches()
    bench_run.SCRATCH.mkdir(parents=True, exist_ok=True)
    import gc

    import torch

    cell = spec.Cell(args.workload)
    for seed in args.seeds:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if cell.kind.RUNNER == "serve":
            out = serve_readings(ServeRun(cell, seed, args.seconds, False, "cuda",
                                          str(bench_run.SCRATCH)))
        else:
            out = train_readings(TrainRun(cell, seed, args.seconds, False, "cuda",
                                          str(bench_run.SCRATCH)))
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
