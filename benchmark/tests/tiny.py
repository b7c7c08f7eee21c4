"""Tiny stand-ins for the benchmark's cells, for runs on the CPU: the
cells' own files with the configuration, the mix and the settings cut to
a size a test can hold, and limits no sound run reaches."""

from __future__ import annotations

import copy
import io
import json
from contextlib import redirect_stderr, redirect_stdout

from benchmark import run as bench_run
from benchmark import spec

# What a checkout of the benchmark alone holds.
ROOT_FILES = ("BENCHMARK.json", "benchmark")

TINY_CONFIG = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
               "intermediate_size": 128, "vocab_size": 256, "max_position_embeddings": 96,
               "dtype": "float32"}
TINY_ENGINE = {"slots": 4, "page_size": 8, "prompt_bucket": 16, "pipelined": True}
TINY_MIX = {"prompt_len": {"law": "log_uniform", "lo": 4, "hi": 40},
            "new_tokens": {"law": "log_uniform", "lo": 4, "hi": 16}}


def tiny_cell(name: str, open_loop: bool = False) -> spec.Cell:
    """A cell of ``BENCHMARK.json`` cut to a tiny size; with ``open_loop``,
    a serving cell's requests arrive by the open loop's Poisson process
    instead of its own mix."""
    cell = spec.Cell(name)
    if open_loop:
        cell.mix = {"kind": "open_loop", "arrivals": "poisson", "greedy": True}
        cell.kind = spec.load_module(cell.dir / "traffic" / "open_loop.py")
        cell.settings = {**cell.settings, "rate_per_s": 40.0}
    cell.config = {**cell.config, **TINY_CONFIG}
    cell.settings = copy.deepcopy(cell.settings)
    if cell.kind.RUNNER == "serve":
        cell.mix = {**cell.mix, **TINY_MIX}
        if "clients" in cell.mix:
            cell.mix["clients"] = 4
        cell.settings["engine"] = {**cell.settings["engine"], **TINY_ENGINE,
                                   "chunk": min(cell.settings["engine"]["chunk"], 8)}
        cell.settings["check"] = {"sample": 3, "limits": {"max_gap": 1e-3}}
        cell.settings["profile_steps"] = 2
        if "rate_per_s" in cell.settings:
            cell.settings["rate_per_s"] = 40.0
    else:
        cell.mix = {**cell.mix, "batch": 2, "seq_len": 33}
        cell.settings["check"] = {
            "steps": 3, "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}
    return cell


def run_tiny(cell: spec.Cell, seed: int = 2**31 + 5, seconds: float = 3.0,
             trace: int = 0, device: str = "cpu") -> tuple[int, dict | None, str]:
    """(exit code, the result line's object, standard error) of one run
    of ``cell`` on ``device``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = bench_run.main(["--workload", cell.name, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace", str(trace)],
                            cell=cell, device=device)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
