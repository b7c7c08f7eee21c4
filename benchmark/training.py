"""Training cells: the port's ``train.make_train_step`` on seeded batches.

Set-up makes the float32 master weights from the seed, builds one
training step with its AdamW state and drives that same object through
its first ``check.steps`` steps, each on a fresh batch from the seed,
through the call the window uses.  It keeps what the comparison needs:
each step's loss, every leaf's gradient norm after step 1 as the
optimizer got it (from its second moment: nu = (1 - b2) g^2 after one
step), and every leaf's change after the last of them (against the
weights drawn again from the seed).  The window then runs further steps
on further batches, each ending in a synchronise.  Once it has closed and
the program's state is freed, the reference follows the same steps in
float32 from the same weights and batches.  The weights, the port's
config and train step and the reference come from the configuration's
block family (``spec.family``).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time

import torch

from benchmark import spec, trace
from benchmark.reference import model as ref


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class TrainRun:
    def __init__(self, cell, seed: int, seconds: float, trace_on: bool, device, scratch: str):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device, self.scratch = trace_on, torch.device(device), scratch
        self.cfg, self.settings, self.mix = cell.config, cell.settings, cell.mix
        self.family = cell.family
        self.run: dict = {"cfg": self.cfg, "settings": self.settings, "mix": self.mix}
        self.opt = dict(self.settings["optimizer"])

    def batch(self, step: int) -> torch.Tensor:
        return self.cell.kind.batch(self.mix, self.seed, step, self.cfg["vocab_size"],
                                    self.device)

    # ---- set-up --------------------------------------------------------

    def setup(self) -> None:
        from workloads_torch.train import AdamW

        fam, trainer = self.family, self.settings["trainer"]
        config = fam.port_config(
            self.cfg, getattr(torch, self.cfg["dtype"]),
            attention_impl=trainer["attention_impl"], remat_layers=bool(trainer["remat_layers"]))
        config = dataclasses.replace(config, max_seq_len=int(self.mix["seq_len"]))
        self.optimizer = AdamW(**self.opt)
        self.params = fam.make_params(self.cfg, self.seed, torch.float32, self.device)
        self.state = self.optimizer.init(self.params)
        self.step = fam.port_train_step(config, self.optimizer)
        self.steps_done = 0
        losses = []
        for i in range(int(self.settings["check"]["steps"])):
            loss = self._one()
            losses.append(loss)
            if i == 0:
                scale = 1.0 / (1.0 - self.optimizer.b2)
                self.grad_norms = {p: math.sqrt(float(nu.sum()) * scale)
                                   for p, nu in fam.leaf_items(self.state["nu"])}
        self.losses = [float(x) for x in losses]
        start = fam.make_params(self.cfg, self.seed, torch.float32, self.device)
        self.change_norms = {
            p: float((now - then).norm())
            for (p, now), (_, then) in zip(fam.leaf_items(self.params), fam.leaf_items(start))}
        del start
        _sync(self.device)

    def _one(self) -> torch.Tensor:
        self.steps_done += 1
        tokens = self.batch(self.steps_done)
        self.params, self.state, self.loss = self.step(self.params, self.state, tokens)
        return self.loss

    # ---- the window ----------------------------------------------------

    def window(self) -> None:
        """Steps for the run's seconds; with the trace on, then
        ``profile_steps`` more under the profiler."""
        rows, seq = int(self.mix["batch"]), int(self.mix["seq_len"])
        first = self.steps_done
        t0 = time.perf_counter()
        end = t0 + self.seconds
        while time.perf_counter() < end:
            with trace.span("bench.train_step"):
                self._one()
                _sync(self.device)
        window_s = time.perf_counter() - t0
        steps = self.steps_done - first
        self.run.update(window_s=window_s, steps=steps, batch=rows, seq=seq - 1,
                        tokens=steps * rows * (seq - 1), last_loss=float(self.loss),
                        slice=None)
        if self.trace_on:
            n = int(self.settings.get("profile_steps", 1))
            with trace.Slice(self.scratch, cuda=self.device.type == "cuda") as sl:
                for _ in range(n):
                    with trace.span("bench.train_step"):
                        self._one()
            sl.read()
            self.run["slice"] = {"trace": sl, "steps": n}

    # ---- after the window ---------------------------------------------

    def finish(self) -> dict:
        _sync(self.device)
        self.run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         if self.device.type == "cuda" else 0)
        self.run["attempted"] = self.run["steps"] + int(self.settings["check"]["steps"])
        self.run["failed"] = int(not math.isfinite(self.run["last_loss"]))
        del self.params, self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        reading = reference_reading(self.cfg, self.seed, self.batch, self.opt,
                                    int(self.settings["check"]["steps"]), self.device)
        self.reading = reading
        numbers = compare(reading, self.losses, self.grad_norms, self.change_norms)
        print(f"run.py: losses {self.losses}, reference {reading['losses']}", file=sys.stderr)
        limits = self.settings["check"]["limits"]
        out = {"failed": {"value": self.run["failed"], "limit": 0}}
        for name, value in numbers.items():
            if name in limits:
                out[name] = {"value": value, "limit": limits[name]}
        self.run["readings"] = numbers
        return out


def reference_reading(cfg: dict, seed: int, batch, opt: dict, steps: int, device,
                      fp8: bool = False, rows_of=None) -> dict:
    """The reference's losses, first gradients' norms and changes after
    ``steps`` steps, from the seed's weights and batches, by the
    configuration's block family."""
    fam = spec.family(cfg)
    ref.highest_precision()
    params = fam.make_params(cfg, seed, torch.float32, device)
    paths = [p for p, _ in fam.leaf_items(params)]
    leaves = [t.requires_grad_(True) for _, t in fam.leaf_items(params)]
    start = [t.detach().clone() for t in leaves]
    adam = ref.AdamW(leaves, opt.get("lr", 1e-3), opt.get("b1", 0.9), opt.get("b2", 0.999),
                     opt.get("eps", 1e-8), opt.get("weight_decay", 1e-4))
    losses, grad_norms = [], {}
    for s in range(1, steps + 1):
        tokens = batch(s).long()
        rows = None if rows_of is None else rows_of(tokens)
        loss, grads = fam.loss_and_grads(params, tokens, cfg, leaves, fp8, rows)
        losses.append(loss)
        if s == 1:
            grad_norms = {p: float(g.norm()) for p, g in zip(paths, grads)}
        adam.step(leaves, grads)
        del grads
    change = {p: float((t.detach() - t0).norm()) for p, t, t0 in zip(paths, leaves, start)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def compare(reading: dict, losses: list, grad_norms: dict, change_norms: dict) -> dict:
    """The compared numbers: the worst step's loss gap over the
    reference's loss, and by the worst leaf the gap between the norms of
    the first gradient and of the change, over the reference's norm of
    that leaf or of the median leaf, whichever is larger.  Leaves whose
    reference gradient is under a thousandth of the median leaf's are
    left out of the change.  Beside them, for the record: each step's loss
    gap and the worst leaves."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, reading["losses"])]
    ref_g = reading["grad_norms"]
    med_g = statistics.median(ref_g.values())
    grad = {p: abs(grad_norms[p] - r) / max(r, med_g) for p, r in ref_g.items()}
    ref_c = reading["change_norms"]
    moved = [p for p in ref_c if ref_g[p] >= 1e-3 * med_g]
    med_c = statistics.median(ref_c[p] for p in moved)
    change = {p: abs(change_norms[p] - ref_c[p]) / max(ref_c[p], med_c) for p in moved}
    return {"loss_gap": max(loss_gaps), "grad_gap": max(grad.values()),
            "change_gap": max(change.values()), "loss_gaps": loss_gaps,
            "grad_worst": max(grad, key=grad.get), "change_worst": max(change, key=change.get),
            "left_out": len(ref_c) - len(moved)}
