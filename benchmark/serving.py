"""Serving cells: the port's ``ServeEngine`` under seeded traffic.

Set-up makes the weights from the seed, builds the engine with the
cell's settings and warms up every shape the mix will use (each prefill
chunk the longest prompt needs, the decode graph), then the window
drives ``submit``/``step`` from the traffic generator for the run's
seconds.  The engine is read from outside: its ``Request`` stamps, its
counters, and the rows of the chunk it dispatched.  Once the window has
closed, a sample of the requests it finished (the longest among them) is
run through the reference, and the widest gap by which a served token's
reference logit lies below the reference's best decides ``correct``.
The weights, the port's config and the reference come from the
configuration's block family (``spec.family``).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from benchmark import draws, spec, trace
from benchmark.reference import model as ref

# The engine's counters every serving cell records over the window; a
# cell's settings may name more (``"counters"``).
COUNTERS = ("generated_tokens", "chunks_run", "prefill_dispatches", "prefill_tokens",
            "requests_admitted", "prefill_sweeps")


@dataclass
class Ask:
    """One request of the traffic, and what the run saw of it."""

    prompt: list
    max_new: int
    due: float = 0.0
    req: object = None  # the engine's Request once submitted
    t_submit: float | None = None
    t_last: float | None = None  # when its newest token was seen
    seen: int = 0  # tokens seen by then

    @property
    def t_first(self):
        return None if self.req is None else self.req.t_first

    @property
    def t_admit(self):
        return None if self.req is None else self.req.t_admit


def model_config(cfg: dict, dtype: torch.dtype, **extra):
    """The port's ``ModelConfig`` for a configuration file's dict."""
    from workloads_torch.model import ModelConfig

    return ModelConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_layers=cfg["num_hidden_layers"],
        d_ff=cfg["intermediate_size"], max_seq_len=cfg["max_position_embeddings"],
        dtype=dtype, n_kv_heads=cfg.get("num_key_value_heads"),
        attention_window=cfg.get("sliding_window"), **extra)


class ServeRun:
    def __init__(self, cell, seed: int, seconds: float, trace_on: bool, device, scratch: str):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device, self.scratch = trace_on, torch.device(device), scratch
        self.cfg, self.settings, self.mix = cell.config, cell.settings, cell.mix
        self.family = cell.family
        self.counters = COUNTERS + tuple(self.settings.get("counters", ()))
        self.run: dict = {"cfg": self.cfg, "settings": self.settings, "mix": self.mix}

    # ---- set-up --------------------------------------------------------

    def setup(self) -> None:
        from workloads_torch.serve import ServeEngine

        dtype = getattr(torch, self.cfg["dtype"])
        self.params = self.family.make_params(self.cfg, self.seed, dtype, self.device)
        self.engine = ServeEngine(self.params, self.family.port_config(self.cfg, dtype),
                                  device=self.device, **self.settings["engine"])
        self.feed = self.cell.kind.Feed(self.mix, self.settings, self.seed,
                                        self.cfg["vocab_size"], self.seconds)
        self._warm_up()

    def _warm_up(self) -> None:
        """Every prefill chunk the longest prompt needs, the shortest
        prompt, and two decode dispatches, so nothing is built, captured
        or first allocated inside the window."""
        gen = draws.rng(self.seed, "warm_up")
        e = self.engine
        law = self.mix["prompt_len"]
        for n in (law.get("hi", law.get("value")), law.get("lo", law.get("value"))):
            prompt = gen.integers(0, self.cfg["vocab_size"], size=int(n)).tolist()
            e.submit(prompt, 2 * e.chunk + 2)
        e.run()
        bad = [r for r in e.drain_completed() if r.status != "ok"]
        if bad:
            raise RuntimeError(f"warm-up request {bad[0].rid} ended {bad[0].status}: "
                               f"{bad[0].error}")
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- the window ----------------------------------------------------

    def window(self) -> None:
        """Drive the traffic for the run's seconds; with the trace on, then
        ``profile_steps`` more steps of the same traffic under the
        profiler, so profiling costs the window nothing."""
        e = self.engine
        self.active: list[Ask] = []
        self.asks: list[Ask] = []
        self.stepping = 0.0  # wall seconds of step() calls that dispatched work
        self.steps = 0
        before = {k: getattr(e, k) for k in self.counters}
        t0 = time.perf_counter()
        end = t0 + self.seconds
        self.feed.start(t0)
        while time.perf_counter() < end:
            self._tick(end)
        t_end = time.perf_counter()
        unsent = [a for a in self.feed.due(t_end) if a.due < t_end]
        # What the run saw by the window's close: the slice profiled after
        # it steps the same requests on.
        self.run.update(
            unsent=[replace(a) for a in unsent], window_s=t_end - t0, t0=t0,
            asks=[replace(a) for a in self.asks], stepping_s=self.stepping,
            steps=self.steps, chunk=e.chunk,
            counters={k: getattr(e, k) - before[k] for k in self.counters})
        self.run["slice"] = self._profile_slice(unsent) if self.trace_on else None

    def _tick(self, end: float, positions: list[int] | None = None) -> None:
        """Submit what is due, then one engine step (or wait for the next
        arrival, a second at most, when there is nothing to do)."""
        e = self.engine
        now = time.perf_counter()
        self._submit(self.feed.due(now))
        if e.idle:
            nxt = self.feed.next_due()
            wake = min(end, now + 1.0) if nxt is None else min(nxt, end, now + 1.0)
            time.sleep(max(0.0, wake - now))
            return
        self._step(positions)

    def _submit(self, asks: list[Ask]) -> None:
        with trace.span("bench.submit"):
            for ask in asks:
                ask.t_submit = time.perf_counter()
                self.engine.submit(ask.prompt, ask.max_new)
                ask.req = self.engine.pending[-1]
                self.active.append(ask)
                self.asks.append(ask)

    def _step(self, positions: list[int] | None = None) -> None:
        """One engine step; the tokens each request shows after it.  With
        ``positions``, the position each decoded token was fed at is added
        to it: token ``i >= 1`` of a request comes from the decode step at
        ``len(prompt) + i - 1`` (token 0 from its prefill)."""
        e = self.engine
        before = [(a, len(a.req.tokens)) for a in self.active] if positions is not None else []
        marks = (e.chunks_run, e.prefill_dispatches)
        t = time.perf_counter()
        with trace.span("bench.step"):
            finished = e.step()
        now = time.perf_counter()
        dispatched = (e.chunks_run, e.prefill_dispatches) != marks
        with trace.span("bench.track"):
            done = {id(r) for r in finished}
            for ask in list(self.active):
                n = len(ask.req.tokens)
                if id(ask.req) in done:
                    ask.seen, ask.t_last = n, ask.req.t_done
                    self.active.remove(ask)
                    self.feed.finished(ask, now)
                elif n > ask.seen:
                    ask.seen, ask.t_last = n, now
        if dispatched:
            self.stepping += now - t
            self.steps += 1
        for a, n in before:
            first = len(a.prompt) - 1
            positions.extend(range(first + max(n, 1), first + len(a.req.tokens)))

    def _profile_slice(self, unsent: list[Ask]) -> dict:
        """``profile_steps`` engine steps of the same traffic under the
        profiler, and the positions of the tokens that the decode chunks
        they dispatched emitted.  A pipelined engine reads a chunk back
        one step after it dispatched it, so those tokens come in the
        profiled steps after the first and in one step after the slice."""
        e = self.engine
        lag = 1 if self.settings["engine"].get("pipelined", False) else 0
        positions: list[int] = []
        far = time.perf_counter() + 3600.0
        self._submit(unsent)
        mark = e.chunks_run
        with trace.Slice(self.scratch, cuda=self.device.type == "cuda") as sl:
            for i in range(int(self.settings.get("profile_steps", 2))):
                self._tick(far, positions if i >= lag else None)
        chunks = e.chunks_run - mark
        for _ in range(lag):
            self._tick(far, positions)
        sl.read()
        return {"trace": sl, "decode_positions": positions, "chunks": chunks,
                "decode_steps": chunks * e.chunk}

    # ---- after the window ---------------------------------------------

    def finish(self) -> dict:
        """Read the peak, free the engine, and check a sample of the
        finished requests against the reference."""
        return self.check(self.close())

    def close(self) -> list[Ask]:
        """Read the peak and the window's outcome, free the engine; the
        sample of finished requests to check."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.run["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        else:
            self.run["memory_peak_bytes"] = 0
        asks = self.run["asks"]
        end = self.run["t0"] + self.run["window_s"]
        finished = [a for a in asks if a.req.status == "ok" and a.req.t_done <= end]
        self.run["attempted"] = len(asks)
        failed = [a.req for a in asks if a.req.status in ("failed", "rejected")]
        self.run["failed"] = len(failed)
        for error in sorted({str(r.error) for r in failed})[:3]:
            print(f"run.py: a request failed: {error[:500]}", file=sys.stderr)
        sample = self.sample(finished)
        self.engine.close()
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return sample

    def sample(self, finished: list[Ask]) -> list[Ask]:
        """The longest finished request and others drawn from the seed."""
        n = int(self.settings["check"]["sample"])
        if not finished:
            return []
        longest = max(finished, key=lambda a: (a.seen, len(a.prompt)))
        rest = [a for a in finished if a is not longest]
        gen = draws.rng(self.seed, "check")
        picks = gen.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
        return [longest] + [rest[i] for i in sorted(picks)]

    def check(self, sample: list[Ask]) -> dict:
        ref.highest_precision()
        gaps = []
        with torch.no_grad():
            for ask in sample:
                served = list(ask.req.tokens)
                logits = self.family.served_logits(self.params, ask.prompt, served,
                                                   self.cfg, self.device)
                chosen = torch.tensor(served, dtype=torch.int64, device=self.device)
                gaps.append(ref.widest_gap(logits, chosen))
                del logits
        self.run["compared_requests"] = len(sample)
        self.run["compared_tokens"] = sum(len(a.req.tokens) for a in sample)
        limits = self.settings["check"]["limits"]
        return {
            "failed": {"value": self.run["failed"], "limit": 0},
            "max_gap": {"value": max(gaps) if gaps else None,
                        "limit": limits["max_gap"]},
        }


def decode_flops(cfg: dict, asks: list[Ask], end: float) -> float:
    """Model FLOPs of the prompt and output tokens the window processed:
    each admitted prompt (its last token's logits included) and each
    token decoded after the first, at its position, as the
    configuration's block family counts them."""
    span_flops = spec.family(cfg).span_flops
    total = 0.0
    for a in asks:
        if a.t_admit is None or a.t_admit > end:
            continue
        p = len(a.prompt)
        total += span_flops(cfg, 0, p, logits=False)
        total += 2 * cfg["hidden_size"] * cfg["vocab_size"]
        if a.seen > 1:
            total += span_flops(cfg, p, p + a.seen - 1, logits=True)
    return total


def p95(values) -> float | None:
    """The 95th percentile (linear), or None without values."""
    values = list(values)
    return float(np.percentile(values, 95)) if values else None


def tpots_ms(run: dict) -> list[float]:
    """Per request with two tokens or more in the window: (last token seen
    - first token) / (tokens - 1), in ms."""
    return [1e3 * (a.t_last - a.t_first) / (a.seen - 1)
            for a in run["asks"] if a.seen >= 2 and a.t_first is not None]
