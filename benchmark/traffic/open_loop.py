"""Open-loop serving traffic: independent users arriving on their own
schedule, whatever the system's state.

Mix parameters: ``arrivals`` (``"poisson"``), ``prompt_len`` and
``new_tokens`` (size laws, ``draws.sizes``); the cell gives the rate
(``rate_per_s``).  The window's arrivals are a Poisson process given its
count (``draws.poisson_gaps``), with a size pair drawn for each; a
second span of the same law follows it, for the steps profiled after the
window.  Each span's gaps and sizes are the same set for every seed
(``draws.SCHEDULE``), and the seed orders them and draws the token ids.
A request is due at its arrival time; the runner submits it as soon as
it can and times it from the due time.
"""

from __future__ import annotations

import numpy as np

from benchmark import draws
from benchmark.serving import Ask

RUNNER = "serve"
SPANS = 2  # the window, then the traffic of the slice profiled after it


class Feed:
    def __init__(self, mix: dict, settings: dict, seed: int, vocab: int, seconds: float):
        if mix["arrivals"] != "poisson":
            raise ValueError(f"unknown arrival law {mix['arrivals']!r}")
        rate = float(settings["rate_per_s"])
        sched = draws.rng(draws.SCHEDULE, "open_loop")
        order = draws.rng(seed, "open_loop:order")
        offsets, prompt_lens, news = [], [], []
        for k in range(SPANS):
            gaps = order.permutation(draws.poisson_gaps(sched, rate, seconds))
            n = len(gaps) - 1
            lens = draws.sizes(sched, mix["prompt_len"], n)
            new = draws.sizes(sched, mix["new_tokens"], n)
            pick = order.permutation(n)
            offsets += (k * seconds + np.cumsum(gaps)[:n]).tolist()
            prompt_lens += [lens[i] for i in pick]
            news += [new[i] for i in pick]
        prompts = draws.token_lists(draws.rng(seed, "open_loop:tokens"), prompt_lens, vocab)
        self.asks = [Ask(p, m) for p, m in zip(prompts, news)]
        self.offsets = offsets
        self.next = 0

    def start(self, now: float) -> None:
        for ask, off in zip(self.asks, self.offsets):
            ask.due = now + off

    def due(self, now: float) -> list[Ask]:
        out = []
        while self.next < len(self.asks) and self.asks[self.next].due <= now:
            out.append(self.asks[self.next])
            self.next += 1
        return out

    def next_due(self) -> float | None:
        return self.asks[self.next].due if self.next < len(self.asks) else None

    def finished(self, ask: Ask, now: float) -> None:
        pass
