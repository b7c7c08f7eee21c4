"""Closed-loop serving traffic: ``clients`` callers, each sending its
next request the moment its last one ends.

Mix parameters: ``clients``, ``prompt_len`` and ``new_tokens`` (size
laws, ``draws.sizes``), ``pool`` (requests drawn up front; a run that
would need more fails rather than repeat one).  The pool's sizes are
the same set for every seed (``draws.SCHEDULE``); the seed orders them
and draws the token ids.  Every request is due when its client sends it.
"""

from __future__ import annotations

from benchmark import draws
from benchmark.serving import Ask

RUNNER = "serve"


class Feed:
    def __init__(self, mix: dict, settings: dict, seed: int, vocab: int, seconds: float):
        sched = draws.rng(draws.SCHEDULE, "closed_loop")
        n = int(mix["pool"])
        lens = draws.sizes(sched, mix["prompt_len"], n)
        new = draws.sizes(sched, mix["new_tokens"], n)
        pick = draws.rng(seed, "closed_loop:order").permutation(n)
        prompt_lens, news = [lens[i] for i in pick], [new[i] for i in pick]
        prompts = draws.token_lists(draws.rng(seed, "closed_loop:tokens"), prompt_lens, vocab)
        self.asks = [Ask(p, m) for p, m in zip(prompts, news)]
        self.clients = int(mix["clients"])
        self.next = 0
        self.ready: list[float] = []

    def _take(self, now: float) -> Ask:
        if self.next >= len(self.asks):
            raise RuntimeError("the closed loop ran out of drawn requests: raise its pool")
        ask = self.asks[self.next]
        self.next += 1
        ask.due = now
        return ask

    def start(self, now: float) -> None:
        self.ready = [now] * self.clients

    def due(self, now: float) -> list[Ask]:
        out = [self._take(t) for t in self.ready]
        self.ready = []
        return out

    def next_due(self) -> float | None:
        return min(self.ready) if self.ready else None

    def finished(self, ask: Ask, now: float) -> None:
        self.ready.append(now)
