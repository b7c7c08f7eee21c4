"""Seeded draws for the traffic generators.

Sizes are independent draws from their law, and arrivals a Poisson
process (independent exponential gaps): bursts of arrivals and runs of
long prompts come as they come.  Each set is drawn once from a fixed
stream (``SCHEDULE``); the run's seed orders it and draws the token ids,
so every seed offers the same work in another order.  With the sets
drawn from each seed as well, runs of different seeds would differ by
how much work they were given, besides its order.
"""

from __future__ import annotations

import math

import numpy as np

SCHEDULE = 0  # the seed of every mix's set of sizes and gaps


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), *tag.encode()])


def sizes(gen: np.random.Generator, law: dict, n: int) -> list[int]:
    """``n`` independent whole sizes under ``law``: ``{"law":
    "log_uniform", "lo": a, "hi": b}`` (a and b included) or ``{"law":
    "fixed", "value": v}``."""
    if law["law"] == "fixed":
        return [int(law["value"])] * n
    if law["law"] != "log_uniform":
        raise ValueError(f"unknown size law {law['law']!r}")
    lo, hi = math.log(law["lo"]), math.log(law["hi"] + 1)
    return [min(int(math.exp(x)), law["hi"]) for x in gen.uniform(lo, hi, size=n)]


def poisson_gaps(gen: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """The gaps of a Poisson process at ``rate`` per second over
    ``seconds``, given its count: a Poisson count ``n``, then ``n + 1``
    independent exponentials (the first arrival's wait, the gaps between
    arrivals, the stretch after the last) scaled to fill the span.  In
    any order their running sums up to the ``n``-th are the arrivals."""
    n = int(gen.poisson(rate * seconds))
    gaps = gen.exponential(size=n + 1)
    return seconds * gaps / gaps.sum()


def token_lists(gen: np.random.Generator, lengths: list[int], vocab: int) -> list[list[int]]:
    ids = gen.integers(0, vocab, size=sum(lengths))
    out, start = [], 0
    for n in lengths:
        out.append(ids[start:start + n].tolist())
        start += n
    return out
