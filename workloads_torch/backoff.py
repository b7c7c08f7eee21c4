"""Shared retry backoff: exponential, capped, seeded-jitter, interruptible.

Two consumers, one escalation policy:

  * ``tpu_device_plugin/main.py`` — the daemon's plugin-(re)start loop.
    The reference restarts failed plugins on a flat 5 s timer
    (main.go:264-280); ours used to mirror that
    (``RESTART_BACKOFF_SECS = 5.0``), which hammers a permanently-broken
    kubelet socket at a fixed cadence forever.  The daemon now escalates
    per CONSECUTIVE start failure and resets on success.
  * ``workloads/supervisor.py`` — the fleet supervisor's replica
    resurrection schedule: each failed restart of the same chip slot
    pushes the next attempt out exponentially, so a sick chip is probed
    ever more gently until the crash-loop detector quarantines it.

Design points:

  * **Deterministic jitter.**  Retry storms come from synchronized
    clients; jitter decorrelates them.  But tests (and the chaos fuzz)
    need replayable schedules, so the jitter is a pure function of
    ``(seed, attempt)`` — same policy, same attempt, same delay, on any
    host.  Distinct seeds (one per replica slot / daemon instance)
    decorrelate in production.
  * **Interruptible sleeping.**  ``sleep()`` takes an optional
    ``threading.Event`` and returns early (``True``) when it is set — a
    terminal signal must never wait out a 30 s backoff.  Callers with
    their own event loops (the daemon's queue-draining
    ``_sleep_interruptible``, the supervisor's cooperative step clock)
    use ``delay()`` and wait their own way.

Deliberately dependency-free (no jax, no numpy): importable by the
plugin daemon, host-only tests and the Makefile self-checks.

The PyTorch port's own copy of ``workloads/backoff.py`` (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds every
definition to it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

__all__ = ["Backoff"]


@dataclass(frozen=True)
class Backoff:
    """An escalation policy: ``delay(attempt)`` for attempt 0, 1, 2, ...

    ``base_s * factor**attempt``, capped at ``max_s``, plus a
    deterministic jitter drawn uniformly from ``[0, jitter * delay]``
    by ``random.Random((seed, attempt))`` — pure per (seed, attempt),
    so schedules replay bit-identically while distinct seeds
    decorrelate."""

    base_s: float = 0.5
    factor: float = 2.0
    max_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.base_s <= 0:
            raise ValueError(f"base_s must be > 0, got {self.base_s}")
        if self.factor < 1.0:
            raise ValueError(
                f"factor must be >= 1 (backoff never shrinks), got "
                f"{self.factor}"
            )
        if self.max_s < self.base_s:
            raise ValueError(
                f"max_s {self.max_s} must be >= base_s {self.base_s}"
            )
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(
                f"jitter must be in [0, 1] (a fraction of the delay), "
                f"got {self.jitter}"
            )

    def delay(self, attempt: int) -> float:
        """Seconds to wait before retry number ``attempt`` (0-based:
        the first retry after the first failure is attempt 0)."""
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0, got {attempt}")
        # Cap the exponent before exponentiating: factor**attempt
        # overflows floats near attempt ~1000 and the cap makes any
        # larger exponent indistinguishable anyway.
        raw = self.base_s * self.factor ** min(attempt, 64)
        capped = min(raw, self.max_s)
        if self.jitter == 0.0:
            return capped
        # An int mix, not hash((seed, attempt)): tuple seeding is
        # deprecated and str hashes vary per process — the schedule
        # must replay bit-identically across hosts.
        rng = random.Random(self.seed * 1_000_003 + attempt * 7919)
        return capped + rng.uniform(0.0, self.jitter * capped)

    def derive(self, key: str) -> "Backoff":
        """This policy re-seeded for one identity (a chip slot, a
        daemon instance): same escalation curve, decorrelated jitter.
        crc32, not hash() — str hashes vary per process and derived
        schedules must replay bit-identically across hosts."""
        import zlib

        return Backoff(
            base_s=self.base_s, factor=self.factor, max_s=self.max_s,
            jitter=self.jitter,
            seed=(
                self.seed * 1_000_003 + zlib.crc32(key.encode())
            ) & 0x7FFFFFFF,
        )

    def sleep(self, attempt: int, interrupt=None) -> bool:
        """Wait out ``delay(attempt)``; returns True if ``interrupt``
        (a ``threading.Event``) was set before the delay elapsed —
        interruptible by contract, so shutdown never waits out a capped
        backoff."""
        secs = self.delay(attempt)
        if interrupt is not None:
            return bool(interrupt.wait(secs))
        import time

        time.sleep(secs)
        return False
