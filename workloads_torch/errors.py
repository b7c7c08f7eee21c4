"""Typed error taxonomy for the serving engine.

The PyTorch port's own copy of ``workloads/errors.py`` (the port imports
nothing of the JAX package); the two must stay identical in types and
messages.

The reference plugin treats failure as a first-class state (it blocks on
critical-error events and flips devices Unhealthy instead of letting
faults surface as hangs — PAPER.md, nvidia.go:181-269); this module is
the serving half's analog at the API seam: every way a request can be
refused or abandoned is a distinct, catchable type instead of a bare
``ValueError``/``RuntimeError`` the caller must string-match.

The hierarchy deliberately double-inherits from the builtin types the
engine historically raised (``InvalidRequest``/``RequestTooLarge`` are
``ValueError``s, ``QueueFull``/``EngineClosed`` are ``RuntimeError``s),
so existing ``except ValueError`` call sites and tests keep working —
the messages are unchanged, only the types are narrower.

Deliberately dependency-free (no jax): importable by tooling and tests
that never touch a device.
"""

from __future__ import annotations

__all__ = [
    "ServeError",
    "InvalidRequest",
    "RequestTooLarge",
    "QueueFull",
    "EngineClosed",
]


class ServeError(Exception):
    """Base of every typed serving-engine error."""


class InvalidRequest(ServeError, ValueError):
    """A submission the engine can never serve as specified (unknown
    adapter, duplicate in-flight rid, malformed knobs) — resubmit with
    corrected arguments; retrying unchanged can never succeed."""


class RequestTooLarge(InvalidRequest):
    """A submission whose size can never fit this engine: prompt outside
    the [1, max_seq_len-1] window, prompt + max_new_tokens beyond the
    context window, or a worst-case page need exceeding the whole pool.
    A structural rejection, not backpressure — shrink the request or
    build a bigger engine."""


class QueueFull(ServeError, RuntimeError):
    """Bounded-admission backpressure: the pending queue is at
    ``max_pending`` and the engine rejects rather than queue without
    bound.  Transient by design — retry after retirements drain the
    queue (internal replay requeues are exempt from the bound, so
    recovery can never deadlock against it)."""


class EngineClosed(ServeError, RuntimeError):
    """The engine was ``close()``d: submissions and steps are refused,
    and requests that were pending or running at close time were failed
    with this error recorded on them."""
