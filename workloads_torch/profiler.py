"""Device-time observability for the serving stack: on-demand deep
profiles, per-dispatch device-time attribution, and a live
perf-regression sentry.

The PyTorch port's own copy of ``workloads/profiler.py`` (the port
imports nothing of the JAX package); tests/test_torch_copies.py holds
every definition to JAX's but three:

  * ``ProfileSession.start`` / ``stop`` capture with ``torch.profiler``
    (CPU activities, and CUDA's where a card is present) instead of
    ``jax.profiler``.  A torch profile stops only on the thread that
    started it, and the serving fleet starts a capture on an HTTP
    handler thread and stops it on the auto-stop timer's thread or
    another handler, while its kernels launch on the fleet's driver
    thread.  So each capture has one owner thread that enters and leaves
    the profiler, with every thread's operators recorded
    (``profile_all_threads``); ``stop`` exports the capture as a Chrome
    trace, ``profile-NNN/trace.json``, and sums the bytes on disk as JAX
    does.  The duration budget, the disk budget, the auto-stop timer and
    the thread safety are JAX's.  A capture that fails to start raises.
  * ``load_committed_artifact`` reads the port's own artifact,
    ``docs/bench-torch-latest.json`` (``python -m
    workloads_torch.perfbench`` on the card), never the JAX package's
    ``docs/bench-builder-latest.json``, whose numbers were taken on a
    TPU: a TPU noise band must never arm the port's sentry.

``DeviceTimeTable`` calibrates ``StepRecord.device_ms`` as in JAX: the
observer feeds it each step's wall less the engine's host syncs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "ProfileSession",
    "DeviceTimeTable",
    "RegressionSentry",
    "SentryFeed",
    "sentry_from_artifact",
    "artifact_spread_fraction",
    "device_report",
]


# ---- on-demand deep profiles -------------------------------------------


class ProfileSession:
    """Bounded ``torch.profiler`` trace capture for a live process.

    One session owns one output directory and two budgets: every
    capture's duration is clamped to ``max_secs`` (a background timer
    stops a capture the caller forgets), and the summed on-disk size of
    all captures is capped at ``max_bytes`` — ``start()`` refuses once
    the budget is spent, so an operator hammering ``POST /profile``
    cannot fill the node's disk.  Thread-safe: the fleet HTTP handler
    and the auto-stop timer race ``stop()`` harmlessly."""

    def __init__(
        self,
        out_dir: str,
        *,
        max_secs: float = 30.0,
        max_bytes: int = 256 * 1024 * 1024,
        clock=time.monotonic,
    ):
        if max_secs <= 0:
            raise ValueError(f"max_secs must be > 0, got {max_secs}")
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.out_dir = out_dir
        self.max_secs = float(max_secs)
        self.max_bytes = int(max_bytes)
        self.captures: list[dict] = []
        self._clock = clock
        self._lock = threading.Lock()
        self._active_dir: str | None = None
        self._t_start: float | None = None
        self._timer: threading.Timer | None = None

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    @property
    def bytes_spent(self) -> int:
        return sum(c["bytes"] for c in self.captures)

    def start(self, secs: float | None = None) -> dict:
        """Begin one capture.  ``secs`` arms an auto-stop timer (clamped
        to ``max_secs``); ``None`` captures until ``stop()`` — still
        duration-bounded by a ``max_secs`` timer, so a dropped client
        can never leave the profiler running forever.  Raises
        ``RuntimeError`` when a capture is already active, the disk
        budget is spent or the profiler fails to start."""
        with self._lock:
            if self._active_dir is not None:
                raise RuntimeError(
                    f"profile capture already active in {self._active_dir}"
                )
            if self.bytes_spent >= self.max_bytes:
                raise RuntimeError(
                    f"profile disk budget spent ({self.bytes_spent} of "
                    f"{self.max_bytes} bytes across "
                    f"{len(self.captures)} captures)"
                )
            secs = self.max_secs if secs is None else min(
                float(secs), self.max_secs
            )
            if secs <= 0:
                raise ValueError(f"secs must be > 0, got {secs}")
            dump_dir = os.path.join(
                self.out_dir, f"profile-{len(self.captures):03d}"
            )
            os.makedirs(dump_dir, exist_ok=True)
            import torch
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(
                activities=activities,
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True
                ),
            )
            started, finish = threading.Event(), threading.Event()
            outcome: dict = {}

            def own() -> None:
                # The owner thread enters and leaves the profiler: a
                # torch profile stopped from any other thread stays on.
                try:
                    prof.start()
                except Exception as exc:  # handed to start()'s caller
                    outcome["error"] = exc
                    return
                finally:
                    started.set()
                finish.wait()
                try:
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                    prof.stop()
                    prof.export_chrome_trace(
                        os.path.join(dump_dir, "trace.json")
                    )
                except Exception as exc:  # handed to stop()'s caller
                    outcome["error"] = exc

            owner = threading.Thread(
                target=own, name=f"profile-{len(self.captures):03d}",
                daemon=True,
            )
            owner.start()
            started.wait()
            if "error" in outcome:
                owner.join()
                raise RuntimeError(
                    f"profile capture failed to start: {outcome['error']!r}"
                ) from outcome["error"]
            self._trace = (owner, finish, outcome)
            self._active_dir = dump_dir
            self._t_start = self._clock()
            self._timer = threading.Timer(secs, self.stop)
            self._timer.daemon = True
            self._timer.start()
            return {"dir": dump_dir, "secs": secs}

    def stop(self) -> dict | None:
        """End the active capture (idempotent: the auto-stop timer and
        an explicit caller may both arrive).  Returns the capture
        record — dump dir, wall secs, on-disk bytes — or ``None`` when
        nothing was active.  Raises ``RuntimeError`` when the profiler
        failed to stop or to write its trace."""
        with self._lock:
            dump_dir, self._active_dir = self._active_dir, None
            if dump_dir is None:
                return None
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            owner, finish, outcome = self._trace
            self._trace = None
            finish.set()
            owner.join()
            size = 0
            for root, _, files in os.walk(dump_dir):
                for fn in files:
                    try:
                        size += os.path.getsize(os.path.join(root, fn))
                    except OSError:
                        pass
            rec = {
                "dir": dump_dir,
                "secs": round(self._clock() - (self._t_start or 0.0), 3),
                "bytes": size,
            }
            self.captures.append(rec)
            if "error" in outcome:
                raise RuntimeError(
                    f"profile capture in {dump_dir} failed: "
                    f"{outcome['error']!r}"
                ) from outcome["error"]
            return rec

    def state(self) -> dict:
        """JSON-able session state for the HTTP endpoint and bundles."""
        with self._lock:
            return {
                "out_dir": self.out_dir,
                "active": self._active_dir is not None,
                "active_dir": self._active_dir,
                "max_secs": self.max_secs,
                "max_bytes": self.max_bytes,
                "bytes_spent": self.bytes_spent,
                "captures": [dict(c) for c in self.captures],
            }

    def close(self) -> dict | None:
        return self.stop()


# ---- per-dispatch device-time attribution ------------------------------


def _pow2_bucket(n: int) -> int:
    """Next power-of-two bucket (0 stays 0): dispatch shapes the engine
    actually compiles are bucketed, so measured times generalize across
    requests without one table entry per exact size."""
    n = int(n)
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b *= 2
    return b


class DeviceTimeTable:
    """EWMA calibration table: (program, seq-bucket, batch-bucket) ->
    measured device milliseconds per dispatch.

    The observer feeds it every non-idle step's measured device window
    (step wall minus the engine-measured host-sync stall) and reads the
    smoothed estimate back as ``StepRecord.device_ms`` — warmup
    dispatches the engine already runs populate the first entries, so
    attribution works from the first served request.  ``to_dict`` /
    ``load`` round-trip through JSON for ``EngineSnapshot`` persistence
    and the bench artifact (``profiler_device_time_table``)."""

    def __init__(self, *, alpha: float = 0.25):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._table: dict[str, dict] = {}
        # Artifact refreshes that fail to parse (absent, truncated,
        # corrupt, wrong schema) adopt nothing and count here —
        # attribution degrades to live-measurement warmup (the cold
        # path), never raises.
        self.refresh_errors = 0

    @staticmethod
    def key(program: str, seq_tokens: int, batch: int) -> str:
        return (
            f"{program}|s{_pow2_bucket(seq_tokens)}|b{_pow2_bucket(batch)}"
        )

    def __len__(self) -> int:
        return len(self._table)

    def observe(
        self, program: str, seq_tokens: int, batch: int, device_ms: float
    ) -> None:
        if device_ms < 0:
            return
        k = self.key(program, seq_tokens, batch)
        ent = self._table.get(k)
        if ent is None:
            self._table[k] = {"ms": float(device_ms), "n": 1}
        else:
            ent["ms"] += self.alpha * (float(device_ms) - ent["ms"])
            ent["n"] += 1

    def estimate(
        self, program: str, seq_tokens: int, batch: int
    ) -> float | None:
        """Smoothed device-ms for a dispatch shape: the exact bucket
        when calibrated, else the nearest same-program bucket (a coarse
        prior beats attributing nothing), else ``None``."""
        k = self.key(program, seq_tokens, batch)
        ent = self._table.get(k)
        if ent is not None:
            return ent["ms"]
        want_s = _pow2_bucket(seq_tokens)
        want_b = _pow2_bucket(batch)
        best, best_d = None, None
        for other, ent in self._table.items():
            prog, s_s, b_s = other.split("|")
            if prog != program:
                continue
            d = abs(int(s_s[1:]) - want_s) + abs(int(b_s[1:]) - want_b)
            if best_d is None or d < best_d:
                best, best_d = ent["ms"], d
        return best

    def to_dict(self) -> dict:
        return {
            k: {"ms": round(v["ms"], 4), "n": v["n"]}
            for k, v in sorted(self._table.items())
        }

    def load(self, table: dict | None) -> int:
        """Merge a persisted table (snapshot / bench artifact); existing
        live entries win — a snapshot must never overwrite fresher
        measurements.  Returns the number of entries adopted."""
        if not isinstance(table, dict):
            if table is not None:
                self.refresh_errors += 1
            return 0
        adopted = 0
        for k, v in table.items():
            if k in self._table or not isinstance(v, dict):
                continue
            ms = v.get("ms")
            n = v.get("n", 1)
            if not isinstance(n, (int, float)):
                n = 1
            if isinstance(ms, (int, float)) and ms >= 0:
                self._table[k] = {"ms": float(ms), "n": int(n) or 1}
                adopted += 1
        return adopted

    def refresh_from_artifact(self, artifact) -> int:
        """Adopt the calibration the committed bench artifact carries
        (``profiler_device_time_table``, published by the
        ``measure_profiler`` arm).  ``artifact`` is the parsed artifact
        dict OR a path to the JSON file; an absent/truncated/corrupt
        file or a malformed payload adopts nothing and bumps
        ``refresh_errors`` — the table stays on live-measurement
        warmup, the cold path."""
        if isinstance(artifact, (str, os.PathLike)):
            try:
                with open(artifact, encoding="utf-8") as f:
                    artifact = json.load(f)
            except (OSError, ValueError):
                self.refresh_errors += 1
                return 0
        if not isinstance(artifact, dict):
            self.refresh_errors += 1
            return 0
        return self.load(artifact.get("profiler_device_time_table"))


def device_report(observers) -> dict:
    """Fleet-wide device-busy/host-stall split, per dispatch program,
    from the observers' step rings: the per-phase decomposition the
    chip-time ledger's wall windows lack.  Read-only over already-
    recorded rings — safe to call from ``/healthz`` or a summary
    print."""
    phases: dict[str, dict] = {}
    wall_ms = device_ms = 0.0
    for obs in observers:
        if obs is None:
            continue
        for rec in list(obs.steps):
            ph = phases.setdefault(
                rec.mode, {"wall_ms": 0.0, "device_ms": 0.0, "steps": 0}
            )
            w = rec.dur_secs * 1000.0
            d = getattr(rec, "device_ms", 0.0)
            ph["wall_ms"] += w
            ph["device_ms"] += d
            ph["steps"] += 1
            wall_ms += w
            device_ms += d
    for ph in phases.values():
        ph["device_busy_fraction"] = round(
            min(ph["device_ms"] / ph["wall_ms"], 1.0), 4
        ) if ph["wall_ms"] > 0 else 0.0
        ph["wall_ms"] = round(ph["wall_ms"], 3)
        ph["device_ms"] = round(ph["device_ms"], 3)
    busy = min(device_ms / wall_ms, 1.0) if wall_ms > 0 else 0.0
    return {
        "device_busy_fraction": round(busy, 4),
        "host_stall_fraction": round(1.0 - busy, 4),
        "wall_ms": round(wall_ms, 3),
        "device_ms": round(device_ms, 3),
        "phases": {k: phases[k] for k in sorted(phases)},
    }


# ---- live regression sentry --------------------------------------------


@dataclass
class _Detector:
    """One watched signal: EWMA-smoothed value scored as a z against
    the committed baseline's mean and noise band.  ``direction`` is +1
    when HIGHER is bad (latency, stall) and -1 when LOWER is bad
    (throughput, busy fraction) — the signed z is positive exactly when
    the signal moved the bad way."""

    name: str
    baseline: float | None
    spread: float
    direction: int
    warmup: int
    ewma: float | None = None
    breaches: int = 0
    oks: int = 0
    samples: int = 0
    last_z: float = 0.0
    _warm: list = field(default_factory=list)


class RegressionSentry:
    """Rolling EWMA + z-score regression detection over live serving
    signals, firing ``perf_regression`` into an attached
    ``FlightRecorder`` exactly once per incident.

    ``watch()`` registers a signal with a committed baseline mean and
    an absolute noise band (``spread``); ``observe()`` feeds live
    values.  A detector breaches when its smoothed z crosses
    ``z_threshold`` for ``confirm`` consecutive observations; the FIRST
    breach while armed fires the trigger and DISARMS the sentry, so a
    sustained regression produces one bundle, not one per poll.  The
    sentry re-arms only after every breached detector has read
    in-band for ``rearm`` consecutive observations (recovery), at
    which point a NEW regression fires again.  A ``baseline=None``
    watch self-baselines from its first ``warmup`` observations (the
    live-fleet mode: the committed artifact contributes the RELATIVE
    noise band, the run contributes its own operating point — a CLI
    fleet on a different model shape must not compare absolute tok/s
    against the bench's).  Everything here is host-side float
    arithmetic over values the caller already computed: the sentry
    never touches device state, RNG or scheduling — streams are
    bit-identical sentry on/off."""

    def __init__(
        self,
        *,
        z_threshold: float = 4.0,
        alpha: float = 0.3,
        confirm: int = 3,
        rearm: int = 5,
        clock=time.monotonic,
        history: int = 64,
    ):
        if z_threshold <= 0:
            raise ValueError(f"z_threshold must be > 0, got {z_threshold}")
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if confirm < 1 or rearm < 1:
            raise ValueError("confirm/rearm must be >= 1 observations")
        self.z_threshold = z_threshold
        self.alpha = alpha
        self.confirm = confirm
        self.rearm = rearm
        self.clock = clock
        self.armed = True
        self.fired = 0
        self.incidents: list[dict] = []
        self.recorder = None
        self._detectors: dict[str, _Detector] = {}
        self._history: list[dict] = []
        self._history_limit = history

    def watch(
        self,
        name: str,
        baseline: float | None,
        spread: float,
        *,
        direction: str = "down_bad",
        warmup: int = 4,
    ) -> None:
        if direction not in ("down_bad", "up_bad"):
            raise ValueError(
                f"direction must be down_bad|up_bad, got {direction!r}"
            )
        if spread <= 0:
            raise ValueError(f"spread must be > 0, got {spread}")
        self._detectors[name] = _Detector(
            name=name,
            baseline=None if baseline is None else float(baseline),
            spread=float(spread),
            direction=+1 if direction == "up_bad" else -1,
            warmup=max(int(warmup), 1),
        )

    @property
    def signals(self) -> tuple[str, ...]:
        return tuple(sorted(self._detectors))

    def observe(self, name: str, value: float) -> dict | None:
        """Feed one live sample; returns the incident dict when THIS
        observation fired the trigger, else ``None``.  Unwatched names
        are ignored (the feed may offer more signals than the baseline
        could anchor)."""
        det = self._detectors.get(name)
        if det is None:
            return None
        value = float(value)
        det.samples += 1
        if det.baseline is None:
            # Self-baselining: the first `warmup` samples fix the
            # operating point; the RELATIVE band from the artifact
            # becomes absolute against it.
            det._warm.append(value)
            if len(det._warm) < det.warmup:
                return None
            det.baseline = sum(det._warm) / len(det._warm)
            det.spread = max(
                det.spread * abs(det.baseline), 1e-9
            )
            det._warm.clear()
            return None
        det.ewma = value if det.ewma is None else (
            det.ewma + self.alpha * (value - det.ewma)
        )
        z = (
            (det.ewma - det.baseline) / max(det.spread, 1e-9)
        ) * det.direction
        det.last_z = round(z, 3)
        self._history.append({
            "t": self.clock(), "signal": name,
            "value": round(value, 4), "z": det.last_z,
        })
        del self._history[: -self._history_limit]
        if z >= self.z_threshold:
            det.breaches += 1
            det.oks = 0
        else:
            det.oks += 1
            if det.oks >= self.rearm:
                det.breaches = 0
        incident = None
        if det.breaches >= self.confirm and self.armed:
            self.armed = False
            self.fired += 1
            incident = {
                "signal": name,
                "z": det.last_z,
                "ewma": round(det.ewma, 4),
                "baseline": round(det.baseline, 4),
                "spread": round(det.spread, 4),
                "t": self.clock(),
            }
            self.incidents.append(incident)
            if self.recorder is not None:
                self.recorder.trigger(
                    "perf_regression",
                    detail=(
                        f"{name} z={det.last_z} "
                        f"ewma={incident['ewma']} "
                        f"baseline={incident['baseline']} "
                        f"spread={incident['spread']}"
                    ),
                )
        elif not self.armed and all(
            d.breaches == 0 for d in self._detectors.values()
        ):
            # Every breached signal has recovered: re-arm so the NEXT
            # regression fires its own bundle.
            self.armed = True
        return incident

    def state(self) -> dict:
        """Detector state for flight-recorder bundles: baselines,
        smoothed values, z-scores, breach counters, the incident log
        and the last N raw observations."""
        return {
            "armed": self.armed,
            "fired": self.fired,
            "z_threshold": self.z_threshold,
            "alpha": self.alpha,
            "confirm": self.confirm,
            "rearm": self.rearm,
            "detectors": {
                name: {
                    "baseline": (
                        None if d.baseline is None
                        else round(d.baseline, 4)
                    ),
                    "spread": round(d.spread, 4),
                    "direction": (
                        "up_bad" if d.direction > 0 else "down_bad"
                    ),
                    "ewma": None if d.ewma is None else round(d.ewma, 4),
                    "last_z": d.last_z,
                    "breaches": d.breaches,
                    "oks": d.oks,
                    "samples": d.samples,
                }
                for name, d in sorted(self._detectors.items())
            },
            "incidents": [dict(i) for i in self.incidents],
            "recent": [dict(h) for h in self._history],
        }


def artifact_spread_fraction(
    artifact: dict, floor: float = 0.08
) -> float:
    """The committed artifact's own measured cross-run noise band: the
    median relative half-width of its pooled ``<key>_samples`` spread
    families (the same derivation tools/bench_diff.py uses for its
    spread-guarded thresholds), floored for artifacts that predate the
    samples."""
    widths = []
    for key in artifact:
        if not key.endswith("_samples"):
            continue
        base = key[: -len("_samples")]
        lo, hi, mid = (
            artifact.get(base + "_min"),
            artifact.get(base + "_max"),
            artifact.get(base),
        )
        if all(
            isinstance(v, (int, float)) for v in (lo, hi, mid)
        ) and mid:
            widths.append((hi - lo) / (2 * abs(mid)))
    if not widths:
        return floor
    widths.sort()
    return max(floor, widths[len(widths) // 2])


# Signal -> (artifact key carrying its baseline, bad direction).  The
# four live signals the ISSUE's sentry watches; keys absent from the
# artifact degrade to an unwatched signal, loudly listed in state().
_SENTRY_SIGNALS = (
    ("tokens_per_sec", "profiler_on_tokens_per_sec", "down_bad"),
    ("ttft_p99_ms", "serve_ttft_p99_ms", "up_bad"),
    ("host_sync_ms", "decode_host_sync_ms", "up_bad"),
    ("device_busy_fraction", "device_busy_fraction", "down_bad"),
)


def sentry_from_artifact(
    artifact: dict,
    *,
    live: bool = False,
    recorder=None,
    **kw,
) -> RegressionSentry:
    """Build the four-signal sentry from the committed bench artifact.

    ``live=False`` (tests, bench-shaped runs): baselines are the
    artifact's ABSOLUTE values, spreads its measured noise band times
    each baseline — in-band noise at the committed spread can never
    fire.  ``live=True`` (the serve CLI's fleet loop): the artifact
    contributes only the RELATIVE spread; each detector self-baselines
    from its first observed windows, because a CLI fleet on a different
    model shape must not be scored against the bench's absolute
    numbers.  Artifact keys that are missing leave their signal
    unwatched."""
    sentry = RegressionSentry(**kw)
    if recorder is not None:
        recorder.attach_sentry(sentry)
    rel = artifact_spread_fraction(artifact)
    for signal, key, direction in _SENTRY_SIGNALS:
        base = artifact.get(key)
        if signal == "tokens_per_sec" and not isinstance(
            base, (int, float)
        ):
            base = artifact.get("serve_tokens_per_sec")
        if not isinstance(base, (int, float)) or not base:
            continue
        if live:
            sentry.watch(signal, None, rel, direction=direction)
        else:
            sentry.watch(
                signal, float(base), rel * abs(float(base)),
                direction=direction,
            )
    return sentry


class SentryFeed:
    """Windowed signal extraction from a live fleet into the sentry:
    polled from the drive loop (next to ``FlightRecorder.poll``), it
    reads engine counters and observer rings — never device state —
    and feeds tokens/sec, host-sync ms/step, TTFT p99 and the
    device-busy fraction once per ``min_window_s`` window."""

    def __init__(
        self,
        sentry: RegressionSentry,
        *,
        min_window_s: float = 0.25,
        clock=time.perf_counter,
    ):
        self.sentry = sentry
        self.min_window_s = min_window_s
        self._clock = clock
        self._engines: list = []
        self._observers: list = []
        self._t_last: float | None = None
        self._tokens_last = 0
        self._sync_last = 0.0
        self._steps_last = 0
        self._spans_seen: dict[int, int] = {}
        self._ttft_ms: list[float] = []

    def attach(self, engine, observer=None) -> None:
        self._engines.append(engine)
        if observer is not None:
            self._observers.append(observer)

    def poll(self) -> list[dict]:
        """One windowed observation sweep; returns any incidents fired."""
        now = self._clock()
        if self._t_last is None:
            self._t_last = now
            self._tokens_last = self._total("generated_tokens")
            self._sync_last = self._total("host_sync_s")
            self._steps_last = sum(
                o._step_index for o in self._observers
            )
            return []
        window = now - self._t_last
        if window < self.min_window_s:
            return []
        incidents = []
        tokens = self._total("generated_tokens")
        d_tokens = tokens - self._tokens_last
        inc = self.sentry.observe("tokens_per_sec", d_tokens / window)
        if inc:
            incidents.append(inc)
        sync = self._total("host_sync_s")
        steps = sum(o._step_index for o in self._observers)
        d_steps = steps - self._steps_last
        if d_steps > 0:
            inc = self.sentry.observe(
                "host_sync_ms",
                (sync - self._sync_last) * 1000.0 / d_steps,
            )
            if inc:
                incidents.append(inc)
        for obs in self._observers:
            # Non-destructive new-span cursor: spans-ever-recorded is
            # ring length + counted evictions, so the feed never drains
            # (the trace export owns the rings) and never double-counts.
            ever = len(obs.spans) + obs.dropped_spans
            seen = self._spans_seen.get(id(obs), 0)
            fresh = min(ever - seen, len(obs.spans))
            self._spans_seen[id(obs)] = ever
            if fresh > 0:
                for span in list(obs.spans)[-fresh:]:
                    if span.ttft_secs is not None:
                        self._ttft_ms.append(span.ttft_secs * 1000.0)
        del self._ttft_ms[:-256]
        if self._ttft_ms:
            ordered = sorted(self._ttft_ms)
            p99 = ordered[
                min(int(len(ordered) * 0.99), len(ordered) - 1)
            ]
            inc = self.sentry.observe("ttft_p99_ms", p99)
            if inc:
                incidents.append(inc)
        fracs = [
            o.device_busy_fraction
            for o in self._observers
            if getattr(o, "_wall_ms", 0.0) > 0
        ]
        if fracs:
            inc = self.sentry.observe(
                "device_busy_fraction", sum(fracs) / len(fracs)
            )
            if inc:
                incidents.append(inc)
        self._t_last = now
        self._tokens_last = tokens
        self._sync_last = sync
        self._steps_last = steps
        return incidents

    def _total(self, attr: str) -> float:
        total = 0.0
        for eng in self._engines:
            try:
                total += float(getattr(eng, attr, 0) or 0)
            except Exception:
                pass
        return total


def load_committed_artifact(repo_root: str | None = None) -> dict | None:
    """The committed bench artifact the sentry baselines against — the
    port's own, ``docs/bench-torch-latest.json``, measured on the card —
    or ``None`` when absent/broken: the CLI degrades to no sentry rather
    than failing a serve run over a docs file."""
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    )
    path = os.path.join(root, "docs", "bench-torch-latest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
