"""Fast replica start: the kernel-build cache + warm-state snapshots.

The PyTorch port's own copy of ``workloads/faststart.py`` (the port
imports nothing of the JAX package).  A respawned or scaled-up replica
pays its engine build, its decode graph's capture and — for
``spec="auto"`` engines — the spec-breakeven calibration's dead
dispatches.  Two layers cut that:

**1. The kernel-build cache** (``enable_compile_cache``).  The port has
no jit cache; the persistent cache it has is ``ops/_build.py``: each
CUDA source is built by ``nvcc`` into a library named for the hash of
its source and flags, and a later process finds it built.
``enable_compile_cache(dir)`` points that build directory at ``dir``
(process-global: the last caller wins, as JAX's ``jax.config``); without
a call the default ``build/workloads_torch/`` stays.  ``cache_stats()``
counts ``hits`` (a library found built) and ``misses`` (a run of
``nvcc``), in every process and directory; the engine surfaces
per-engine deltas as ``engine_compile_cache_{hits,misses}_total``
(obs.py).  A library already loaded in the process is not looked up
again.

**2. The post-warmup engine snapshot** (``EngineSnapshot``), JAX's:
``capture()`` records the calibrated ``spec_breakeven`` with its
``spec_calibration`` evidence, the kernel-select table and the canary
probe with its oracle stream; ``prime(engine)`` injects them into a
fresh engine, whose first decode step then reuses the calibration
(``engine.calibration_reused`` counts the skips).  A snapshot cannot
carry a CUDA graph: a primed engine still captures its own.

tests/test_torch_copies.py holds every definition to JAX's but these:
``enable_compile_cache`` (the build directory, not ``jax.config``; no
``jax.monitoring`` listener, so no ``_on_event``),
``fingerprint_engine`` and ``EngineSnapshot.capture`` (``torch.__version__``
and the card's name from ``torch.cuda.get_device_name``, ``"cpu"`` for a
CPU engine, in place of ``jax.__version__`` and the device kind; ``"tp"``
is False: the port's engine has no mesh).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from .ops import _build

SNAPSHOT_VERSION = 1

# Process-global compile-cache state: one build directory per process
# (ops/_build.py's), and its monotonic counters.
_cache_dir: str | None = None
_stats = _build.cache_counts


def enable_compile_cache(cache_dir: str) -> str:
    """Point the kernel-build cache (``ops/_build.py``) at ``cache_dir``
    (created if missing): every kernel library built later in this
    process is written there, and one built there before — by this
    process or another — is loaded instead of rebuilt.  Idempotent:
    repeated calls with the same directory are no-ops; a DIFFERENT
    directory re-points the cache (process-global — the last caller
    wins, so fleets should share one directory)."""
    global _cache_dir
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    if _cache_dir != cache_dir:
        _build.set_build_dir(cache_dir)
        _cache_dir = cache_dir
    return cache_dir


def compile_cache_dir() -> str | None:
    """The directory the persistent cache currently writes to (None
    while disabled)."""
    return _cache_dir


def cache_stats() -> dict[str, int]:
    """Monotonic process-wide persistent-cache counters: ``hits`` are
    compiles served from disk, ``misses`` are compiles that ran XLA
    (and then populated the cache).  Engines read per-engine deltas
    off these (ServeEngine.compile_cache_hits/misses)."""
    return dict(_stats)


def _scalar(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) else None


def _config_dict(config) -> dict:
    """A ModelConfig (or any config object) as a scalars-only dict —
    the model half of the fingerprint."""
    import dataclasses

    if dataclasses.is_dataclass(config):
        raw = dataclasses.asdict(config)
    else:
        raw = dict(vars(config))
    return {k: _scalar(v) if _scalar(v) is not None else str(v)
            for k, v in sorted(raw.items())}


def fingerprint_engine(engine) -> str:
    """The compatibility key for one live engine: every knob that
    shapes its graphs or the calibration verdict — model + draft
    configs, batch/page geometry, decode-mode knobs, sampling, LoRA
    census — plus the torch version and the card's name (a threshold
    measured on one card says nothing about another).  Params VALUES
    are deliberately excluded: the snapshot carries no tensors, and
    timing verdicts depend on shapes, not weights."""
    import hashlib

    import torch

    payload = {
        "version": SNAPSHOT_VERSION,
        "torch": torch.__version__,
        "device": _device_name(engine),
        "config": _config_dict(engine.config),
        "draft_config": (
            _config_dict(engine.draft_config)
            if engine.draft_config is not None else None
        ),
        "engine": {
            "slots": engine.slots,
            "page_size": engine.page_size,
            "chunk": engine.chunk,
            "prompt_bucket": engine.prompt_bucket,
            "temperature": engine.temperature,
            "top_k": engine.top_k,
            "top_p": engine.top_p,
            "gamma": engine.gamma,
            "spec": engine.spec,
            "spec_lookahead": engine.spec_lookahead,
            "spec_superstep_k": engine.spec_superstep_k,
            "superstep_k": engine.superstep_k,
            "pipelined": engine.pipelined,
            "adapters": sorted(engine._adapter_ids),
            "lora_alpha": engine.lora_alpha,
            "tp": False,
        },
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _device_name(engine) -> str:
    """The card's name for a CUDA engine, ``"cpu"`` for a CPU one."""
    if engine.device.type != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(engine.device)


def _device_table_dict(engine) -> dict | None:
    """The engine observer's device-time calibration table
    (workloads/profiler.py ``DeviceTimeTable``) as a JSON-able dict,
    or ``None`` when the engine carries no observer/table — snapshots
    persist the warmup calibration so a primed replica attributes
    device time from its first served request."""
    obs = getattr(engine, "_obs", None)
    table = getattr(obs, "device_table", None)
    if table is None or not len(table):
        return None
    return table.to_dict()


@dataclass
class EngineSnapshot:
    """The host-side warmed state of one served engine, captured after
    warmup + calibration so later spawns of the SAME shape skip both.
    Versioned + config-fingerprinted; ``prime``/``compatible`` reject
    mismatches (fall back to the cold path) rather than ever serving a
    wrong table or threshold.  JSON round-trippable — small enough to
    ship next to the weights."""

    config_key: str
    version: int = SNAPSHOT_VERSION
    spec_breakeven: float | None = None
    spec_calibration: dict | None = None
    kernel_table: dict[int, str] | None = None
    probe: tuple[list[int], int] | None = None
    probe_oracle: list[int] | None = None
    device_time_table: dict | None = None
    meta: dict = field(default_factory=dict)

    @classmethod
    def capture(
        cls, engine, *, probe=None, probe_oracle=None,
    ) -> "EngineSnapshot":
        """Snapshot a WARMED engine: its calibration verdict (when the
        first decode step has run one — ``spec="auto"`` engines), the
        process-wide kernel-select table, and the canary contract the
        supervisor/autoscaler held it to."""
        import torch

        from .ops.kernel_select import kernel_table

        table = kernel_table()
        return cls(
            config_key=fingerprint_engine(engine),
            spec_breakeven=(
                float(engine.spec_breakeven)
                if engine.spec_breakeven is not None else None
            ),
            spec_calibration=(
                dict(engine.spec_calibration)
                if engine.spec_calibration is not None else None
            ),
            kernel_table=(
                {int(b): impl for b, impl in table}
                if table is not None else None
            ),
            probe=(
                ([int(t) for t in probe[0]], int(probe[1]))
                if probe is not None else None
            ),
            probe_oracle=(
                [int(t) for t in probe_oracle]
                if probe_oracle is not None else None
            ),
            device_time_table=_device_table_dict(engine),
            meta={
                "torch": torch.__version__,
                "device": _device_name(engine),
                "created_unix": time.time(),
                "compile_cache_dir": _cache_dir,
            },
        )

    # ---- compatibility ---------------------------------------------------

    def compatible(self, engine) -> bool:
        """True iff this snapshot was captured from an engine of the
        SAME shape as ``engine`` (version + full config fingerprint) —
        the stale-snapshot gate every consumer checks before reuse."""
        return (
            self.version == SNAPSHOT_VERSION
            and self.config_key == fingerprint_engine(engine)
        )

    def prime(self, engine) -> bool:
        """Inject the warmed state into a freshly built engine.
        Returns True iff the snapshot applied; an incompatible
        (stale/foreign) snapshot is a no-op False — the engine keeps
        its cold path and calibrates itself.  Calibration injection
        rides the engine's lazy ``_calibrate_breakeven`` seam, so the
        skip lands (and ``calibration_reused`` ticks) at the first
        decode step, exactly where the dead dispatches would have
        run."""
        if not self.compatible(engine):
            return False
        if self.kernel_table is not None:
            from .ops.kernel_select import set_kernel_table

            set_kernel_table(self.kernel_table)
        if (
            self.spec_calibration is not None
            and engine.spec == "auto"
            and engine.spec_breakeven is None
            and engine._injected_calibration is None
        ):
            engine._injected_calibration = dict(self.spec_calibration)
        elif (
            self.spec_breakeven is not None
            and engine.spec == "auto"
            and engine.spec_breakeven is None
            and engine._injected_calibration is None
        ):
            # A snapshot carrying only the verdict (no evidence dict)
            # still skips the dead dispatches.
            engine._injected_calibration = {
                "threshold": float(self.spec_breakeven)
            }
        if self.device_time_table:
            obs = getattr(engine, "_obs", None)
            table = getattr(obs, "device_table", None)
            if table is not None:
                # Live entries win inside load() — a snapshot seeds the
                # device-time attribution, it never overwrites fresher
                # measurements.
                table.load(self.device_time_table)
        return True

    def engine_kw(self) -> dict:
        """Constructor-time injection kwargs for ``ServeEngine`` — the
        factory path (`make_engine_factory(snapshot=...)`) prefers
        ``prime`` post-build (which can fingerprint-check), but callers
        composing their own kwargs can merge these."""
        kw: dict = {}
        if self.spec_calibration is not None:
            kw["spec_calibration"] = dict(self.spec_calibration)
        return kw

    # ---- (de)serialization ----------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "config_key": self.config_key,
            "spec_breakeven": self.spec_breakeven,
            "spec_calibration": self.spec_calibration,
            "kernel_table": self.kernel_table,
            "probe": (
                [self.probe[0], self.probe[1]]
                if self.probe is not None else None
            ),
            "probe_oracle": self.probe_oracle,
            "device_time_table": self.device_time_table,
            "meta": self.meta,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "EngineSnapshot":
        d = json.loads(blob)
        probe = d.get("probe")
        return cls(
            config_key=d["config_key"],
            version=int(d.get("version", -1)),
            spec_breakeven=d.get("spec_breakeven"),
            spec_calibration=d.get("spec_calibration"),
            kernel_table=(
                {int(b): impl for b, impl in d["kernel_table"].items()}
                if d.get("kernel_table") is not None else None
            ),
            probe=(
                ([int(t) for t in probe[0]], int(probe[1]))
                if probe is not None else None
            ),
            probe_oracle=d.get("probe_oracle"),
            device_time_table=d.get("device_time_table"),
            meta=dict(d.get("meta") or {}),
        )

    # Snapshot artifacts that fail to parse (truncated by a crash
    # mid-copy, bit-flipped, wrong schema) degrade to the cold path:
    # ``load`` returns None and bumps this counter instead of raising —
    # a warm-start artifact must never be able to stop a cold start.
    load_errors = 0

    def save(self, path: str) -> str:
        from .durable import atomic_write_text

        atomic_write_text(path, self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "EngineSnapshot | None":
        """Parse a saved snapshot, or None (counted in
        ``EngineSnapshot.load_errors``) when the artifact is absent,
        truncated, or corrupt — the caller cold-starts."""
        try:
            with open(path) as f:
                return cls.from_json(f.read())
        except (OSError, ValueError, KeyError, TypeError):
            cls.load_errors += 1
            return None
