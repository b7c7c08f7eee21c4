"""Engine observability: request-lifecycle spans, per-step records, and
a Prometheus bridge for ServeEngine.

The plugin half of this repo treats observability as a subsystem
(tpu_device_plugin/metrics.py: a dependency-free Registry + /metrics
endpoint); this module gives the serving half the same surface.  An
``EngineObserver`` is OPT-IN (``ServeEngine(observer=...)``) and records
at the engine's existing seams — admission, decode dispatch (spec vs
plain), readbacks, retirement — three views of the same run:

  1. **Request lifecycle spans** (``RequestSpan``): queued → admitted →
     first-token → done, with the queue-wait / prefill / decode segments
     derived from the Request's host-side stamps (``t_submit`` /
     ``t_admit`` / ``t_first`` / ``t_done``).
  2. **Per-step engine records** (``StepRecord``): step index, slot
     occupancy, admissions coalesced, retirements, decode mode,
     dispatch counts, host readback time — in a bounded ring with a
     ``drain_steps()`` API mirroring ``engine.drain_completed()``.
  3. **A Prometheus bridge** (``bind_registry``): counters, scrape-time
     gauges and seconds-scale histograms on the shared Registry, served
     by the existing MetricsServer next to the plugin's own metrics.

The observer is deliberately INERT: it never touches device state, RNG
keys, scheduling or page accounting, so token streams are bit-identical
with it on or off (pinned by tests/test_obs.py) and its cost is priced
by the perf bench (``obs_overhead_pct``).  ``trace_events`` renders the
rings as a chrome://tracing-loadable timeline (tools/trace_export.py is
the CLI/validator side).

This module is importable WITHOUT jax — it handles host-side stamps and
counters only — so the metrics lint and trace tooling stay fast.

The PyTorch port's own copy of ``workloads/obs.py`` (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds every
definition to it, but for the device time of a card engine.  There JAX's
``StepRecord.device_ms``, the step's wall less its host-sync stall, is
not the device's time: the wall holds host work the device overlaps, and
the host also waits outside the syncs (in graph launches behind a full
queue).  Over the benchmark's generate traffic on an H100 it read 86% of
the profiler's device busy time for the same steps.  So on the card the
engine brackets each prefill sweep and each decode dispatch with a pair
of CUDA timing events, read at the host sync that reads the work back,
and ``StepRecord`` carries ``prefill_device_ms`` and
``decode_device_ms``, whose sum is ``device_ms`` (``StepRecord``,
``EngineObserver._step_begin``/``_step_end``; ``trace_events`` draws the
two on the device lane).  CPU engines keep JAX's derivation, and
``device_table`` (profiler.py's ``DeviceTimeTable``) calibrates it as in
JAX; on the card the table takes the event time.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field, fields

# Seconds-scale histogram ladder for serving latencies.  The Registry's
# default LATENCY_BUCKETS top out at 1.0 s (tuned for Allocate handler
# latency); serve TTFT/e2e routinely exceed that, so the engine families
# override per-family buckets (metrics.Registry.describe(buckets=...)).
SERVE_SECONDS_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0,
)

# Device-time-scale ladder (workloads/profiler.py): per-dispatch device
# windows sit well under a millisecond on real chips, where the serving
# ladder's 5 ms floor would flatten every observation into one bucket —
# so `engine_device_seconds` gets its own sub-millisecond floor.
DEVICE_SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)


@dataclass(frozen=True)
class MetricSpec:
    """One engine metric family as exposed on the Registry — the single
    source for bind_registry, the metrics lint test, and the rendered
    docs/OBSERVABILITY.md catalog (render_bench_docs)."""

    name: str
    type: str  # "counter" | "gauge" | "histogram"
    labels: tuple[str, ...]
    help: str


# Every family the bridge ever emits.  The lint test
# (tests/test_metrics_lint.py) cross-checks this catalog against the
# names the code actually inc()s / observe_seconds()s, and the rendered
# metric catalog in docs/OBSERVABILITY.md is generated from it — three
# consumers, one spec, no drift.
ENGINE_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "engine_tokens_total", "counter", ("engine",),
        "tokens emitted by the serving engine",
    ),
    MetricSpec(
        "engine_requests_admitted_total", "counter", ("engine",),
        "requests admitted into engine slots (instant-finish included)",
    ),
    MetricSpec(
        "engine_requests_retired_total", "counter", ("engine",),
        "requests retired by the serving engine",
    ),
    MetricSpec(
        "engine_mode_switches_total", "counter", ("engine",),
        'spec="auto" decode-mode boundary crossings (each drains the '
        "other mode's pipelined in-flight state)",
    ),
    MetricSpec(
        "engine_decode_steps_total", "counter", ("engine", "mode"),
        "decode dispatches by mode (plain chunk vs speculative superstep)",
    ),
    MetricSpec(
        "engine_prefill_dispatches_total", "counter", ("engine",),
        "target prefill program dispatches (admission sweeps and chunks)",
    ),
    MetricSpec(
        "engine_prefill_deferred_tokens_total", "counter", ("engine",),
        "prompt tokens whose prefill the per-step budget parked for a "
        "later step (prefill_budget chunked-prefill interleaving)",
    ),
    MetricSpec(
        "engine_prefill_inflight", "gauge", ("engine",),
        "admissions currently parked mid-prefill by the step budget "
        "(scrape-time)",
    ),
    MetricSpec(
        "engine_requests_cancelled_total", "counter", ("engine",),
        "requests cancelled via engine.cancel (queued or running)",
    ),
    MetricSpec(
        "engine_requests_expired_total", "counter", ("engine",),
        "requests whose deadline_s passed before completion",
    ),
    MetricSpec(
        "engine_requests_failed_total", "counter", ("engine",),
        "requests failed terminally (retry budget exhausted, or the "
        "engine closed over them)",
    ),
    MetricSpec(
        "engine_requests_retried_total", "counter", ("engine",),
        "replay requeues after a quarantined step (prompt + emitted "
        "tokens re-prefilled; greedy streams resume bit-identically)",
    ),
    MetricSpec(
        "engine_queue_rejections_total", "counter", ("engine",),
        "submissions rejected by bounded admission (max_pending)",
    ),
    MetricSpec(
        "engine_calibration_reused_total", "counter", ("engine",),
        'spec="auto" break-even calibrations adopted from an injected '
        "warm-state snapshot instead of re-running the dead timing "
        "dispatches (workloads/faststart.py EngineSnapshot)",
    ),
    MetricSpec(
        "engine_compile_cache_hits_total", "counter", ("engine",),
        "persistent-compile-cache hits during this engine's lifetime "
        "(executables replayed from disk instead of recompiled — "
        "faststart.enable_compile_cache / --compile-cache-dir)",
    ),
    MetricSpec(
        "engine_compile_cache_misses_total", "counter", ("engine",),
        "persistent-compile-cache misses during this engine's lifetime "
        "(compiles that ran XLA and then populated the cache — the "
        "cold-spawn signature)",
    ),
    MetricSpec(
        "engine_queue_depth", "gauge", ("engine",),
        "requests waiting in the pending queue (scrape-time)",
    ),
    MetricSpec(
        "engine_slot_occupancy", "gauge", ("engine",),
        "batch slots currently decoding a request (scrape-time)",
    ),
    MetricSpec(
        "engine_slots", "gauge", ("engine",),
        "total batch slots the engine was built with",
    ),
    MetricSpec(
        "engine_resident_pages", "gauge", ("engine",),
        "KV-cache pages currently held by live sequences (scrape-time)",
    ),
    MetricSpec(
        "engine_prefix_hit_pages_total", "counter", ("engine",),
        "prompt pages served from the prefix cache (radix or flat) "
        "instead of re-prefilling — host-RAM reloads included",
    ),
    MetricSpec(
        "engine_prefix_miss_total", "counter", ("engine",),
        "prefix-cache lookups that matched nothing (the prompt "
        "prefilled from scratch)",
    ),
    MetricSpec(
        "engine_kv_offloaded_pages", "gauge", ("engine",),
        "KV pages currently parked in the host-RAM offload tier "
        "(kv_offload; scrape-time — state held without holding HBM)",
    ),
    MetricSpec(
        "engine_kv_disk_pages", "gauge", ("engine",),
        "KV pages durable in the disk tier below host RAM "
        "(--kv-disk-dir; per-page files named by chain key, shared "
        "across replicas and processes — scrape-time)",
    ),
    MetricSpec(
        "engine_paused", "gauge", ("engine",),
        "1 while the health bridge holds admission paused on an "
        "Unhealthy chip (scrape-time; fleet routers read this as the "
        "replica's drain signal)",
    ),
    MetricSpec(
        "engine_tokens_overdecoded_total", "counter", ("engine",),
        "device decode steps computed past a row's retirement point "
        "(dead decode-superstep compute, reconciled at each fused "
        "readback)",
    ),
    MetricSpec(
        "engine_observer_dropped_steps_total", "counter", ("engine",),
        "step records the observer's bounded ring evicted UNREAD "
        "(drain_steps too rarely) — non-zero means the scraped "
        "timeline is silently truncated",
    ),
    MetricSpec(
        "engine_observer_dropped_spans_total", "counter", ("engine",),
        "lifecycle spans the observer's bounded ring evicted unread — "
        "silent span loss made visible",
    ),
    MetricSpec(
        "engine_ttft_seconds", "histogram", ("engine",),
        "submission -> first observed token (queue wait included)",
    ),
    MetricSpec(
        "engine_host_sync_seconds", "histogram", ("engine",),
        "wall time one engine step spent BLOCKED in host syncs "
        "(readbacks + fused consumes — the per-step tax decode "
        "supersteps amortize)",
    ),
    MetricSpec(
        "engine_e2e_seconds", "histogram", ("engine",),
        "submission -> retirement end-to-end latency",
    ),
    MetricSpec(
        "engine_step_seconds", "histogram", ("engine",),
        "wall time of one engine step() (admit + dispatch + consume)",
    ),
    MetricSpec(
        "engine_device_seconds", "histogram", ("engine",),
        "DEVICE time of one step: on a card engine the CUDA-event time "
        "of the prefill sweeps and decode dispatches the step read back "
        "(a pipelined chunk on the step after its dispatch); on the CPU "
        "the step wall minus the engine-measured host-sync stall, "
        "smoothed through the per-(program, seq-bucket, batch-bucket) "
        "calibration table when one is attached (profiler.py); "
        "sub-millisecond DEVICE_SECONDS_BUCKETS ladder",
    ),
    MetricSpec(
        "engine_device_busy_fraction", "gauge", ("engine",),
        "fraction of observed step wall the device was busy: summed "
        "engine_device_seconds over summed step wall (scrape-time, "
        "cumulative over this observer's run; CUDA-event time on a "
        "card engine — the device-side split of the chip-second the "
        "ledger charges)",
    ),
    MetricSpec(
        "engine_host_stall_fraction", "gauge", ("engine",),
        "1 - engine_device_busy_fraction: observed step wall spent "
        "host-stalled (readbacks, scheduling, idle admission polls)",
    ),
)

# Fleet-level metric families (workloads/fleet.py; FleetObserver below).
# Same three-consumer contract as ENGINE_METRICS: bind_fleet metrics,
# the lint test, and the rendered docs/OBSERVABILITY.md catalog all read
# this spec.  Engine families additionally carry a ``replica`` label in
# fleet mode (EngineObserver(replica=...)); single-engine output is
# byte-compatible when the label is left at its empty default.
FLEET_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "fleet_requests_total", "counter", ("fleet",),
        "requests accepted into the fleet router queue",
    ),
    MetricSpec(
        "fleet_tokens_total", "counter", ("fleet",),
        "tokens generated across every live replica",
    ),
    MetricSpec(
        "fleet_failovers_total", "counter", ("fleet",),
        "charged failover requeues after true replica faults "
        "(crash/hang/escaped exception; replay re-prefills prompt + "
        "emitted tokens on a survivor)",
    ),
    MetricSpec(
        "fleet_drain_requeues_total", "counter", ("fleet",),
        "uncharged requeues off health-paused or operator-removed "
        "replicas (a sick chip is not the request's fault)",
    ),
    MetricSpec(
        "fleet_queue_rejections_total", "counter", ("fleet",),
        "submissions rejected by the fleet-wide admission bound "
        "(max_pending)",
    ),
    MetricSpec(
        "fleet_replica_failures_total", "counter", ("fleet", "kind"),
        "replicas lost, by failure kind (crash vs hang)",
    ),
    MetricSpec(
        "fleet_queue_depth", "gauge", ("fleet",),
        "requests waiting in the fleet router queue (scrape-time)",
    ),
    MetricSpec(
        "fleet_replicas", "gauge", ("fleet", "state"),
        "replicas by state (active / draining / dead; scrape-time)",
    ),
    MetricSpec(
        "fleet_replica_state", "gauge", ("fleet", "replica", "state"),
        "1 for each live replica's current router state "
        "(active/draining — the per-replica drain signal; scrape-time)",
    ),
    MetricSpec(
        "fleet_replica_paused", "gauge", ("fleet", "replica"),
        "1 while the replica's engine is health-paused (scrape-time)",
    ),
    MetricSpec(
        "fleet_queue_wait_seconds", "histogram", ("fleet",),
        "submission -> first admission into any replica's slots, "
        "pooled across the fleet",
    ),
    MetricSpec(
        "fleet_ttft_seconds", "histogram", ("fleet",),
        "submission -> first streamed token, pooled across the fleet "
        "(failover re-admissions do not reset it)",
    ),
    MetricSpec(
        "fleet_e2e_seconds", "histogram", ("fleet",),
        "submission -> terminal status, pooled across the fleet",
    ),
    # Per-SLO-class attainment (Fleet.submit(slo_class=...)): the exact
    # inputs the ROADMAP's SLO-class scheduler and autoscaler consume —
    # attainment per class, not just global percentiles.
    MetricSpec(
        "fleet_slo_requests_total", "counter", ("fleet", "slo_class"),
        "SLO-classed requests that reached a terminal status "
        "(cancelled requests are excluded — a client abort is not an "
        "SLO verdict)",
    ),
    MetricSpec(
        "fleet_slo_attained_total", "counter", ("fleet", "slo_class"),
        "SLO-classed requests that finished ok WITHIN their class "
        "targets (TTFT-bound interactive, TPOT-bound bulk); "
        "attained/requests is the per-class attainment ratio",
    ),
    MetricSpec(
        "fleet_slo_burn_rate", "gauge", ("fleet", "slo_class"),
        "windowed error-budget burn rate per class (miss fraction over "
        "the sliding slo_window_s divided by the class's error budget "
        "1-objective; 1.0 = burning exactly the budget, >1 = an SRE "
        "multi-window alert would fire; scrape-time)",
    ),
    MetricSpec(
        "fleet_class_ttft_seconds", "histogram", ("fleet", "slo_class"),
        "submission -> first streamed token, by SLO class (the "
        "interactive class's bound)",
    ),
    MetricSpec(
        "fleet_class_tpot_seconds", "histogram", ("fleet", "slo_class"),
        "per-token decode time (first token -> done over tokens-1), by "
        "SLO class (the bulk class's bound)",
    ),
    # Disaggregated prefill/decode pools (Fleet(roles=...), docs/
    # SERVING.md "Disaggregated prefill/decode"): KV handoff volume and
    # latency, the per-class WFQ dispatch split, and the live role map.
    MetricSpec(
        "fleet_kv_handoffs_total", "counter", ("fleet",),
        "prefill→decode KV handoffs: prompts whose finished pages were "
        "exported off a prefill-pool replica and continued on the "
        "decode pool (greedy streams bit-identical to mixed dispatch)",
    ),
    MetricSpec(
        "fleet_handoff_pages_total", "counter", ("fleet",),
        "KV pages adopted from handoff tickets by decode-pool replicas "
        "(grafted into the target's radix index; reloaded on the "
        "admission sweep)",
    ),
    MetricSpec(
        "fleet_handoff_seconds", "histogram", ("fleet",),
        "prefill-done -> first decode-pool token per handed-off stream "
        "(the bench's disagg_handoff_ms window)",
    ),
    MetricSpec(
        "fleet_wfq_dispatches_total", "counter", ("fleet", "slo_class"),
        "fresh-prompt dispatches granted by the SLO-class weighted "
        "fair queue, by class (wfq_weights=; continuations are free — "
        "they already hold service)",
    ),
    MetricSpec(
        "fleet_replica_role", "gauge", ("fleet", "replica", "role"),
        "1 for each live replica's disaggregation role "
        "(prefill/decode/mixed; scrape-time)",
    ),
    # KV pages as the schedulable unit (Fleet(page_scheduling=True),
    # docs/SERVING.md "Memory as the schedulable unit"): page-granular
    # dispatch volume, live-signal snapshot publications for the device
    # plugin's GetPreferredAllocation scorer, and the free-page headroom
    # the page-aware admission bound scales with.
    MetricSpec(
        "fleet_page_dispatches_total", "counter", ("fleet",),
        "dispatches routed by the page-granular load view (pages held "
        "+ pages the queued work will claim, goodput-penalized) "
        "instead of request counts (page_scheduling=True)",
    ),
    MetricSpec(
        "fleet_stats_published_total", "counter", ("fleet",),
        "live-signal snapshots atomically published to the host-local "
        "stats file the device plugin's preferred-allocation scorer "
        "reads (Fleet.publish_stats; tpu_device_plugin/kvsched.py)",
    ),
    MetricSpec(
        "fleet_free_pages", "gauge", ("fleet", "tier"),
        "aggregate free KV pages across live replicas, by tier (hbm = "
        "unallocated pool pages, host = offload-tier headroom; "
        "scrape-time — the page-aware admission bound's inputs)",
    ),
    # Durable sessions (Fleet(journal_dir=...), docs/SERVING.md
    # "Durable sessions"): session-journal checkpoint volume, injected
    # torn writes, and sessions resurrected by Fleet.restore after a
    # full process restart.
    MetricSpec(
        "fleet_journal_writes_total", "counter", ("fleet",),
        "session-journal checkpoints durably written (atomic, with "
        "the previous generation kept beside the current one as the "
        "torn-write recovery point)",
    ),
    MetricSpec(
        "fleet_journal_torn_total", "counter", ("fleet",),
        "journal checkpoints torn mid-write (the journal_torn_write "
        "chaos seam) — each one left the previous generation as the "
        "restore point, at most one checkpoint interval of progress "
        "lost",
    ),
    MetricSpec(
        "fleet_sessions_restored_total", "counter", ("fleet",),
        "sessions resurrected from the journal + disk tier by "
        "Fleet.restore after a full process restart (greedy "
        "continuations bit-identical to the uninterrupted stream; "
        "interrupted streams true prefixes)",
    ),
    MetricSpec(
        "fleet_observer_dropped_spans_total", "counter", ("fleet",),
        "fleet-request spans the observer's bounded ring evicted "
        "unread — the merged trace and postmortem bundles are "
        "silently missing exactly this many requests",
    ),
)

# Supervisor-level metric families (workloads/supervisor.py;
# SupervisorObserver below).  Same three-consumer contract as
# ENGINE_METRICS / FLEET_METRICS: bind_registry, the lint test, and the
# rendered docs/OBSERVABILITY.md catalog all read this spec.
SUPERVISOR_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "supervisor_restarts_total", "counter", ("supervisor",),
        "replicas resurrected onto their chip slot (half-open canary "
        "probe passed bit-identically, replica rejoined the router)",
    ),
    MetricSpec(
        "supervisor_restart_failures_total", "counter", ("supervisor",),
        "failed resurrection attempts (respawn seam fault, engine "
        "factory error, or half-open probe divergence) — each feeds "
        "the crash-loop window and escalates the slot's backoff",
    ),
    MetricSpec(
        "supervisor_crash_loops_total", "counter", ("supervisor",),
        "crash-loop verdicts: crash_loop_k failures inside the sliding "
        "window (or a max_restarts budget exhausted) quarantined the "
        "chip slot until an operator clear()",
    ),
    MetricSpec(
        "supervisor_health_deferrals_total", "counter", ("supervisor",),
        "resurrections deferred because the chip slot carried a live "
        "HealthFanout Unhealthy mark (honored, not escalated)",
    ),
    MetricSpec(
        "supervisor_slots", "gauge", ("supervisor", "state"),
        "supervised chip slots by state (serving / backoff / probing / "
        "quarantined / forgotten; scrape-time)",
    ),
    MetricSpec(
        "supervisor_restore_seconds", "histogram", ("supervisor",),
        "replica death detection -> probed replacement rejoined the "
        "router (the bench's selfheal_restore_ms window)",
    ),
    MetricSpec(
        "supervisor_dropped_events_total", "counter", ("supervisor",),
        "supervision-timeline events the bounded ring evicted unread "
        "— the merged trace's supervisor lane and postmortem bundles "
        "are silently missing exactly this many transitions",
    ),
)

# Autoscaler-level metric families (workloads/autoscaler.py;
# AutoscalerObserver below).  Same three-consumer contract as the other
# catalogs: bind_registry, the lint test, and the rendered
# docs/OBSERVABILITY.md catalog all read this spec.
AUTOSCALER_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "autoscaler_decisions_total", "counter", ("autoscaler", "action"),
        "control-loop decisions by action (scale_up / scale_down / "
        "spawn_failed / brownout / brownout_clear / preempt / "
        "preempt_clear) — the audit trail of every actuation the "
        "closed loop took",
    ),
    MetricSpec(
        "autoscaler_scale_ups_total", "counter", ("autoscaler",),
        "replicas added by the control loop (engine_factory spawn + "
        "bit-identical canary probe passed + add_replica; supervised "
        "fleets adopt the new slot so it heals like a founder)",
    ),
    MetricSpec(
        "autoscaler_scale_downs_total", "counter", ("autoscaler",),
        "replicas retired by the control loop (graceful drain of the "
        "least-loaded ACTIVE replica, removed once idle — never below "
        "min_replicas, never the last dispatchable one)",
    ),
    MetricSpec(
        "autoscaler_spawn_failures_total", "counter", ("autoscaler",),
        "failed scale-up attempts (scale_spawn_fail seam fault, engine "
        "factory error, or canary divergence) — each escalates the "
        "up-gate backoff; persistent failure is what drops the fleet "
        "onto the degradation ladder",
    ),
    MetricSpec(
        "autoscaler_brownouts_total", "counter", ("autoscaler",),
        "degradation-ladder step-1 entries: the capacity-aware "
        "admission bound tightened to brownout_factor while overload "
        "outran elastic capacity (typed QueueFull names the brownout)",
    ),
    MetricSpec(
        "autoscaler_preemptions_total", "counter", ("autoscaler",),
        "degradation-ladder step-2 preemptions: running bulk-class "
        "streams parked via host offload (RadixKV.park) and requeued "
        "uncharged for post-spike resumption as exact continuations",
    ),
    MetricSpec(
        "autoscaler_ladder_level", "gauge", ("autoscaler",),
        "current degradation-ladder level (0 = normal, 1 = brownout, "
        "2 = preemption-via-offload; scrape-time)",
    ),
    MetricSpec(
        "autoscaler_replicas_target", "gauge", ("autoscaler",),
        "replicas the control loop currently wants (provisioned plus "
        "in-flight resurrections, clamped to [min_replicas, "
        "max_replicas]; scrape-time)",
    ),
    MetricSpec(
        "autoscaler_replicas_live", "gauge", ("autoscaler",),
        "replicas actually alive in the fleet right now (target vs "
        "live is the convergence lag the step-load bench measures; "
        "scrape-time)",
    ),
)

# Goodput-controller families (workloads/control.py; ControlObserver
# below).  Same three-consumer contract as the other catalogs:
# bind_registry, the lint test, and the rendered docs/OBSERVABILITY.md
# catalog all read this spec.
CONTROL_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "control_decisions_total", "counter", ("controller", "action"),
        "goodput-control decisions by action (retune / wfq_reweight / "
        "hold) — the audit trail of every ledger-driven actuation the "
        "online retuning loop took",
    ),
    MetricSpec(
        "control_retunes_total", "counter", ("controller",),
        "ServeEngine.retune() transitions the controller applied "
        "(spec_breakeven shifts, superstep_k / spec_superstep_k steps "
        "— each drained in-flight state first, so greedy streams stay "
        "bit-identical across the knob move)",
    ),
    MetricSpec(
        "control_wfq_reweights_total", "counter", ("controller",),
        "live Fleet.wfq_weights updates from measured per-class "
        "goodput-per-chip-second (operator weights remain the floor; "
        "wasteful classes stop buying dispatch credit)",
    ),
    MetricSpec(
        "control_dropped_events_total", "counter", ("controller",),
        "control-timeline events the bounded ring evicted unread — "
        "the merged trace's supervisor lane is silently missing "
        "exactly this many actuations",
    ),
    MetricSpec(
        "control_goodput_fraction", "gauge", ("controller",),
        "the controller's EWMA-smoothed view of the fleet's goodput "
        "fraction — the signal the retune/reweight/waste-budget "
        "decisions read (scrape-time; absent until the ledger has "
        "accounted a measurable delta)",
    ),
    MetricSpec(
        "control_spec_rejected_fraction", "gauge", ("controller",),
        "EWMA share of newly-accounted device work going to rejected "
        "speculative drafts — the speculation-retune input "
        "(scrape-time; absent until measured)",
    ),
    MetricSpec(
        "control_overdecode_fraction", "gauge", ("controller",),
        "EWMA share of newly-accounted device work going to "
        "overdecode (chained superstep chunks past retirement) — the "
        "superstep-retune input (scrape-time; absent until measured)",
    ),
)

# Chip-time ledger families (workloads/ledger.py; docs/OBSERVABILITY.md
# "Chip-time ledger, goodput & postmortems").  Same three-consumer
# contract as the other catalogs: the engine/fleet bridges push them
# when a ledger is armed, the lint test cross-checks, the docs render
# from this spec.  The engine families ride the EngineObserver (per
# replica in fleet mode); the fleet families ride the FleetObserver.
LEDGER_METRICS: tuple[MetricSpec, ...] = (
    MetricSpec(
        "ledger_chip_seconds_total", "counter", ("engine", "phase"),
        "chip-time attribution: wall seconds of engine work by phase "
        "(prefill / decode / spec_draft / spec_verify / spec_commit / "
        "kv_spill / kv_reload / kv_handoff / probe / warmup / idle) — "
        "sum(phases) == total observed wall, every second lands in "
        "exactly one phase",
    ),
    MetricSpec(
        "ledger_tokens_total", "counter", ("engine", "class"),
        "token accounting by class: goodput (delivered to an "
        "ok-terminal stream) vs the named waste taxonomy (overdecode, "
        "spec_rejected, replay, preempt_recompute, cancelled, "
        "probe_warmup); goodput + waste + pending == every token's "
        "worth of device work the ledger charged",
    ),
    MetricSpec(
        "ledger_busy_fraction", "gauge", ("engine",),
        "fraction of the engine's observed wall time in any non-idle "
        "phase (scrape-time — the serving-side pendant of the "
        "plugin's aggregate_chip_busy_fraction north star)",
    ),
    MetricSpec(
        "ledger_goodput_fraction", "gauge", ("engine",),
        "goodput tokens over every token's worth of device work "
        "charged (scrape-time; 1.0 = zero waste)",
    ),
    MetricSpec(
        "ledger_pending_tokens", "gauge", ("engine",),
        "tokens charged but not yet classified (their request has no "
        "terminal status yet; scrape-time — drains to 0 at quiescence "
        "on a standalone engine)",
    ),
    MetricSpec(
        "ledger_waste_chip_seconds", "gauge", ("engine", "class"),
        "estimated chip-SECONDS behind each waste class (the phase "
        "times scaled by the class's token share of its phase — an "
        "attribution model, documented in workloads/ledger.py; "
        "scrape-time)",
    ),
    MetricSpec(
        "fleet_ledger_tokens_total", "counter",
        ("fleet", "slo_class", "kind"),
        "fleet-scope terminal token classification per SLO class: "
        "kind=goodput (ok streams) vs kind=waste (cancelled/expired/"
        "failed streams) — the per-class goodput split the scheduler "
        "reads",
    ),
    MetricSpec(
        "fleet_ledger_goodput_fraction", "gauge", ("fleet",),
        "fleet-wide goodput tokens over all charged device work, "
        "failover replays and engine-local waste included "
        "(scrape-time)",
    ),
)


@dataclass
class RequestSpan:
    """One finished request's lifecycle, flattened from its Request
    stamps at retirement.  Segment invariants (``t_submit <= t_admit <=
    t_first <= t_done``) hold whenever the engine stamped all four;
    requests that finish AT admission have ``t_first == t_done``.

    ``status`` is the request's terminal status ("ok" / "cancelled" /
    "expired" / "failed") — non-ok spans may be missing admit/first
    stamps (a request cancelled while queued never admitted)."""

    rid: str
    t_submit: float
    t_admit: float | None
    t_first: float | None
    t_done: float
    n_tokens: int
    status: str = "ok"

    @property
    def queue_wait_secs(self) -> float | None:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def prefill_secs(self) -> float | None:
        """Admission -> first token: the prefill + first-sample segment
        (under batched admission this includes riding the step's shared
        sweep; under a ``prefill_budget`` it spans every step the
        admission sat parked mid-prefill — the trace's prefill segment
        is the honest budget-stretched window)."""
        if self.t_admit is None or self.t_first is None:
            return None
        return self.t_first - self.t_admit

    @property
    def decode_secs(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_done - self.t_first

    @property
    def ttft_secs(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def e2e_secs(self) -> float:
        return self.t_done - self.t_submit

    @classmethod
    def from_request(cls, req) -> "RequestSpan":
        return cls(
            rid=req.rid, t_submit=req.t_submit, t_admit=req.t_admit,
            t_first=req.t_first, t_done=req.t_done,
            n_tokens=len(req.tokens),
            status=getattr(req, "status", "ok"),
        )


@dataclass
class StepRecord:
    """One engine ``step()`` as the observer saw it.  ``mode`` is the
    decode program the step actually DISPATCHED ("plain" chunk, "spec"
    superstep) or "idle" (pure admission / drain / nothing-to-do
    steps).  ``readback_secs`` sums the host syncs the step performed
    (first-token readbacks + chunk/superstep consumes)."""

    index: int
    t_start: float
    dur_secs: float
    occupancy: int
    queue_depth: int
    admitted: int
    retired: int
    mode: str
    prefill_dispatches: int
    decode_dispatches: int
    sweeps: int
    tokens: int
    readback_secs: float
    # Budgeted chunked-prefill interleaving (prefill_budget): admissions
    # parked mid-prefill when the step ended, and the prompt tokens the
    # budget deferred THIS step (defaults keep records from unbudgeted
    # engines and older tooling identical).
    prefill_inflight: int = 0
    deferred_tokens: int = 0
    # Decode supersteps (superstep_k): wall ms this step spent BLOCKED
    # in host syncs (engine.host_sync_s delta — measured engine-side,
    # observer on or off), and the device decode steps computed past
    # rows' retirement points this step (the bounded over-decode the
    # fused readback reconciled).
    host_sync_ms: float = 0.0
    tokens_overdecoded: int = 0
    # Device-time attribution (workloads/profiler.py): DEVICE ms of this
    # step (0.0 for idle steps and for records from older tooling — the
    # default keeps them identical).  On a card engine it is
    # prefill_device_ms + decode_device_ms, the CUDA-event time of the
    # prefill sweeps and the decode dispatches whose work this step READ
    # BACK: under ``pipelined`` chunk N is read back in step N+1, so its
    # time lands on that record.  CPU engines record no events (both
    # 0.0) and estimate device_ms as the step wall less its host syncs.
    device_ms: float = 0.0
    prefill_device_ms: float = 0.0
    decode_device_ms: float = 0.0


@dataclass
class AttemptSpan:
    """One per-replica serving attempt of a fleet request — the unit
    the fleet-scope trace stitches.  A request that fails over carries
    several attempts: each later one is a RETRY CHILD of the previous
    (rendered as a chrome flow link), with ``outcome`` recording why
    the parent ended ("crash"/"hang" for charged faults, "drain" /
    "removed" / "closed" for uncharged operator or health moves,
    "failed" when the engine's own retry budget gave up, or the
    terminal engine status for the final attempt).  Stamps are on the
    fleet's clock (``time.perf_counter`` — the one clock every lane of
    the merged trace shares)."""

    replica: int
    t_dispatch: float
    t_admit: float | None = None
    t_first: float | None = None
    t_end: float | None = None
    tokens: int = 0
    outcome: str = "running"
    charged: bool = False


@dataclass
class FleetSpan:
    """One fleet request's whole lifecycle on the fleet's clock:
    router enqueue -> each per-replica attempt -> exactly one terminal
    status.  ``t_admit``/``t_first`` are FIRST-segment stamps (a
    failover's re-admission never resets them), so queue-wait and TTFT
    attribution stay correct across failovers; ``attempts`` carries
    the per-replica segments with their fault kinds."""

    rid: str
    t_submit: float
    t_done: float
    status: str
    n_tokens: int
    slo_class: str | None = None
    slo_attained: bool | None = None
    t_admit: float | None = None
    t_first: float | None = None
    failovers: int = 0
    attempts: list = field(default_factory=list)

    @property
    def queue_wait_secs(self) -> float | None:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft_secs(self) -> float | None:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def e2e_secs(self) -> float:
        return self.t_done - self.t_submit

    @property
    def tpot_secs(self) -> float | None:
        """Per-token decode time (first token -> done over the n-1
        decoded tokens) — the bulk class's bound.  None for spans that
        never decoded past their first token."""
        if self.t_first is None or self.n_tokens < 2:
            return None
        return (self.t_done - self.t_first) / (self.n_tokens - 1)

    @classmethod
    def from_fleet_request(cls, fr) -> "FleetSpan":
        return cls(
            rid=fr.rid, t_submit=fr.t_submit, t_done=fr.t_done,
            status=fr.status, n_tokens=len(fr.tokens),
            slo_class=getattr(fr, "slo_class", None),
            slo_attained=getattr(fr, "slo_attained", None),
            t_admit=fr.t_admit, t_first=fr.t_first,
            failovers=getattr(fr, "failovers", 0),
            attempts=list(getattr(fr, "attempts", ())),
        )


@dataclass
class SupervisorEvent:
    """One instant on the supervision timeline (death, backoff wait,
    canary probe, quarantine, rejoin, ...) — rendered as an instant
    event on the merged fleet trace's supervisor lane.  Lives here
    (jax-free, next to the other span types) so the trace tooling
    never needs the supervisor module."""

    t: float
    kind: str
    chip_id: str = ""
    detail: str = ""


class EngineObserver:
    """Opt-in observability for one ServeEngine.

    Construct it, pass it to the engine (``ServeEngine(...,
    observer=obs)``), and optionally ``bind_registry()`` it to a
    metrics Registry.  The engine drives the ``_step_begin`` /
    ``_step_end`` / ``_note_readback`` hooks; everything user-facing is
    the rings (``steps`` / ``spans``), their ``drain_*`` APIs, and
    ``export_trace``.

    Ring bounds: both rings are bounded (``step_limit`` /
    ``span_limit``); evictions are COUNTED (``dropped_steps`` /
    ``dropped_spans``) so a long-running caller who forgot to drain can
    see exactly how much history it lost rather than silently reading a
    truncated timeline."""

    def __init__(
        self,
        *,
        step_limit: int = 2048,
        span_limit: int = 2048,
        name: str = "0",
        replica: str = "",
        device_table=None,
    ):
        if step_limit < 1 or span_limit < 1:
            raise ValueError(
                f"step_limit/span_limit must be >= 1, got "
                f"{step_limit}/{span_limit}"
            )
        self.name = name
        # Fleet mode: a non-empty ``replica`` adds a replica=<id> label
        # to every series AND keys the gauge registrations, so N
        # engines share one registry without colliding.  The empty
        # default keeps single-engine scrape output BYTE-compatible
        # (no replica label, name-keyed gauges) — pinned by
        # tests/test_metrics_lint.py.
        self.replica = replica
        self.steps: deque[StepRecord] = deque(maxlen=step_limit)
        self.spans: deque[RequestSpan] = deque(maxlen=span_limit)
        self.dropped_steps = 0
        self.dropped_spans = 0
        # Device-time attribution (workloads/profiler.py): an optional
        # DeviceTimeTable smooths per-dispatch device estimates; the
        # wall/device running sums back the busy/stall fraction gauges
        # either way (pure host arithmetic over values the step hooks
        # already computed — nothing here touches device state).
        self.device_table = device_table
        self._wall_ms = 0.0
        self._device_ms = 0.0
        self._step_index = 0
        self._readback_secs = 0.0
        self._registry = None
        self._labels: dict = {}
        self._engine = None
        # Last value pushed to the registry per lifecycle counter: these
        # engine counters can also move BETWEEN steps (cancel(),
        # QueueFull rejections at submit time), so per-step snapshot
        # deltas would drop those increments — each _step_end pushes
        # the difference against the engine's running total instead.
        self._pushed: dict[str, float] = {}

    # ---- registry bridge -------------------------------------------------

    def bind_registry(self, reg, labels: dict | None = None) -> None:
        """Attach this observer to a metrics Registry: describe every
        family in ENGINE_METRICS (histograms get the seconds-scale
        bucket ladder), register the scrape-time gauges, and start
        pushing counter/histogram updates from the step hooks.  All
        series carry an ``engine=<name>`` label so several engines can
        share one registry.  Without a ``replica`` id, gauge
        registration replaces by name (give concurrent engines distinct
        observer names and bind the LAST one, or separate registries —
        the single-engine contract, unchanged); WITH one (fleet mode),
        each observer's gauges register under its own key, every series
        additionally carries ``replica=<id>``, and N replicas coexist
        on one registry.  ``unbind_registry()`` detaches when the
        engine retires."""
        self._registry = reg
        self._labels = dict(labels or {})
        self._labels.setdefault("engine", self.name)
        if self.replica:
            self._labels.setdefault("replica", self.replica)
        for m in ENGINE_METRICS:
            if m.type == "histogram":
                # Per-dispatch device windows need the sub-millisecond
                # ladder; every serving latency keeps the seconds scale.
                buckets = (
                    DEVICE_SECONDS_BUCKETS
                    if m.name == "engine_device_seconds"
                    else SERVE_SECONDS_BUCKETS
                )
                reg.describe(m.name, m.help, buckets=buckets)
            else:
                reg.describe(m.name, m.help)
        # Ledger families describe unconditionally (the engine may not
        # exist yet at bind time); their gauges read empty until an
        # armed ledger appears, and the counter pushes are delta-gated.
        for m in LEDGER_METRICS:
            if m.labels[0] == "engine":
                reg.describe(m.name, m.help)
        key = f"replica:{self.replica}" if self.replica else None
        for name, reader in self._GAUGE_READERS.items():
            reg.register_gauge(
                name, lambda reader=reader: self._gauge(reader), key=key
            )
        for name, reader in self._LEDGER_GAUGE_READERS.items():
            reg.register_gauge(
                name, lambda reader=reader: self._ledger_gauge(reader),
                key=key,
            )

    # One engine reader per gauge family in ENGINE_METRICS — bind and
    # unbind both iterate this mapping, so a new gauge cannot be
    # registered without also being unregistered (and the lint test
    # pins it against the catalog).
    _GAUGE_READERS = {
        "engine_queue_depth": lambda e: len(e.pending),
        "engine_slot_occupancy": lambda e: int(e._occupied.sum()),
        "engine_slots": lambda e: e.slots,
        "engine_resident_pages": lambda e: e.ctrl.used_pages,
        "engine_prefill_inflight": (
            lambda e: len(getattr(e, "_inflight_prefill", ()))
        ),
        "engine_paused": (
            lambda e: 1.0 if getattr(e, "paused", False) else 0.0
        ),
        "engine_kv_offloaded_pages": (
            lambda e: getattr(
                getattr(e, "prefix", None), "offloaded_pages", 0
            ) or 0
        ),
        "engine_kv_disk_pages": (
            lambda e: getattr(e, "kv_disk_pages", 0) or 0
        ),
        # Device-time split (workloads/profiler.py): read back through
        # the engine's bound observer; engines without one (or before
        # any step) read empty via _gauge's teardown guard.
        "engine_device_busy_fraction": (
            lambda e: e._obs.device_busy_fraction
        ),
        "engine_host_stall_fraction": (
            lambda e: e._obs.host_stall_fraction
        ),
    }

    # Chip-time ledger gauges (LEDGER_METRICS): ``e`` is the bound
    # engine's ChipTimeLedger; a reader may return a scalar or a
    # [(labels, value), ...] list.  Registered alongside the engine
    # gauges (replica-keyed in fleet mode) and read empty until a
    # ledger is armed.
    _LEDGER_GAUGE_READERS = {
        "ledger_busy_fraction": lambda e: e.busy_fraction,
        "ledger_goodput_fraction": lambda e: e.goodput_fraction,
        "ledger_pending_tokens": lambda e: e.pending_tokens,
        "ledger_waste_chip_seconds": lambda e: [
            ({"class": c}, s) for c, s in sorted(e.waste_chip_s().items())
        ],
    }

    # Lifecycle counter families -> the ServeEngine attribute carrying
    # the running total (fault-tolerance telemetry; the catalog, the
    # lint test and the rendered docs all see these via ENGINE_METRICS).
    _LIFECYCLE_COUNTERS = {
        "engine_requests_cancelled_total": "requests_cancelled",
        "engine_requests_expired_total": "requests_expired",
        "engine_requests_failed_total": "requests_failed",
        "engine_requests_retried_total": "requests_retried",
        "engine_queue_rejections_total": "queue_rejections",
        # Fast-start telemetry (workloads/faststart.py): snapshot
        # calibration skips and the per-engine persistent-compile-cache
        # deltas (properties over the process-global counters).
        "engine_calibration_reused_total": "calibration_reused",
        "engine_compile_cache_hits_total": "compile_cache_hits",
        "engine_compile_cache_misses_total": "compile_cache_misses",
    }

    def unbind_registry(self) -> None:
        """Detach from the bound registry: unregister the gauge
        collectors (whose closures otherwise pin this observer — and
        through it the engine's params and KV page pools — on the
        registry forever) and stop pushing counters.  Call it when the
        engine retires in a long-lived process; already-accumulated
        counter/histogram series stay on the registry, monotonic, but
        no dead engine keeps scraping as live state.  Gauge
        registration replaces by name, so unbind the retiring observer
        BEFORE binding its successor — unbinding afterwards would
        remove the successor's collectors.  (Fleet mode is immune:
        replica-keyed registrations unbind only their own key, so one
        replica retiring never touches its siblings'.)"""
        reg, self._registry = self._registry, None
        if reg is None:
            return
        key = f"replica:{self.replica}" if self.replica else None
        for name in self._GAUGE_READERS:
            reg.unregister_gauge(name, key=key)
        for name in self._LEDGER_GAUGE_READERS:
            reg.unregister_gauge(name, key=key)
        self._engine = None

    def _gauge(self, value_fn) -> list[tuple[dict, float]]:
        eng = self._engine
        if eng is None:
            return []
        try:
            return [(dict(self._labels), float(value_fn(eng)))]
        except Exception:
            # A gauge must never fail a scrape mid-teardown; the
            # Registry logs collector failures, an empty read is honest.
            return []

    def _ledger_gauge(self, value_fn) -> list[tuple[dict, float]]:
        led = getattr(self._engine, "ledger", None)
        if led is None:
            return []
        try:
            out = value_fn(led)
            if isinstance(out, list):
                return [
                    ({**self._labels, **labels}, float(v))
                    for labels, v in out
                ]
            return [(dict(self._labels), float(out))]
        except Exception:
            return []  # a gauge must never fail a scrape mid-teardown

    # ---- device-time split (workloads/profiler.py) -----------------------

    @property
    def device_busy_fraction(self) -> float:
        """Fraction of observed step wall the device was busy, over
        this observer's whole run (0.0 before any step)."""
        if self._wall_ms <= 0:
            return 0.0
        return min(self._device_ms / self._wall_ms, 1.0)

    @property
    def host_stall_fraction(self) -> float:
        if self._wall_ms <= 0:
            return 0.0
        return 1.0 - self.device_busy_fraction

    # ---- engine-facing hooks --------------------------------------------

    def _bind(self, engine) -> None:
        self._engine = engine

    def _note_readback(self, secs: float) -> None:
        """Called by the engine around every host sync (first-token
        readbacks, chunk/superstep consumes) while an observer is
        attached."""
        self._readback_secs += secs

    def _step_begin(self, engine) -> tuple:
        self._readback_secs = 0.0
        prefix = getattr(engine, "prefix", None)
        return (
            time.perf_counter(),
            engine.generated_tokens,
            engine.requests_admitted,
            engine.requests_retired,
            engine.prefill_dispatches,
            engine.prefill_sweeps,
            engine.chunks_run,
            engine.spec_rounds,
            engine.mode_switches,
            getattr(engine, "prefill_deferred_tokens", 0),
            getattr(engine, "host_sync_s", 0.0),
            getattr(engine, "tokens_overdecoded", 0),
            getattr(prefix, "hits", 0),
            getattr(prefix, "misses", 0),
            getattr(engine, "prefill_device_s", 0.0),
            getattr(engine, "decode_device_s", 0.0),
        )

    def _step_end(self, engine, snap: tuple, finished) -> StepRecord:
        (
            t0, tokens0, adm0, ret0, pd0, sw0, ch0, sr0, ms0, dt0, hs0,
            od0, ph0, pm0, pdev0, ddev0,
        ) = snap
        dur = time.perf_counter() - t0
        host_sync = getattr(engine, "host_sync_s", 0.0) - hs0
        overdecoded = getattr(engine, "tokens_overdecoded", 0) - od0
        tokens = engine.generated_tokens - tokens0
        admitted = engine.requests_admitted - adm0
        retired = engine.requests_retired - ret0
        # chunks_run counts device decode CHUNKS; a superstep engine
        # runs superstep_k of them per dispatch, so normalize both
        # decode families to DISPATCH counts.
        chunk_d = (engine.chunks_run - ch0) // max(
            getattr(engine, "superstep_k", 1), 1
        )
        spec_rounds_d = engine.spec_rounds - sr0
        spec_d = spec_rounds_d // max(
            engine.spec_lookahead, getattr(engine, "spec_superstep_k", 1), 1
        )
        # The mode the step actually DISPATCHED: the engine runs at most
        # one decode program per step (drains only consume in-flight
        # work; they never dispatch).
        mode = "spec" if spec_d else ("plain" if chunk_d else "idle")
        # Device-time attribution: the measured device window is the
        # step wall minus the engine-measured host-sync stall; idle
        # steps (pure admission/drain, no dispatch) attribute nothing.
        # A prefill-only step dispatches too — count it as its own
        # program so the calibration table keys don't mix phases.
        program = mode
        if mode == "idle" and engine.prefill_dispatches - pd0 > 0:
            program = "prefill"
        # A card engine times its sweeps and dispatches with CUDA events
        # (ServeEngine._phase_event): the step's device time is theirs,
        # read back this step, and the table takes it as measured.
        prefill_ms = (getattr(engine, "prefill_device_s", 0.0) - pdev0) * 1000.0
        decode_ms = (getattr(engine, "decode_device_s", 0.0) - ddev0) * 1000.0
        timed = getattr(engine, "_phase_event", None) is not None
        device_ms = 0.0
        if timed:
            device_ms = prefill_ms + decode_ms
            if self.device_table is not None and program != "idle" and device_ms > 0:
                batch = int(engine._occupied.sum())
                self.device_table.observe(program, tokens, batch, device_ms)
        elif program != "idle":
            measured_ms = max((dur - host_sync) * 1000.0, 0.0)
            device_ms = measured_ms
            if self.device_table is not None:
                batch = int(engine._occupied.sum())
                self.device_table.observe(
                    program, tokens, batch, measured_ms
                )
                est = self.device_table.estimate(program, tokens, batch)
                if est is not None:
                    device_ms = est
        self._wall_ms += dur * 1000.0
        self._device_ms += device_ms
        rec = StepRecord(
            index=self._step_index,
            t_start=t0,
            dur_secs=dur,
            occupancy=int(engine._occupied.sum()),
            queue_depth=len(engine.pending),
            admitted=admitted,
            retired=retired,
            mode=mode,
            prefill_dispatches=engine.prefill_dispatches - pd0,
            decode_dispatches=chunk_d + spec_d,
            sweeps=engine.prefill_sweeps - sw0,
            tokens=tokens,
            readback_secs=self._readback_secs,
            prefill_inflight=len(getattr(engine, "_inflight_prefill", ())),
            deferred_tokens=(
                getattr(engine, "prefill_deferred_tokens", 0) - dt0
            ),
            host_sync_ms=round(host_sync * 1000, 3),
            tokens_overdecoded=overdecoded,
            device_ms=round(device_ms, 3),
            prefill_device_ms=round(prefill_ms, 3),
            decode_device_ms=round(decode_ms, 3),
        )
        self._step_index += 1
        if len(self.steps) == self.steps.maxlen:
            self.dropped_steps += 1
        self.steps.append(rec)
        new_spans = self._record_spans(finished)
        reg = self._registry
        if reg is not None:
            labels = self._labels
            if tokens:
                reg.inc("engine_tokens_total", labels, tokens)
            if admitted:
                reg.inc("engine_requests_admitted_total", labels, admitted)
            if retired:
                reg.inc("engine_requests_retired_total", labels, retired)
            if rec.prefill_dispatches:
                reg.inc(
                    "engine_prefill_dispatches_total", labels,
                    rec.prefill_dispatches,
                )
            if rec.deferred_tokens:
                reg.inc(
                    "engine_prefill_deferred_tokens_total", labels,
                    rec.deferred_tokens,
                )
            switches = engine.mode_switches - ms0
            if switches:
                reg.inc("engine_mode_switches_total", labels, switches)
            if overdecoded:
                reg.inc(
                    "engine_tokens_overdecoded_total", labels, overdecoded
                )
            prefix = getattr(engine, "prefix", None)
            prefix_hits = getattr(prefix, "hits", 0) - ph0
            prefix_misses = getattr(prefix, "misses", 0) - pm0
            if prefix_hits:
                reg.inc(
                    "engine_prefix_hit_pages_total", labels, prefix_hits
                )
            if prefix_misses:
                reg.inc("engine_prefix_miss_total", labels, prefix_misses)
            if host_sync > 0:
                reg.observe_seconds("engine_host_sync", host_sync, labels)
            if rec.device_ms > 0:
                reg.observe_seconds(
                    "engine_device", rec.device_ms / 1000.0, labels
                )
            self._push_lifecycle(engine, reg, labels)
            self._push_ring_drops(reg, labels)
            self._push_ledger(engine, reg, labels)
            if mode != "idle":
                reg.inc(
                    "engine_decode_steps_total", {**labels, "mode": mode}
                )
            reg.observe_seconds("engine_step", dur, labels)
            for span in new_spans:
                if span.ttft_secs is not None:
                    reg.observe_seconds(
                        "engine_ttft", span.ttft_secs, labels
                    )
                reg.observe_seconds("engine_e2e", span.e2e_secs, labels)
        return rec

    def _record_spans(self, finished) -> list[RequestSpan]:
        """Append one RequestSpan per finished request to the bounded
        ring, counting drops; returns the new spans."""
        new_spans = [RequestSpan.from_request(req) for req in finished]
        for span in new_spans:
            if len(self.spans) == self.spans.maxlen:
                self.dropped_spans += 1
            self.spans.append(span)
        return new_spans

    def _push_lifecycle(self, engine, reg, labels) -> None:
        """Push the lifecycle counter families as deltas against the
        engine's running totals (totals, not per-step increments, so
        between-step transitions — cancels, rejections, close-time
        fails — land on the registry too)."""
        for metric, attr in self._LIFECYCLE_COUNTERS.items():
            total = float(getattr(engine, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = total

    def _push_ring_drops(self, reg, labels) -> None:
        """Ring-overflow visibility: evictions the bounded step/span
        rings made unread land as counters, so silent history loss is
        a scrapeable signal instead of a surprise during a postmortem."""
        for metric, total in (
            ("engine_observer_dropped_steps_total", self.dropped_steps),
            ("engine_observer_dropped_spans_total", self.dropped_spans),
        ):
            delta = float(total) - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = float(total)

    def _push_ledger(self, engine, reg, labels) -> None:
        """Chip-time ledger counter families, pushed as deltas against
        the armed ledger's running totals (phase seconds and the
        goodput/waste token taxonomy — LEDGER_METRICS)."""
        led = getattr(engine, "ledger", None)
        if led is None:
            return
        for phase, secs in led.phase_s.items():
            key = f"ledger_chip_seconds_total:{phase}"
            delta = float(secs) - self._pushed.get(key, 0.0)
            if delta > 0:
                reg.inc(
                    "ledger_chip_seconds_total",
                    {**labels, "phase": phase}, delta,
                )
                self._pushed[key] = float(secs)
        classes = [("goodput", led.goodput_tokens)]
        classes += sorted(led.waste_tokens.items())
        for cls, total in classes:
            key = f"ledger_tokens_total:{cls}"
            delta = float(total) - self._pushed.get(key, 0.0)
            if delta > 0:
                reg.inc(
                    "ledger_tokens_total", {**labels, "class": cls}, delta
                )
                self._pushed[key] = float(total)

    def _engine_closed(self, engine, finished) -> None:
        """Final flush at ``engine.close()``: counters are pushed and
        spans recorded at step boundaries, but close() fails in-flight
        work and then refuses further steps — so the last lifecycle
        deltas and the close-failed requests' spans land here, before
        the registry unbinds (a shutdown that failed N requests must
        not scrape as 0 failures)."""
        new_spans = self._record_spans(finished)
        reg = self._registry
        if reg is None:
            return
        labels = self._labels
        self._push_lifecycle(engine, reg, labels)
        self._push_ring_drops(reg, labels)
        self._push_ledger(engine, reg, labels)
        for span in new_spans:
            if span.ttft_secs is not None:
                reg.observe_seconds("engine_ttft", span.ttft_secs, labels)
            reg.observe_seconds("engine_e2e", span.e2e_secs, labels)

    # ---- drains ---------------------------------------------------------

    def drain_steps(self) -> list[StepRecord]:
        """Hand back (and clear) the step-record ring — the same
        between-measurement-windows contract as
        ``engine.drain_completed()``."""
        out = list(self.steps)
        self.steps.clear()
        return out

    def drain_spans(self) -> list[RequestSpan]:
        """Hand back (and clear) the finished-request span ring."""
        out = list(self.spans)
        self.spans.clear()
        return out

    # ---- chrome trace export --------------------------------------------

    def export_trace(self, path: str) -> int:
        """Write the recorded timeline as chrome://tracing-loadable
        trace_event JSON.  Returns the number of trace events written."""
        trace = trace_events(self)
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
        return len(trace["traceEvents"])


class FleetObserver:
    """Fleet-level Prometheus bridge (workloads/fleet.py): aggregate
    counters, scrape-time gauges and pooled latency histograms NEXT TO
    the per-replica engine series (give each replica's EngineObserver a
    distinct ``replica=`` id and bind everything to one registry).

    Same discipline as the engine bridge: inert (host counters only,
    never scheduling state), jax-free, counters pushed as deltas
    against the fleet's running totals at each ``Fleet.step()``.

    Beyond the bridge, the observer keeps the FLEET-SCOPE request
    timeline: one ``FleetSpan`` per terminal request (router enqueue ->
    every per-replica attempt -> exactly one terminal status) in a
    bounded ring with the engine observer's drain/dropped contract —
    the raw material ``fleet_trace_events`` merges into one chrome
    trace.  Spans record with or without a bound registry."""

    def __init__(self, *, name: str = "0", span_limit: int = 2048):
        if span_limit < 1:
            raise ValueError(
                f"span_limit must be >= 1, got {span_limit}"
            )
        self.name = name
        self.spans: deque[FleetSpan] = deque(maxlen=span_limit)
        self.dropped_spans = 0
        self._registry = None
        self._labels: dict = {}
        self._fleet = None
        self._pushed: dict[str, float] = {}

    # Scrape-time readers; ``e`` is the bound Fleet (the lint's
    # reader-regex contract shared with the engine bridge).
    _FLEET_GAUGE_READERS = {
        "fleet_queue_depth": lambda e: [({}, float(len(e.queue)))],
        "fleet_replicas": lambda e: [
            ({"state": state}, float(
                sum(1 for r in e.replicas if r.state == state)
            ))
            for state in ("active", "draining", "dead")
        ],
        "fleet_replica_state": lambda e: [
            ({"replica": str(r.index), "state": r.state}, 1.0)
            for r in e.replicas if r.state != "dead"
        ],
        "fleet_replica_paused": lambda e: [
            ({"replica": str(r.index)}, 1.0 if r.paused else 0.0)
            for r in e.replicas if r.state != "dead"
        ],
        "fleet_slo_burn_rate": lambda e: [
            ({"slo_class": name}, float(rate))
            for name, rate in sorted(e.slo_burn_rates().items())
        ],
        "fleet_replica_role": lambda e: [
            ({"replica": str(r.index), "role": r.role}, 1.0)
            for r in e.replicas if r.state != "dead"
        ],
        "fleet_free_pages": lambda e: [
            ({"tier": "hbm"}, float(sum(
                r.free_pages() or 0 for r in e.replicas
                if r.state != "dead" and hasattr(r, "free_pages")
            ))),
            ({"tier": "host"}, float(sum(
                r.host_free_pages() for r in e.replicas
                if r.state != "dead" and hasattr(r, "host_free_pages")
            ))),
        ],
    }

    # Fleet-scope chip-time ledger gauge (LEDGER_METRICS): reads the
    # armed FleetLedger off the bound fleet; empty until one exists.
    # The counter-derived property, NOT a full snapshot — this runs on
    # every scrape.
    _FLEET_LEDGER_GAUGE_READERS = {
        "fleet_ledger_goodput_fraction": lambda e: (
            [({}, float(e.ledger.goodput_fraction))]
            if getattr(e, "ledger", None) is not None else []
        ),
    }

    # Counter family -> Fleet attribute carrying the running total.
    _FLEET_COUNTERS = {
        "fleet_requests_total": "requests_submitted",
        "fleet_tokens_total": "generated_tokens",
        "fleet_failovers_total": "failover_requeues",
        "fleet_drain_requeues_total": "drain_requeues",
        "fleet_queue_rejections_total": "queue_rejections",
        "fleet_kv_handoffs_total": "kv_handoffs",
        "fleet_handoff_pages_total": "handoff_pages",
        "fleet_page_dispatches_total": "page_dispatches",
        "fleet_stats_published_total": "stats_published",
        "fleet_journal_writes_total": "journal_writes",
        "fleet_journal_torn_total": "journal_torn",
        "fleet_sessions_restored_total": "sessions_restored",
    }

    def bind_registry(self, reg, labels: dict | None = None) -> None:
        self._registry = reg
        self._labels = dict(labels or {})
        self._labels.setdefault("fleet", self.name)
        for m in FLEET_METRICS:
            if m.type == "histogram":
                reg.describe(m.name, m.help, buckets=SERVE_SECONDS_BUCKETS)
            else:
                reg.describe(m.name, m.help)
        for m in LEDGER_METRICS:
            if m.labels[0] == "fleet":
                reg.describe(m.name, m.help)
        for name, reader in {
            **self._FLEET_GAUGE_READERS,
            **self._FLEET_LEDGER_GAUGE_READERS,
        }.items():
            reg.register_gauge(
                name, lambda reader=reader: self._gauge(reader),
                key=f"fleet:{self.name}",
            )

    def unbind_registry(self) -> None:
        reg, self._registry = self._registry, None
        if reg is None:
            return
        for name in self._FLEET_GAUGE_READERS:
            reg.unregister_gauge(name, key=f"fleet:{self.name}")
        for name in self._FLEET_LEDGER_GAUGE_READERS:
            reg.unregister_gauge(name, key=f"fleet:{self.name}")
        self._fleet = None

    def _gauge(self, value_fn) -> list[tuple[dict, float]]:
        fleet = self._fleet
        if fleet is None:
            return []
        try:
            return [
                ({**self._labels, **labels}, float(v))
                for labels, v in value_fn(fleet)
            ]
        except Exception:
            return []  # a gauge must never fail a scrape mid-teardown

    # ---- fleet-facing hooks ---------------------------------------------

    def _bind(self, fleet) -> None:
        self._fleet = fleet

    def drain_spans(self) -> list[FleetSpan]:
        """Hand back (and clear) the fleet-span ring — the same
        between-measurement-windows contract as the engine observer's."""
        out = list(self.spans)
        self.spans.clear()
        return out

    def _fleet_step_end(self, fleet, finished) -> None:
        # The span ring fills whether or not a registry is bound — a
        # --trace-out run without --metrics-port still gets its merged
        # timeline.
        new_spans = []
        for fr in finished:
            span = FleetSpan.from_fleet_request(fr)
            if len(self.spans) == self.spans.maxlen:
                self.dropped_spans += 1
            self.spans.append(span)
            new_spans.append(span)
        reg = self._registry
        if reg is None:
            return
        labels = self._labels
        for metric, attr in self._FLEET_COUNTERS.items():
            total = float(getattr(fleet, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = total
        for kind, attr in (
            ("crash", "replica_crashes"), ("hang", "replica_hangs"),
        ):
            metric = f"fleet_replica_failures_total:{kind}"
            total = float(getattr(fleet, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(
                    "fleet_replica_failures_total",
                    {**labels, "kind": kind}, delta,
                )
                self._pushed[metric] = total
        for cls, total in sorted(
            getattr(fleet, "wfq_dispatches", {}).items()
        ):
            metric = f"fleet_wfq_dispatches_total:{cls}"
            delta = float(total) - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(
                    "fleet_wfq_dispatches_total",
                    {**labels, "slo_class": cls or "untagged"}, delta,
                )
                self._pushed[metric] = float(total)
        # Ring-overflow visibility (the engine bridge's contract).
        drops = float(self.dropped_spans)
        drop_delta = drops - self._pushed.get(
            "fleet_observer_dropped_spans_total", 0.0
        )
        if drop_delta:
            reg.inc(
                "fleet_observer_dropped_spans_total", labels, drop_delta
            )
            self._pushed["fleet_observer_dropped_spans_total"] = drops
        # Fleet-scope ledger: per-SLO-class terminal token
        # classification, pushed as running-total deltas.
        led = getattr(fleet, "ledger", None)
        if led is not None:
            for cls, counts in sorted(
                getattr(led, "class_tokens", {}).items()
            ):
                for kind in ("goodput", "waste"):
                    key = f"fleet_ledger_tokens_total:{cls}:{kind}"
                    total = float(counts.get(kind, 0))
                    delta = total - self._pushed.get(key, 0.0)
                    if delta > 0:
                        reg.inc(
                            "fleet_ledger_tokens_total",
                            {**labels, "slo_class": cls, "kind": kind},
                            delta,
                        )
                        self._pushed[key] = total
        # Handoff windows closed since the last step (the list only
        # appends, so the pushed length is the delta cursor).
        windows = getattr(fleet, "handoff_s", ())
        seen = int(self._pushed.get("fleet_handoff_seconds:n", 0.0))
        for secs in list(windows)[seen:]:
            reg.observe_seconds("fleet_handoff", secs, labels)
        self._pushed["fleet_handoff_seconds:n"] = float(len(windows))
        for span in new_spans:
            if span.queue_wait_secs is not None:
                reg.observe_seconds(
                    "fleet_queue_wait", span.queue_wait_secs, labels
                )
            if span.ttft_secs is not None:
                reg.observe_seconds("fleet_ttft", span.ttft_secs, labels)
            if span.e2e_secs is not None:
                reg.observe_seconds("fleet_e2e", span.e2e_secs, labels)
            if span.slo_class is None:
                continue
            cls_labels = {**labels, "slo_class": span.slo_class}
            # The fleet's accounting decision travels on the request:
            # slo_attained is None for spans the fleet excluded
            # (cancelled — a client abort is not an SLO verdict).
            if span.slo_attained is not None:
                reg.inc("fleet_slo_requests_total", cls_labels)
                if span.slo_attained:
                    reg.inc("fleet_slo_attained_total", cls_labels)
            if span.ttft_secs is not None:
                reg.observe_seconds(
                    "fleet_class_ttft", span.ttft_secs, cls_labels
                )
            if span.tpot_secs is not None:
                reg.observe_seconds(
                    "fleet_class_tpot", span.tpot_secs, cls_labels
                )


class SupervisorObserver:
    """Supervisor-level Prometheus bridge (workloads/supervisor.py):
    restart / crash-loop / quarantine counters, a slots-by-state
    scrape gauge and the restore-time histogram, NEXT TO the fleet and
    per-replica engine series on one shared registry.

    Same discipline as the other bridges: inert (host counters only,
    never scheduling state), jax-free, counters pushed as deltas
    against the supervisor's running totals at each ``poll()``."""

    def __init__(self, *, name: str = "0"):
        self.name = name
        self._registry = None
        self._labels: dict = {}
        self._supervisor = None
        self._pushed: dict[str, float] = {}
        self._restores_pushed = 0

    # Scrape-time readers; ``e`` is the bound FleetSupervisor (the
    # lint's reader-regex contract shared with the other bridges).
    _SUPERVISOR_GAUGE_READERS = {
        "supervisor_slots": lambda e: [
            ({"state": state}, float(
                sum(1 for s in e.slots if s.state == state)
            ))
            for state in (
                "serving", "backoff", "probing", "quarantined",
                "forgotten",
            )
        ],
    }

    # Counter family -> FleetSupervisor attribute with the running total.
    _SUPERVISOR_COUNTERS = {
        "supervisor_restarts_total": "restarts_total",
        "supervisor_restart_failures_total": "restart_failures",
        "supervisor_crash_loops_total": "crash_loops",
        "supervisor_health_deferrals_total": "health_deferrals",
    }

    def bind_registry(self, reg, labels: dict | None = None) -> None:
        self._registry = reg
        self._labels = dict(labels or {})
        self._labels.setdefault("supervisor", self.name)
        for m in SUPERVISOR_METRICS:
            if m.type == "histogram":
                reg.describe(m.name, m.help, buckets=SERVE_SECONDS_BUCKETS)
            else:
                reg.describe(m.name, m.help)
        for name, reader in self._SUPERVISOR_GAUGE_READERS.items():
            reg.register_gauge(
                name, lambda reader=reader: self._gauge(reader),
                key=f"supervisor:{self.name}",
            )

    def unbind_registry(self) -> None:
        reg, self._registry = self._registry, None
        if reg is None:
            return
        for name in self._SUPERVISOR_GAUGE_READERS:
            reg.unregister_gauge(name, key=f"supervisor:{self.name}")
        self._supervisor = None

    def _gauge(self, value_fn) -> list[tuple[dict, float]]:
        sup = self._supervisor
        if sup is None:
            return []
        try:
            return [
                ({**self._labels, **labels}, float(v))
                for labels, v in value_fn(sup)
            ]
        except Exception:
            return []  # a gauge must never fail a scrape mid-teardown

    # ---- supervisor-facing hooks ----------------------------------------

    def _bind(self, supervisor) -> None:
        self._supervisor = supervisor

    def _supervisor_poll_end(self, supervisor) -> None:
        reg = self._registry
        if reg is None:
            return
        labels = self._labels
        for metric, attr in self._SUPERVISOR_COUNTERS.items():
            total = float(getattr(supervisor, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = total
        drops = float(getattr(supervisor, "dropped_events", 0) or 0)
        drop_delta = drops - self._pushed.get(
            "supervisor_dropped_events_total", 0.0
        )
        if drop_delta:
            reg.inc("supervisor_dropped_events_total", labels, drop_delta)
            self._pushed["supervisor_dropped_events_total"] = drops
        fresh = supervisor.restore_s[self._restores_pushed:]
        for secs in fresh:
            reg.observe_seconds("supervisor_restore", secs, labels)
        self._restores_pushed += len(fresh)


class AutoscalerObserver:
    """Autoscaler-level Prometheus bridge (workloads/autoscaler.py):
    decision/actuation counters, the degradation-ladder level and the
    replicas-target-vs-live gauges, NEXT TO the fleet, supervisor and
    per-replica engine series on one shared registry.

    Same discipline as the other bridges: inert (host counters only,
    never control state), jax-free, counters pushed as deltas against
    the autoscaler's running totals at each ``poll()``."""

    def __init__(self, *, name: str = "0"):
        self.name = name
        self._registry = None
        self._labels: dict = {}
        self._autoscaler = None
        self._pushed: dict[str, float] = {}

    # Scrape-time readers; ``e`` is the bound FleetAutoscaler (the
    # lint's reader-regex contract shared with the other bridges).
    _AUTOSCALER_GAUGE_READERS = {
        "autoscaler_ladder_level": lambda e: [
            ({}, float(e.ladder_level))
        ],
        "autoscaler_replicas_target": lambda e: [
            ({}, float(e.target_replicas))
        ],
        "autoscaler_replicas_live": lambda e: [
            ({}, float(len(e.fleet.alive)))
        ],
    }

    # Counter family -> FleetAutoscaler attribute with the running
    # total.
    _AUTOSCALER_COUNTERS = {
        "autoscaler_scale_ups_total": "scale_ups",
        "autoscaler_scale_downs_total": "scale_downs",
        "autoscaler_spawn_failures_total": "spawn_failures",
        "autoscaler_brownouts_total": "brownouts",
        "autoscaler_preemptions_total": "preemptions_total",
    }

    def bind_registry(self, reg, labels: dict | None = None) -> None:
        self._registry = reg
        self._labels = dict(labels or {})
        self._labels.setdefault("autoscaler", self.name)
        for m in AUTOSCALER_METRICS:
            if m.type == "histogram":
                reg.describe(m.name, m.help, buckets=SERVE_SECONDS_BUCKETS)
            else:
                reg.describe(m.name, m.help)
        for name, reader in self._AUTOSCALER_GAUGE_READERS.items():
            reg.register_gauge(
                name, lambda reader=reader: self._gauge(reader),
                key=f"autoscaler:{self.name}",
            )

    def unbind_registry(self) -> None:
        reg, self._registry = self._registry, None
        if reg is None:
            return
        for name in self._AUTOSCALER_GAUGE_READERS:
            reg.unregister_gauge(name, key=f"autoscaler:{self.name}")
        self._autoscaler = None

    def _gauge(self, value_fn) -> list[tuple[dict, float]]:
        asc = self._autoscaler
        if asc is None:
            return []
        try:
            return [
                ({**self._labels, **labels}, float(v))
                for labels, v in value_fn(asc)
            ]
        except Exception:
            return []  # a gauge must never fail a scrape mid-teardown

    # ---- autoscaler-facing hooks ----------------------------------------

    def _bind(self, autoscaler) -> None:
        self._autoscaler = autoscaler

    def _autoscaler_poll_end(self, autoscaler) -> None:
        reg = self._registry
        if reg is None:
            return
        labels = self._labels
        for metric, attr in self._AUTOSCALER_COUNTERS.items():
            total = float(getattr(autoscaler, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = total
        for action, total in autoscaler.decisions.items():
            key = f"autoscaler_decisions_total:{action}"
            delta = float(total) - self._pushed.get(key, 0.0)
            if delta:
                reg.inc(
                    "autoscaler_decisions_total",
                    {**labels, "action": action}, delta,
                )
                self._pushed[key] = float(total)


class ControlObserver:
    """Goodput-controller Prometheus bridge (workloads/control.py):
    actuation counters and the EWMA signal gauges, NEXT TO the fleet,
    supervisor, autoscaler and per-replica engine series on one shared
    registry.

    Same discipline as the other bridges: inert (host counters only,
    never control state), jax-free, counters pushed as deltas against
    the controller's running totals at each ``poll()``."""

    def __init__(self, *, name: str = "0"):
        self.name = name
        self._registry = None
        self._labels: dict = {}
        self._controller = None
        self._pushed: dict[str, float] = {}

    # Scrape-time readers; ``e`` is the bound GoodputController (the
    # lint's reader-regex contract shared with the other bridges).
    # EWMA gauges emit NO sample until the signal has been measured —
    # a 0.0 placeholder would read as "perfect waste" on dashboards.
    _CONTROL_GAUGE_READERS = {
        "control_goodput_fraction": lambda e: (
            [] if e.goodput_fraction_ewma is None
            else [({}, float(e.goodput_fraction_ewma))]
        ),
        "control_spec_rejected_fraction": lambda e: (
            [] if e.spec_rejected_fraction_ewma is None
            else [({}, float(e.spec_rejected_fraction_ewma))]
        ),
        "control_overdecode_fraction": lambda e: (
            [] if e.overdecode_fraction_ewma is None
            else [({}, float(e.overdecode_fraction_ewma))]
        ),
    }

    # Counter family -> GoodputController attribute with the running
    # total.
    _CONTROL_COUNTERS = {
        "control_retunes_total": "retunes_applied",
        "control_wfq_reweights_total": "wfq_reweights",
        "control_dropped_events_total": "dropped_events",
    }

    def bind_registry(self, reg, labels: dict | None = None) -> None:
        self._registry = reg
        self._labels = dict(labels or {})
        self._labels.setdefault("controller", self.name)
        for m in CONTROL_METRICS:
            if m.type == "histogram":
                reg.describe(m.name, m.help, buckets=SERVE_SECONDS_BUCKETS)
            else:
                reg.describe(m.name, m.help)
        for name, reader in self._CONTROL_GAUGE_READERS.items():
            reg.register_gauge(
                name, lambda reader=reader: self._gauge(reader),
                key=f"controller:{self.name}",
            )

    def unbind_registry(self) -> None:
        reg, self._registry = self._registry, None
        if reg is None:
            return
        for name in self._CONTROL_GAUGE_READERS:
            reg.unregister_gauge(name, key=f"controller:{self.name}")
        self._controller = None

    def _gauge(self, value_fn) -> list[tuple[dict, float]]:
        ctrl = self._controller
        if ctrl is None:
            return []
        try:
            return [
                ({**self._labels, **labels}, float(v))
                for labels, v in value_fn(ctrl)
            ]
        except Exception:
            return []  # a gauge must never fail a scrape mid-teardown

    # ---- controller-facing hooks ----------------------------------------

    def _bind(self, controller) -> None:
        self._controller = controller

    def _control_poll_end(self, controller) -> None:
        reg = self._registry
        if reg is None:
            return
        labels = self._labels
        for metric, attr in self._CONTROL_COUNTERS.items():
            total = float(getattr(controller, attr, 0))
            delta = total - self._pushed.get(metric, 0.0)
            if delta:
                reg.inc(metric, labels, delta)
                self._pushed[metric] = total
        for action, total in controller.decisions.items():
            key = f"control_decisions_total:{action}"
            delta = float(total) - self._pushed.get(key, 0.0)
            if delta:
                reg.inc(
                    "control_decisions_total",
                    {**labels, "action": action}, delta,
                )
                self._pushed[key] = float(total)


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


def trace_events(observer: EngineObserver, t0: float | None = None) -> dict:
    """Render an observer's rings (NON-destructively — drains are the
    caller's business) as a Chrome trace_event object: request lifecycle
    spans as complete ("X") events on a per-request lane under the
    "requests" process, step records as "X" events plus occupancy /
    queue-depth counter ("C") tracks under the "engine" process.  Load
    the written file in chrome://tracing or https://ui.perfetto.dev.
    ``t0`` pins the timeline origin to an EXTERNAL clock zero — the
    merged fleet trace passes the fleet-wide minimum so every lane
    shares one clock; standalone export derives it from the rings."""
    steps = list(observer.steps)
    spans = list(observer.spans)
    if t0 is None:
        stamps = [s.t_start for s in steps] + [sp.t_submit for sp in spans]
        t0 = min(stamps) if stamps else 0.0
    events: list[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": f"requests (engine {observer.name})"}},
        {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
         "args": {"name": f"engine {observer.name} steps"}},
        {"ph": "M", "pid": 2, "tid": 1, "name": "thread_name",
         "args": {"name": "step()"}},
        {"ph": "M", "pid": 2, "tid": 2, "name": "thread_name",
         "args": {"name": "device"}},
    ]
    for lane, span in enumerate(spans, start=1):
        events.append(
            {"ph": "M", "pid": 1, "tid": lane, "name": "thread_name",
             "args": {"name": span.rid}}
        )
        # A request that reached a terminal status while still queued
        # (cancelled/expired/failed-at-close) has no admit/first stamps;
        # its queued segment runs to t_done so the lane still shows it.
        segments = (
            ("queued", span.t_submit,
             span.t_admit if span.t_admit is not None else span.t_done),
            ("prefill", span.t_admit, span.t_first),
            ("decode", span.t_first, span.t_done),
        )
        for name, start, end in segments:
            if start is None or end is None:
                continue
            events.append({
                "ph": "X", "pid": 1, "tid": lane, "cat": "request",
                "name": name, "ts": _us(start, t0),
                "dur": max(_us(end, t0) - _us(start, t0), 0.0),
                "args": {
                    "rid": span.rid, "tokens": span.n_tokens,
                    "status": span.status,
                },
            })
    for rec in steps:
        events.append({
            "ph": "X", "pid": 2, "tid": 1, "cat": "step",
            "name": f"step[{rec.mode}]", "ts": _us(rec.t_start, t0),
            "dur": max(round(rec.dur_secs * 1e6, 3), 0.0),
            "args": {
                f.name: getattr(rec, f.name)
                for f in fields(rec) if f.name not in ("t_start", "index")
            },
        })
        # Device lane (workloads/profiler.py): the step's attributed
        # device window rendered directly under its step() span — in
        # the merged fleet trace this lane rides each replica's
        # process, aligned under that replica's attempt spans.
        # A card engine's record splits it into the prefill and the
        # decode time it read back, drawn one after the other.
        split = [
            (program, ms) for program, ms in (
                ("prefill", getattr(rec, "prefill_device_ms", 0.0)),
                ("decode", getattr(rec, "decode_device_ms", 0.0)),
            ) if ms > 0
        ]
        if not split and getattr(rec, "device_ms", 0.0) > 0:
            program = rec.mode
            if program == "idle" and rec.prefill_dispatches > 0:
                program = "prefill"
            split = [(program, rec.device_ms)]
        ts = _us(rec.t_start, t0)
        for program, ms in split:
            dur = max(round(ms * 1000.0, 3), 0.0)
            events.append({
                "ph": "X", "pid": 2, "tid": 2, "cat": "device",
                "name": f"device[{program}]", "ts": ts, "dur": dur,
                "args": {
                    "device_ms": ms,
                    "host_sync_ms": rec.host_sync_ms,
                    "mode": rec.mode,
                },
            })
            ts = round(ts + dur, 3)
        for counter, value in (
            ("occupancy", rec.occupancy),
            ("queue_depth", rec.queue_depth),
        ):
            events.append({
                "ph": "C", "pid": 2, "tid": 1, "name": counter,
                "ts": _us(rec.t_start, t0), "args": {counter: value},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# Merged fleet trace pid layout: the router process, the supervisor
# process, then two pids per replica (its requests + its engine steps,
# the same split the single-engine export uses).
_ROUTER_PID = 1
_SUPERVISOR_PID = 2
_REPLICA_PID_BASE = 10


def fleet_trace_events(
    fleet_observer,
    engine_observers=(),
    supervisor_events=(),
) -> dict:
    """Merge the whole fleet's timelines into ONE chrome trace_event
    object, all lanes on the fleet's clock:

      * **Router process** (pid 1): one lane per terminal fleet request
        — its queued segment, then one complete event per per-replica
        attempt (replica id, outcome/fault kind, charged flag, SLO
        class in ``args``), failover replays linked to the attempt they
        retry by chrome flow events ("s"/"f"), and an instant event at
        the exactly-one terminal status.
      * **Supervisor process** (pid 2): instant events for every
        supervision transition (death, backoff wait, canary probe,
        quarantine, rejoin, ... — ``SupervisorEvent``).
      * **Per-replica processes** (pids 10+): each replica's full
        engine timeline exactly as its own ``trace_events`` renders it
        (request lanes + step/counter tracks), re-based onto the shared
        clock zero.

    Load the written file in chrome://tracing or perfetto;
    ``tools/trace_export.py --validate`` schema-checks it."""
    spans = list(fleet_observer.spans) if fleet_observer is not None else []
    engine_observers = [o for o in engine_observers if o is not None]
    supervisor_events = list(supervisor_events)
    stamps = [s.t_submit for s in spans]
    stamps += [ev.t for ev in supervisor_events]
    for obs in engine_observers:
        stamps += [r.t_start for r in obs.steps]
        stamps += [sp.t_submit for sp in obs.spans]
    t0 = min(stamps) if stamps else 0.0
    events: list[dict] = [
        {"ph": "M", "pid": _ROUTER_PID, "tid": 0, "name": "process_name",
         "args": {"name": "fleet router"}},
        {"ph": "M", "pid": _SUPERVISOR_PID, "tid": 0,
         "name": "process_name", "args": {"name": "supervisor"}},
        {"ph": "M", "pid": _SUPERVISOR_PID, "tid": 1, "name": "thread_name",
         "args": {"name": "events"}},
    ]
    flow_id = 0
    for lane, span in enumerate(spans, start=1):
        events.append(
            {"ph": "M", "pid": _ROUTER_PID, "tid": lane,
             "name": "thread_name", "args": {"name": span.rid}}
        )
        first_dispatch = (
            span.attempts[0].t_dispatch if span.attempts else span.t_done
        )
        events.append({
            "ph": "X", "pid": _ROUTER_PID, "tid": lane, "cat": "request",
            "name": "queued", "ts": _us(span.t_submit, t0),
            "dur": max(
                _us(first_dispatch, t0) - _us(span.t_submit, t0), 0.0
            ),
            "args": {
                "rid": span.rid, "slo_class": span.slo_class,
                "status": span.status,
            },
        })
        prev_end = None
        for i, att in enumerate(span.attempts):
            end = att.t_end if att.t_end is not None else span.t_done
            events.append({
                "ph": "X", "pid": _ROUTER_PID, "tid": lane,
                "cat": "attempt", "name": f"attempt r{att.replica}",
                "ts": _us(att.t_dispatch, t0),
                "dur": max(
                    _us(end, t0) - _us(att.t_dispatch, t0), 0.0
                ),
                "args": {
                    "rid": span.rid, "replica": att.replica,
                    "attempt": i, "outcome": att.outcome,
                    "charged": att.charged, "tokens": att.tokens,
                    "retry_of": i - 1 if i else None,
                    "slo_class": span.slo_class,
                },
            })
            if i:
                # Chrome flow link: the replay attempt is a retry CHILD
                # of the attempt the fault ended ("s" at the parent's
                # end, "f" at the child's dispatch; matched by
                # cat+name+id).
                flow_id += 1
                events.append({
                    "ph": "s", "pid": _ROUTER_PID, "tid": lane,
                    "cat": "failover", "name": "failover",
                    "id": flow_id,
                    "ts": _us(prev_end if prev_end is not None
                              else att.t_dispatch, t0),
                })
                events.append({
                    "ph": "f", "pid": _ROUTER_PID, "tid": lane,
                    "cat": "failover", "name": "failover",
                    "id": flow_id, "bp": "e",
                    "ts": _us(att.t_dispatch, t0),
                })
            prev_end = end
        events.append({
            "ph": "i", "pid": _ROUTER_PID, "tid": lane, "cat": "request",
            "name": f"terminal:{span.status}", "ts": _us(span.t_done, t0),
            "s": "t",
            "args": {
                "rid": span.rid, "status": span.status,
                "failovers": span.failovers,
                "slo_class": span.slo_class,
                "slo_attained": span.slo_attained,
                "tokens": span.n_tokens,
            },
        })
    for ev in supervisor_events:
        events.append({
            "ph": "i", "pid": _SUPERVISOR_PID, "tid": 1,
            "cat": "supervisor", "name": ev.kind, "ts": _us(ev.t, t0),
            "s": "t",
            "args": {"chip_id": ev.chip_id, "detail": ev.detail},
        })
    for idx, obs in enumerate(engine_observers):
        base = _REPLICA_PID_BASE + 2 * idx
        for ev in trace_events(obs, t0=t0)["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = base + (ev["pid"] - 1)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_fleet_trace(
    path: str,
    fleet_observer,
    engine_observers=(),
    supervisor_events=(),
) -> tuple[int, int]:
    """Write the merged fleet timeline (``fleet_trace_events``) as
    chrome://tracing-loadable JSON.  Returns ``(n_events,
    n_replicas)`` — how much of the fleet the file actually covers, so
    the CLI can say so instead of silently exporting one replica."""
    engine_observers = [o for o in engine_observers if o is not None]
    trace = fleet_trace_events(
        fleet_observer, engine_observers, supervisor_events
    )
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return len(trace["traceEvents"]), len(engine_observers)
