"""A fault-domain serving fleet: N ``ServeEngine`` replicas behind a
draining, failover-capable router.

The paper's headline feature is time-sliced chip sharing — one physical
chip advertised as N schedulable replicas — and this module is the
serving side of that story: one ``ServeEngine`` per advertised replica,
fronted by a ``Router`` that dispatches with least-loaded +
session/prefix-affinity placement and a per-fleet admission bound.  The
headline contract is ROBUSTNESS: each replica is an isolated fault
domain, in the Llumnix lineage of instance-level schedulers over
Orca/vLLM-style continuous-batching engines.

  * **Failover by replay.** When a replica dies (a crash or hang at the
    replica seams of ``workloads/faults.py``, or any exception that
    escapes the engine's own step-level quarantine), the fleet harvests
    its in-flight requests — prompt plus every token already streamed —
    and requeues them at the router-queue front.  The next dispatch
    re-prefills prompt + emitted tokens on a survivor (the PR-4 replay
    path, lifted across engines), so a resumed greedy stream is
    bit-identical to an uninterrupted one and an interrupted stream is
    always a true prefix.  Every accepted rid reaches EXACTLY one
    terminal status, fleet-wide.
  * **Health drains are not faults.** A ``HealthFanout`` Unhealthy event
    pauses the affected replica's engine (the PR-4 health bridge); the
    fleet then withdraws that replica's requeued work and fails it over
    to survivors WITHOUT charging failover budgets — a sick chip is not
    the request's fault.  Mixed-attribution event streams drain exactly
    the replicas whose chip the event names; an unattributed event
    (``chip_id == ""``) applies to every replica, and an unattributed
    all-clear lifts every mark, so no stream can strand the whole fleet
    paused.  While EVERY replica is paused the fleet parks work in
    place (there is nowhere to fail over to) and resumes on recovery.
  * **Elastic membership.** ``drain()`` stops routing to a replica and
    lets its in-flight work finish; ``remove()`` closes a drained or
    dead replica; ``add_replica()`` joins a fresh engine live — the
    router sees it on the next dispatch.

The module also ships the workload that proves the fleet: an HTTP/SSE
front end (``FleetServer``; ``python -m workloads_torch.serve --fleet N
--http-port P``) and a seeded OPEN-LOOP traffic generator
(``TrafficGen``: bursty Markov-modulated arrivals, heavy-tailed prompt
lengths) driven by ``drive_open_loop`` — the bench's ``measure_fleet``
arm publishes ``fleet_tokens_per_sec`` / ``router_overhead_ms`` /
``fleet_ttft_p99_ms`` / ``failover_recovery_ms`` from exactly this
harness.

The fleet is single-threaded and cooperative — ``step()`` advances every
replica once, in index order, so tests are deterministic — and
additionally takes an internal lock around its public surface so the
HTTP front end can submit/poll from handler threads while one driver
thread steps (``serve_forever``).

Reference pendant: none — the reference plugin allocates the replicas
but never serves on them; this joins the two halves.

The PyTorch port's own copy of ``workloads/fleet.py`` (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds every
definition to it.  Two definitions differ: ``make_fleet`` builds the
port's ``ServeEngine`` on ``device``, and ``Fleet.publish_stats`` writes
the device plugin's stats document itself with the port's
``atomic_write_json`` (``tpu_device_plugin.kvsched.write_stats_snapshot``
imports the JAX package's ``durable`` at call time).
"""

from __future__ import annotations

import itertools
import json
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from .durable import SessionJournal
from .errors import EngineClosed, InvalidRequest, QueueFull, RequestTooLarge
from .faults import InjectedFault
from .obs import AttemptSpan

TERMINAL = ("ok", "cancelled", "expired", "failed")

ACTIVE = "active"
DRAINING = "draining"
DEAD = "dead"

# Replica roles (Fleet(roles=...), docs/SERVING.md "Disaggregated
# prefill/decode"): a ``prefill`` replica runs fresh prompts' budgeted
# sweeps to completion and hands the finished KV off; a ``decode``
# replica holds token-by-token residency and takes no fresh prompts
# while prefill capacity lives; ``mixed`` (the default) does both —
# today's behavior, and what every pool degrades to when its
# counterpart pool dies.
ROLES = ("prefill", "decode", "mixed")


@dataclass(frozen=True)
class SLOClass:
    """One service-level class a request can be submitted under
    (``Fleet.submit(slo_class=...)``).  A class binds whichever targets
    matter to its tenants — TTFT for interactive chat, TPOT (per-token
    decode time) for bulk generation — and an attainment ``objective``
    whose complement is the error budget the windowed burn-rate gauge
    divides by (SRE-workbook convention: burn rate 1.0 = spending the
    budget exactly as fast as the objective allows)."""

    name: str
    ttft_target_s: float | None = None
    tpot_target_s: float | None = None
    objective: float = 0.99

    def __post_init__(self):
        if self.ttft_target_s is None and self.tpot_target_s is None:
            raise ValueError(
                f"SLO class {self.name!r} needs at least one of "
                "ttft_target_s / tpot_target_s"
            )
        for field_name in ("ttft_target_s", "tpot_target_s"):
            v = getattr(self, field_name)
            if v is not None and v <= 0:
                raise ValueError(
                    f"{field_name} must be > 0, got {v}"
                )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )

    def met(self, ttft_secs, tpot_secs) -> bool:
        """Did a finished-ok request hit every target this class sets?
        A missing measurement against a set target is a miss (a request
        that never produced a first token cannot have attained a TTFT
        bound); an unset target constrains nothing, and a one-token
        request has no TPOT to miss."""
        if self.ttft_target_s is not None and (
            ttft_secs is None or ttft_secs > self.ttft_target_s
        ):
            return False
        if self.tpot_target_s is not None and (
            tpot_secs is not None and tpot_secs > self.tpot_target_s
        ):
            return False
        return True


# The stock class pair the ROADMAP's SLO scheduler names: TTFT-bound
# interactive tenants vs TPOT-bound bulk tenants.  Pass your own dict
# to Fleet(slo_classes=) to retune.
DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", ttft_target_s=1.0, objective=0.95),
    SLOClass("bulk", tpot_target_s=0.25, objective=0.95),
)


@dataclass
class KVHandoff:
    """One prefill→decode KV handoff ticket: the finished prompt's
    page payloads (host-RAM blobs out of the prefill replica's
    ``ServeEngine.export_kv`` — independent of the engine that produced
    them, so a prefill replica dying AFTER the spill cannot strand the
    ticket) plus enough identity to graft them into the target replica's
    radix index (``import_kv``) under the right adapter salt.  An empty
    ``blobs`` list is a valid ticket: the continuation then re-prefills
    — bit-identical, just without the transfer discount."""

    prompt: list[int]
    adapter: str | None
    blobs: list
    src_replica: int
    t_export: float


@dataclass
class FleetRequest:
    """One request through the fleet.  ``tokens`` is the STITCHED stream
    across replica segments (each failover's survivor segment appends);
    ``status`` follows the engine lifecycle — ``queued`` → ``running``
    → exactly one terminal status — with the fleet, not any single
    engine, owning the terminal transition.  ``failovers`` counts
    replays charged for TRUE replica faults (crash/hang/escaped
    exception); health drains and operator removals requeue uncharged."""

    rid: str
    prompt: list[int]
    max_new_tokens: int
    eos_token: int | None = None
    adapter: str | None = None
    session: str | None = None
    deadline_s: float | None = None
    t_deadline: float | None = None
    tokens: list[int] = field(default_factory=list)
    status: str = "queued"
    error: str | None = None
    replica: int | None = None
    failovers: int = 0
    segments: int = 0
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    # Fleet-scope tracing + SLO classes: one AttemptSpan per replica
    # dispatch (failover replays append retry children), the request's
    # SLO class tag, and the fleet's terminal attainment verdict (None
    # = untagged or excluded, e.g. cancelled).
    slo_class: str | None = None
    slo_attained: bool | None = None
    attempts: list = field(default_factory=list)
    # Preemption-via-offload (degradation ladder step 2): times this
    # stream was parked and requeued uncharged — kept separate from
    # ``failovers`` because being low priority is not a fault.
    preemptions: int = 0
    # Disaggregated prefill/decode: ``handoff_pending`` marks a dispatch
    # onto a prefill-pool replica whose budget was capped at the first
    # token (the prefill-complete signal); ``handoff`` carries the KV
    # ticket between the prefill retire and the decode re-dispatch;
    # ``handoffs`` counts completed prefill→decode transfers (uncharged
    # — a handoff is the plan, not a fault).
    handoff_pending: bool = False
    handoff: KVHandoff | None = None
    handoffs: int = 0

    @property
    def done(self) -> bool:
        return self.status in TERMINAL

    @property
    def ttft_secs(self) -> float | None:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def e2e_secs(self) -> float | None:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait_secs(self) -> float | None:
        """Submission -> FIRST admission into any replica's slots."""
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def tpot_secs(self) -> float | None:
        """Per-token decode time: first token -> done over the n-1
        decoded tokens (the bulk SLO class's bound).  None until
        terminal, and for streams that never decoded past their first
        token."""
        if self.t_first is None or self.t_done is None:
            return None
        if len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)


class Replica:
    """One fault domain: a ``ServeEngine`` plus its fleet-side state.

    ``chip_id`` ties the replica to the plugin-advertised chip whose
    time-slice it serves on, so health events route to exactly the
    replicas the sick chip backs."""

    def __init__(
        self, index: int, engine, chip_id: str = "", role: str = "mixed",
    ):
        import queue as _queue

        if role not in ROLES:
            raise ValueError(
                f"replica role must be one of {ROLES}, got {role!r}"
            )
        self.index = index
        self.engine = engine
        self.chip_id = chip_id
        self.role = role
        self.state = ACTIVE
        self.rids: dict[str, object] = {}  # fleet rid -> engine Request
        self.slow_steps = 0
        self.steps = 0
        # The per-replica health inbox the fleet routes fanout events
        # into; the engine polls it each step (raw-queue contract).  An
        # engine already carrying its own health subscription keeps it.
        if engine._health_events is None and engine._health_fanout is None:
            self.health_q: "_queue.Queue" = _queue.Queue()
            engine._health_events = self.health_q
        else:
            self.health_q = engine._health_events

    @property
    def paused(self) -> bool:
        return bool(self.engine.paused)

    @property
    def dispatchable(self) -> bool:
        """May the router hand this replica NEW work?"""
        return self.state == ACTIVE and not self.engine.paused

    def load(self) -> int:
        """The router's least-loaded scalar: queued + mid-prefill +
        occupied slots.  Queued and slotted requests count 1 each, but a
        row parked MID-PREFILL weighs its REMAINING prompt tokens in
        prompt-bucket units — a 4k-token prompt two chunks in is many
        steps of sweep work, and counting it as 1 (like a finishing
        one-token decode row) made long-prompt replicas look cheap
        exactly when they were busiest (pinned by
        tests/test_disagg.py::test_load_weights_midprefill_backlog)."""
        e = self.engine
        bucket = max(1, getattr(e, "prompt_bucket", 1))
        backlog = 0
        for plan in getattr(e, "_inflight_prefill", ()):
            if not plan.get("prefill", False):
                # Fan-out reuse rows wait on a sibling's logits — no
                # sweep work of their own; one unit, as before.
                backlog += 1
                continue
            remaining = plan["n"] - plan["cursor"] * bucket
            backlog += max(1, -(-remaining // bucket))
        return len(e.pending) + backlog + int(e._occupied.sum())

    def load_requests(self) -> int:
        """The PRE-weighting scalar: queued + mid-prefill + occupied,
        one unit per REQUEST.  The autoscaler's queue-depth signal is
        calibrated in requests per replica (``depth_high``), so it
        reads this — feeding it ``load()``'s bucket-weighted units
        would let one long mid-prefill prompt read as dozens of queued
        requests and trip a spurious scale-up/brownout."""
        e = self.engine
        return (
            len(e.pending)
            + len(e._inflight_prefill)
            + int(e._occupied.sum())
        )

    # ---- KV-page accounting (Fleet(page_scheduling=True)) ----------------

    def total_pages(self) -> int | None:
        """HBM KV pages this replica's engine owns, or None when the
        engine runs no page pool (page scheduling degrades to the
        request-count load for it)."""
        ctrl = getattr(self.engine, "ctrl", None)
        n = getattr(ctrl, "n_pages", None)
        return None if n is None else int(n)

    def free_pages(self) -> int | None:
        """Unallocated HBM KV pages right now, or None without a pool."""
        ctrl = getattr(self.engine, "ctrl", None)
        if ctrl is None or not hasattr(ctrl, "used_pages"):
            return None
        return max(0, int(ctrl.n_pages) - int(ctrl.used_pages))

    def host_free_pages(self) -> int:
        """Host-tier offload headroom in pages: how much HBM pressure
        this replica can relieve by spilling cold radix pages (0 when
        the engine runs no radix cache or the host tier is off; an
        unbounded tier reports one HBM pool's worth — the most the
        relief valve can matter to one scheduling decision)."""
        prefix = getattr(self.engine, "prefix", None)
        budget = getattr(prefix, "host_pages", 0)
        if prefix is None or budget == 0:
            return 0
        if budget is None:
            return self.total_pages() or 0
        return max(0, int(budget) - int(prefix.offloaded_pages))

    def page_load(self) -> int:
        """The page-granular router scalar: KV pages held plus pages
        the queued/mid-prefill work will claim — memory as the unit
        the fleet schedules, mirroring the device plugin's
        pages-per-chip advertisement.  Engines without a page pool
        fall back to the bucket-weighted request load so heterogeneous
        fleets keep a comparable (if mixed-unit) view."""
        e = self.engine
        ctrl = getattr(e, "ctrl", None)
        if ctrl is None or not hasattr(ctrl, "pages_needed"):
            return self.load()
        demand = 0
        for req in e.pending:
            n = len(getattr(req, "prompt", ()) or ())
            demand += max(1, int(ctrl.pages_needed(n)))
        bucket = max(1, getattr(e, "prompt_bucket", 1))
        for plan in getattr(e, "_inflight_prefill", ()):
            if not plan.get("prefill", False):
                demand += 1
                continue
            remaining = max(0, plan["n"] - plan["cursor"] * bucket)
            demand += max(1, int(ctrl.pages_needed(remaining)))
        return int(ctrl.used_pages) + demand

    # Pages of handicap a fully-wasteful replica carries in the
    # page-granular load view — enough to steer marginal dispatches
    # off a replica burning its chip-time, small enough that real
    # free-page deltas still dominate.
    _GOODPUT_PENALTY_PAGES = 4

    def goodput_penalty(self) -> int:
        """Ledger-informed handicap: (1 - goodput_fraction) scaled to
        pages.  0 without an armed per-engine chip-time ledger, and 0
        until the ledger has accounted any tokens — an idle fleet must
        not dispatch differently just because a ledger is attached."""
        led = getattr(self.engine, "ledger", None)
        if led is None or not getattr(led, "tokens_accounted", 0):
            return 0
        try:
            goodput = float(led.goodput_fraction)
        except Exception:
            return 0
        return int(round(
            (1.0 - max(0.0, min(1.0, goodput)))
            * self._GOODPUT_PENALTY_PAGES
        ))

    def dispatch_score(self, *, page_scheduling: bool = False) -> int:
        """THE routing scalar — the one seam the router and the
        goodput controller share.  Request-count fleets score the
        bucket-weighted ``load()``; page-scheduled fleets score pages
        held + pages the queued work will claim (``page_load()``) plus
        the ledger's goodput handicap, so a replica burning chip-time
        on waste stops winning marginal dispatches.  Pinned unchanged
        against the two pre-unification paths by tests/test_fleet.py."""
        if page_scheduling:
            return self.page_load() + self.goodput_penalty()
        return self.load()

    @property
    def idle(self) -> bool:
        return self.engine.idle


class Router:
    """Dispatch policy: least-loaded with session/prefix affinity.

    Affinity key: the request's explicit ``session`` when given, else
    the first ``prefix_tokens`` prompt tokens — requests sharing a
    system prompt land on the replica that already holds its KV pages
    (the prefix cache is per-engine, so affinity is what makes it pay
    fleet-wide).  When replicas carry the RADIX prefix index
    (``prefix_cache=True`` engines), a sticky miss falls through to
    MEASURED affinity: each in-slack candidate is scored by its tree's
    actual longest-prefix match depth for THIS prompt
    (``RadixKV.match_depth`` — offloaded pages count; they reload on
    hit), and the deepest match wins — so a replica that genuinely
    holds a conversation's pages attracts its next turn even when the
    opaque session/prefix key never saw it.  Affinity yields to
    balance: a sticky replica more than ``affinity_slack`` requests
    above the least-loaded one is skipped (classic bounded-load
    consistent placement).  Deterministic throughout — ties break on
    (load, lowest replica index)."""

    def __init__(self, *, affinity_slack: int = 2, prefix_tokens: int = 16):
        if affinity_slack < 0:
            raise ValueError(
                f"affinity_slack must be >= 0, got {affinity_slack}"
            )
        if prefix_tokens < 1:
            raise ValueError(
                f"prefix_tokens must be >= 1, got {prefix_tokens}"
            )
        self.affinity_slack = affinity_slack
        self.prefix_tokens = prefix_tokens
        self._affinity: dict = {}
        self.dispatches = 0
        self.affinity_hits = 0
        self.radix_hits = 0  # picks won by measured radix match depth

    def _key(self, fr: FleetRequest):
        if fr.session is not None:
            return ("session", fr.session)
        return ("prefix", tuple(fr.prompt[: self.prefix_tokens]))

    @staticmethod
    def _radix_depth(rep: Replica, fr: FleetRequest) -> int:
        """Pages of this prompt the replica's radix index already holds
        (0 when the engine runs no cache, a flat cache, or the probe
        fails — measured affinity degrades to the key-based policy,
        never breaks dispatch)."""
        prefix = getattr(rep.engine, "prefix", None)
        match = getattr(prefix, "match_depth", None)
        if match is None:
            return 0
        try:
            aidx = rep.engine._adapter_ids.get(fr.adapter, 0)
            salt = f"lora:{aidx}" if aidx else ""
            return int(match(fr.prompt, salt=salt))
        except Exception:
            return 0

    def choose(
        self, fr: FleetRequest, candidates: list[Replica],
        loads: dict[int, int],
    ) -> int:
        """Pick a replica index from ``candidates`` (non-empty, all
        dispatchable).  ``loads`` is the router's WORKING load view —
        the caller bumps the chosen entry so one step's dispatches
        spread instead of all chasing the same minimum."""
        self.dispatches += 1
        min_load = min(loads[r.index] for r in candidates)
        key = self._key(fr)
        sticky = self._affinity.get(key)
        if sticky is not None:
            for rep in candidates:
                if rep.index == sticky:
                    if loads[sticky] <= min_load + self.affinity_slack:
                        self.affinity_hits += 1
                        return sticky
                    break
        # Measured affinity: among candidates within the load slack,
        # the replica whose radix tree holds the DEEPEST actual prefix
        # of this prompt wins (adapter-salted, offloaded pages count);
        # depth 0 everywhere falls through to plain least-loaded.
        in_slack = [
            r for r in candidates
            if loads[r.index] <= min_load + self.affinity_slack
        ]
        depths = {r.index: self._radix_depth(r, fr) for r in in_slack}
        best = max(
            in_slack,
            key=lambda r: (depths[r.index], -loads[r.index], -r.index),
        )
        if depths[best.index] > 0:
            self.radix_hits += 1
            pick = best.index
        else:
            pick = min(
                candidates, key=lambda r: (loads[r.index], r.index)
            ).index
        self._affinity[key] = pick
        return pick

    def forget(self, index: int) -> None:
        """Drop affinity pins onto a replica that left the fleet."""
        self._affinity = {
            k: v for k, v in self._affinity.items() if v != index
        }


class Fleet:
    """N ``ServeEngine`` replicas behind a draining, failover-capable
    router.

    Construct with a list of engines (homogeneous config; each becomes
    one fault domain), or see ``make_fleet`` for the factory helper.
    Engines should be built WITHOUT their own ``max_pending`` — the
    fleet owns bounded admission (``max_pending=``, fleet-wide).

    ``fault_injector`` consults the REPLICA-level seams of
    ``workloads/faults.py`` once per replica step: ``replica_crash``
    and ``replica_hang`` kill the replica (hang after the step watchdog
    ``hang_timeout_s`` budget; ``None`` disables the wall-clock
    watchdog — injected hangs still fire.  A replica's FIRST step is
    always exempt: it is dominated by one-time XLA compilation, and a
    compile is not a wedge), failing its work over to survivors
    under ``max_failovers``; ``replica_slow`` injects
    ``slow_readback_s`` of extra step latency, and
    ``slow_drain_after`` consecutive slow steps auto-drain the replica
    (graceful — in-flight work finishes there, nothing is charged).
    Engine-internal seams stay the engines' own business (their
    quarantine/replay machinery runs unchanged inside each domain)."""

    def __init__(
        self,
        engines,
        *,
        router: Router | None = None,
        chip_ids: list[str] | None = None,
        max_pending: int | None = None,
        max_pending_per_replica: int | None = None,
        max_failovers: int = 2,
        fault_injector=None,
        hang_timeout_s: float | None = 5.0,
        slow_readback_s: float = 0.002,
        slow_drain_after: int | None = 3,
        observer=None,
        slo_classes=None,
        slo_window_s: float = 60.0,
        roles=None,
        wfq_weights=None,
        ledger=None,
        page_scheduling: bool = False,
        stats_path: str | None = None,
        journal_dir: str | None = None,
        journal_every: int | None = None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        if roles is not None:
            roles = list(roles)
            if len(roles) != len(engines):
                raise ValueError(
                    f"roles ({len(roles)}) must match engines "
                    f"({len(engines)})"
                )
            bad = [r for r in roles if r not in ROLES]
            if bad:
                raise ValueError(
                    f"replica roles must be from {ROLES}, got {bad}"
                )
        if wfq_weights is not None:
            import math

            wfq_weights = dict(wfq_weights)
            for cls, w in wfq_weights.items():
                if not isinstance(w, (int, float)) or not math.isfinite(
                    w
                ) or w <= 0:
                    raise ValueError(
                        f"wfq_weights[{cls!r}] must be a finite weight "
                        f"> 0, got {w!r}"
                    )
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None (unbounded), got "
                f"{max_pending}"
            )
        if max_pending_per_replica is not None and max_pending_per_replica <= 0:
            raise ValueError(
                f"max_pending_per_replica must be > 0 or None (fractions "
                f"allowed: the bound is ceil(per * active)), got "
                f"{max_pending_per_replica}"
            )
        if max_pending is not None and max_pending_per_replica is not None:
            raise ValueError(
                "pass max_pending (static fleet-wide bound) OR "
                "max_pending_per_replica (capacity-aware bound), not both"
            )
        if max_failovers < 0:
            raise ValueError(
                f"max_failovers must be >= 0, got {max_failovers}"
            )
        if chip_ids is not None and len(chip_ids) != len(engines):
            raise ValueError(
                f"chip_ids ({len(chip_ids)}) must match engines "
                f"({len(engines)})"
            )
        self.router = router if router is not None else Router()
        self.replicas: list[Replica] = [
            Replica(
                i, eng, (chip_ids or [""] * len(engines))[i],
                role=(roles or ["mixed"] * len(engines))[i],
            )
            for i, eng in enumerate(engines)
        ]
        # SLO-class weighted fair queuing (docs/SERVING.md
        # "Disaggregated prefill/decode"): with weights set, fresh
        # prompts dispatch in per-class virtual-time order instead of
        # strict FIFO — a class's virtual time advances by its
        # prefill cost (prompt-bucket units) over its weight per
        # dispatch, so the contended prefill slots split in weight
        # proportion while continuations (failover replays, handoff
        # tickets, preempted resumptions) keep absolute precedence:
        # they already started service.  None keeps FIFO (today's
        # behavior).  The PR-13 preemption ladder stays the priority
        # backstop above this: parked classes skip dispatch entirely.
        self.wfq_weights: dict[str, float] | None = wfq_weights
        self._wfq_vtime: dict[str, float] = {}
        self._wfq_v = 0.0
        self.wfq_dispatches: dict[str, int] = {}
        self._bucket = max(
            1, getattr(engines[0], "prompt_bucket", 1)
        )
        self.max_pending = max_pending
        # Capacity-aware load shedding: with ``max_pending_per_replica``
        # the fleet-wide admission bound is per-replica budget x the
        # CURRENT number of replicas the router can dispatch to, so a
        # degraded fleet sheds (typed QueueFull) instead of queueing
        # work its surviving capacity cannot absorb — and the bound
        # grows back the moment the supervisor resurrects a replica.
        self.max_pending_per_replica = max_pending_per_replica
        # Brownout knob (degradation ladder step 1, set by the
        # autoscaler): < 1.0 tightens the admission bound to this
        # fraction while overload outruns elastic capacity; QueueFull
        # messages name the brownout so rejected clients know the shed
        # is deliberate and temporary.
        self.admission_factor = 1.0
        # Degradation ladder step 2: SLO classes parked out of dispatch
        # (their queued requests hold position but are skipped) while
        # the autoscaler's preemption-via-offload protects the
        # interactive class.  Empty outside ladder level 2 — an
        # abandoned non-empty set would starve the class, so only the
        # autoscaler's ladder transitions write it.
        self.parked_classes: set[str] = set()
        self.max_failovers = max_failovers
        self._faults = fault_injector
        if hang_timeout_s is not None and hang_timeout_s <= 0:
            raise ValueError(
                f"hang_timeout_s must be > 0 or None (watchdog off), "
                f"got {hang_timeout_s}"
            )
        self.hang_timeout_s = (
            None if hang_timeout_s is None else float(hang_timeout_s)
        )
        self.slow_readback_s = float(slow_readback_s)
        self.slow_drain_after = slow_drain_after
        self.queue: deque[FleetRequest] = deque()
        self._reqs: dict[str, FleetRequest] = {}
        self.completed: list[FleetRequest] = []
        # Terminal transitions made OUTSIDE step() (cancel of a
        # router-queued request) surface through the next step()'s
        # return, mirroring the engine's contract.
        self._finished_buffer: list[FleetRequest] = []
        self._ids = itertools.count()
        self._closed = False
        self._lock = threading.RLock()
        self._health_fanout = None
        self._health_sub = None
        # Supervision seam (workloads/supervisor.py): when set, a
        # zero-live-replica fleet consults it before failing its queue —
        # True means a resurrection is pending and the queue PARKS for
        # the replacement instead of failing terminally.  Validation
        # needs a config even while every engine is down, so it is
        # cached from the founding member.
        self.revival_hook = None
        self._config_cache = engines[0].config
        # Telemetry: the fleet-level mirror of the engines' lifecycle
        # counters, plus the router/failover economics the bench reads.
        self.requests_submitted = 0
        self.queue_rejections = 0
        self.requests_ok = 0
        self.requests_cancelled = 0
        self.requests_expired = 0
        self.requests_failed = 0
        self.failover_requeues = 0  # charged (true-fault) failovers
        self.drain_requeues = 0  # uncharged (health/operator) failovers
        # Chip-time ledger waste class "replay" at FLEET scope: prompt
        # + emitted tokens requeued for re-prefill on a survivor (a
        # failover's or drain's recompute bill — the replica-local
        # pendant is engine.tokens_replayed; workloads/ledger.py).
        self.tokens_replayed = 0
        # Preemption-via-offload (degradation ladder step 2): streams
        # parked by preempt() and requeued uncharged, plus the
        # preempt -> next-resumed-token windows the bench publishes as
        # autoscale_preempt_resume_ms.
        self.preemptions = 0
        self.preempt_resume_s: list[float] = []
        self._preempted_at: dict[str, float] = {}
        # Disaggregated prefill/decode: completed KV handoffs, pages
        # shipped on tickets, and the prefill-done -> first-decode-token
        # windows the bench publishes as disagg_handoff_ms.
        self.kv_handoffs = 0
        self.handoff_pages = 0
        self.handoff_s: list[float] = []
        self._handoff_at: dict[str, float] = {}
        self.replica_crashes = 0
        self.replica_hangs = 0
        self.replicas_added = 0
        self.replicas_removed = 0
        self.generated_tokens = 0
        self.router_secs = 0.0  # dispatch + failover bookkeeping time
        # Failover recovery: fault stamp -> first post-failover token on
        # a survivor, the fleet-scope pendant of engine.fault_recovery_s
        # (the bench's failover_recovery_ms).
        self.failover_recovery_s: list[float] = []
        self._t_fault: float | None = None
        self._recovery_rids: set[str] = set()
        # SLO classes: requests submitted with slo_class= are scored
        # against their class targets at the terminal transition, and
        # the per-class attainment counters + sliding miss window feed
        # the burn-rate gauge (the SLO scheduler/autoscaler inputs).
        if slo_window_s <= 0:
            raise ValueError(
                f"slo_window_s must be > 0, got {slo_window_s}"
            )
        classes = (
            DEFAULT_SLO_CLASSES if slo_classes is None else slo_classes
        )
        if isinstance(classes, dict):
            classes = tuple(classes.values())
        self.slo_classes: dict[str, SLOClass] = {
            c.name: c for c in classes
        }
        self.slo_window_s = float(slo_window_s)
        self.slo_request_counts = {c: 0 for c in self.slo_classes}
        self.slo_attained_counts = {c: 0 for c in self.slo_classes}
        self._slo_window: dict[str, deque] = {
            c: deque() for c in self.slo_classes
        }
        self._obs = observer
        if observer is not None:
            observer._bind(self)
        # Fleet-scope chip-time ledger (workloads/ledger.py
        # FleetLedger): per-replica engine ledgers roll up through it
        # and the fleet classifies terminal tokens per SLO class.
        # Inert like the observer; /healthz and the FleetObserver's
        # LEDGER_METRICS families read it.
        self.ledger = ledger
        # KV pages as the schedulable unit (docs/SERVING.md "Memory as
        # the schedulable unit"): dispatch ranks replicas by a
        # page-granular load view (pages held + pages the queued work
        # will claim, goodput-penalized) instead of request counts, and
        # an unbounded/per-replica admission bound additionally caps at
        # the fleet's aggregate free pages (HBM + host-tier headroom —
        # oversubscription stays safe because cold pages spill to the
        # PR-9 host tier instead of evicting).  Off by default: False
        # keeps every dispatch decision bit-identical to the
        # request-count router.
        self.page_scheduling = bool(page_scheduling)
        # Where publish_stats() drops the live-signal snapshot the
        # device plugin's GetPreferredAllocation scorer reads
        # (tpu_device_plugin/kvsched.py); None publishes nowhere until
        # a path is passed explicitly.
        self.stats_path = stats_path
        self._stats_epoch = 0
        self.page_dispatches = 0
        self.stats_published = 0
        # Durable sessions (docs/SERVING.md "Durable sessions"): with a
        # journal directory set, ``journal_now()`` checkpoints every
        # live session (and a bounded tail of finished ones) plus their
        # prefix pages' disk-tier copies, and ``restore()`` on a
        # freshly built fleet resurrects them after a FULL process
        # restart — greedy continuations bit-identical to the
        # uninterrupted stream (the failover-replay contract lifted
        # across process death).  ``journal_every`` (steps) arms an
        # automatic cadence inside ``step()``; None journals only on
        # explicit calls (the supervisor's poll cadence, close()).
        if journal_every is not None and journal_every < 1:
            raise ValueError(
                f"journal_every must be >= 1 or None, got {journal_every}"
            )
        if journal_every is not None and journal_dir is None:
            raise ValueError(
                "journal_every needs journal_dir= (nowhere to write)"
            )
        self._journal = (
            SessionJournal(journal_dir, injector=fault_injector)
            if journal_dir is not None else None
        )
        self.journal_every = journal_every
        self._steps_since_journal = 0
        self.journal_sessions = 0  # sessions in the last checkpoint
        self.sessions_restored = 0

    # ---- introspection ---------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def alive(self) -> list[Replica]:
        return [r for r in self.replicas if r.state != DEAD]

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return (
            not self.queue
            and not self._finished_buffer
            and all(r.idle for r in self.alive)
        )

    def states(self) -> dict[int, str]:
        return {r.index: r.state for r in self.replicas}

    def roles(self) -> dict[int, str]:
        return {r.index: r.role for r in self.replicas}

    @property
    def disaggregated(self) -> bool:
        """Does any live replica carry a specialist role?  False keeps
        every dispatch on today's role-blind path."""
        return any(
            r.role != "mixed" for r in self.replicas if r.state != DEAD
        )

    @property
    def dispatchable_count(self) -> int:
        """Replicas the router can hand NEW work to right now (ACTIVE
        and not health-paused) — the capacity the capacity-aware
        admission bound scales with.  DRAINING and paused replicas
        still finish their in-flight work, but queueing fresh load
        against capacity that accepts none of it is exactly the
        unbounded-growth mode the bound exists to prevent."""
        return sum(1 for r in self.replicas if r.dispatchable)

    @property
    def admission_bound(self) -> int | None:
        """The fleet queue's CURRENT admission bound: the static
        ``max_pending`` when set, the capacity-scaled
        ``max_pending_per_replica x max(1, dispatchable replicas)``
        when that knob is set (never zero — a fully-degraded fleet
        still queues one replica's worth while recovery runs), else
        None (unbounded).  ``admission_factor`` < 1 TIGHTENS whichever
        bound is in force (the autoscaler's brownout — degradation
        ladder step 1); it never loosens one and never bounds an
        unbounded fleet."""
        bound = None
        if self.max_pending is not None:
            bound = self.max_pending
        elif self.max_pending_per_replica is not None:
            import math

            # ceil of the exact product: a fractional per-replica
            # budget (the supervisor's max_pending/n conversion) yields
            # the operator's EXACT bound at full capacity instead of a
            # rounded-up one.
            bound = max(1, math.ceil(
                self.max_pending_per_replica
                * max(1, self.dispatchable_count)
            ))
        if self.page_scheduling and self.max_pending is None:
            pages = self.aggregate_free_pages()
            if pages is not None:
                # Admission scales with what the memory can actually
                # hold: one queued request per aggregate free page
                # (HBM + host-tier headroom).  An operator's static
                # max_pending stays authoritative; the page bound only
                # CAPS the per-replica/unbounded modes — admitting past
                # the pages would just park work in the queue anyway.
                page_bound = max(1, pages)
                bound = (
                    page_bound if bound is None
                    else min(bound, page_bound)
                )
        if bound is not None and self.admission_factor < 1.0:
            bound = max(1, int(bound * self.admission_factor))
        return bound

    def aggregate_free_pages(self) -> int | None:
        """Free KV pages the dispatchable replicas can absorb right
        now, host-tier offload headroom included; None when no
        dispatchable replica exposes a page pool (page-granular
        admission degrades to the configured bound)."""
        total = None
        for rep in self.replicas:
            if not rep.dispatchable:
                continue
            free = rep.free_pages()
            if free is None:
                continue
            total = (total or 0) + free + rep.host_free_pages()
        return total

    # Back-compat alias: the penalty logic moved onto Replica (the
    # dispatch_score unification); the fleet-side name stays callable.
    _GOODPUT_PENALTY_PAGES = Replica._GOODPUT_PENALTY_PAGES

    def _goodput_penalty(self, rep: Replica) -> int:
        return rep.goodput_penalty()

    def publish_stats(self, path: str | None = None) -> str | None:
        """Publish each replica's live signals — free/total KV pages,
        host-tier headroom, radix-resident pages, ledger busy/goodput
        fractions — to the host-local snapshot the device plugin's
        GetPreferredAllocation scorer reads (atomic write-then-rename
        with a monotonic epoch; tpu_device_plugin/kvsched.py).  Chips
        are keyed by ``chip_id``, so only replicas pinned to an
        advertised chip publish.  Returns the path written, or None
        when no path is configured or no replica carries a chip id
        (the scorer then falls back to the static spread — by
        design).

        The document is ``kvsched.write_stats_snapshot``'s, built here
        and written with the port's ``atomic_write_json`` (that function
        imports the JAX package's ``durable``): the stamped epoch is
        max(the file's epoch + 1, the fleet's next), the signals are
        floats, and ``kvsched.read_stats_snapshot`` reads it as JAX's."""
        from .durable import atomic_write_json

        path = path if path is not None else self.stats_path
        if path is None:
            return None
        chips: dict[str, dict[str, float]] = {}
        for rep in self.replicas:
            if not rep.chip_id or rep.state == DEAD:
                continue
            signals = chips.setdefault(rep.chip_id, {
                "free_pages": 0.0, "total_pages": 0.0,
                "host_free_pages": 0.0, "radix_resident_pages": 0.0,
                "busy_fraction": 0.0, "goodput_fraction": 0.0,
            })
            free = rep.free_pages()
            if free is not None:
                signals["free_pages"] += free
                signals["total_pages"] += rep.total_pages() or 0
            signals["host_free_pages"] += rep.host_free_pages()
            prefix = getattr(rep.engine, "prefix", None)
            signals["radix_resident_pages"] += float(
                getattr(prefix, "cached_pages", 0) or 0
            )
            led = getattr(rep.engine, "ledger", None)
            if led is not None:
                # Chips backing several replicas publish the WORST
                # busy and goodput: the scorer is placing NEW load,
                # and the most contended time-slice is what it hits.
                signals["busy_fraction"] = max(
                    signals["busy_fraction"], float(led.busy_fraction)
                )
                signals["goodput_fraction"] = max(
                    signals["goodput_fraction"],
                    float(led.goodput_fraction),
                )
        if not chips:
            return None
        prev = -1
        try:
            with open(path, encoding="utf-8") as f:
                prev = int(json.load(f).get("epoch", -1))
        except (OSError, ValueError, TypeError, AttributeError):
            prev = -1
        stamped = max(prev + 1, self._stats_epoch + 1)
        atomic_write_json(path, {
            "epoch": stamped,
            "written_at": float(time.time()),
            "chips": {
                str(cid): {
                    k: float(v) for k, v in signals.items()
                    if isinstance(v, (int, float))
                }
                for cid, signals in chips.items()
            },
        })
        self._stats_epoch = stamped
        self.stats_published += 1
        return path

    # ---- durable sessions ------------------------------------------------

    # Finished-ok sessions kept in each checkpoint (newest first to
    # go): enough for post-restart session continuation, bounded so the
    # journal cannot grow with lifetime traffic.
    _JOURNAL_IDLE_CAP = 256

    @property
    def journal_writes(self) -> int:
        """Checkpoints durably written (fleet_journal_writes_total)."""
        return self._journal.writes if self._journal is not None else 0

    @property
    def journal_torn(self) -> int:
        """Checkpoints torn mid-write by the ``journal_torn_write``
        seam — each one left the previous generation as the recovery
        point (fleet_journal_torn_total)."""
        return (
            self._journal.torn_writes if self._journal is not None else 0
        )

    def journal_now(self) -> int:
        """Checkpoint the fleet's sessions into the journal: every
        live request (router-queued and dispatched — the live engine
        segment's already-consumed tokens included) plus the most
        recent finished streams, live and ok ones with their prefix
        pages flushed to the disk tier first.  Cancelled, expired and
        failed streams are journaled too, as history with nothing to
        resume: ``restore()`` mints new rids past every journaled one,
        and the JAX package's copy, which leaves them out, re-mints the
        rid of one that ended just before the restart (two terminal
        statuses for one rid).  The parked-page manifest is implicit
        by construction: pages are keyed by the prompt+tokens chain
        keys, so ``restore()`` recomputes them from the record alone.
        Returns sessions checkpointed; 0 without a journal.  A torn
        write (injected crash-mid-write) is counted, never raised —
        the previous generation remains the recovery point."""
        if self._journal is None:
            return 0
        with self._lock:
            live: list[dict] = []
            idle: list[dict] = []
            for fr in self._reqs.values():
                toks = list(fr.tokens)
                if not fr.done and fr.replica is not None:
                    rep = self.replicas[fr.replica]
                    ereq = rep.rids.get(fr.rid)
                    if ereq is not None:
                        toks += [int(t) for t in ereq.tokens]
                rec = {
                    "rid": fr.rid,
                    "prompt": [int(t) for t in fr.prompt],
                    "tokens": toks,
                    "max_new_tokens": int(fr.max_new_tokens),
                    "eos_token": fr.eos_token,
                    "adapter": fr.adapter,
                    "session": fr.session,
                    "slo_class": fr.slo_class,
                    "status": fr.status if fr.done else "live",
                }
                (idle if fr.done else live).append(rec)
            records = idle[-self._JOURNAL_IDLE_CAP:] + live
            flushed = 0
            for rec in records:
                stitched = rec["prompt"] + rec["tokens"]
                pages = 0
                for rep in self.replicas:
                    if rec["status"] not in ("live", "ok"):
                        break  # history only: nothing to resume
                    if rep.state == DEAD:
                        continue
                    try:
                        pages = rep.engine.flush_kv_to_disk(
                            stitched, adapter=rec["adapter"]
                        )
                    except Exception:  # noqa: BLE001 — a checkpoint
                        pages = 0  # must never take the fleet down
                    if pages:
                        break  # files are shared: one durable copy is enough
                rec["kv_pages"] = pages
                flushed += pages
            self._journal.write(records, meta={
                "sessions": len(records), "kv_pages_flushed": flushed,
            })
            self.journal_sessions = len(records)
            self._steps_since_journal = 0
            return len(records)

    def restore(self, journal_dir: str | None = None) -> int:
        """Resurrect journaled sessions into THIS (freshly built, still
        empty) fleet after a full process restart.  Finished sessions
        re-register as history — their rids stay unique and pollable,
        no terminal counter moves (they were the dead process's work).
        Live sessions requeue with their journaled tokens stitched:
        the next dispatch re-prefills prompt + emitted on whichever
        replica the router picks, and ``attach_kv_disk`` first adopts
        their parked pages from ``--kv-disk-dir`` so the re-prefill
        reloads instead of recomputing.  A journaled-complete stream
        (the process died between its last token and the terminal
        transition) finishes terminally here without re-dispatch.
        Greedy continuations are bit-identical to the uninterrupted
        stream; sampled ones preserve the journaled prefix exactly.
        The replayed prompt+token re-prefill is charged to
        ``tokens_replayed`` (ledger waste class "replay").  Returns
        sessions restored; a missing or doubly-corrupt journal
        restores 0 (cold start), never raises."""
        journal = self._journal
        if journal_dir is not None:
            journal = SessionJournal(journal_dir)
        if journal is None:
            raise ValueError(
                "restore() needs journal_dir= here or on the Fleet"
            )
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet is closed")
            if self._reqs:
                raise RuntimeError(
                    "restore() is a boot-time operation: this fleet "
                    f"already tracks {len(self._reqs)} request(s)"
                )
            records, reason = journal.load()
            if records is None:
                return 0  # absent/corrupt: cold start, by design
            restored = 0
            for rec in records:
                try:
                    rid = str(rec["rid"])
                    prompt = [int(t) for t in rec["prompt"]]
                    toks = [int(t) for t in rec.get("tokens") or ()]
                    budget = int(rec["max_new_tokens"])
                    status = str(rec.get("status", "live"))
                except (KeyError, TypeError, ValueError):
                    continue  # one damaged record must not sink the rest
                if not prompt or budget < 1 or rid in self._reqs:
                    continue
                eos = rec.get("eos_token")
                fr = FleetRequest(
                    rid, prompt, budget,
                    int(eos) if eos is not None else None,
                    adapter=rec.get("adapter"),
                    session=rec.get("session"),
                    slo_class=(
                        rec.get("slo_class")
                        if rec.get("slo_class") in self.slo_classes
                        else None
                    ),
                    t_submit=time.perf_counter(),
                )
                fr.tokens = toks
                self._reqs[rid] = fr
                restored += 1
                if status in TERMINAL:
                    # History: visible to poll()/session continuation,
                    # not this process's work.
                    fr.status = status
                    fr.t_submit = None
                    self.completed.append(fr)
                    continue
                self.requests_submitted += 1
                if len(toks) >= budget or (
                    fr.eos_token is not None
                    and toks
                    and toks[-1] == fr.eos_token
                ):
                    # Bit-complete in the journal: the process died
                    # between the last token and the terminal
                    # transition (the _requeue_victims check, lifted
                    # across process death).
                    self._finished_buffer.append(
                        self._finish_terminal(fr, "ok")
                    )
                    continue
                # Adopt the parked pages everywhere live — the files
                # are shared and attach costs stat calls, so the
                # router's pick is free to land anywhere.
                stitched = prompt + toks
                for rep in self.replicas:
                    if rep.state == DEAD:
                        continue
                    try:
                        rep.engine.attach_kv_disk(
                            stitched, adapter=fr.adapter
                        )
                    except Exception:  # noqa: BLE001 — degrade to
                        pass  # plain re-prefill, bit-identical anyway
                self.tokens_replayed += len(stitched)
                fr.status = "queued"
                self.queue.append(fr)
            # Never mint a rid the journal already owns: a restored
            # "fleet-3" colliding with this process's own counter would
            # reject the new submission as already-in-flight.
            taken = [
                int(r[len("fleet-"):]) for r in self._reqs
                if r.startswith("fleet-")
                and r[len("fleet-"):].isdigit()
            ]
            if taken:
                self._ids = itertools.count(max(taken) + 1)
            self.sessions_restored += restored
            return restored

    def _revival_pending(self) -> bool:
        hook = self.revival_hook
        if hook is None:
            return False
        try:
            return bool(hook())
        except Exception:  # noqa: BLE001 — a broken hook must not wedge
            return False  # the fleet's own failure handling

    def _config(self):
        for rep in self.replicas:
            if rep.state != DEAD:
                return rep.engine.config
        if self._revival_pending():
            # Every replica is down but a supervisor is bringing one
            # back: keep accepting (bounded) work for the replacement.
            return self._config_cache
        raise EngineClosed("every replica in the fleet is dead")

    # ---- submission ------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int | None = None,
        *,
        eos_token: int | None = None,
        rid: str | None = None,
        adapter: str | None = None,
        deadline_s: float | None = None,
        session: str | None = None,
        slo_class: str | None = None,
    ) -> str:
        """Queue one request with the router; dispatch happens on the
        next ``step()``.  Validation mirrors ``ServeEngine.submit`` so
        a request the fleet accepts is one every (homogeneous) replica
        can run; bounded admission raises a typed ``QueueFull`` against
        the FLEET-wide queue.  ``slo_class`` tags the request with one
        of the fleet's service-level classes (``slo_classes=``; default
        ``interactive``/``bulk``) — scored at the terminal transition,
        never consulted by dispatch, so tagging cannot move tokens."""
        with self._lock:
            if self._closed:
                raise EngineClosed(
                    "fleet is closed; submissions are refused"
                )
            config = self._config()
            prompt = [int(t) for t in prompt]
            limit = config.max_seq_len - 1
            if not 1 <= len(prompt) <= limit:
                raise RequestTooLarge(
                    f"prompt length {len(prompt)} must be in [1, {limit}]"
                )
            if max_new_tokens is None:
                max_new_tokens = config.max_seq_len - len(prompt)
            if max_new_tokens < 1:
                raise InvalidRequest(
                    f"max_new_tokens must be >= 1, got {max_new_tokens}"
                )
            if len(prompt) + max_new_tokens > config.max_seq_len:
                raise RequestTooLarge(
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds max_seq_len "
                    f"{config.max_seq_len}"
                )
            if deadline_s is not None and deadline_s <= 0:
                raise InvalidRequest(
                    f"deadline_s must be > 0 (or None), got {deadline_s}"
                )
            if slo_class is not None and slo_class not in self.slo_classes:
                raise InvalidRequest(
                    f"unknown slo_class {slo_class!r}: fleet serves "
                    f"{sorted(self.slo_classes) or '(none)'}"
                )
            bound = self.admission_bound
            if bound is not None and len(self.queue) >= bound:
                self.queue_rejections += 1
                scaled = (
                    f" (capacity-aware: scaled to "
                    f"{self.dispatchable_count} dispatchable "
                    f"replica(s))" if self.max_pending is None else ""
                )
                brownout = (
                    f" (brownout: admission tightened to "
                    f"{self.admission_factor:g}x while overload "
                    f"outruns scale-up)"
                    if self.admission_factor < 1.0 else ""
                )
                raise QueueFull(
                    f"fleet queue is full ({len(self.queue)} >= "
                    f"max_pending {bound}{scaled}{brownout}); resubmit "
                    "after completions drain it"
                )
            rid = rid if rid is not None else f"fleet-{next(self._ids)}"
            if rid in self._reqs and not self._reqs[rid].done:
                raise InvalidRequest(
                    f"request id {rid!r} is already in flight"
                )
            t_submit = time.perf_counter()
            fr = FleetRequest(
                rid, prompt, max_new_tokens, eos_token, adapter=adapter,
                session=session, deadline_s=deadline_s,
                t_deadline=(
                    t_submit + deadline_s if deadline_s is not None
                    else None
                ),
                t_submit=t_submit, slo_class=slo_class,
            )
            self._reqs[rid] = fr
            self.queue.append(fr)
            self.requests_submitted += 1
            return rid

    def cancel(self, rid: str) -> bool:
        """Cancel one request anywhere in the fleet: router-queued
        requests finish terminally here; dispatched ones cancel inside
        their replica's engine (surfacing on the next step).  Returns
        True iff the rid was live."""
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet is closed")
            fr = self._reqs.get(rid)
            if fr is None or fr.done:
                return False
            if any(q is fr for q in self.queue):
                self.queue.remove(fr)
                self._finished_buffer.append(
                    self._finish_terminal(fr, "cancelled")
                )
                return True
            rep = (
                self.replicas[fr.replica] if fr.replica is not None
                else None
            )
            if rep is not None and rid in rep.rids and rep.state != DEAD:
                # The engine-side cancel drains pipelined in-flight
                # chunks first, emitting tokens (for co-batched rows
                # too) OUTSIDE step()'s capture window — fold the delta
                # in here or the ledger's emitted base undercounts.
                g0 = rep.engine.generated_tokens
                got = bool(rep.engine.cancel(rid))
                self.generated_tokens += rep.engine.generated_tokens - g0
                return got
            return False

    def preempt_candidates(self, slo_class: str) -> list[str]:
        """Running ``slo_class`` rids in preemption-VICTIM order:
        ascending goodput-per-retained-page — tokens the stream has
        delivered so far over the KV pages it uniquely retains
        (``ServeEngine.retained_pages``: RadixKV/fork-shared pages
        count 1/refcount).  The ladder's preempt step walks this order
        so the request that frees the most pages per token thrown away
        parks first; a rid retaining no pages (dispatched but never
        admitted) scores 0 — the cheapest possible victim, nothing is
        lost parking it.  Ties (and engines without page pools, which
        all score 0) fall back to the old deterministic order: replica
        index, then rid insertion order — so the scored ladder
        degrades to exactly the unscored one."""
        with self._lock:
            scored: list[tuple[float, int, int, str]] = []
            seq = 0
            for rep in self.replicas:
                if rep.state == DEAD:
                    continue
                for rid, ereq in rep.rids.items():
                    fr = self._reqs.get(rid)
                    if fr is None or fr.done or fr.slo_class != slo_class:
                        continue
                    emitted = len(fr.tokens) + len(
                        getattr(ereq, "tokens", ()) or ()
                    )
                    pages = 0.0
                    fn = getattr(rep.engine, "retained_pages", None)
                    if fn is not None:
                        try:
                            pages = float(fn(getattr(ereq, "rid", rid)))
                        except Exception:  # noqa: BLE001 — scoring must
                            # never block a preemption the ladder needs.
                            pages = 0.0
                    score = emitted / pages if pages > 0 else 0.0
                    scored.append((score, rep.index, seq, rid))
                    seq += 1
            scored.sort(key=lambda t: (t[0], t[1], t[2]))
            return [t[3] for t in scored]

    def preempt(self, rid: str) -> bool:
        """Preemption-via-offload (degradation ladder step 2): pull one
        dispatched request back off its replica statuslessly
        (``ServeEngine.preempt``: pipelined state drained, prompt
        prefix pages pushed to the host offload tier when armed) and
        requeue it at the router-queue BACK, uncharged (being low
        priority is not the request's fault), for later resumption via
        the ordinary replay path: the re-dispatch re-prefills prompt +
        emitted tokens (prefix lookup reloads the parked pages), so
        the resumed greedy stream is an EXACT continuation.  Only
        requests that had actually ADMITTED (pages committed, work
        started) count as preemptions and open a preempt-resume
        window; a rid still waiting in the replica's own queue just
        moves back to the router (its class park keeps it there) with
        nothing counted — no pages were parked and no work was lost.
        Returns True iff the rid was pulled back; router-queued, done,
        or unreachable rids return False."""
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet is closed")
            fr = self._reqs.get(rid)
            if fr is None or fr.done or any(q is fr for q in self.queue):
                return False
            rep = (
                self.replicas[fr.replica] if fr.replica is not None
                else None
            )
            if rep is None or rid not in rep.rids or rep.state == DEAD:
                return False
            try:
                # Like cancel(): the engine-side preempt drains
                # pipelined in-flight chunks, emitting tokens outside
                # step()'s capture window — fold the delta in so the
                # ledger's emitted base keeps the token identity.
                g0 = rep.engine.generated_tokens
                ereq = rep.engine.preempt(rid)
                self.generated_tokens += rep.engine.generated_tokens - g0
            except EngineClosed:
                return False
            if ereq is None:
                return False
            rep.rids.pop(rid, None)
            self._close_attempt(fr, ereq, "preempt")
            fr.tokens.extend(int(t) for t in ereq.tokens)
            fr.replica = None
            fr.segments += 1
            if len(fr.tokens) >= fr.max_new_tokens or (
                fr.eos_token is not None
                and fr.tokens
                and fr.tokens[-1] == fr.eos_token
            ):
                # The stream is already bit-complete: finishing it ok
                # beats requeueing a zero-budget replay.
                self._finished_buffer.append(
                    self._finish_terminal(fr, "ok")
                )
                return True
            if ereq.t_admit is not None:
                # Real work was displaced: count it and open the
                # park -> first-resumed-token window the bench
                # publishes.  A never-admitted rid pulled off a
                # replica's queue parked nothing — counting it would
                # let plain queue-wait pollute the resume metric.
                self.preemptions += 1
                fr.preemptions += 1
                self._preempted_at[rid] = time.perf_counter()
            fr.status = "queued"
            self.queue.append(fr)  # BACK: parked bulk yields the spike
            return True

    # ---- terminal bookkeeping -------------------------------------------

    def _finish_terminal(
        self, fr: FleetRequest, status: str, error: str | None = None
    ) -> FleetRequest:
        if fr.done:  # one terminal status per rid — never overwrite
            return fr
        fr.status = status
        fr.error = error
        fr.t_done = time.perf_counter()
        self._preempted_at.pop(fr.rid, None)
        self._handoff_at.pop(fr.rid, None)
        fr.handoff = None  # a terminal ticket's blobs free with it
        self._close_attempt(fr, None, status)
        fr.replica = None
        counter = {
            "ok": "requests_ok",
            "cancelled": "requests_cancelled",
            "expired": "requests_expired",
            "failed": "requests_failed",
        }[status]
        setattr(self, counter, getattr(self, counter) + 1)
        self._score_slo(fr)
        self.completed.append(fr)
        return fr

    def _score_slo(self, fr: FleetRequest) -> None:
        """The terminal SLO verdict for a classed request: ok within
        every class target = attained; failed/expired (or ok outside a
        target) = a miss.  Cancelled requests are EXCLUDED — a client
        abort is not an SLO verdict — leaving ``slo_attained`` None."""
        cls = self.slo_classes.get(fr.slo_class or "")
        if cls is None or fr.status == "cancelled":
            return
        fr.slo_attained = fr.status == "ok" and cls.met(
            fr.ttft_secs, fr.tpot_secs
        )
        self.slo_request_counts[cls.name] += 1
        if fr.slo_attained:
            self.slo_attained_counts[cls.name] += 1
        win = self._slo_window[cls.name]
        win.append((fr.t_done, fr.slo_attained))
        self._trim_slo_window(win, fr.t_done)

    def _trim_slo_window(self, win: deque, now: float) -> None:
        while win and now - win[0][0] > self.slo_window_s:
            win.popleft()

    def slo_attainment(self) -> dict[str, float | None]:
        """Lifetime per-class attainment ratio (attained / scored), or
        None for a class no scored request has reached yet."""
        with self._lock:
            return {
                name: (
                    self.slo_attained_counts[name] / n if n else None
                )
                for name, n in self.slo_request_counts.items()
            }

    def slo_burn_rates(self, now: float | None = None) -> dict[str, float]:
        """Windowed error-budget burn rate per class: the miss fraction
        over the sliding ``slo_window_s`` divided by the class's error
        budget (1 - objective).  1.0 = burning the budget exactly as
        fast as the objective allows; an empty window reads 0.0 (no
        evidence of burning).  The SRE-workbook multi-window alert is
        this gauge sampled at two cadences."""
        with self._lock:
            now = time.perf_counter() if now is None else now
            out: dict[str, float] = {}
            for name, cls in self.slo_classes.items():
                win = self._slo_window[name]
                self._trim_slo_window(win, now)
                if not win:
                    out[name] = 0.0
                    continue
                misses = sum(1 for _, attained in win if not attained)
                budget = max(1.0 - cls.objective, 1e-9)
                out[name] = (misses / len(win)) / budget
            return out

    def drain_completed(self) -> list[FleetRequest]:
        """Hand back (and clear) the finished-request ring — the same
        between-measurement-windows contract as the engine's."""
        with self._lock:
            out = list(self.completed)
            self.completed.clear()
            return out

    # ---- health routing --------------------------------------------------

    def bind_health(self, fanout) -> None:
        """Subscribe the FLEET (one subscription) to a plugin
        ``HealthFanout`` and route each event to exactly the replicas
        whose ``chip_id`` it names — ``chip_id == ""`` (unattributed)
        reaches every replica, per the HealthEvent all-chips contract.
        Each engine then applies its own pause/resume bridge."""
        with self._lock:
            if self._health_fanout is not None:
                raise RuntimeError(
                    "fleet is already bound to a health fanout"
                )
            self._health_fanout = fanout
            self._health_sub = fanout.subscribe()

    def unbind_health(self) -> None:
        with self._lock:
            if self._health_fanout is not None:
                self._health_fanout.unsubscribe(self._health_sub)
                self._health_fanout = None
            self._health_sub = None

    def deliver_health(self, events) -> None:
        """Route health events to the affected replicas' inboxes (the
        test/raw-queue entry point; ``bind_health`` feeds the same
        path from a live fanout)."""
        with self._lock:
            for ev in events:
                for rep in self.replicas:
                    if rep.state == DEAD or rep.health_q is None:
                        continue
                    if not ev.chip_id or ev.chip_id == rep.chip_id:
                        rep.health_q.put(ev)

    def _pump_health(self) -> None:
        q = self._health_sub
        if q is None:
            return
        import queue as _queue

        events = []
        while True:
            try:
                events.append(q.get_nowait())
            except _queue.Empty:
                break
        if events:
            self.deliver_health(events)

    # ---- membership ------------------------------------------------------

    def add_replica(
        self, engine, chip_id: str = "", role: str = "mixed",
        *, snapshot=None,
    ) -> int:
        """Join a fresh engine live; the router dispatches to it from
        the next step.  ``role`` places it in a disaggregated fleet's
        prefill/decode pools (the supervisor passes the dead slot's
        original role back so a resurrected pool member rejoins its
        pool).  ``snapshot`` (workloads/faststart.py) primes the joiner
        with captured warm state before it takes traffic — incompatible
        snapshots no-op and the engine warms cold.  Returns the new
        replica index."""
        if snapshot is not None:
            snapshot.prime(engine)
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet is closed")
            rep = Replica(len(self.replicas), engine, chip_id, role=role)
            self.replicas.append(rep)
            self.replicas_added += 1
            return rep.index

    def drain(self, index: int) -> None:
        """Graceful drain: stop routing NEW work to the replica; its
        queued and in-flight requests finish there (nothing is failed
        over, nothing charged).  ``remove()`` closes it once idle."""
        with self._lock:
            rep = self.replicas[index]
            if rep.state == ACTIVE:
                rep.state = DRAINING
                self.router.forget(index)

    def resume(self, index: int) -> None:
        """Undo a drain (not a death): the replica takes new work
        again."""
        with self._lock:
            rep = self.replicas[index]
            if rep.state == DRAINING:
                rep.state = ACTIVE
                rep.slow_steps = 0

    def remove(self, index: int, *, force: bool = False) -> None:
        """Remove a replica: dead replicas detach immediately; live
        ones must be idle (drain first) unless ``force``, which fails
        their in-flight work over to survivors UNCHARGED (an operator
        removal is not the requests' fault) before closing."""
        with self._lock:
            rep = self.replicas[index]
            if rep.state == DEAD:
                self.replicas_removed += 1
                return
            if not rep.idle and not force:
                raise RuntimeError(
                    f"replica {index} still holds work "
                    f"(load {rep.load()}); drain it first or pass "
                    "force=True"
                )
            victims = self._harvest(rep, outcome="removed")
            rep.state = DEAD
            self.router.forget(index)
            try:
                rep.engine.close()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
            self._requeue_victims(victims, charge=False)
            self.replicas_removed += 1

    # ---- failover core ---------------------------------------------------

    def _close_attempt(
        self, fr: FleetRequest, ereq, outcome: str, *,
        charged: bool = False,
    ) -> None:
        """Close the request's open per-replica attempt span with the
        reason its segment ended (the fault kind for failovers, the
        engine status for finishes) and, when the engine-side Request
        is still in hand, its admission/first-token stamps and segment
        token count.  Idempotent — the terminal transition's sweep only
        catches attempts nothing else closed."""
        for att in reversed(fr.attempts):
            if att.t_end is not None:
                return
            att.t_end = time.perf_counter()
            att.outcome = outcome
            att.charged = charged
            if ereq is not None:
                att.t_admit = ereq.t_admit
                att.t_first = ereq.t_first
                att.tokens = len(ereq.tokens)
            return

    def _harvest(
        self, rep: Replica, *, outcome: str = "crash",
        charged: bool = False,
    ) -> list[FleetRequest]:
        """Pull every live fleet request off a replica, stitching the
        tokens its current segment already emitted (consumed host-side
        — tokens still in flight on the device are gone with the
        replica, and replay re-emits them bit-identically).  Each
        victim's open attempt span closes with ``outcome`` (the fault
        kind, or the uncharged drain/removal reason)."""
        victims: list[FleetRequest] = []
        for rid, ereq in list(rep.rids.items()):
            fr = self._reqs.get(rid)
            rep.rids.pop(rid, None)
            if fr is None or fr.done:
                continue
            self._close_attempt(fr, ereq, outcome, charged=charged)
            fr.tokens.extend(int(t) for t in ereq.tokens)
            fr.replica = None
            fr.segments += 1
            victims.append(fr)
        return victims

    def _requeue_victims(
        self, victims: list[FleetRequest], *, charge: bool,
        error: str | None = None,
    ) -> list[FleetRequest]:
        """Route harvested requests: requeue at the router-queue FRONT
        for failover replay, or — when a charged failover exhausts
        ``max_failovers`` — fail terminally.  Returns the terminally
        finished ones."""
        finished: list[FleetRequest] = []
        for fr in reversed(victims):  # appendleft keeps FIFO order
            if len(fr.tokens) >= fr.max_new_tokens or (
                fr.eos_token is not None
                and fr.tokens
                and fr.tokens[-1] == fr.eos_token
            ):
                # The harvested stream is already bit-complete (the
                # replica died between emitting the last token and
                # retiring the request): nothing to replay — a zero
                # budget re-submit would InvalidRequest a stream the
                # client received in full.
                finished.append(self._finish_terminal(fr, "ok"))
                continue
            if charge:
                fr.failovers += 1
                self.failover_requeues += 1
                if fr.failovers > self.max_failovers:
                    finished.append(self._finish_terminal(
                        fr, "failed",
                        error=(error or "replica failure")
                        + f" (after {self.max_failovers} failovers)",
                    ))
                    continue
                if self._t_fault is not None:
                    # Only victims of the open fault window may close
                    # it — an engine-escalated failure with no window
                    # must not donate a rid that later closes someone
                    # else's crash at a meaningless near-zero reading.
                    self._recovery_rids.add(fr.rid)
            else:
                self.drain_requeues += 1
            # Ledger waste class "replay": the failover re-prefills
            # prompt + everything the dead/drained replica already
            # emitted (workloads/ledger.py — charged whether or not
            # the fault was the request's fault: the chip recomputes
            # either way).
            self.tokens_replayed += len(fr.prompt) + len(fr.tokens)
            fr.status = "queued"
            self.queue.appendleft(fr)
        return finished

    def _fail_replica(
        self, rep: Replica, exc: BaseException, kind: str
    ) -> list[FleetRequest]:
        """A replica died (crash, hang past the watchdog, or an escaped
        exception): mark it DEAD, close what can be closed, and fail
        its work over to survivors under the failover budget.  Opens
        the failover-recovery window the bench measures."""
        victims = self._harvest(rep, outcome=kind, charged=True)
        rep.state = DEAD
        self.router.forget(rep.index)
        if kind == "hang":
            self.replica_hangs += 1
        else:
            self.replica_crashes += 1
        try:
            rep.engine.close()
        except Exception:  # noqa: BLE001 — a dead replica may not close
            pass
        self._t_fault = time.perf_counter()
        return self._requeue_victims(
            victims, charge=True,
            error=f"replica {rep.index} {kind}: "
                  f"{type(exc).__name__}: {exc}",
        )

    def _drain_paused(self, rep: Replica) -> None:
        """A health-paused replica holds its (quarantine-requeued) work
        in its own pending queue; when a dispatchable survivor exists,
        withdraw and fail it over UNCHARGED.  With no survivor the work
        parks in place — bouncing it between paused replicas would burn
        time for nothing, and recovery resumes it where it sits."""
        if not rep.rids:
            return
        if not any(
            r.dispatchable for r in self.replicas if r.index != rep.index
        ):
            return
        victims: list[FleetRequest] = []
        for rid in list(rep.rids):
            ereq = rep.engine.withdraw(rid)
            if ereq is None:
                continue  # still mid-teardown; next step retries
            rep.rids.pop(rid, None)
            fr = self._reqs.get(rid)
            if fr is None or fr.done:
                continue
            self._close_attempt(fr, ereq, "drain")
            fr.tokens.extend(int(t) for t in ereq.tokens)
            fr.replica = None
            fr.segments += 1
            victims.append(fr)
        self._requeue_victims(victims, charge=False)

    # ---- dispatch --------------------------------------------------------

    def _phase(self, fr: FleetRequest) -> str:
        """Which pool serves this request NEXT: a request with no tokens
        yet needs its prompt prefilled; one carrying tokens (a handoff
        continuation, failover replay or preempted resumption) is
        decode-bound residency."""
        return "decode" if (fr.tokens or fr.handoff is not None) else (
            "prefill"
        )

    def _role_candidates(
        self, fr: FleetRequest, dispatchable: list[Replica],
    ) -> list[Replica]:
        """Role-filter the dispatchable set for one request: fresh
        prompts prefer the prefill pool, continuations the decode pool,
        ``mixed`` replicas serve both.  An EMPTY preferred pool (its
        replicas dead, paused or draining) degrades to every
        dispatchable replica — a dead decode pool turns the fleet back
        into mixed dispatch rather than stranding handoff tickets."""
        if not self.disaggregated:
            return dispatchable
        phase = self._phase(fr)
        pref = [
            r for r in dispatchable if r.role in (phase, "mixed")
        ]
        return pref or dispatchable

    def _wfq_cost(self, fr: FleetRequest) -> float:
        """A fresh prompt's service cost in prompt-bucket units — the
        prefill-slot work WFQ meters (a 4k-token prompt charges its
        class ~bucket-count times a one-bucket chat turn).  Metered in
        the FOUNDING engine's bucket (one fleet-level normalization:
        class fairness needs a single unit even when heterogeneous
        replicas bucket differently)."""
        return float(max(1, -(-len(fr.prompt) // self._bucket)))

    def _wfq_order(
        self, entries: list[FleetRequest],
    ) -> list[FleetRequest]:
        """Order one step's dispatch attempts by SLO-class weighted
        fair queuing: continuations first (FIFO — they already hold
        service), then fresh prompts by per-class virtual finish time
        (class virtual time + cost/weight, FIFO within a class; ties
        break on class name, then arrival).  A class re-entering
        service starts at the fleet's current virtual time — idling
        banks no credit.  Pure simulation over copies: the persistent
        clocks only advance on ACTUAL dispatch, so a request that
        finds no candidate charges nothing."""
        cont = [fr for fr in entries if self._phase(fr) == "decode"]
        fresh = [fr for fr in entries if self._phase(fr) == "prefill"]
        if not fresh:
            return cont
        weights = self.wfq_weights or {}
        per_class: dict[str, deque[FleetRequest]] = {}
        for fr in fresh:
            per_class.setdefault(fr.slo_class or "", deque()).append(fr)
        # Each backlogged class's virtual clock floors to the fleet's
        # current virtual time ONCE, at batch entry (no banked credit
        # from idling) — flooring per pick would drag waiting classes
        # forward with every other class's service and serialize the
        # batch instead of interleaving it.
        vt = {
            c: max(self._wfq_vtime.get(c, 0.0), self._wfq_v)
            for c in per_class
        }
        ordered: list[FleetRequest] = []

        def finish_tag(cls: str) -> tuple[float, str]:
            # Classic WFQ picks by virtual FINISH time of each class's
            # head (start + cost/weight), not start time — on equal
            # starts, a light high-weight prompt must beat a heavy
            # low-weight one, which start-time selection would decide
            # by name alone.
            head = per_class[cls][0]
            return (
                vt[cls] + self._wfq_cost(head) / weights.get(cls, 1.0),
                cls,
            )

        while per_class:
            cls = min(per_class, key=finish_tag)
            fr = per_class[cls].popleft()
            if not per_class[cls]:
                del per_class[cls]
            vt[cls] += self._wfq_cost(fr) / weights.get(cls, 1.0)
            ordered.append(fr)
        return cont + ordered

    def _wfq_charge(self, fr: FleetRequest, v_base: float) -> None:
        """Advance the persistent WFQ clocks for one ACTUAL dispatch —
        the same recurrence ``_wfq_order`` simulated: each class floors
        ONCE against the batch-entry virtual time ``v_base`` (flooring
        against a per-dispatch ratchet would overcharge classes whose
        heads dispatch later in the batch and skew the cross-step
        share below the configured weights).  Continuations are free."""
        if self.wfq_weights is None or self._phase(fr) != "prefill":
            return
        cls = fr.slo_class or ""
        start = max(self._wfq_vtime.get(cls, 0.0), v_base)
        self._wfq_vtime[cls] = start + self._wfq_cost(fr) / (
            self.wfq_weights.get(cls, 1.0)
        )
        self.wfq_dispatches[cls] = self.wfq_dispatches.get(cls, 0) + 1

    def _dispatch_queued(self) -> list[FleetRequest]:
        """Hand router-queued requests to replicas: least-loaded +
        affinity via the Router, against a WORKING load view bumped per
        dispatch so one step spreads its admissions.  Failover replays
        sit at the queue front and re-prefill prompt + stitched tokens.
        With roles set, fresh prompts go to the prefill pool and
        continuations (handoff tickets included) to the decode pool
        (mixed serves both; an empty pool degrades to any replica);
        with ``wfq_weights`` set, fresh prompts dispatch in per-class
        weighted-fair order instead of strict FIFO.  Returns requests
        that finished terminally at dispatch (expired in queue, or
        nothing left to serve them)."""
        finished: list[FleetRequest] = []
        if not self.queue:
            return finished
        t0 = time.perf_counter()
        now = t0
        dispatchable = [r for r in self.replicas if r.dispatchable]
        # One scoring seam for both dispatch currencies
        # (Replica.dispatch_score): request-count least-loaded, or —
        # page-scheduled — pages held + pages the queued work will
        # claim plus the ledger's goodput handicap, so free pages,
        # radix match depth (the Router's measured affinity) and
        # goodput replace the request count as the dispatch currency.
        loads = {
            r.index: r.dispatch_score(page_scheduling=self.page_scheduling)
            for r in dispatchable
        }
        entries = [fr for fr in self.queue if not fr.done]
        self.queue.clear()
        order = (
            self._wfq_order(entries) if self.wfq_weights is not None
            else entries
        )
        v_base = self._wfq_v  # batch-entry virtual time; see _wfq_charge
        charged: set[str] = set()
        removed: set[int] = set()
        for fr in order:
            if fr.t_deadline is not None and now >= fr.t_deadline:
                finished.append(self._finish_terminal(fr, "expired"))
                removed.add(id(fr))
                continue
            if fr.slo_class in self.parked_classes:
                # Ladder step 2 (WFQ's priority backstop): the class is
                # parked — hold position in the queue (deadlines above
                # still apply) until the autoscaler unparks it.
                continue
            candidates = self._role_candidates(fr, dispatchable)
            if not candidates:
                continue
            pick = self.router.choose(fr, candidates, loads)
            try:
                self._dispatch_to(fr, self.replicas[pick])
            except (InvalidRequest, RequestTooLarge) as exc:
                # A replica-level validation miss (heterogeneous fleet,
                # or a replay that no longer fits): terminal, loudly.
                finished.append(self._finish_terminal(
                    fr, "failed", error=f"{type(exc).__name__}: {exc}"
                ))
                removed.add(id(fr))
                continue
            except EngineClosed:
                continue  # raced a death; redispatch next step
            if self.wfq_weights is not None and (
                self._phase(fr) == "prefill"
            ):
                self._wfq_charge(fr, v_base)
                charged.add(fr.slo_class or "")
            # Bump the working view by the request's PREFILL cost in
            # the same bucket units Replica.load() now reports — a +1
            # bump would let one step pile short prompts onto the
            # replica that just took a 4k-token prefill.  The CHOSEN
            # replica's own bucket, not the fleet norm: heterogeneous
            # fleets are legal and load() reports per-engine units.
            n_request = len(fr.prompt) + len(fr.tokens)
            ctrl = getattr(self.replicas[pick].engine, "ctrl", None)
            if self.page_scheduling and hasattr(ctrl, "pages_needed"):
                # Same currency as the page-load view: the pages this
                # request's KV will claim on the chosen replica.
                self.page_dispatches += 1
                loads[pick] += max(1, int(ctrl.pages_needed(n_request)))
            else:
                rep_bucket = max(1, getattr(
                    self.replicas[pick].engine, "prompt_bucket", 1
                ))
                loads[pick] += max(1, -(-n_request // rep_bucket))
            removed.add(id(fr))
        if charged:
            # The fleet's virtual time after the batch: the LEAST
            # advanced served class's clock (monotone — every charge
            # floored at v_base and added positive cost/weight).  An
            # idle class re-entering next batch floors to this.
            self._wfq_v = min(
                self._wfq_vtime[c] for c in charged
            )
        # Undispatched requests keep their ARRIVAL order (WFQ reorders
        # dispatch attempts, never the queue itself).
        self.queue = deque(
            fr for fr in entries if id(fr) not in removed
        )
        self.router_secs += time.perf_counter() - t0
        return finished

    def _dispatch_to(self, fr: FleetRequest, rep: Replica) -> None:
        """Submit one fleet request (or failover replay) into a
        replica's engine: the engine-side prompt is prompt + stitched
        tokens, the budget the remaining tokens — greedy continuation
        of prompt+emitted is bit-identical to the uninterrupted
        stream, so a failed-over stream resumes exactly where the
        client's stopped.

        Disaggregation hooks: a fresh prompt landing on a PREFILL-pool
        replica (with a live handoff target elsewhere) caps its budget
        at the first token — the token that rides the fused prefill
        readback — so the replica retires it at prefill-complete and
        ``_absorb_finished`` turns the retirement into a KV handoff.
        A request carrying a handoff ticket grafts the ticket's page
        blobs into THIS replica's radix index first (``import_kv``),
        so the submit's admission lookup reloads them instead of
        re-running the prefill; a failed graft just means the replay
        re-prefills — bit-identical either way."""
        prompt = fr.prompt + fr.tokens
        remaining = fr.max_new_tokens - len(fr.tokens)
        fr.handoff_pending = False
        if (
            rep.role == "prefill"
            and not fr.tokens
            and remaining > 1
            and any(
                r.role in ("decode", "mixed")
                for r in self.replicas
                if r.state != DEAD and r.index != rep.index
            )
        ):
            remaining = 1
            fr.handoff_pending = True
        ticket = fr.handoff
        pages_in = 0
        if (
            ticket is not None
            and ticket.blobs
            and rep.index != ticket.src_replica
        ):
            # Back on the exporter (degrade): its own index still holds
            # the pages — grafting would be a no-op by construction.
            try:
                pages_in = rep.engine.import_kv(
                    ticket.prompt, ticket.blobs, adapter=ticket.adapter,
                )
            except Exception:  # noqa: BLE001 — a graft failure must
                pass  # degrade to plain re-prefill, never block dispatch
        if (
            ticket is not None
            and pages_in == 0
            and rep.index != ticket.src_replica
        ):
            # The handoff degraded to a re-prefill (empty ticket,
            # incompatible blobs, or a failed graft): the decode pool
            # recomputes the prompt — ledger waste class "replay".
            self.tokens_replayed += len(prompt)
        deadline = None
        if fr.t_deadline is not None:
            deadline = max(fr.t_deadline - time.perf_counter(), 1e-6)
        rep.engine.submit(
            prompt, remaining, eos_token=fr.eos_token, rid=fr.rid,
            adapter=fr.adapter, deadline_s=deadline,
        )
        # The ticket is consumed (and its pages counted) only once the
        # submit LANDED: an EngineClosed race requeues the request
        # still carrying its ticket, so the next dispatch onto a live
        # decode replica keeps the transfer discount (a graft into the
        # dying engine is gone with it — harmless).
        fr.handoff = None
        self.handoff_pages += pages_in
        ereq = rep.engine.pending[-1]  # submit() appends its Request
        rep.rids[fr.rid] = ereq
        fr.replica = rep.index
        fr.status = "running"
        # Open this segment's attempt span — a failover replay appends
        # a retry child next to the attempt the fault closed.
        fr.attempts.append(AttemptSpan(
            replica=rep.index, t_dispatch=time.perf_counter(),
        ))

    # ---- stepping --------------------------------------------------------

    def _consult_seams(self, rep: Replica) -> bool:
        """Cross the replica-level fault seams for one replica step.
        ``replica_crash`` / ``replica_hang`` raise (the caller fails
        the replica over); a ``replica_slow`` hit returns True and the
        step pays ``slow_readback_s`` of injected latency."""
        inj = self._faults
        if inj is None:
            return False
        inj.check("replica_crash")
        inj.check("replica_hang")
        try:
            inj.check("replica_slow")
        except InjectedFault:
            return True
        return False

    def _step_replica(self, rep: Replica) -> list[FleetRequest]:
        finished: list[FleetRequest] = []
        slow = False
        try:
            slow = self._consult_seams(rep)
            if slow:
                time.sleep(self.slow_readback_s)
            t0 = time.perf_counter()
            engine_done = rep.engine.step()
            step_secs = time.perf_counter() - t0
        except InjectedFault as exc:
            kind = "hang" if exc.seam == "replica_hang" else "crash"
            return self._fail_replica(rep, exc, kind)
        except EngineClosed:
            # Closed under us (operator remove raced a step): harvest
            # whatever tracking remains, uncharged.
            victims = self._harvest(rep, outcome="closed")
            rep.state = DEAD
            self._requeue_victims(victims, charge=False)
            return finished
        except Exception as exc:  # noqa: BLE001 — escaped the engine's
            # own quarantine: the whole domain is suspect.
            return self._fail_replica(rep, exc, "crash")
        warmup = rep.steps == 0
        rep.steps += 1
        if slow:
            rep.slow_steps += 1
            if (
                self.slow_drain_after is not None
                and rep.state == ACTIVE
                and rep.slow_steps >= self.slow_drain_after
                # Never auto-drain the last dispatchable replica:
                # degraded service beats a queue nothing can serve.
                and any(
                    r.dispatchable for r in self.replicas
                    if r.index != rep.index
                )
            ):
                self.drain(rep.index)
        else:
            rep.slow_steps = 0
        # A superstep engine (plain decode OR chained speculative)
        # legitimately runs k chunks'/rounds' worth of device work per
        # step; scale the watchdog budget with the larger k so neither
        # can read as a wedge.
        hang_budget = (
            None if self.hang_timeout_s is None
            else self.hang_timeout_s
            * max(
                1,
                getattr(rep.engine, "superstep_k", 1),
                getattr(rep.engine, "spec_superstep_k", 1),
            )
        )
        if (
            hang_budget is not None
            and not warmup  # first step = one-time XLA compiles, not a wedge
            and step_secs > hang_budget
            and rep.state != DEAD
        ):
            # Watchdog after the fact: the cooperative loop cannot
            # preempt a wedged step, but it can refuse to trust the
            # replica that wedged it.
            return finished + self._fail_replica(
                rep,
                RuntimeError(
                    f"step took {step_secs:.3f}s > hang_timeout_s "
                    f"{hang_budget}"
                ),
                "hang",
            )
        for ereq in engine_done:
            finished.extend(self._absorb_finished(rep, ereq))
        self._observe_progress(rep)
        return finished

    def _absorb_finished(self, rep: Replica, ereq) -> list[FleetRequest]:
        """Map one engine-terminal Request onto its fleet request:
        stitch the segment's tokens and either finish the fleet
        request, or — engine-terminal ``failed`` (its OWN retry budget
        exhausted inside the domain) — escalate to a charged fleet
        failover onto a survivor."""
        fr = self._reqs.get(ereq.rid)
        if fr is None or fr.done or ereq.rid not in rep.rids:
            return []
        rep.rids.pop(ereq.rid, None)
        self._close_attempt(
            fr, ereq, ereq.status, charged=ereq.status == "failed",
        )
        # A request that admits and retires within one engine step never
        # reaches _observe_progress — stamp it (and close any open
        # failover-recovery window) here, or the fleet's TTFT/queue-wait
        # pools silently drop exactly the fastest requests.
        if fr.t_admit is None and ereq.t_admit is not None:
            fr.t_admit = ereq.t_admit
        if fr.t_first is None and not fr.tokens and ereq.t_first is not None:
            fr.t_first = ereq.t_first
        if (
            self._t_fault is not None
            and ereq.rid in self._recovery_rids
            and ereq.tokens
        ):
            self.failover_recovery_s.append(
                time.perf_counter() - self._t_fault
            )
            self._t_fault = None
            self._recovery_rids.clear()
        if ereq.rid in self._preempted_at and ereq.tokens:
            self.preempt_resume_s.append(
                time.perf_counter() - self._preempted_at.pop(ereq.rid)
            )
        if ereq.rid in self._handoff_at and ereq.tokens:
            self.handoff_s.append(
                time.perf_counter() - self._handoff_at.pop(ereq.rid)
            )
        fr.tokens.extend(int(t) for t in ereq.tokens)
        fr.segments += 1
        fr.replica = None
        if ereq.status == "ok":
            if fr.handoff_pending and not (
                len(fr.tokens) >= fr.max_new_tokens
                or (
                    fr.eos_token is not None
                    and fr.tokens
                    and fr.tokens[-1] == fr.eos_token
                )
            ):
                # Prefill-complete, stream not: retire here becomes a
                # KV handoff to the decode pool instead of a terminal.
                return self._handoff(rep, fr)
            return [self._finish_terminal(fr, "ok")]
        if ereq.status in ("cancelled", "expired"):
            return [self._finish_terminal(fr, ereq.status, ereq.error)]
        # "failed": the domain gave up; the fleet may still fail over.
        return self._requeue_victims(
            [fr], charge=True,
            error=ereq.error or "engine retry budget exhausted",
        )

    def _handoff(self, rep: Replica, fr: FleetRequest) -> list:
        """Turn a prefill-pool retirement into a KV handoff: export the
        finished prompt's pages off the prefill replica (parked to the
        host tier — one gathered device_get — and packaged as blobs
        that outlive the exporter), attach the ticket, and requeue the
        stream at the queue FRONT for the decode pool, UNCHARGED (a
        handoff is the plan, not a fault).  An export failure ships an
        empty ticket: the decode replica re-prefills — bit-identical,
        just without the transfer discount.  Opens the prefill-done ->
        first-decode-token window published as disagg_handoff_ms."""
        fr.handoff_pending = False
        t_export = time.perf_counter()
        blobs = None
        try:
            blobs = rep.engine.export_kv(fr.prompt, adapter=fr.adapter)
        except Exception:  # noqa: BLE001 — a failed export degrades to
            blobs = None  # replay re-prefill, never fails the stream
        fr.handoff = KVHandoff(
            prompt=list(fr.prompt), adapter=fr.adapter,
            blobs=list(blobs or ()), src_replica=rep.index,
            t_export=t_export,
        )
        fr.handoffs += 1
        self.kv_handoffs += 1
        self._handoff_at[fr.rid] = t_export
        fr.status = "queued"
        self.queue.appendleft(fr)
        return []

    def _observe_progress(self, rep: Replica) -> None:
        """Per-step stamps off the replica's live requests: fleet-level
        t_admit/t_first (first segment only — a failover's re-admission
        is not the client's first token), and the failover-recovery
        window closing on the first post-failover token."""
        for rid, ereq in rep.rids.items():
            fr = self._reqs.get(rid)
            if fr is None:
                continue
            if fr.t_admit is None and ereq.t_admit is not None:
                fr.t_admit = ereq.t_admit
            if (
                fr.t_first is None
                and not fr.tokens
                and ereq.t_first is not None
            ):
                fr.t_first = ereq.t_first
            if (
                self._t_fault is not None
                and rid in self._recovery_rids
                and ereq.tokens
            ):
                self.failover_recovery_s.append(
                    time.perf_counter() - self._t_fault
                )
                self._t_fault = None
                self._recovery_rids.clear()
            if rid in self._preempted_at and ereq.tokens:
                # Preempt -> first token of the resumed segment: the
                # bench's autoscale_preempt_resume_ms window.
                self.preempt_resume_s.append(
                    time.perf_counter() - self._preempted_at.pop(rid)
                )
            if rid in self._handoff_at and ereq.tokens:
                # Prefill-done -> first decode-pool token: the bench's
                # disagg_handoff_ms window.
                self.handoff_s.append(
                    time.perf_counter() - self._handoff_at.pop(rid)
                )

    def step(self) -> list[FleetRequest]:
        """One fleet iteration: route health events and apply every
        replica's pause/resume FIRST (so drain decisions see a
        coherent fleet-wide picture — a fleet-wide Unhealthy must park
        work in place, not bounce it through a replica that is about
        to pause), then drain paused replicas onto true survivors,
        dispatch the router queue, and advance every live replica one
        engine step (index order — deterministic).  Returns the fleet
        requests that reached a terminal status this step."""
        with self._lock:
            if self._closed:
                raise EngineClosed("fleet is closed; no further steps")
            engines = [r.engine for r in self.alive]
            tokens0 = sum(e.generated_tokens for e in engines)
            finished = list(self._finished_buffer)
            self._finished_buffer.clear()
            self._pump_health()
            for rep in self.replicas:
                if rep.state == DEAD:
                    continue
                try:
                    # Apply pause/resume now; anything it finishes
                    # surfaces through the engine's own next step.
                    rep.engine._finished_buffer.extend(
                        rep.engine._poll_health()
                    )
                except Exception:  # noqa: BLE001 — a dying replica's
                    pass  # poll failing is the step's problem below
            for rep in self.replicas:
                if rep.state != DEAD and rep.engine.paused:
                    self._drain_paused(rep)
            finished += self._dispatch_queued()
            for rep in list(self.replicas):
                if rep.state == DEAD:
                    continue
                finished.extend(self._step_replica(rep))
            # A fleet with zero live replicas left cannot serve its
            # queue — fail it loudly rather than spin forever, UNLESS a
            # supervisor reports a resurrection in flight (the queue
            # then parks for the replacement; deadlines/cancels still
            # apply while it waits).
            if self.queue and not self.alive and not self._revival_pending():
                while self.queue:
                    fr = self.queue.popleft()
                    if not fr.done:
                        finished.append(self._finish_terminal(
                            fr, "failed",
                            error="no live replicas remain",
                        ))
            self.generated_tokens += (
                sum(e.generated_tokens for e in engines) - tokens0
            )
            if self._journal is not None and self.journal_every is not None:
                self._steps_since_journal += 1
                if self._steps_since_journal >= self.journal_every:
                    self.journal_now()
            if self.ledger is not None:
                self.ledger.step_end(self, finished)
            if self._obs is not None:
                self._obs._fleet_step_end(self, finished)
            return finished

    def run(self) -> dict[str, list[int]]:
        """Drive ``step()`` until every submitted request is terminal;
        returns {rid: stitched tokens}.  While no replica is
        dispatchable (every live one health-paused or draining) the
        loop polls instead of spinning — steps still advance, so
        draining replicas finish their in-flight work."""
        out: dict[str, list[int]] = {}
        while True:
            with self._lock:
                if self.idle:
                    break
                for fr in self.step():
                    out[fr.rid] = fr.tokens
                parked = bool(self.alive) and not any(
                    r.dispatchable for r in self.alive
                )
            if parked:
                time.sleep(0.001)
        return out

    # ---- streaming / front-end support ----------------------------------

    def poll(self, rid: str, cursor: int = 0):
        """Snapshot one request's stream from ``cursor``: returns
        (new_tokens, done, status).  Includes the live segment's
        already-consumed tokens, so an SSE handler streams tokens as
        the driver thread steps."""
        with self._lock:
            fr = self._reqs.get(rid)
            if fr is None:
                raise KeyError(rid)
            tokens = list(fr.tokens)
            if not fr.done and fr.replica is not None:
                rep = self.replicas[fr.replica]
                ereq = rep.rids.get(rid)
                if ereq is not None:
                    tokens += [int(t) for t in ereq.tokens]
            return tokens[cursor:], fr.done, fr.status

    def serve_forever(self, stop_event: threading.Event) -> None:
        """The front-end driver loop: step while work exists, idle-poll
        otherwise, until ``stop_event`` is set."""
        while not stop_event.is_set():
            parked = False
            with self._lock:
                busy = not self.idle and not self._closed
                if busy:
                    self.step()
                    parked = bool(self.alive) and not any(
                        r.dispatchable for r in self.alive
                    )
            if not busy:
                time.sleep(0.002)
            elif parked:
                time.sleep(0.001)

    # ---- shutdown --------------------------------------------------------

    def close(self) -> None:
        """Idempotent shutdown: every queued and in-flight request
        fails terminally with the cause recorded, every live engine
        closes, and the health subscription tears down."""
        with self._lock:
            if self._closed:
                return
            # Checkpoint FIRST, while in-flight sessions still read as
            # live: a graceful close's journal is what a successor
            # process restores from (a crash's journal is whatever the
            # last cadence wrote — the previous generation at worst).
            if self._journal is not None:
                try:
                    self.journal_now()
                except Exception:  # noqa: BLE001 — shutdown must not
                    pass  # fail because the checkpoint did
            self._closed = True
            err = "EngineClosed: fleet closed with the request in flight"
            closed_now: list[FleetRequest] = []
            for rep in self.replicas:
                if rep.state == DEAD:
                    continue
                for rid, ereq in list(rep.rids.items()):
                    fr = self._reqs.get(rid)
                    if fr is not None and not fr.done:
                        self._close_attempt(fr, ereq, "closed")
                        fr.tokens.extend(int(t) for t in ereq.tokens)
                        closed_now.append(
                            self._finish_terminal(fr, "failed", error=err)
                        )
                rep.rids.clear()
                try:
                    rep.engine.close()
                except Exception:  # noqa: BLE001
                    pass
                rep.state = DEAD
            while self.queue:
                fr = self.queue.popleft()
                if not fr.done:
                    closed_now.append(
                        self._finish_terminal(fr, "failed", error=err)
                    )
            self._finished_buffer.clear()
            if self.ledger is not None:
                # A shutdown that failed N streams must not read as 0
                # waste: the last counter deltas and close-failed
                # classification land before the books freeze.
                self.ledger.step_end(self, closed_now)
            self.unbind_health()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def make_fleet(
    params,
    config,
    n: int,
    *,
    engine_kw: dict | None = None,
    chip_ids: list[str] | None = None,
    observers=None,
    device=None,
    **fleet_kw,
) -> Fleet:
    """Build N homogeneous ``ServeEngine`` replicas over SHARED params
    (the time-sliced chips serve one model; per-replica page pools are
    each engine's own) and front them with a ``Fleet``.  ``observers``
    is an optional list of per-replica EngineObservers (index-aligned;
    give them distinct names/replica labels before binding a shared
    registry).

    The port's engines run on ``device`` (default ``cuda``; pass
    ``"cpu"`` explicitly; a ``device`` in ``engine_kw`` wins)."""
    from .serve import ServeEngine

    if n < 1:
        raise ValueError(f"a fleet needs n >= 1 replicas, got {n}")
    engine_kw = dict(engine_kw or {})
    engine_kw.setdefault("device", device)
    engines = []
    for i in range(n):
        kw = dict(engine_kw)
        if observers is not None:
            kw["observer"] = observers[i]
        engines.append(ServeEngine(params, config, **kw))
    return Fleet(engines, chip_ids=chip_ids, **fleet_kw)


# ---- open-loop traffic ---------------------------------------------------


@dataclass
class TrafficGen:
    """Seeded OPEN-LOOP traffic: arrivals are scheduled in advance and
    do not wait for completions — the load model "millions of users"
    reduces to at fleet scale.  Arrivals ride a two-state
    Markov-modulated Poisson process (calm rate ``rate_rps``, bursts at
    ``burst_factor`` x for geometric dwells — bursty by construction),
    and prompt lengths are heavy-tailed (Pareto with shape
    ``tail_alpha``, clamped to ``[min_prompt, max_prompt]``), the mix
    long-prompt head-of-line risk comes from.  Deterministic per seed."""

    seed: int = 0
    rate_rps: float = 50.0
    burst_factor: float = 4.0
    burst_dwell: float = 0.25  # P(stay in burst) per arrival
    calm_dwell: float = 0.9  # P(stay calm) per arrival
    min_prompt: int = 1
    max_prompt: int = 24
    tail_alpha: float = 1.5
    min_new: int = 1
    max_new: int = 16
    vocab: int = 256
    # Per-SLO-class arrival mix for schedule_classed: (class, weight)
    # pairs — the default mirrors a chat-dominated tenant mix with a
    # bulk-generation minority (the ROADMAP's interactive-vs-bulk
    # split).
    class_mix: tuple = (("interactive", 3.0), ("bulk", 1.0))

    @staticmethod
    def step_profile(start_s: float, duration_s: float, factor: float):
        """A rate profile for ``schedule(profile=...)``: arrival rate x
        ``factor`` inside the ``[start_s, start_s + duration_s)``
        window, x1 outside — the step-load trace the autoscaler bench
        drives (rate x4 for a bounded window, then back)."""
        if duration_s <= 0:
            raise ValueError(
                f"step duration_s must be > 0, got {duration_s}"
            )
        if factor <= 0:
            raise ValueError(f"step factor must be > 0, got {factor}")

        def profile(t: float) -> float:
            return factor if start_s <= t < start_s + duration_s else 1.0

        return profile

    @staticmethod
    def ramp_profile(start_s: float, duration_s: float, peak: float):
        """A rate profile for ``schedule(profile=...)``: x1 until
        ``start_s``, then a linear climb to ``peak`` over
        ``duration_s``, holding ``peak`` after — the gradual-overload
        trace (does hysteresis track a slow climb without flapping)."""
        if duration_s <= 0:
            raise ValueError(
                f"ramp duration_s must be > 0, got {duration_s}"
            )
        if peak <= 0:
            raise ValueError(f"ramp peak must be > 0, got {peak}")

        def profile(t: float) -> float:
            if t < start_s:
                return 1.0
            if t >= start_s + duration_s:
                return peak
            return 1.0 + (peak - 1.0) * (t - start_s) / duration_s

        return profile

    def schedule(
        self, n: int, profile=None,
    ) -> list[tuple[float, list[int], int]]:
        """n arrivals as (t_offset_s, prompt, max_new_tokens).

        ``profile`` optionally modulates the arrival RATE as a function
        of schedule time (``step_profile`` / ``ramp_profile`` above, or
        any ``t -> factor`` callable).  The rng draw SEQUENCE is
        profile-independent — prompts, budgets and the burst chain are
        bit-identical across profiles for a fixed seed; only the
        inter-arrival gaps rescale — so a step-load trace serves
        exactly the calm trace's requests, compressed in time."""
        rng = random.Random(self.seed)
        out = []
        t = 0.0
        burst = False
        for _ in range(n):
            rate = self.rate_rps * (self.burst_factor if burst else 1.0)
            if profile is not None:
                factor = float(profile(t))
                if factor <= 0:
                    raise ValueError(
                        f"rate profile must return > 0, got {factor} "
                        f"at t={t}"
                    )
                rate *= factor
            t += rng.expovariate(rate)
            stay = self.burst_dwell if burst else self.calm_dwell
            if rng.random() > stay:
                burst = not burst
            # Pareto excursion scaled to span/8: the BODY stays short
            # (median a few tokens) while the tail still reaches the
            # cap a few percent of the time — mostly-chat traffic with
            # occasional document-sized head-of-line risks.
            span = self.max_prompt - self.min_prompt
            plen = self.min_prompt + min(
                span,
                int(span * (rng.paretovariate(self.tail_alpha) - 1.0) / 8),
            )
            prompt = [rng.randrange(self.vocab) for _ in range(plen)]
            new = rng.randint(self.min_new, self.max_new)
            out.append((t, prompt, new))
        return out

    def schedule_classed(
        self, n: int, profile=None,
    ) -> list[tuple[float, list[int], int, str]]:
        """``schedule(n)`` with a per-arrival SLO class drawn from
        ``class_mix`` — the per-class arrival streams the attainment
        bench and the SLO scheduler consume.  The class draw uses its
        OWN seeded rng, so the arrival process, prompts and budgets
        stay bit-identical to the unclassed schedule (tagging cannot
        move tokens, starting with the generator) — and, because the
        draw sequence is positional, a rate ``profile`` changes
        neither the class sequence nor the mix: a step-load spike
        serves the calm trace's exact class assignment, compressed in
        time."""
        if not self.class_mix:
            raise ValueError("schedule_classed needs a non-empty class_mix")
        names = [name for name, _ in self.class_mix]
        weights = [float(w) for _, w in self.class_mix]
        rng = random.Random((self.seed << 8) ^ 0x510C1A55)
        return [
            (t, prompt, new, rng.choices(names, weights)[0])
            for t, prompt, new in self.schedule(n, profile)
        ]

    def schedule_per_class(
        self, n: int, profile=None,
    ) -> list[tuple[float, list[int], int, str]]:
        """TRUE per-class arrival streams (ROADMAP item 1): one
        INDEPENDENT seeded Markov-modulated arrival process per SLO
        class in ``class_mix``, merged by arrival time.  Each class's
        process runs at its weight share of ``rate_rps`` with its own
        derived seed (stable hash of the class name — not Python's
        salted ``hash``), so its arrivals, bursts, prompts and budgets
        are a deterministic function of (seed, class name, weight
        share, its arrival count) ALONE: reordering ``class_mix``
        entries, or the draws of any other class, cannot move a single
        token of this class's sub-stream (pinned by
        tests/test_disagg.py).  This is what ``schedule_classed``'s
        shared-process class draw could not give: bursty interactive
        chat and smooth bulk generation as genuinely different arrival
        processes, not one process wearing two tags.  ``n`` splits
        across classes in weight proportion (each class gets >= 1
        arrival); ``profile`` rescales every class's gaps alike."""
        import zlib

        if not self.class_mix:
            raise ValueError(
                "schedule_per_class needs a non-empty class_mix"
            )
        total = sum(float(w) for _, w in self.class_mix)
        if total <= 0:
            raise ValueError(
                f"class_mix weights must sum > 0, got {self.class_mix}"
            )
        import dataclasses

        merged: list[tuple[float, list[int], int, str]] = []
        for name, w in self.class_mix:
            share = float(w) / total
            sub = dataclasses.replace(
                self,
                seed=(self.seed << 16) ^ zlib.crc32(name.encode()),
                rate_rps=self.rate_rps * share,
            )
            for t, prompt, new in sub.schedule(
                max(1, round(n * share)), profile
            ):
                merged.append((t, prompt, new, name))
        merged.sort(key=lambda e: (e[0], e[3]))
        return merged

    @staticmethod
    def schedule_stats(schedule, window_s: float = 1.0) -> dict:
        """Reproducibility stats for a generated schedule (the
        autoscaler bench logs these next to its measurements so a
        step-load trace is auditable): arrival count, span, mean rate,
        the peak rate over any sliding ``window_s`` window (the spike
        the autoscaler must absorb), prompt/budget token totals, and —
        for classed schedules — the per-class arrival counts."""
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        entries = list(schedule)
        out = {
            "arrivals": len(entries),
            "span_s": 0.0,
            "mean_rps": 0.0,
            "peak_rps": 0.0,
            "prompt_tokens": sum(len(e[1]) for e in entries),
            "budget_tokens": sum(int(e[2]) for e in entries),
        }
        if not entries:
            return out
        offsets = [float(e[0]) for e in entries]
        span = max(offsets) - min(offsets)
        out["span_s"] = round(span, 6)
        out["mean_rps"] = round(len(entries) / max(span, 1e-9), 3)
        peak, lo = 0, 0
        for hi in range(len(offsets)):
            while offsets[hi] - offsets[lo] > window_s:
                lo += 1
            peak = max(peak, hi - lo + 1)
        out["peak_rps"] = round(peak / window_s, 3)
        if entries and len(entries[0]) > 3:
            counts: dict[str, int] = {}
            for e in entries:
                counts[e[3]] = counts.get(e[3], 0) + 1
            out["class_counts"] = dict(sorted(counts.items()))
            # Per-class mean arrival rate over the class's OWN span —
            # the audit line for per-class streams (schedule_per_class):
            # each class's realized rate should sit near its weight
            # share of the generator's rate.
            rates: dict[str, float | None] = {}
            for name in counts:
                offs = [float(e[0]) for e in entries if e[3] == name]
                span = max(offs) - min(offs)
                # A single-arrival class has no span to rate over —
                # None, not the absurd 1/epsilon.
                rates[name] = (
                    round(len(offs) / span, 3)
                    if len(offs) > 1 and span > 0 else None
                )
            out["class_mean_rps"] = dict(sorted(rates.items()))
        return out


def drive_open_loop(
    fleet: Fleet,
    schedule: list[tuple[float, list[int], int]],
    *,
    time_scale: float = 1.0,
    session_every: int | None = None,
    on_reject=None,
) -> dict[str, list[int]]:
    """Run a TrafficGen schedule through a fleet OPEN-LOOP: submissions
    land at their scheduled wall-clock offsets (scaled by
    ``time_scale``) whether or not earlier work finished, the fleet
    stepping continuously in between.  ``session_every`` tags every
    k-th request with a recurring session id (affinity traffic).
    Entries may be ``(t, prompt, new)`` or — ``schedule_classed`` —
    ``(t, prompt, new, slo_class)``.  Returns {rid: tokens} for every
    accepted request."""
    out: dict[str, list[int]] = {}
    idx = 0
    t0 = time.perf_counter()
    while idx < len(schedule) or not fleet.idle:
        now = (time.perf_counter() - t0) / time_scale
        while idx < len(schedule) and schedule[idx][0] <= now:
            entry = schedule[idx]
            _, prompt, new = entry[:3]
            slo_class = entry[3] if len(entry) > 3 else None
            session = (
                f"sess-{idx % session_every}"
                if session_every else None
            )
            try:
                rid = fleet.submit(
                    prompt, new, session=session, slo_class=slo_class,
                )
                out[rid] = []
            except QueueFull:
                if on_reject is not None:
                    on_reject(idx)
            idx += 1
        for fr in fleet.step():
            if fr.rid in out:
                out[fr.rid] = fr.tokens
    return out


# ---- HTTP/SSE front end --------------------------------------------------


class FleetServer:
    """A minimal HTTP/SSE front end over a Fleet (dependency-free, like
    the plugin's MetricsServer).

      * ``POST /v1/generate`` — JSON body ``{"prompt": [ints],
        "max_new_tokens": n, "session": ..., "eos_token": ...,
        "deadline_s": ...}`` → ``text/event-stream``: one
        ``data: {"tokens": [...]}`` event per poll with fresh tokens,
        then a final ``data: {"done": true, "status": ..., "rid": ...}``.
        Backpressure maps to HTTP 429 (QueueFull), validation to 400.
      * ``GET /healthz`` — fleet liveness + per-replica states JSON.
      * ``POST /drain/<i>`` / ``POST /undrain/<i>`` — the operator
        seam over HTTP: stop routing new work to replica ``i`` (its
        in-flight work finishes there) / take it back.  ``/healthz``
        already reported the drain states; these make them actionable
        remotely.
      * ``POST /clear/<chip_id>`` — lift a supervisor quarantine for
        one chip slot (409 when no supervisor is armed, 404 for an
        unknown slot): the remote pendant of
        ``FleetSupervisor.clear()``, which was in-process only.
      * ``POST /profile?secs=N`` / ``POST /profile/stop`` /
        ``GET /profile`` — on-demand device-trace capture against the
        armed ``ProfileSession`` (workloads/profiler.py; the serve
        CLI's ``--profile-dir``): start a bounded ``torch.profiler``
        capture on the live fleet, stop it early, read session state.
        409 when no session is armed, a capture is already active, or
        the disk budget is spent.

    ``start()`` binds the port (0 = ephemeral; the bound port lands
    back on ``.port``) and spins the fleet's driver thread; handlers
    only submit/poll under the fleet lock."""

    def __init__(
        self, fleet: Fleet, port: int = 0, poll_s: float = 0.002,
        supervisor=None, autoscaler=None, profiler=None,
        controller=None,
    ):
        self.fleet = fleet
        self.port = port
        self.poll_s = poll_s
        # Optional FleetSupervisor (workloads/supervisor.py): the driver
        # thread then runs the SUPERVISED loop (heal pass per step) and
        # /healthz reports per-chip-slot supervision states.  An armed
        # FleetAutoscaler (workloads/autoscaler.py) takes over the
        # driver loop (its step wraps the supervisor's, which wraps the
        # fleet's) and /healthz reports the control-loop state too.
        self.supervisor = supervisor
        self.autoscaler = autoscaler
        # Optional GoodputController (workloads/control.py): outranks
        # both for the driver loop (its serve_forever wraps whatever
        # driver it was built over — heal and scale before retune) and
        # /healthz reports the control-loop state.
        self.controller = controller
        # Optional ProfileSession (workloads/profiler.py): arms the
        # /profile endpoints for live device-trace capture.
        self.profiler = profiler
        self._httpd = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def start(self) -> int:
        import http.server

        fleet, poll_s, stop = self.fleet, self.poll_s, self._stop
        supervisor = self.supervisor
        autoscaler = self.autoscaler
        controller = self.controller
        profiler = self.profiler

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _json(self, code: int, obj: dict) -> None:
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _profile(self, action: str, query: str) -> None:
                """Live device-trace capture: start (bounded by the
                session's duration/disk budgets), stop early, or read
                state.  The capture itself is the profiler's business —
                this handler only translates its refusals to 409s."""
                if profiler is None:
                    self._json(409, {
                        "error": "no profile session is armed; start the "
                                 "serve CLI with --profile-dir",
                    })
                    return
                if action == "state":
                    self._json(200, profiler.state())
                    return
                if action == "stop":
                    rec = profiler.stop()
                    if rec is None:
                        self._json(409, {"error": "no capture is active"})
                    else:
                        self._json(200, {"ok": True, "capture": rec})
                    return
                secs = None
                for pair in query.split("&"):
                    if pair.startswith("secs="):
                        try:
                            secs = float(pair[len("secs="):])
                        except ValueError:
                            self._json(400, {
                                "error": f"secs wants a number, got "
                                         f"{pair[len('secs='):]!r}",
                            })
                            return
                try:
                    started = profiler.start(secs)
                except RuntimeError as e:
                    self._json(409, {"error": str(e)})
                    return
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"ok": True, **started})

            def do_GET(self):  # noqa: N802
                if self.path.split("?")[0] == "/profile":
                    self._profile("state", "")
                    return
                if self.path != "/healthz":
                    self.send_error(404)
                    return
                health = {
                    "ok": not fleet.closed,
                    "replicas": {
                        str(r.index): {
                            "state": r.state,
                            "paused": r.paused,
                            "load": r.load(),
                        }
                        for r in fleet.replicas
                    },
                    "queue_depth": fleet.queue_depth,
                }
                if supervisor is not None:
                    health["supervisor"] = supervisor.states()
                if autoscaler is not None:
                    health["autoscaler"] = autoscaler.states()
                if controller is not None:
                    health["control"] = controller.states()
                if getattr(fleet, "ledger", None) is not None:
                    # Chip-time accounting on the liveness endpoint:
                    # busy/goodput fractions + the per-waste-class
                    # token and estimated chip-second totals
                    # (docs/OBSERVABILITY.md "Chip-time ledger").
                    health["ledger"] = fleet.ledger.healthz()
                self._json(200, health)

            def _operator(self, verb: str, arg: str) -> None:
                """The remote operator seam: drain/undrain a replica by
                index, clear a quarantined chip slot by id.  Responses
                carry the resulting state so a curl loop can watch the
                transition it caused."""
                try:
                    if verb in ("drain", "undrain"):
                        if not arg.isdigit():
                            self._json(400, {
                                "error": f"/{verb}/<replica-index> wants "
                                         f"an integer, got {arg!r}",
                            })
                            return
                        index = int(arg)
                        # Decide under the lock, RESPOND outside it: a
                        # client that stalls reading its response must
                        # never hold the fleet driver loop hostage.
                        code, body = None, None
                        with fleet._lock:
                            if not 0 <= index < len(fleet.replicas):
                                code, body = 404, {
                                    "error": f"no replica {index} "
                                             f"(fleet has "
                                             f"{len(fleet.replicas)})",
                                }
                            elif fleet.replicas[index].state == DEAD:
                                code, body = 409, {
                                    "error": f"replica {index} is dead; "
                                             "drain/undrain applies to "
                                             "live replicas",
                                }
                            else:
                                if verb == "drain":
                                    fleet.drain(index)
                                else:
                                    fleet.resume(index)
                                code, body = 200, {
                                    "ok": True, "replica": index,
                                    "state": fleet.replicas[index].state,
                                }
                        self._json(code, body)
                        return
                    # verb == "clear": a supervisor quarantine lift.
                    if supervisor is None:
                        self._json(409, {
                            "error": "no supervisor is armed; /clear "
                                     "lifts supervisor quarantines "
                                     "(--supervise)",
                        })
                        return
                    try:
                        supervisor.clear(arg)
                    except KeyError:
                        self._json(404, {
                            "error": f"no supervised slot for chip "
                                     f"{arg!r} (slots: "
                                     f"{sorted(supervisor.states())})",
                        })
                        return
                    self._json(200, {
                        "ok": True, "chip_id": arg,
                        "state": supervisor.states().get(arg),
                    })
                except Exception as e:  # noqa: BLE001 — an operator
                    # endpoint must answer, not kill the handler thread.
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):  # noqa: N802
                route, _, query = self.path.partition("?")
                parts = route.strip("/").split("/")
                if parts[0] == "profile":
                    action = parts[1] if len(parts) == 2 else "start"
                    if len(parts) > 2 or action not in ("start", "stop"):
                        self.send_error(404)
                        return
                    self._profile(action, query)
                    return
                if len(parts) == 2 and parts[0] in (
                    "drain", "undrain", "clear",
                ):
                    self._operator(parts[0], parts[1])
                    return
                if self.path != "/v1/generate":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    rid = fleet.submit(
                        body["prompt"],
                        body.get("max_new_tokens"),
                        eos_token=body.get("eos_token"),
                        adapter=body.get("adapter"),
                        deadline_s=body.get("deadline_s"),
                        session=body.get("session"),
                        slo_class=body.get("slo_class"),
                    )
                except QueueFull as e:
                    self._json(429, {"error": str(e)})
                    return
                except (
                    KeyError, ValueError, TypeError, json.JSONDecodeError,
                ) as e:
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                except EngineClosed as e:
                    self._json(503, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                cursor = 0
                while not stop.is_set():
                    new, done, status = fleet.poll(rid, cursor)
                    if new:
                        cursor += len(new)
                        self.wfile.write(
                            b"data: "
                            + json.dumps({"tokens": new}).encode()
                            + b"\n\n"
                        )
                        self.wfile.flush()
                    if done:
                        self.wfile.write(
                            b"data: "
                            + json.dumps({
                                "done": True, "status": status,
                                "rid": rid, "n_tokens": cursor,
                            }).encode()
                            + b"\n\n"
                        )
                        self.wfile.flush()
                        return
                    time.sleep(poll_s)

            def log_message(self, fmt, *args):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("", self.port), Handler
        )
        self.port = self._httpd.server_address[1]
        if self.controller is not None:
            driver = self.controller.serve_forever
        elif self.autoscaler is not None:
            driver = self.autoscaler.serve_forever
        elif self.supervisor is not None:
            driver = self.supervisor.serve_forever
        else:
            driver = self.fleet.serve_forever
        for name, target in (
            ("fleet-http", self._httpd.serve_forever),
            ("fleet-driver", lambda: driver(self._stop)),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
