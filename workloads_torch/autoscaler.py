"""Closed-loop fleet autoscaling with a graceful-degradation ladder.

Everything needed to resize the fleet has existed since PRs 6–10 —
``FleetObserver`` publishes queue depth and queue-wait/TTFT percentiles,
the fleet scores per-class SLO attainment and error-budget burn rates,
and ``FleetSupervisor`` can spawn, drain and quarantine replicas through
``engine_factory`` — but nothing DROVE it: the fleet was provisioned
once and reacted to nothing.  ``FleetAutoscaler`` closes that loop, the
serving-layer mirror of the reference plugin's own feedback mode (its
``replicas = -1`` sizes the advertised resource to live device capacity
— PAPER.md §0.5; here the fleet sizes itself to live load).

One autoscaler watches one ``Fleet`` (optionally through its
``FleetSupervisor`` — heal first, then scale).  Each ``poll()`` reads
three signals the fleet already publishes:

  * **p99 queue-wait** over a sliding window of finished requests
    (first-admission stamps, so a failover or preemption replay never
    inflates the signal);
  * **queue depth per dispatchable replica** (parked-class requests
    excluded — deliberately parked bulk is not demand);
  * **per-class SLO burn rates** (``Fleet.slo_burn_rates``), excluding
    the class the ladder deliberately sacrifices.

and actuates through the existing seams:

  * **Scale UP** — ``engine_factory`` builds a fresh engine, a
    bit-identical canary probe must pass (the supervisor's half-open
    discipline: no blind rejoins), then ``Fleet.add_replica`` and —
    when supervised — ``FleetSupervisor.adopt`` so the new replica is
    healed like any founding member.  The ``scale_spawn_fail`` fault
    seam (workloads/faults.py) is consulted once per attempt, so chaos
    runs script capacity-that-cannot-arrive deterministically.
    Quarantined chip slots are respected: slots the supervisor is
    already resurrecting count toward ``max_replicas`` (no
    double-provisioning a slot about to revive), and quarantined slots
    are never re-seeded by the autoscaler.
  * **Scale DOWN** — graceful ``drain()`` of the least-loaded ACTIVE
    replica (never below ``min_replicas``, never the last dispatchable
    one — degraded service beats a queue nothing can serve), then
    ``remove()`` once its in-flight work finishes.  A supervised slot
    is ``forget()``-ed first so the supervisor does not resurrect a
    deliberate retirement.
  * **Hysteresis** — separate up/down cooldowns from the shared
    ``workloads.backoff`` policy (exponential, capped, deterministic
    seeded jitter), plus a consecutive-clear-polls requirement before
    any scale-down, so a noisy signal cannot flap the fleet: spawn
    failures escalate the up-gate exponentially, repeated downs space
    themselves out, and a reversal resets the streaks.

Below the scaling band sits the **degradation ladder**, for when
capacity cannot arrive in time (at ``max_replicas``, spawn failures, or
still inside the up-cooldown while the signal burns):

  * **Step 1 — brownout.**  ``Fleet.admission_factor`` tightens the
    capacity-aware admission bound to ``brownout_factor`` of itself;
    the typed ``QueueFull`` names the brownout, so shed clients know
    the rejection is deliberate and temporary.
  * **Step 2 — preemption-via-offload.**  Running ``preempt_class``
    (default bulk) streams are PARKED: ``ServeEngine.preempt`` drains
    their pipelined state, pushes their radix-tree prefix pages to the
    PR-9 host offload tier (``RadixKV.park`` — HBM freed the moment
    the stream yields), and the fleet requeues them UNCHARGED at the
    queue back with their class parked out of dispatch.  The
    interactive class gets the slots; when the spike passes the ladder
    steps back down, the class unparks, and the ordinary replay path
    resumes every parked stream as an EXACT continuation (the prefix
    lookup reloads the parked pages bit-exactly).

The controller is cooperative and deterministic like the supervisor:
``poll()`` runs after each ``fleet.step()`` (or use ``step()`` /
``run()`` / ``serve_forever``, which wrap the supervised loops), takes
no threads of its own, and every decision lands on the event ring the
merged fleet trace renders on the supervisor lane
(``workloads.obs.fleet_trace_events``) and on the registry via
``AutoscalerObserver`` (AUTOSCALER_METRICS, docs/OBSERVABILITY.md).

The bench arm is ``measure_autoscale`` (workloads/perfbench.py): a
seeded TrafficGen step-load trace (arrival rate x4 for a bounded
window) must scale 1 -> N and back with ok token streams bit-identical
to a fixed-size oracle fleet, publishing ``autoscale_recover_slo_ms``
(signal breach -> signal clear), ``autoscale_overprovision_chip_s``
(extra chip-seconds held while the signal was already clear) and
``autoscale_preempt_resume_ms`` (park -> first resumed token).

Reference pendant: the reference's ``replicas = -1`` resizes the
ADVERTISED resource to device capacity once per discovery pass
(PAPER.md §0.5); this is the same feedback idea pointed at the serving
layer, where load — not hardware — is the thing that moves.

The PyTorch port's own copy of ``workloads/autoscaler.py`` (the port
imports nothing of the JAX package); tests/test_torch_copies.py holds
every definition to it.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace

from .backoff import Backoff
from .errors import EngineClosed
from .obs import SupervisorEvent

# Supervisor slot states the autoscaler must respect (string literals to
# stay importable without the supervisor module loaded).
_SLOT_PENDING = ("backoff", "probing")


@dataclass(frozen=True)
class AutoscaleSignals:
    """One poll's view of the fleet's own load signals.  ``qw_p99_s``
    is None while the sliding window holds no finished requests (no
    evidence either way — never a breach on its own)."""

    qw_p99_s: float | None
    depth_per_replica: float
    burn: float  # max windowed burn rate over non-sacrificed classes
    breach: bool  # scale-up territory
    clear: bool  # scale-down territory (strictly below the breach band)
    severe: bool  # ladder step-2 territory
    # Aggregate free KV pages / total pages across live replicas (None
    # when the fleet exposes no page pools or the watermark is off) —
    # page capacity as a FLUID autoscale input: snapshot-primed fast
    # start makes adding a replica cheap, so running low on pages is
    # itself scale-up territory (page_low_watermark=).
    free_page_fraction: float | None = None
    # Fleet-wide wasted-chip-time fraction (1 - ledger goodput
    # fraction; the GoodputController's EWMA when one is feeding
    # ``waste_fraction_hint``, the instantaneous fleet-ledger read
    # otherwise).  None while no ``waste_budget=`` is set or no ledger
    # has accounted tokens — never an input on its own.
    waste_fraction: float | None = None


class FleetAutoscaler:
    """Close the loop: poll the fleet's own signals, resize through the
    supervisor's seams, degrade gracefully when resize can't keep pace
    (module docstring).

    ``engine_factory(slot)`` must return a fresh homogeneous
    ``ServeEngine`` (the supervisor's factory contract; scale-ups pass
    a slot-SHAPED handle carrying the new ``chip_id`` and
    ``restarts=0`` so observer-attaching factories can label the
    replica, probe calibration passes ``None``).  ``probe`` /
    ``probe_oracle`` are the canary contract: every scaled-up engine
    must reproduce the oracle stream bit-identically before it joins
    (trust-on-first-use when no oracle is given)."""

    def __init__(
        self,
        fleet,
        engine_factory,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        supervisor=None,
        queue_wait_p99_target_s: float = 0.5,
        depth_high: float = 4.0,
        burn_high: float = 1.0,
        clear_fraction: float = 0.5,
        severe_factor: float = 2.0,
        window_s: float = 10.0,
        up_backoff: Backoff | None = None,
        down_backoff: Backoff | None = None,
        down_consecutive: int = 3,
        brownout_factor: float = 0.5,
        preempt_class: str = "bulk",
        preempt_batch: int = 2,
        page_low_watermark: float | None = None,
        waste_budget: float | None = None,
        probe: tuple[list[int], int] = ([1, 2, 3], 4),
        probe_oracle: list[int] | None = None,
        probe_max_steps: int = 400,
        fault_injector=None,
        observer=None,
        snapshot=None,
        clock=time.perf_counter,
    ):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}"
            )
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} must be >= min_replicas "
                f"{min_replicas}"
            )
        if queue_wait_p99_target_s <= 0:
            raise ValueError(
                f"queue_wait_p99_target_s must be > 0, got "
                f"{queue_wait_p99_target_s}"
            )
        if depth_high <= 0:
            raise ValueError(f"depth_high must be > 0, got {depth_high}")
        if burn_high <= 0:
            raise ValueError(f"burn_high must be > 0, got {burn_high}")
        if not 0.0 < clear_fraction < 1.0:
            raise ValueError(
                f"clear_fraction must be in (0, 1) — the clear band "
                f"must sit strictly below the breach band, got "
                f"{clear_fraction}"
            )
        if severe_factor <= 1.0:
            raise ValueError(
                f"severe_factor must be > 1, got {severe_factor}"
            )
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if down_consecutive < 1:
            raise ValueError(
                f"down_consecutive must be >= 1, got {down_consecutive}"
            )
        if not 0.0 < brownout_factor < 1.0:
            raise ValueError(
                f"brownout_factor must be in (0, 1) — 1 tightens "
                f"nothing and 0 sheds everything, got {brownout_factor}"
            )
        if preempt_batch < 1:
            raise ValueError(
                f"preempt_batch must be >= 1, got {preempt_batch}"
            )
        if page_low_watermark is not None and not (
            0.0 < page_low_watermark < 1.0
        ):
            raise ValueError(
                f"page_low_watermark must be in (0, 1) or None (off), "
                f"got {page_low_watermark}"
            )
        if waste_budget is not None and not 0.0 < waste_budget < 1.0:
            raise ValueError(
                f"waste_budget must be in (0, 1) or None (off) — the "
                f"tolerated fraction of charged chip-time going to "
                f"waste, got {waste_budget}"
            )
        prompt, new = probe
        if not prompt or new < 1:
            raise ValueError(
                f"probe needs a non-empty prompt and max_new >= 1, got "
                f"{probe}"
            )
        if probe_max_steps < 1:
            raise ValueError(
                f"probe_max_steps must be >= 1, got {probe_max_steps}"
            )
        self.fleet = fleet
        self.engine_factory = engine_factory
        self.supervisor = supervisor
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.queue_wait_p99_target_s = float(queue_wait_p99_target_s)
        self.depth_high = float(depth_high)
        self.burn_high = float(burn_high)
        self.clear_fraction = float(clear_fraction)
        self.severe_factor = float(severe_factor)
        self.window_s = float(window_s)
        self.page_low_watermark = (
            None if page_low_watermark is None
            else float(page_low_watermark)
        )
        # Waste-budget SLO (the goodput control plane's seam 3): with a
        # budget set and a fleet ledger armed, scale-up is HELD while
        # the measured waste fraction exceeds it (more replicas
        # multiply waste — the degradation ladder engages instead, and
        # the GoodputController's retunes attack the waste itself),
        # and the scale-down streak relaxes to one clear poll while
        # waste sits comfortably inside the budget (goodput headroom
        # means capacity above the floor is pure
        # autoscale_overprovision_chip_s).  A GoodputController feeds
        # its EWMA-smoothed view through ``waste_fraction_hint``;
        # without one the instantaneous fleet-ledger read is used.
        self.waste_budget = (
            None if waste_budget is None else float(waste_budget)
        )
        self.waste_fraction_hint: float | None = None
        # Separate up/down hysteresis from the shared backoff policy:
        # derive() decorrelates the jitter per direction, consecutive
        # spawn failures escalate the up-gate, repeated downs space out.
        self._up = (
            up_backoff if up_backoff is not None
            else Backoff(base_s=0.5, max_s=30.0)
        ).derive("scale-up")
        self._down = (
            down_backoff if down_backoff is not None
            else Backoff(base_s=2.0, max_s=60.0)
        ).derive("scale-down")
        self.down_consecutive = down_consecutive
        self.brownout_factor = float(brownout_factor)
        self.preempt_class = preempt_class
        self.preempt_batch = preempt_batch
        self.probe_prompt = [int(t) for t in prompt]
        self.probe_new = int(new)
        self.probe_max_steps = probe_max_steps
        self._probe_oracle = (
            [int(t) for t in probe_oracle]
            if probe_oracle is not None else None
        )
        # Fast start (workloads/faststart.py): a snapshot captured
        # against the SAME probe seeds the canary oracle, so arming the
        # autoscaler needs no scratch build — the first scale-up is the
        # first engine built.
        self.snapshot = snapshot
        if (
            self._probe_oracle is None
            and snapshot is not None
            and getattr(snapshot, "probe_oracle", None) is not None
            and getattr(snapshot, "probe", None) is not None
            and list(snapshot.probe[0]) == self.probe_prompt
            and int(snapshot.probe[1]) == self.probe_new
        ):
            self._probe_oracle = [int(t) for t in snapshot.probe_oracle]
        self._faults = fault_injector
        self._clock = clock
        self._serial = itertools.count()
        self._probes = 0
        # Control state.
        self._qw: deque[tuple[float, float]] = deque()
        self._gate_up = float("-inf")
        self._gate_down = float("-inf")
        self._spawn_fail_streak = 0
        self._downs_in_row = 0
        self._clear_streak = 0
        self._retiring: dict[int, str] = {}  # replica index -> chip id
        self._breach_t: float | None = None
        self._last_poll_t: float | None = None
        self.ladder_level = 0
        self.last_signals: AutoscaleSignals | None = None
        self.target_replicas = self._provisioned()
        # Telemetry (mirrored to the registry by AutoscalerObserver).
        self.scale_ups = 0
        self.scale_downs = 0
        self.spawn_failures = 0
        self.brownouts = 0
        self.preemptions_total = 0
        self.waste_holds = 0  # scale-up-held-by-waste-budget windows
        self._waste_hold_open = False
        self.decisions: dict[str, int] = {}
        self.recover_s: list[float] = []  # breach -> clear windows
        self.overprovision_chip_s = 0.0
        # The control timeline: one SupervisorEvent per decision, on the
        # merged fleet trace's supervisor lane next to the heal events.
        self.events: deque = deque(maxlen=4096)
        self.dropped_events = 0
        self._obs = observer
        if observer is not None:
            observer._bind(self)

    # ---- bookkeeping -----------------------------------------------------

    def _event(
        self, kind: str, chip_id: str = "", detail: str = "",
        t: float | None = None,
    ) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped_events += 1
        self.events.append(SupervisorEvent(
            t=self._clock() if t is None else t, kind=kind,
            chip_id=chip_id, detail=detail,
        ))

    def drain_events(self) -> list:
        out = list(self.events)
        self.events.clear()
        return out

    def _decide(self, action: str) -> None:
        self.decisions[action] = self.decisions.get(action, 0) + 1

    @property
    def recover_ms(self) -> list[float]:
        return [round(s * 1000, 2) for s in self.recover_s]

    def states(self) -> dict:
        """The /healthz introspection blob: where the control loop is
        right now."""
        return {
            "ladder_level": self.ladder_level,
            "target_replicas": self.target_replicas,
            "live_replicas": len(self.fleet.alive),
            "dispatchable": self.fleet.dispatchable_count,
            "retiring": sorted(self._retiring),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "admission_factor": self.fleet.admission_factor,
            "parked_classes": sorted(self.fleet.parked_classes),
            "waste_budget": self.waste_budget,
            "waste_fraction": (
                None if self.last_signals is None
                else self.last_signals.waste_fraction
            ),
            "waste_holds": self.waste_holds,
        }

    # ---- capacity accounting ---------------------------------------------

    def _provisioned(self) -> int:
        """Replica capacity already owned or promised: live non-retiring
        replicas, plus supervised slots mid-resurrection (a slot the
        supervisor is about to revive must not be double-provisioned by
        a scale-up).  Quarantined/forgotten slots count nothing — their
        capacity is genuinely gone until an operator acts."""
        live = sum(
            1 for r in self.fleet.replicas
            if r.state != "dead" and r.index not in self._retiring
        )
        pending = 0
        if self.supervisor is not None:
            pending = sum(
                1 for s in self.supervisor.slots
                if s.state in _SLOT_PENDING
            )
        return live + pending

    def note_finished(self, finished) -> None:
        """Feed the queue-wait window from a step's terminal requests.
        First-admission stamps only (``t_admit`` never resets across
        failovers or preemptions), so replays cannot inflate the
        signal."""
        now = self._clock()
        for fr in finished:
            qw = fr.queue_wait_secs
            if qw is not None:
                self._qw.append((now, float(qw)))
        while self._qw and now - self._qw[0][0] > self.window_s:
            self._qw.popleft()

    def _signals(self, now: float) -> AutoscaleSignals:
        while self._qw and now - self._qw[0][0] > self.window_s:
            self._qw.popleft()
        qw_p99 = None
        if self._qw:
            samples = sorted(s for _, s in self._qw)
            qw_p99 = samples[
                min(len(samples) - 1, int(0.99 * len(samples)))
            ]
        fleet = self.fleet
        with fleet._lock:
            # Demand = router-queued requests (parked classes excluded:
            # the ladder parked them on purpose, and counting them
            # would hold the breach open forever) PLUS the replicas'
            # own backlog beyond their decode slots — the router
            # dispatches its whole queue into engine queues every
            # step, so the router queue alone reads near-empty however
            # overloaded the fleet is.
            depth = sum(
                1 for fr in fleet.queue
                if fr.slo_class not in fleet.parked_classes
            )
            for r in fleet.replicas:
                if r.state != "dead":
                    # load_requests, NOT load(): this signal is
                    # calibrated in requests per replica (depth_high);
                    # the router's bucket-weighted load() would let one
                    # long mid-prefill prompt read as dozens of queued
                    # requests.
                    depth += max(
                        0,
                        r.load_requests() - getattr(r.engine, "slots", 0),
                    )
            dispatchable = max(1, fleet.dispatchable_count)
            # Page capacity as a fluid signal (page_low_watermark=):
            # the fraction of the fleet's KV pages still free, host
            # tier included.  Low headroom means admission is about to
            # tighten (the page-aware bound) — with snapshot-primed
            # fast start a new replica is cheap page capacity, so the
            # watermark opens the breach before queue wait does.
            page_frac = None
            if self.page_low_watermark is not None:
                free = total = 0
                for r in fleet.replicas:
                    if not r.dispatchable:
                        continue
                    rep_free = r.free_pages()
                    if rep_free is None:
                        continue
                    # Host-tier headroom counts toward FREE (spilling
                    # cold pages relieves HBM pressure) but not toward
                    # the denominator — clamped, so an oversized host
                    # tier reads as "fully free", never more.
                    free += rep_free + r.host_free_pages()
                    total += r.total_pages() or 0
                if total > 0:
                    page_frac = min(1.0, free / total)
        depth_per = depth / dispatchable
        burn = 0.0
        for name, rate in fleet.slo_burn_rates().items():
            if name == self.preempt_class:
                continue  # the class the ladder sacrifices is not input
            burn = max(burn, rate)
        target = self.queue_wait_p99_target_s
        wm = self.page_low_watermark
        page_low = (
            wm is not None and page_frac is not None and page_frac < wm
        )
        breach = (
            (qw_p99 is not None and qw_p99 > target)
            or depth_per > self.depth_high
            or burn > self.burn_high
            or page_low
        )
        frac = self.clear_fraction
        clear = (
            not breach
            and (qw_p99 is None or qw_p99 <= target * frac)
            and depth_per <= self.depth_high * frac
            and burn <= self.burn_high * frac
            # Scale-down only with COMFORTABLE page headroom: the same
            # hysteresis ratio the other signals use, inverted because
            # free fraction clears HIGH (breach below wm, clear at or
            # above wm / frac).
            and (
                wm is None or page_frac is None
                or page_frac >= min(1.0, wm / frac)
            )
        )
        sev = self.severe_factor
        severe = (
            (qw_p99 is not None and qw_p99 > sev * target)
            or depth_per > sev * self.depth_high
            or burn > sev * self.burn_high
            or (page_low and page_frac < wm / sev)
        )
        # Wasted-chip-time fraction (waste_budget=): prefer the
        # controller's EWMA hint (smoothed over its own poll windows),
        # fall back to the instantaneous fleet-ledger read.  None
        # until something has accounted tokens — an idle fleet must
        # not hold or relax anything on zero evidence.
        waste_frac = None
        if self.waste_budget is not None:
            if self.waste_fraction_hint is not None:
                waste_frac = max(
                    0.0, min(1.0, float(self.waste_fraction_hint))
                )
            else:
                led = getattr(fleet, "ledger", None)
                if led is not None and getattr(
                    led, "tokens_accounted", 0
                ):
                    waste_frac = max(0.0, min(
                        1.0, 1.0 - float(led.goodput_fraction)
                    ))
        return AutoscaleSignals(
            qw_p99_s=qw_p99, depth_per_replica=depth_per, burn=burn,
            breach=breach, clear=clear, severe=severe,
            free_page_fraction=page_frac,
            waste_fraction=waste_frac,
        )

    # ---- waste-budget SLO (goodput control plane seam 3) ---------------

    def _waste_over(self, sig: AutoscaleSignals) -> bool:
        """Scale-up-hold territory: measured waste exceeds the budget
        — a new replica would burn its chip-time the same way, so
        capacity must not grow into it (the ladder and the
        controller's retunes attack the waste instead)."""
        return (
            self.waste_budget is not None
            and sig.waste_fraction is not None
            and sig.waste_fraction > self.waste_budget
        )

    def _waste_headroom(self, sig: AutoscaleSignals) -> bool:
        """Eager-scale-down territory: waste comfortably inside the
        budget (the same clear_fraction hysteresis band the other
        signals use) — goodput headroom means replicas above the
        floor are accumulating pure overprovision chip-seconds."""
        return (
            self.waste_budget is not None
            and sig.waste_fraction is not None
            and sig.waste_fraction
            <= self.waste_budget * self.clear_fraction
        )

    # ---- actuation: scale up --------------------------------------------

    def _probe(self, engine) -> tuple[bool, str]:
        """The half-open canary (the supervisor's discipline, shared
        ``run_canary`` runner): one request must finish ok,
        bit-identical to the oracle, before the engine may join."""
        from .supervisor import run_canary

        self._probes += 1
        # Ledger-armed engines classify the canary's chip time and
        # tokens as probe_warmup waste, not goodput — the supervisor
        # probe's discipline (workloads/ledger.py OFFBOOK_PHASES).
        had_phase = getattr(engine, "ledger_phase", None)
        if had_phase is not None:
            engine.ledger_phase = "probe"
        try:
            tokens, status = run_canary(
                engine, self.probe_prompt, self.probe_new,
                rid=f"scale-canary-{self._probes}",
                max_steps=self.probe_max_steps,
            )
        except Exception as exc:  # noqa: BLE001 — a probe blowing up IS
            # the signal probes exist for.
            return False, f"{type(exc).__name__}: {exc}"
        finally:
            if had_phase is not None:
                engine.ledger_phase = had_phase
        if tokens is None:
            return False, (
                f"canary did not finish within {self.probe_max_steps} "
                f"steps"
            )
        if status != "ok":
            return False, f"canary finished {status!r}"
        if self._probe_oracle is None:
            self._probe_oracle = tokens
            return True, "oracle seeded"
        if tokens != self._probe_oracle:
            return False, (
                f"canary stream diverged from oracle: {tokens} != "
                f"{self._probe_oracle}"
            )
        return True, "bit-identical"

    def calibrate_probe(self) -> list[int]:
        """Seed the canary oracle from a scratch factory engine now
        (the supervisor's arm-time calibration), so the FIRST scale-up
        is already held to bit-identity.  No-op with an oracle
        present."""
        if self._probe_oracle is None:
            scratch = self.engine_factory(None)
            try:
                ok, detail = self._probe(scratch)
                if not ok:
                    raise RuntimeError(
                        f"probe calibration failed: {detail}"
                    )
            finally:
                try:
                    scratch.close()
                except Exception:  # noqa: BLE001 — scratch teardown
                    pass
        return list(self._probe_oracle)

    def _spawn_failed(self, now: float, reason: str) -> None:
        self.spawn_failures += 1
        self._decide("spawn_failed")
        # Exponential up-gate escalation per consecutive failure: a
        # provisioning API that keeps refusing is probed ever more
        # gently, exactly the supervisor's restart discipline.
        self._gate_up = now + self._up.delay(self._spawn_fail_streak)
        self._spawn_fail_streak += 1
        self._event("spawn_failed", "", reason, t=now)

    def _try_scale_up(self, now: float) -> bool:
        """One probed scale-up attempt; returns True iff a replica
        joined (the ladder escalates only when this could not help)."""
        if now < self._gate_up:
            return False
        if self._provisioned() >= self.max_replicas:
            return False
        chip_id = f"scale-{next(self._serial)}"
        if self.supervisor is not None and chip_id in {
            s.chip_id for s in self.supervisor.slots
        }:
            # Never re-seed an existing (possibly quarantined) slot id.
            chip_id = f"scale-{next(self._serial)}"
        try:
            if self._faults is not None:
                self._faults.check("scale_spawn_fail")
            # A slot-SHAPED handle (chip_id + restarts), not None:
            # observer-attaching factories (the serve CLI's respawn/
            # scale factories) key a replica label off it, so a
            # scaled-up replica's timeline lands on the merged trace
            # exactly like a resurrected one's.  Probe calibration
            # still passes None (scratch engines stay unobserved).
            engine = self.engine_factory(
                SimpleNamespace(chip_id=chip_id, restarts=0)
            )
        except Exception as exc:  # noqa: BLE001 — a spawn failure is a
            # signal, not an autoscaler crash.
            self._spawn_failed(
                now, f"spawn died: {type(exc).__name__}: {exc}"
            )
            return False
        if self.snapshot is not None:
            # Idempotent when the factory already primed: injection
            # only lands on an engine with no calibration yet.
            self.snapshot.prime(engine)
        ok, detail = self._probe(engine)
        if not ok:
            try:
                engine.close()
            except Exception:  # noqa: BLE001 — discard must not raise
                pass
            self._spawn_failed(now, f"half-open probe failed: {detail}")
            return False
        try:
            index = self.fleet.add_replica(engine, chip_id)
        except EngineClosed:
            try:
                engine.close()
            except Exception:  # noqa: BLE001 — discard must not raise
                pass
            return False
        if self.supervisor is not None:
            try:
                self.supervisor.adopt(chip_id, index)
            except ValueError:
                pass  # already supervised (defensive; ids are fresh)
        self.scale_ups += 1
        self._decide("scale_up")
        self._spawn_fail_streak = 0
        self._clear_streak = 0
        # Cooldowns both ways: no immediate second up (let the new
        # replica absorb load first), and no down while it warms.
        self._gate_up = now + self._up.delay(0)
        self._gate_down = max(
            self._gate_down, now + self._down.delay(0)
        )
        self._event(
            "scale_up", chip_id,
            f"replica {index} joined ({detail})", t=now,
        )
        return True

    # ---- actuation: scale down ------------------------------------------

    def _try_scale_down(self, now: float) -> None:
        fleet = self.fleet
        live = [
            r for r in fleet.replicas
            if r.state == "active" and r.index not in self._retiring
        ]
        if len(live) + sum(
            1 for r in fleet.replicas
            if r.state == "draining" and r.index not in self._retiring
        ) <= self.min_replicas:
            return
        candidates = [r for r in live if r.dispatchable]
        # Never drain the last dispatchable replica fleet-wide:
        # degraded service beats a queue nothing can serve.
        if not candidates or fleet.dispatchable_count <= 1:
            return
        victim = min(candidates, key=lambda r: (r.load(), r.index))
        chip_id = victim.chip_id or f"replica-{victim.index}"
        # A supervised slot must stop being healed BEFORE the drain
        # completes, or the supervisor would resurrect the deliberate
        # retirement as a death.
        if self.supervisor is not None:
            for cid in (victim.chip_id, f"replica-{victim.index}"):
                try:
                    self.supervisor.forget(cid)
                    break
                except KeyError:
                    continue
        fleet.drain(victim.index)
        self._retiring[victim.index] = chip_id
        self.scale_downs += 1
        self._decide("scale_down")
        self._gate_down = now + self._down.delay(
            min(self._downs_in_row, 8)
        )
        self._downs_in_row += 1
        self._clear_streak = 0
        self._event(
            "scale_down", chip_id,
            f"draining replica {victim.index} (load {victim.load()})",
            t=now,
        )

    def _finish_retirements(self) -> None:
        """Close out drains the scale-down opened: an idle DRAINING
        replica removes (its engine closes, pages release); a replica
        that died or was resumed under us just leaves the book."""
        fleet = self.fleet
        for index, chip_id in list(self._retiring.items()):
            rep = fleet.replicas[index]
            if rep.state == "dead" or rep.state == "active":
                self._retiring.pop(index)
                continue
            if rep.state == "draining" and rep.idle:
                try:
                    fleet.remove(index)
                except Exception:  # noqa: BLE001 — retry next poll
                    continue
                self._retiring.pop(index)
                self._event(
                    "removed", chip_id, f"replica {index} retired"
                )

    # ---- the degradation ladder -----------------------------------------

    def _ladder_up(self, now: float, severe: bool) -> None:
        fleet = self.fleet
        if self.ladder_level == 0:
            self.ladder_level = 1
            self.brownouts += 1
            self._decide("brownout")
            fleet.admission_factor = self.brownout_factor
            self._event(
                "brownout", "",
                f"admission tightened to {self.brownout_factor:g}x "
                f"(capacity cannot arrive in time)", t=now,
            )
            return
        if not severe:
            return
        if self.ladder_level == 1:
            self.ladder_level = 2
            fleet.parked_classes.add(self.preempt_class)
            self._event(
                "preempt_level", "",
                f"class {self.preempt_class!r} parked out of dispatch",
                t=now,
            )
        self._preempt_some(now)

    def _preempt_some(self, now: float) -> int:
        """Park up to ``preempt_batch`` running preempt-class streams
        in VICTIM-SCORED order (``Fleet.preempt_candidates``:
        ascending goodput-per-retained-page, so the stream that frees
        the most KV pages per token thrown away parks first; without
        page pools the scores all tie at 0 and the old deterministic
        replica-index/insertion order applies) — their prefix pages
        push to the host tier and the rids requeue uncharged for
        post-spike resumption."""
        fleet = self.fleet
        preempted = 0
        targets = fleet.preempt_candidates(self.preempt_class)
        for rid in targets:
            if preempted >= self.preempt_batch:
                break
            try:
                if fleet.preempt(rid):
                    preempted += 1
            except EngineClosed:
                break
        if preempted:
            self.preemptions_total += preempted
            self._decide("preempt")
            self._event(
                "preempt", "",
                f"parked {preempted} {self.preempt_class!r} stream(s) "
                f"via host offload", t=now,
            )
        return preempted

    def _ladder_down(self, now: float) -> None:
        """One rung per clear poll — recovery is deliberate, never a
        cliff."""
        fleet = self.fleet
        if self.ladder_level == 2:
            self.ladder_level = 1
            fleet.parked_classes.discard(self.preempt_class)
            self._decide("preempt_clear")
            self._event(
                "preempt_clear", "",
                f"class {self.preempt_class!r} unparked; parked "
                f"streams resume via replay", t=now,
            )
        elif self.ladder_level == 1:
            self.ladder_level = 0
            fleet.admission_factor = 1.0
            self._decide("brownout_clear")
            self._event(
                "brownout_clear", "", "admission bound restored", t=now,
            )

    # ---- the control loop ------------------------------------------------

    def poll(self, now: float | None = None) -> None:
        """One control pass: finish pending retirements, read the
        signals, close/open the SLO-recovery window, then ladder-down /
        scale / ladder-up as the signal demands.  Call after each
        ``fleet.step()`` (or use ``step()``/``run()``, which do)."""
        if self.fleet.closed:
            return
        now = self._clock() if now is None else now
        self._finish_retirements()
        sig = self._signals(now)
        self.last_signals = sig
        # Over-provisioned chip-seconds: capacity above the floor held
        # while the signal did NOT demand it — the cost of scaling up
        # (and of lazy scale-down), integrated poll to poll.
        if self._last_poll_t is not None and not sig.breach:
            extra = max(
                0,
                sum(1 for r in self.fleet.replicas if r.state != "dead")
                - self.min_replicas,
            )
            self.overprovision_chip_s += (
                max(0.0, now - self._last_poll_t) * extra
            )
        self._last_poll_t = now
        if sig.breach and self._breach_t is None:
            self._breach_t = now
            self._event(
                "breach", "",
                f"qw_p99={sig.qw_p99_s} depth/replica="
                f"{sig.depth_per_replica:.2f} burn={sig.burn:.2f}",
                t=now,
            )
        if sig.clear and self._breach_t is not None:
            self.recover_s.append(now - self._breach_t)
            self._breach_t = None
            self._event(
                "recovered", "",
                f"signal clear after "
                f"{self.recover_s[-1] * 1000:.1f}ms", t=now,
            )
        if sig.clear and self.ladder_level > 0:
            self._ladder_down(now)
        if sig.breach:
            self._clear_streak = 0
            self._downs_in_row = 0
            scaled = False
            if self._waste_over(sig):
                # Don't scale up into measured waste: a replica added
                # now multiplies the burn.  Hold capacity, let the
                # ladder shed/park while the retunes fix the waste.
                if not self._waste_hold_open:
                    self._waste_hold_open = True
                    self.waste_holds += 1
                    self._decide("waste_hold")
                    self._event(
                        "waste_hold", "",
                        f"waste {sig.waste_fraction:.2f} > budget "
                        f"{self.waste_budget:g}: scale-up held, "
                        f"ladder engages", t=now,
                    )
            else:
                scaled = self._try_scale_up(now)
            if not scaled:
                self._ladder_up(now, sig.severe)
        elif sig.clear:
            self._waste_hold_open = False
            self._clear_streak += 1
            need = (
                1 if self._waste_headroom(sig)
                else self.down_consecutive
            )
            if self._clear_streak >= need and now >= self._gate_down:
                self._try_scale_down(now)
        else:
            # The hysteresis band between clear and breach: hold.
            self._clear_streak = 0
        self.target_replicas = min(
            self.max_replicas, max(self.min_replicas, self._provisioned())
        )
        if self._obs is not None:
            self._obs._autoscaler_poll_end(self)

    # ---- fleet-shaped driving surface ------------------------------------
    # Duck-typed to the Fleet/Supervisor loop API so drive_open_loop and
    # FleetServer can run AUTOSCALED by passing the autoscaler where a
    # fleet goes.

    def submit(self, *args, **kwargs):
        return self.fleet.submit(*args, **kwargs)

    def cancel(self, rid: str) -> bool:
        return self.fleet.cancel(rid)

    @property
    def idle(self) -> bool:
        return self.fleet.idle

    @property
    def closed(self) -> bool:
        return self.fleet.closed

    def step(self):
        """One autoscaled fleet iteration: step (supervised when a
        supervisor is armed — heal before scale), feed the signal
        windows, then run the control pass."""
        finished = (
            self.supervisor.step() if self.supervisor is not None
            else self.fleet.step()
        )
        self.note_finished(finished)
        self.poll()
        return finished

    def _parked(self) -> bool:
        fleet = self.fleet
        if any(r.dispatchable for r in fleet.alive):
            return False
        if self.supervisor is not None:
            return self.supervisor._parked()
        return bool(fleet.alive)

    def run(self) -> dict[str, list[int]]:
        """Drive to fleet idle (the fleet.run contract) with the
        control loop running between steps."""
        out: dict[str, list[int]] = {}
        while not self.fleet.idle:
            for fr in self.step():
                out[fr.rid] = fr.tokens
            if self._parked():
                time.sleep(0.001)
        return out

    def serve_forever(self, stop_event) -> None:
        """The autoscaled front-end driver loop —
        ``FleetServer(fleet, autoscaler=...)`` runs exactly this.
        Only the fleet step runs under the lock; the heal pass and the
        control pass run OUTSIDE it (a respawn or probed scale-up may
        compile an engine and decode a canary — the HTTP handlers must
        keep submitting/polling throughout)."""
        from .supervisor import drive_forever

        def step_fn():
            self.note_finished(self.fleet.step())

        def poll_fn():
            if self.supervisor is not None:
                self.supervisor.poll()
            self.poll()

        drive_forever(
            self.fleet, stop_event,
            step_fn=step_fn, poll_fn=poll_fn, parked_fn=self._parked,
        )

    def wait_quiescent(self, timeout_s: float = 30.0) -> bool:
        """Step the (possibly idle) fleet until the controller is back
        at rest — ladder level 0, no retirements in flight, no open
        breach window, capacity back at the ``min_replicas`` floor —
        or the timeout passes.  The bench's scale-back-down
        convergence wait (over-provisioned chip-seconds accumulate
        until this returns)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.step()
            if (
                self.ladder_level == 0
                and not self._retiring
                and self._breach_t is None
                and self._provisioned() <= self.min_replicas
            ):
                return True
            time.sleep(0.001)
        return False
