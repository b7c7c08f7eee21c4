"""Goodput-optimal control plane: ledger-driven online retuning.

PR 15's chip-time ledger made every charged second ATTRIBUTABLE (phase
taxonomy, goodput-vs-waste token classes, per-SLO-class roll-ups) and
PR 17 made KV pages the schedulable unit — but nothing in the fleet
ACTED on the measurements: spec/superstep knobs froze at startup
calibration, WFQ weights were static operator inputs, the autoscaler
ignored waste, and preemption victims were picked without regard to
what they'd throw away.  ``GoodputController`` closes that loop — the
serving-layer mirror of the reference plugin's ``replicas = -1`` auto
mode (PAPER.md §0.5: the advertised resource re-sizes itself to live
capacity once per discovery pass), applied here to chip-TIME instead of
chip-count.

One controller watches one ``Fleet`` (or a bare ``ServeEngine``).  Each
``poll()`` reads the armed ledger's running totals, EWMA-smooths the
newly-accounted delta's goodput / spec-rejected / overdecode shares,
and actuates through four existing seams:

  * **Online speculation retune** — ``ServeEngine.retune()`` shifts
    ``spec_breakeven`` and steps ``superstep_k`` /
    ``spec_superstep_k`` between dispatches from the observed
    ``spec_rejected`` / ``overdecode`` burn.  The engine drains every
    in-flight pipelined chunk, speculative round and superstep through
    the existing ``_drain_pending_*`` mode-boundary rules before a
    knob mutates, so greedy streams are bit-identical across every
    transition (pinned by tests/test_control.py).  Hill-climb with
    hysteresis: one knob move per cooldown, the cooldown escalating
    through the shared ``workloads.backoff`` policy while moves keep
    landing and resetting once the signal reaches the dead band —
    an oscillating signal slows itself down instead of thrashing.
  * **WFQ re-weighting** — ``Fleet.wfq_weights`` updates live from
    ``FleetLedger.class_economics()``'s measured per-class
    goodput-per-chip-second, so classes that waste chip-time stop
    buying dispatch credit.  Operator weights remain the FLOOR (a
    class is only ever boosted above its configured weight, capped at
    ``wfq_max_boost``); ``parked_classes`` stays the hard backstop.
  * **Waste-budget autoscaling** — the controller feeds its smoothed
    waste fraction to ``FleetAutoscaler.waste_fraction_hint``; with
    ``waste_budget=`` set the autoscaler HOLDS scale-ups while
    measured waste exceeds the budget (more replicas multiply waste —
    the ladder and the retunes attack it instead) and relaxes the
    scale-down streak while waste sits comfortably inside it (goodput
    headroom means capacity above the floor is pure
    ``autoscale_overprovision_chip_s``).
  * **Preemption victim scoring** — the PR-13 ladder's preempt step
    (``FleetAutoscaler._preempt_some``) walks
    ``Fleet.preempt_candidates``: ascending goodput-per-retained-page
    from the fleet's delivered-token counts and the page pool's
    refcounts (``ServeEngine.retained_pages`` — RadixKV/fork-shared
    pages count 1/refcount), so the stream that frees the most pages
    per token thrown away parks first.

The controller is cooperative and deterministic like the supervisor
and the autoscaler: ``poll()`` runs after each step (or use ``step()``
/ ``run()`` / ``serve_forever``, which wrap whatever driver it was
given — fleet, supervisor or autoscaler), takes no threads of its own,
and every actuation lands on the event ring the merged fleet trace
renders on the supervisor lane, plus the registry via
``ControlObserver`` (CONTROL_METRICS, docs/OBSERVABILITY.md).

Inert by default: without a controller nothing changes (``control``
stays opt-in everywhere), and an attached controller actuates nothing
until an armed ledger has accounted a measurable delta — token streams
are bit-identical controller on/off either way for greedy decoding
(every retune drains first; pinned by the fuzz arms and the
``measure_goodput_ctrl`` bench arm, which prices the poll tax as
``ctrl_overhead_pct``).

The PyTorch port's own copy of ``workloads/control.py`` (the port
imports nothing of the JAX package); tests/test_torch_copies.py holds
every definition to it.  It retunes replicas through the port's
``ServeEngine.retune``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from .backoff import Backoff
from .errors import EngineClosed
from .obs import SupervisorEvent


@dataclass(frozen=True)
class ControlSignals:
    """One poll's view of the ledger-derived control inputs.  The
    fractions are EWMA-smoothed over per-poll accounted deltas and
    ``None`` until the first delta of at least ``min_sample_tokens``
    lands (no evidence — never an actuation on its own)."""

    accounted_tokens: int
    delta_tokens: int
    goodput_fraction: float | None
    spec_rejected_fraction: float | None
    overdecode_fraction: float | None


class GoodputController:
    """Close the chip-time loop: poll the armed ledger, retune the
    engines' speculation knobs, re-weight WFQ, hint the autoscaler's
    waste budget, all through existing seams (module docstring).

    ``target`` is a ``Fleet`` (its ``FleetLedger`` supplies the
    signals and per-class economics) or a bare ``ServeEngine`` (its
    ``ChipTimeLedger`` supplies engine-local signals; the WFQ seam is
    then moot).  ``driver`` is what ``step()`` steps — defaults to
    ``autoscaler`` when given (heal → scale → retune layering), else
    the target itself."""

    def __init__(
        self,
        target,
        *,
        autoscaler=None,
        driver=None,
        ewma_alpha: float = 0.3,
        min_sample_tokens: int = 64,
        spec_reject_high: float = 0.3,
        spec_reject_low: float = 0.05,
        overdecode_high: float = 0.3,
        overdecode_low: float = 0.05,
        breakeven_step: float = 1.0,
        wfq_max_boost: float = 4.0,
        wfq_deadband: float = 0.25,
        retune_backoff: Backoff | None = None,
        wfq_backoff: Backoff | None = None,
        observer=None,
        clock=time.perf_counter,
    ):
        if not hasattr(target, "step"):
            raise ValueError(
                "target must be a Fleet or ServeEngine (needs .step())"
            )
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}"
            )
        if min_sample_tokens < 1:
            raise ValueError(
                f"min_sample_tokens must be >= 1, got {min_sample_tokens}"
            )
        for name, low, high in (
            ("spec_reject", spec_reject_low, spec_reject_high),
            ("overdecode", overdecode_low, overdecode_high),
        ):
            if not 0.0 <= low < high <= 1.0:
                raise ValueError(
                    f"{name} thresholds need 0 <= low < high <= 1 (the "
                    f"dead band between them is the hysteresis), got "
                    f"low={low} high={high}"
                )
        if breakeven_step <= 0:
            raise ValueError(
                f"breakeven_step must be > 0, got {breakeven_step}"
            )
        if wfq_max_boost < 1.0:
            raise ValueError(
                f"wfq_max_boost must be >= 1 (operator weights are the "
                f"floor; boosts only go up), got {wfq_max_boost}"
            )
        if wfq_deadband < 0.0:
            raise ValueError(
                f"wfq_deadband must be >= 0, got {wfq_deadband}"
            )
        self.target = target
        self.fleet = target if hasattr(target, "replicas") else None
        self.engine = None if self.fleet is not None else target
        self.autoscaler = autoscaler
        self.driver = (
            driver if driver is not None
            else (autoscaler if autoscaler is not None else target)
        )
        self.ewma_alpha = float(ewma_alpha)
        self.min_sample_tokens = int(min_sample_tokens)
        self.spec_reject_high = float(spec_reject_high)
        self.spec_reject_low = float(spec_reject_low)
        self.overdecode_high = float(overdecode_high)
        self.overdecode_low = float(overdecode_low)
        self.breakeven_step = float(breakeven_step)
        self.wfq_max_boost = float(wfq_max_boost)
        self.wfq_deadband = float(wfq_deadband)
        # Hysteresis from the shared backoff policy: the retune gate
        # escalates while moves keep landing (an oscillating signal
        # slows itself down) and resets at the dead band; the WFQ gate
        # spaces re-weights the same way.
        self._retune = (
            retune_backoff if retune_backoff is not None
            else Backoff(base_s=0.25, max_s=8.0)
        ).derive("retune")
        self._wfq = (
            wfq_backoff if wfq_backoff is not None
            else Backoff(base_s=1.0, max_s=30.0)
        ).derive("wfq")
        self._clock = clock
        # Operator WFQ weights ARE the floor: captured before the first
        # re-weight ever mutates them (lazily, so a fleet that arms WFQ
        # after controller construction still records its own floor).
        self._wfq_floor: dict | None = (
            dict(self.fleet.wfq_weights)
            if self.fleet is not None
            and getattr(self.fleet, "wfq_weights", None) is not None
            else None
        )
        # Control state.
        self._seen: dict[str, int] = {}
        self._ewma: dict[str, float] = {}
        self._retune_gate = float("-inf")
        self._wfq_gate = float("-inf")
        self._retune_streak = 0
        self._wfq_streak = 0
        # Telemetry (mirrored to the registry by ControlObserver).
        self.polls = 0
        self.poll_s = 0.0  # wall seconds spent inside poll(): the tax
        self.samples = 0
        self.retunes_applied = 0
        self.wfq_reweights = 0
        self.decisions: dict[str, int] = {}
        self.last_signals: ControlSignals | None = None
        # The control timeline: one SupervisorEvent per actuation, on
        # the merged fleet trace's supervisor lane next to the heal and
        # scale events.
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
    def goodput_fraction_ewma(self) -> float | None:
        return self._ewma.get("goodput")

    @property
    def spec_rejected_fraction_ewma(self) -> float | None:
        return self._ewma.get("spec_rejected")

    @property
    def overdecode_fraction_ewma(self) -> float | None:
        return self._ewma.get("overdecode")

    def states(self) -> dict:
        """The /healthz introspection blob: where the control loop is
        right now."""
        return {
            "polls": self.polls,
            "poll_s": round(self.poll_s, 6),
            "samples": self.samples,
            "retunes_applied": self.retunes_applied,
            "wfq_reweights": self.wfq_reweights,
            "goodput_fraction_ewma": self.goodput_fraction_ewma,
            "spec_rejected_fraction_ewma":
                self.spec_rejected_fraction_ewma,
            "overdecode_fraction_ewma": self.overdecode_fraction_ewma,
            "wfq_floor": (
                dict(self._wfq_floor)
                if self._wfq_floor is not None else None
            ),
            "decisions": dict(self.decisions),
        }

    # ---- signal plumbing -------------------------------------------------

    def _ledger(self):
        obj = self.fleet if self.fleet is not None else self.engine
        return getattr(obj, "ledger", None)

    def _engines(self) -> list[tuple[str, object]]:
        if self.fleet is not None:
            return [
                (str(rep.index), rep.engine)
                for rep in self.fleet.replicas
                if rep.state != "dead"
            ]
        return [("0", self.engine)]

    @staticmethod
    def _totals(led) -> dict[str, int]:
        """Cumulative accounted/goodput/waste token totals, shape-
        agnostic across ``FleetLedger`` (fleet target) and
        ``ChipTimeLedger`` (bare engine target)."""
        if hasattr(led, "engine_ledgers"):  # FleetLedger
            # Running counters only — no snapshot materialization on
            # the per-step poll path (the controller's steady-state tax
            # is priced by the bench's ctrl_overhead_pct).
            sr = od = 0
            for _, el in led.engine_ledgers:
                w = el.waste_tokens
                sr += int(w.get("spec_rejected", 0))
                od += int(w.get("overdecode", 0))
            return {
                "accounted": int(led.tokens_accounted),
                "goodput": int(led.goodput_tokens),
                "spec_rejected": sr,
                "overdecode": od,
            }
        w = led.waste_tokens
        return {
            "accounted": int(led.tokens_accounted),
            "goodput": int(led.goodput_tokens),
            "spec_rejected": int(w.get("spec_rejected", 0)),
            "overdecode": int(w.get("overdecode", 0)),
        }

    def _update_ewma(self, key: str, value: float) -> None:
        prev = self._ewma.get(key)
        a = self.ewma_alpha
        self._ewma[key] = (
            value if prev is None else prev + a * (value - prev)
        )

    # ---- actuation: speculation retune -----------------------------------

    def _pick_move(self) -> str | None:
        """The hill-climb direction at the current EWMAs, dead-band
        gated: down-moves (waste above the high threshold) win over
        up-moves (waste below the low threshold — step back toward the
        construction-time ceilings to recapture the win); between the
        thresholds, hold.  Moves with no capable engine are never
        picked (a draftless fleet has no speculation to retune)."""
        engines = [e for _, e in self._engines()]
        if not engines:
            return None
        spec_capable = any(
            getattr(e, "draft_params", None) is not None for e in engines
        )
        super_capable = any(
            getattr(e, "_superstep_k_max", getattr(e, "superstep_k", 1))
            > 1
            or getattr(
                e, "_spec_superstep_k_max",
                getattr(e, "spec_superstep_k", 1),
            ) > 1
            for e in engines
        )
        sr = self._ewma.get("spec_rejected")
        od = self._ewma.get("overdecode")
        if spec_capable and sr is not None and sr > self.spec_reject_high:
            return "spec_down"
        if super_capable and od is not None and od > self.overdecode_high:
            return "super_down"
        if spec_capable and sr is not None and sr < self.spec_reject_low:
            return "spec_up"
        if super_capable and od is not None and od < self.overdecode_low:
            return "super_up"
        return None

    def _apply_move(self, move: str, eng) -> dict:
        """One knob move on one engine via ``ServeEngine.retune()``
        (which drains in-flight state first).  Returns retune()'s
        ``{knob: (old, new)}``, empty when the move has nothing left
        to do on this engine."""
        auto = (
            getattr(eng, "spec", None) == "auto"
            and getattr(eng, "draft_params", None) is not None
        )
        breakeven = getattr(eng, "spec_breakeven", None)
        k_sup = getattr(eng, "superstep_k", 1)
        k_spec = getattr(eng, "spec_superstep_k", 1)
        kmax_sup = getattr(eng, "_superstep_k_max", k_sup)
        kmax_spec = getattr(eng, "_spec_superstep_k_max", k_spec)
        if move == "spec_down":
            # Less speculation: lower the auto-mode threshold first
            # (the cheapest lever), then shrink the fused spec rounds.
            if auto and breakeven is not None and float(breakeven) > 0:
                return eng.retune(spec_breakeven=max(
                    0.0, float(breakeven) - self.breakeven_step
                ))
            if k_spec > 1:
                return eng.retune(spec_superstep_k=max(1, k_spec // 2))
            return {}
        if move == "spec_up":
            if k_spec < kmax_spec:
                return eng.retune(spec_superstep_k=min(
                    kmax_spec, max(2, k_spec * 2)
                ))
            if auto and breakeven is not None and (
                float(breakeven) < float(getattr(eng, "slots", 1))
            ):
                return eng.retune(spec_breakeven=min(
                    float(getattr(eng, "slots", 1)),
                    float(breakeven) + self.breakeven_step,
                ))
            return {}
        if move == "super_down":
            # Overdecode is chained chunks burned past retirement —
            # shrink whichever superstep family is fused.
            if k_sup > 1:
                return eng.retune(superstep_k=max(1, k_sup // 2))
            if k_spec > 1:
                return eng.retune(spec_superstep_k=max(1, k_spec // 2))
            return {}
        if move == "super_up":
            if k_sup < kmax_sup:
                return eng.retune(superstep_k=min(
                    kmax_sup, max(2, k_sup * 2)
                ))
            return {}
        return {}

    def _maybe_retune(self, now: float) -> None:
        if now < self._retune_gate:
            return
        move = self._pick_move()
        if move is None:
            # Dead band: the signal converged — reset the escalation so
            # the next genuine excursion acts at base cadence.
            self._retune_streak = 0
            return
        applied: list[str] = []
        for label, eng in self._engines():
            if getattr(eng, "closed", False):
                continue
            try:
                changes = self._apply_move(move, eng)
            except (ValueError, EngineClosed):
                continue  # knob not applicable on this engine's shape
            if changes:
                self.retunes_applied += 1
                applied.append(
                    f"{label}:"
                    + ",".join(
                        f"{k}{old}->{new}"
                        for k, (old, new) in sorted(changes.items())
                    )
                )
        if not applied:
            return  # nothing actionable; re-evaluate next poll
        self._decide("retune")
        self._retune_streak += 1
        self._retune_gate = now + self._retune.delay(
            min(self._retune_streak, 8)
        )
        self._event("retune", "", f"{move} " + "; ".join(applied), t=now)

    # ---- actuation: WFQ re-weighting -------------------------------------

    def _maybe_reweight(self, now: float) -> None:
        fleet = self.fleet
        if fleet is None:
            return
        weights = getattr(fleet, "wfq_weights", None)
        if weights is None:
            return
        led = self._ledger()
        if led is None or not hasattr(led, "class_economics"):
            return
        if now < self._wfq_gate:
            return
        # class_economics() materializes a snapshot — every pass
        # through here (actuating or not) re-arms the gate so the
        # computation runs at the backoff cadence, never per step.
        self._wfq_gate = now + self._wfq.delay(0)
        econ = led.class_economics()
        rates = {
            cls: e["goodput_per_chip_s"]
            for cls, e in econ.items() if e["chip_s"] > 0
        }
        if len(rates) < 2:
            self._wfq_streak = 0
            return  # relative ranking needs at least two measured classes
        mean = sum(rates.values()) / len(rates)
        if mean <= 0:
            self._wfq_streak = 0
            return
        if self._wfq_floor is None:
            self._wfq_floor = dict(weights)
        changed: dict[str, tuple[float, float]] = {}
        for cls, rate in rates.items():
            floor = float(self._wfq_floor.get(cls, 1.0))
            # Boost-above-floor only: an efficient class earns up to
            # wfq_max_boost x its operator weight; a wasteful class
            # holds at its floor — RELATIVE credit shifts away from it
            # without ever starving it below what the operator set
            # (parked_classes stays the hard backstop).
            mult = max(1.0, min(self.wfq_max_boost, rate / mean))
            new = round(floor * mult, 4)
            old = float(weights.get(cls, floor))
            if old > 0 and abs(new - old) / old > self.wfq_deadband:
                changed[cls] = (old, new)
        if not changed:
            self._wfq_streak = 0
            return
        for cls, (_, new) in changed.items():
            weights[cls] = new
        self.wfq_reweights += 1
        self._decide("wfq_reweight")
        self._wfq_streak += 1
        self._wfq_gate = now + self._wfq.delay(min(self._wfq_streak, 8))
        self._event(
            "wfq_reweight", "",
            "; ".join(
                f"{cls}:{old:g}->{new:g}"
                for cls, (old, new) in sorted(changed.items())
            ),
            t=now,
        )

    # ---- the control loop ------------------------------------------------

    def poll(self, now: float | None = None) -> None:
        """One control pass: read the ledger's newly-accounted delta,
        EWMA the waste shares, hint the autoscaler's waste budget, then
        retune / re-weight as the signal demands.  Call after each
        step (or use ``step()``/``run()``, which do).  A no-op without
        an armed ledger — the controller never actuates on zero
        evidence."""
        if self.closed:
            return
        t_tax = time.perf_counter()  # real clock: poll_s meters the
        now = self._clock() if now is None else now  # actual tax even
        self.polls += 1  # when gating runs on an injected clock
        led = self._ledger()
        if led is None:
            if self._obs is not None:
                self._obs._control_poll_end(self)
            self.poll_s += time.perf_counter() - t_tax
            return
        tot = self._totals(led)
        d_acc = max(0, tot["accounted"] - self._seen.get("accounted", 0))
        d_good = max(0, tot["goodput"] - self._seen.get("goodput", 0))
        d_sr = max(
            0, tot["spec_rejected"] - self._seen.get("spec_rejected", 0)
        )
        d_od = max(
            0, tot["overdecode"] - self._seen.get("overdecode", 0)
        )
        if d_acc >= self.min_sample_tokens:
            self._seen = tot
            self._update_ewma("goodput", d_good / d_acc)
            self._update_ewma("spec_rejected", d_sr / d_acc)
            self._update_ewma("overdecode", d_od / d_acc)
            self.samples += 1
        self.last_signals = ControlSignals(
            accounted_tokens=tot["accounted"],
            delta_tokens=d_acc,
            goodput_fraction=self.goodput_fraction_ewma,
            spec_rejected_fraction=self.spec_rejected_fraction_ewma,
            overdecode_fraction=self.overdecode_fraction_ewma,
        )
        if (
            self.autoscaler is not None
            and self.goodput_fraction_ewma is not None
        ):
            # Seam 3: the autoscaler's waste-budget SLO reads the
            # smoothed view instead of the instantaneous ledger read.
            self.autoscaler.waste_fraction_hint = max(
                0.0, min(1.0, 1.0 - self.goodput_fraction_ewma)
            )
        if self.samples:
            self._maybe_retune(now)
            self._maybe_reweight(now)
        if self._obs is not None:
            self._obs._control_poll_end(self)
        self.poll_s += time.perf_counter() - t_tax

    # ---- fleet-shaped driving surface ------------------------------------
    # Duck-typed to the Fleet/Supervisor/Autoscaler loop API so
    # drive_open_loop and the serve CLI can run CONTROLLED by passing
    # the controller where a fleet goes.

    def submit(self, *args, **kwargs):
        return self.driver.submit(*args, **kwargs)

    def cancel(self, rid: str) -> bool:
        return self.driver.cancel(rid)

    @property
    def idle(self) -> bool:
        return self.driver.idle

    @property
    def closed(self) -> bool:
        return self.driver.closed

    def step(self):
        """One controlled iteration: step the wrapped driver (fleet,
        supervisor or autoscaler — heal and scale before retune), then
        run the control pass."""
        finished = self.driver.step()
        self.poll()
        return finished

    def _parked(self) -> bool:
        fn = getattr(self.driver, "_parked", None)
        if callable(fn):
            return bool(fn())
        return False

    def run(self) -> dict[str, list[int]]:
        """Drive to idle (the fleet.run contract) with the control
        loop running between steps."""
        out: dict[str, list[int]] = {}
        while not self.driver.idle:
            for fr in self.step():
                out[fr.rid] = list(fr.tokens)
            if self._parked():
                time.sleep(0.001)
        return out

    def serve_forever(self, stop_event) -> None:
        """The controlled front-end driver loop: only the fleet step
        runs under the lock; heal/scale polls and the control pass run
        OUTSIDE it (a retune drains pipelined state and a scale-up may
        compile — HTTP handlers must keep submitting throughout)."""
        from .supervisor import drive_forever

        fleet = self.fleet
        if fleet is None:
            raise ValueError(
                "serve_forever needs a fleet-backed controller (a bare "
                "engine has no front-end driver loop)"
            )
        drv = self.driver

        def step_fn():
            finished = fleet.step()
            note = getattr(drv, "note_finished", None)
            if note is not None:
                note(finished)

        def poll_fn():
            sup = getattr(drv, "supervisor", None)
            if sup is not None:
                sup.poll()
            if drv is not fleet:
                drv.poll()
            self.poll()

        parked_fn = getattr(drv, "_parked", None)
        if parked_fn is None:
            def parked_fn():
                return (
                    not any(r.dispatchable for r in fleet.alive)
                    and bool(fleet.alive)
                )

        drive_forever(
            fleet, stop_event,
            step_fn=step_fn, poll_fn=poll_fn, parked_fn=parked_fn,
        )

    def wait_quiescent(self, timeout_s: float = 30.0) -> bool:
        """Delegate to the wrapped driver's quiescence wait when it has
        one (the autoscaler's scale-back-down convergence), else step
        to idle."""
        fn = getattr(self.driver, "wait_quiescent", None)
        if fn is not None:
            return bool(fn(timeout_s))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.step()
            if self.driver.idle:
                return True
            time.sleep(0.001)
        return False
