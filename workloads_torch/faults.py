"""Deterministic fault injection at the serving engine's dispatch seams.

The PyTorch port's own copy of ``workloads/faults.py`` (the port imports
nothing of the JAX package); the two must stay identical in seams,
schedules and messages.  ``workloads_torch/serve.py`` crosses all six
engine seams (prefill, decode and spec, each at dispatch and readback);
``fleet.py``, ``supervisor.py`` and ``autoscaler.py`` cross the replica
seams, and ``durable.py`` the disk tier's and the journal's.

The reference device plugin's robustness story is driven by INJECTED
failure (its health loop is tested by synthesizing XID events, not by
breaking GPUs); this module is the serving engine's equivalent: a
seeded, replayable ``FaultInjector`` the engine consults at each named
seam — the host/device boundaries where a real XLA error, a pre-empted
chip, or a dead tunnel would surface — so the recovery machinery
(quarantine, replay, retry budgets: workloads/serve.py) is exercised by
tests and the chaos fuzz arm on any host, bit-reproducibly.

Seams (the engine calls ``injector.check(seam)`` immediately before the
corresponding device interaction):

  * ``prefill_dispatch`` / ``prefill_readback`` — the admission sweep
    (or serial per-request prefill) and its fused first-token readback.
    Under a ``prefill_budget`` the dispatch seam is crossed once per
    BUDGETED sweep (each step's ≤-budget chunk batch), so a fault can
    land with admissions parked mid-prefill across steps — the
    quarantine drops and replays them like occupied slots (pinned by
    tests/test_chunked_prefill.py and the chaos fuzz's budget arm).
  * ``decode_dispatch`` / ``decode_readback``  — the plain decode chunk
    and its token consume.
  * ``spec_dispatch``   / ``spec_readback``    — the speculative
    superstep and its (committed, n_accept) consume.

Fleet-scope REPLICA seams (``REPLICA_SEAMS``; crossed once per replica
step by ``workloads/fleet.py``, which treats a whole engine as one
fault domain):

  * ``replica_crash`` — the replica process/chip dies mid-step: the
    fleet marks it dead and fails its in-flight requests over to
    survivors (charged against their failover budgets).
  * ``replica_hang``  — the step wedges past the fleet's
    ``hang_timeout_s`` watchdog: same failover path, counted
    separately (a hang and a crash are different production symptoms).
  * ``replica_slow``  — a degraded link/readback: the step pays
    injected latency instead of dying; consecutive slow steps drive
    the router's auto-drain.
  * ``replica_respawn`` — crossed by the SUPERVISOR
    (``workloads/supervisor.py``) once per resurrection attempt,
    before the replacement engine is built: a fault here means the
    respawn dies on arrival (a bad chip slot, a wedged runtime — no
    engine is ever constructed for that attempt).
    Scheduling consecutive crossings (``crash_loop_schedule`` below)
    is the repeat-crash-on-restart scenario the crash-loop detector
    quarantines.
  * ``scale_spawn_fail`` — crossed by the AUTOSCALER
    (``workloads/autoscaler.py``) once per scale-UP spawn attempt,
    before the new engine is built: a fault here means elastic
    capacity cannot arrive (quota exhausted, scheduler refused the
    pod, a dead provisioning API), which is exactly the condition the
    degradation ladder (brownout, preemption-via-offload) exists to
    survive.  Chaos runs schedule it DURING step-load spikes so
    resizes race the ladder deterministically.

Two scheduling modes, both deterministic:

  * Explicit: ``FaultInjector({"decode_dispatch": [3]})`` raises
    ``InjectedFault`` on the 3rd crossing of that seam (1-based), and
    never again.  A crossing spec may be any iterable of ints —
    ``range(1, 6)`` schedules five consecutive crossings, the
    repeat-crash shape ``crash_loop_schedule`` packages.
  * Seeded random: ``FaultInjector.random(seed=7, rate=0.05)`` draws an
    independent Bernoulli per crossing from ``random.Random(seed)`` —
    the same seed over the same crossing sequence fires identically,
    so chaos-fuzz failures replay.

An injector with an empty schedule and rate 0 is ARMED BUT INERT: every
seam still calls ``check``, nothing ever raises — the configuration the
bench prices as ``fault_injector_off_overhead_pct`` and the parity test
pins as bit-identical to no injector at all.

Deliberately dependency-free (no jax, no numpy): importable by the
metrics lint, the Makefile self-check, and host-only tests.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

# Engine-internal dispatch/readback seams (ServeEngine's quarantine
# machinery recovers from these inside one fault domain).
ENGINE_SEAMS = (
    "prefill_dispatch",
    "prefill_readback",
    "decode_dispatch",
    "decode_readback",
    "spec_dispatch",
    "spec_readback",
)

# Replica-level seams (the Fleet's failover machinery recovers from
# these ACROSS fault domains; ``replica_respawn`` is the supervisor's
# resurrection seam, ``scale_spawn_fail`` the autoscaler's scale-up
# spawn seam — see module docstring).
REPLICA_SEAMS = (
    "replica_crash",
    "replica_hang",
    "replica_slow",
    "replica_respawn",
    "scale_spawn_fail",
)

# Durability seams (``DURABLE_SEAMS``; crossed by workloads/durable.py
# inside the disk tier's put/get and the session journal's write):
#
#   * ``kv_disk_write_fail``   — a host-tier page's demotion to disk
#     cannot land (ENOSPC, a dead volume): the blob STAYS in host RAM
#     and ordinary pressure handles it — durability degrades, streams
#     do not.
#   * ``kv_disk_read_corrupt`` — a disk page reads back damaged: the
#     checksum catches it, the file is quarantined, and the lookup's
#     prefix hit ends one page earlier (a re-prefill, never a wrong
#     byte).
#   * ``journal_torn_write``   — the process dies mid-checkpoint: the
#     current journal generation is a torn prefix and ``Fleet.restore``
#     falls back to the previous generation (at most one checkpoint
#     interval of progress re-paid as replay).
DURABLE_SEAMS = (
    "kv_disk_write_fail",
    "kv_disk_read_corrupt",
    "journal_torn_write",
)

SEAMS = ENGINE_SEAMS + REPLICA_SEAMS + DURABLE_SEAMS


def crash_loop_schedule(
    k: int, *, seam: str = "replica_respawn", first: int = 1,
) -> dict[str, list[int]]:
    """The repeat-crash-on-restart schedule: ``k`` CONSECUTIVE crossings
    of ``seam`` starting at crossing ``first`` (1-based) — every
    resurrection attempt in the window dies on arrival, which is
    exactly the pattern a supervisor's crash-loop detector exists to
    quarantine.  Returns a plain schedule dict, mergeable via
    ``FaultInjector.arm``."""
    if k < 1:
        raise ValueError(f"a crash loop needs k >= 1 crashes, got {k}")
    if first < 1:
        raise ValueError(f"crossings are 1-based, got first={first}")
    return {seam: list(range(first, first + k))}


def _validate_schedule(
    schedule: dict[str, int | list[int]] | None,
) -> dict[str, set[int]]:
    """Normalize a seam -> crossing(s) mapping to seam -> set of 1-based
    crossings, rejecting unknown seams and non-positive crossings — the
    single validation path for both the constructor and ``arm()``."""
    out: dict[str, set[int]] = {}
    for seam, when in (schedule or {}).items():
        if seam not in SEAMS:
            raise ValueError(
                f"unknown seam {seam!r}: injector seams are {SEAMS}"
            )
        hits = {when} if isinstance(when, int) else {int(w) for w in when}
        if any(h < 1 for h in hits):
            raise ValueError(
                f"crossings are 1-based, got {sorted(hits)} for {seam!r}"
            )
        out[seam] = hits
    return out


class InjectedFault(RuntimeError):
    """The synthetic seam failure.  Carries the seam name and the
    1-based crossing index it fired on, so a quarantine log (and the
    failed request's ``error`` string) pins exactly which dispatch
    died."""

    def __init__(self, seam: str, crossing: int):
        super().__init__(f"injected fault at {seam} (crossing {crossing})")
        self.seam = seam
        self.crossing = crossing


@dataclass
class FaultRecord:
    """One fired fault, in firing order (``injector.fired``)."""

    seam: str
    crossing: int


class FaultInjector:
    """Raise ``InjectedFault`` at named seams on a deterministic
    schedule.

    ``schedule`` maps seam name -> crossing number(s) (1-based, int or
    iterable of ints) at which the seam raises.  ``rate`` adds a seeded
    per-crossing Bernoulli on top (``seed`` defaults to 0); both can be
    combined.  ``max_fires`` bounds the TOTAL number of raises (the
    chaos arm uses it so a high rate cannot fail every retry forever).
    """

    def __init__(
        self,
        schedule: dict[str, int | list[int]] | None = None,
        *,
        seed: int = 0,
        rate: float = 0.0,
        seams: tuple[str, ...] = SEAMS,
        max_fires: int | None = None,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self._schedule = _validate_schedule(schedule)
        for seam in seams:
            if seam not in SEAMS:
                raise ValueError(
                    f"unknown seam {seam!r}: injector seams are {SEAMS}"
                )
        self._rate = float(rate)
        self._rate_seams = frozenset(seams)
        self._rng = random.Random(seed)
        self._seed = seed
        self._max_fires = max_fires
        self.crossings: dict[str, int] = {s: 0 for s in SEAMS}
        self.fired: list[FaultRecord] = []

    @classmethod
    def random(
        cls,
        seed: int,
        rate: float,
        *,
        seams: tuple[str, ...] = SEAMS,
        max_fires: int | None = None,
    ) -> "FaultInjector":
        """The chaos-fuzz constructor: seeded Bernoulli faults at
        ``rate`` per crossing of the given seams, at most ``max_fires``
        total."""
        return cls(None, seed=seed, rate=rate, seams=seams,
                   max_fires=max_fires)

    @property
    def total_fired(self) -> int:
        return len(self.fired)

    def check(self, seam: str) -> None:
        """Called by the engine immediately before the seam's device
        interaction; raises ``InjectedFault`` when the schedule says so.
        Crossing counters advance whether or not anything fires, so an
        inert injector observes exactly the traffic a firing one
        would."""
        if seam not in SEAMS:
            raise ValueError(
                f"unknown seam {seam!r}: injector seams are {SEAMS}"
            )
        self.crossings[seam] += 1
        n = self.crossings[seam]
        if self._max_fires is not None and len(self.fired) >= self._max_fires:
            return
        fire = n in self._schedule.get(seam, ())
        if not fire and self._rate > 0.0 and seam in self._rate_seams:
            # One RNG draw per rate-eligible crossing, schedule hit or
            # not, so the stream stays aligned with a pure-rate replay.
            fire = self._rng.random() < self._rate
        if fire:
            self.fired.append(FaultRecord(seam, n))
            raise InjectedFault(seam, n)

    def arm(self, schedule: dict[str, int | list[int]]) -> None:
        """Merge explicit schedule entries AFTER construction — paired
        with ``reset()`` this schedules crossings relative to a known
        point (the bench warms its compiles with the injector inert,
        then resets and arms the mid-stream fault)."""
        for seam, hits in _validate_schedule(schedule).items():
            self._schedule.setdefault(seam, set()).update(hits)

    def reset(self) -> None:
        """Back to the constructed state: crossing counters zeroed, the
        seeded RNG re-seeded — ``check`` replays the identical firing
        sequence."""
        self.crossings = {s: 0 for s in SEAMS}
        self.fired = []
        self._rng = random.Random(self._seed)


def self_check(verbose: bool = True) -> int:
    """The ``make faults-check`` tripwire: the injector's determinism
    and scheduling contracts, jax-free and sub-second.  Returns 0 on
    success, raises AssertionError otherwise."""
    # Explicit schedules fire exactly on their crossings, once.
    inj = FaultInjector({"decode_dispatch": [2, 4], "spec_readback": 1})
    pattern = []
    for i in range(1, 6):
        try:
            inj.check("decode_dispatch")
            pattern.append(False)
        except InjectedFault as e:
            assert (e.seam, e.crossing) == ("decode_dispatch", i)
            pattern.append(True)
    assert pattern == [False, True, False, True, False], pattern
    try:
        inj.check("spec_readback")
        raise AssertionError("scheduled spec_readback crossing did not fire")
    except InjectedFault:
        pass
    assert [
        (r.seam, r.crossing) for r in inj.fired
    ] == [("decode_dispatch", 2), ("decode_dispatch", 4), ("spec_readback", 1)]

    # Replica seams are first-class: scheduled crossings fire, and a
    # seams= restriction keeps Bernoulli draws off the engine seams (the
    # fleet's chaos arm relies on both).
    rinj = FaultInjector({"replica_crash": 2, "replica_slow": 1})
    rinj.check("replica_crash")
    try:
        rinj.check("replica_slow")
        raise AssertionError("scheduled replica_slow crossing did not fire")
    except InjectedFault as e:
        assert (e.seam, e.crossing) == ("replica_slow", 1)
    try:
        rinj.check("replica_crash")
        raise AssertionError("scheduled replica_crash crossing did not fire")
    except InjectedFault as e:
        assert (e.seam, e.crossing) == ("replica_crash", 2)
    scoped = FaultInjector.random(seed=5, rate=1.0, seams=REPLICA_SEAMS)
    scoped.check("decode_dispatch")  # rate must not apply off-scope
    try:
        scoped.check("replica_hang")
        raise AssertionError("rate=1.0 replica seam did not fire")
    except InjectedFault:
        pass

    # Durability seams are first-class: scheduled crossings fire (the
    # disk tier / journal degrade paths), and a DURABLE_SEAMS-scoped
    # Bernoulli injector leaves engine and replica seams alone — the
    # kill-and-restart chaos arm relies on both.
    dinj = FaultInjector({
        "kv_disk_write_fail": 1, "kv_disk_read_corrupt": 2,
        "journal_torn_write": 1,
    })
    for seam in DURABLE_SEAMS:
        fired_now = 0
        for _ in range(2):
            try:
                dinj.check(seam)
            except InjectedFault as e:
                assert e.seam == seam
                fired_now += 1
        assert fired_now == 1, (seam, fired_now)
    dscoped = FaultInjector.random(seed=7, rate=1.0, seams=DURABLE_SEAMS)
    dscoped.check("decode_dispatch")
    dscoped.check("replica_crash")
    try:
        dscoped.check("kv_disk_write_fail")
        raise AssertionError("rate=1.0 durable seam did not fire")
    except InjectedFault:
        pass

    # The supervisor's repeat-crash-on-restart shape: k consecutive
    # respawn crossings fire, the (k+1)th succeeds — the half-open
    # probe after a quarantine clear rides exactly that crossing.
    loop = FaultInjector(crash_loop_schedule(3))
    fired = 0
    for _ in range(5):
        try:
            loop.check("replica_respawn")
        except InjectedFault as e:
            assert e.seam == "replica_respawn"
            fired += 1
    assert fired == 3, fired
    offset = crash_loop_schedule(2, first=4)
    assert offset == {"replica_respawn": [4, 5]}, offset
    # The autoscaler's scale-up spawn seam is first-class: scheduled
    # crossings fire (capacity "cannot arrive"), later crossings pass
    # (the retry after backoff succeeds).
    spawn = FaultInjector({"scale_spawn_fail": [1, 2]})
    spawn_fired = 0
    for _ in range(3):
        try:
            spawn.check("scale_spawn_fail")
        except InjectedFault as e:
            assert e.seam == "scale_spawn_fail"
            spawn_fired += 1
    assert spawn_fired == 2, spawn_fired
    for bad_loop in (
        lambda: crash_loop_schedule(0),
        lambda: crash_loop_schedule(1, first=0),
    ):
        try:
            bad_loop()
            raise AssertionError("bad crash_loop_schedule was accepted")
        except ValueError:
            pass

    # Seeded randomness replays bit-identically, and reset() replays it.
    def drive(injector, n=200):
        out = []
        for i in range(n):
            seam = SEAMS[i % len(SEAMS)]
            try:
                injector.check(seam)
                out.append(None)
            except InjectedFault as e:
                out.append((e.seam, e.crossing))
        return out

    a = drive(FaultInjector.random(seed=11, rate=0.1))
    b = drive(FaultInjector.random(seed=11, rate=0.1))
    assert a == b, "same seed must fire identically"
    assert any(x is not None for x in a), "rate 0.1 over 200 crossings fired nothing"
    assert a != drive(FaultInjector.random(seed=12, rate=0.1)), (
        "different seeds should (overwhelmingly) differ"
    )
    inj2 = FaultInjector.random(seed=11, rate=0.1)
    first = drive(inj2)
    inj2.reset()
    assert drive(inj2) == first, "reset() must replay the firing sequence"

    # max_fires bounds total raises; an inert injector never raises.
    capped = FaultInjector.random(seed=3, rate=1.0, max_fires=2)
    assert sum(x is not None for x in drive(capped, 50)) == 2
    assert all(x is None for x in drive(FaultInjector(), 100))

    # Bad configurations fail loudly at construction / call time.
    for bad in (
        lambda: FaultInjector({"not_a_seam": 1}),
        lambda: FaultInjector({"decode_dispatch": 0}),
        lambda: FaultInjector(rate=1.5),
        lambda: FaultInjector().check("nope"),
        lambda: FaultInjector().arm({"not_a_seam": 1}),
        lambda: FaultInjector().arm({"decode_dispatch": 0}),
    ):
        try:
            bad()
            raise AssertionError("bad injector config was accepted")
        except (ValueError, AssertionError) as e:
            if isinstance(e, AssertionError):
                raise
    if verbose:
        print("faults selfcheck OK: schedule, replica seams, durable "
              "seams, crash-loop schedules, spawn seam, seeded replay, "
              "reset, max_fires, inert, validation")
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--selfcheck", action="store_true",
                        help="run the injector contract checks and exit")
    args = parser.parse_args(argv)
    if args.selfcheck:
        return self_check()
    parser.error("nothing to do: pass --selfcheck")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
