"""The port's fleet and control plane (workloads_torch.fleet, supervisor,
autoscaler, control, ledger, durable's journal) held to frozen JAX runs
on the CPU.

Scripted, float32, greedy runs on the tiny config of
tests/test_torch_schedule.py (GQA with a window; the JAX tree's bits
from tests/test_torch_golden.npz), each run once on the JAX package
(``python tests/test_torch_parity.py --write-goldens`` writes
tests/test_torch_fleet_golden.npz with ``write_fleet_goldens()``) and
here on the port, through the same ``run_fleet_scenario`` with the
package's modules passed in.  Held: every stream, terminal status, the
replica that served each attempt, failovers, the fleet's counters
(``tokens_replayed`` among them), the supervisor's and autoscaler's
event kinds in order and the journal's record digests.  Not held: wall
clock values.  The supervisor, autoscaler and controller run on a
stepped fake clock; ``hang_timeout_s`` is None (an injected hang is a
seam, not a watchdog reading).

One more check crosses the engines: a journal directory the JAX fleet
wrote (its bytes are in the golden) restores into the port's fleet and
continues each stream to JAX's tokens.  The writer checks the other
direction live.

torch, numpy, the port and the jax-free daemon modules only, so it runs
in the fast tier.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import types

import numpy as np
import pytest
import torch

from tests.test_torch_golden import tiny_config
from tests.test_torch_schedule import SCHEDULE_CASE, _params, golden  # noqa: F401
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import (
    autoscaler, backoff, control, durable, errors, faults, fleet, ledger, obs, supervisor,
)
from workloads_torch.serve import ServeEngine

FLEET_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "test_torch_fleet_golden.npz")
FLEET_CASE = SCHEDULE_CASE
FLEET_KW = dict(slots=2, page_size=4, prompt_bucket=8, chunk=4)
# The fleet's counters held after every scenario.
FLEET_COUNTERS = (
    "requests_ok", "queue_rejections", "replica_crashes", "replica_hangs",
    "failover_requeues", "drain_requeues", "tokens_replayed", "kv_handoffs",
    "handoff_pages", "replicas_added", "replicas_removed",
)
STATUS_PAD = 40  # tokens a stream row holds (max_new stays below)


def port_package():
    """The port's modules under the names ``run_fleet_scenario`` uses."""
    return types.SimpleNamespace(
        autoscaler=autoscaler, backoff=backoff, control=control, durable=durable,
        errors=errors, faults=faults, fleet=fleet, ledger=ledger, obs=obs,
        supervisor=supervisor,
    )


class StepClock:
    """A fake clock that moves ``dt`` seconds at every reading."""

    def __init__(self, dt: float):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def fleet_prompts(seed: int, n: int, lo: int = 3, hi: int = 20, new_lo: int = 3,
                  new_hi: int = 12):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(lo, hi)))],
             int(rng.integers(new_lo, new_hi))) for _ in range(n)]


def _ev(chip_id: str, health: str):
    # The daemon's HealthEvent carries these two fields; a namespace
    # keeps gRPC (which tpu_device_plugin.device loads) out of the run.
    return types.SimpleNamespace(chip_id=chip_id, health=health)


class _Run:
    """What one scenario records: rids in submission order, rejected
    rids, scripted actions by fleet step, event kinds, digests and extra
    counters."""

    def __init__(self):
        self.rids: list[str] = []
        self.rejected: set[str] = set()
        self.script: dict[int, list] = {}
        self.events: list[str] = []
        self.digests: list[str] = []
        self.extra: dict[str, int] = {}
        self.steps = 0

    def submit(self, fl, pkg, prompt, new, **kw):
        rid = kw.pop("rid", None) or f"req-{len(self.rids)}"
        try:
            fl.submit(prompt, new, rid=rid, **kw)
        except pkg.errors.QueueFull:
            self.rejected.add(rid)
        self.rids.append(rid)
        return rid

    def drive(self, target, fl, limit: int = 600):
        """Step ``target`` (the fleet or a controller over it) until the
        fleet is idle, running scripted actions before each step."""
        while not fl.idle or self.script.get(self.steps + 1):
            self.steps += 1
            assert self.steps < limit, fl.states()
            for action in self.script.pop(self.steps, []):
                action(fl)
            target.step()


def _result(fl, run: _Run) -> dict:
    n = len(run.rids)
    tokens = np.full((n, STATUS_PAD), -1, np.int64)
    attempts = np.full((n, 8), -1, np.int64)
    failovers = np.zeros(n, np.int64)
    statuses = []
    for i, rid in enumerate(run.rids):
        if rid in run.rejected:
            statuses.append("rejected")
            continue
        fr = fl._reqs[rid]
        tokens[i, : len(fr.tokens)] = fr.tokens
        attempts[i, : len(fr.attempts)] = [a.replica for a in fr.attempts]
        failovers[i] = fr.failovers
        statuses.append(fr.status)
    counters = [getattr(fl, name) for name in FLEET_COUNTERS]
    counters += [fl.router.dispatches, fl.router.affinity_hits]
    counters += [v for _, v in sorted(run.extra.items())]
    return {
        "tokens": tokens, "statuses": np.asarray(statuses), "attempts": attempts,
        "failovers": failovers, "counters": np.asarray(counters, np.int64),
        "counter_names": np.asarray(list(FLEET_COUNTERS) + ["dispatches", "affinity_hits"]
                                    + sorted(run.extra)),
        "events": np.asarray(run.events or [""]),
        "digests": np.asarray(run.digests or [""]),
    }


def _leak_free(fl, pkg) -> None:
    for rep in fl.replicas:
        if rep.state == pkg.fleet.DEAD:
            continue
        e = rep.engine
        pinned = e.prefix.cached_pages if e.prefix is not None else 0
        assert not e._occupied.any() and e._committed_pages == 0, rep.index
        assert e.ctrl.used_pages == pinned and not rep.rids, rep.index


def _journal_digest(directory: str) -> str:
    import json

    with open(os.path.join(directory, "journal.json"), encoding="utf-8") as f:
        return json.load(f)["checksum"]


def run_fleet_scenario(pkg, make_engine, scenario: str, workdir: str | None = None) -> dict:
    """One scripted fleet run on either package (``pkg`` holds its
    modules, ``make_engine(**kw)`` builds its engine); returns the arrays
    the golden holds.  ``workdir`` keeps the journal scenario's files
    (the cross-engine check reads them)."""
    run = _Run()
    F = pkg.fleet
    owned = None
    if workdir is None:
        owned = tempfile.TemporaryDirectory()
        workdir = owned.name

    def mk_fleet(n, engine_kw=None, **kw):
        kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
        kw.setdefault("hang_timeout_s", None)
        return F.Fleet([make_engine(**(engine_kw or {})) for _ in range(n)], **kw)

    try:
        if scenario == "route":
            fl = mk_fleet(2)
            for i, (p, nw) in enumerate(fleet_prompts(1, 7)):
                run.submit(fl, pkg, p, nw, session=("s0", "s1", None)[i % 3])
            run.drive(fl, fl)
            # A session's second turn extends its first: affinity sends
            # it back to the replica holding the prefix.
            first = fl._reqs[run.rids[0]]
            run.submit(fl, pkg, first.prompt + first.tokens + [7], 4, session="s0")
            run.drive(fl, fl)
        elif scenario == "admission":
            fl = mk_fleet(2, max_pending=3)
            for p, nw in fleet_prompts(2, 8):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
            for p, nw in fleet_prompts(3, 2):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
        elif scenario == "cancel_deadline":
            fl = mk_fleet(2)
            reqs = fleet_prompts(4, 5, new_lo=8)
            for i, (p, nw) in enumerate(reqs):
                run.submit(fl, pkg, p, nw, deadline_s=(None, None, 1e-9, 1e6, None)[i])
            run.script[3] = [lambda f: run.extra.__setitem__(
                "cancel_ok", int(f.cancel(run.rids[1])))]
            run.drive(fl, fl)
        elif scenario in ("crash", "hang"):
            seam = f"replica_{scenario}"
            fl = mk_fleet(2, fault_injector=pkg.faults.FaultInjector({seam: 5}))
            for p, nw in fleet_prompts(5, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
        elif scenario == "slow_drain":
            fl = mk_fleet(2, slow_readback_s=0.0, slow_drain_after=3,
                          fault_injector=pkg.faults.FaultInjector({"replica_slow": [1, 3, 5]}))
            for p, nw in fleet_prompts(6, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
            run.extra["draining"] = int(fl.replicas[0].state == F.DRAINING)
        elif scenario == "health":
            fl = mk_fleet(2)
            for p, nw in fleet_prompts(7, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.script[2] = [lambda f: f.deliver_health([_ev("chip-0", "Unhealthy")])]
            run.script[6] = [lambda f: f.deliver_health([_ev("chip-0", "Healthy")])]
            run.drive(fl, fl)
            for p, nw in fleet_prompts(8, 3):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
        elif scenario == "remove_add":
            fl = mk_fleet(2)
            for p, nw in fleet_prompts(9, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.script[3] = [lambda f: f.remove(0, force=True)]
            run.script[5] = [lambda f: run.extra.__setitem__(
                "added", f.add_replica(make_engine(), chip_id="chip-2"))]
            run.drive(fl, fl)
            for p, nw in fleet_prompts(10, 4):
                run.submit(fl, pkg, p, nw)
            run.drive(fl, fl)
        elif scenario.startswith("roles"):
            kw = dict(prefix_cache=True, kv_offload=True)
            fl = mk_fleet(2, engine_kw=kw, roles=["prefill", "decode"])
            reqs = fleet_prompts(11, 5, lo=9, hi=24, new_lo=4)
            for p, nw in reqs:
                run.submit(fl, pkg, p, nw)
            target = run.rids[0]

            def ticketed(f):
                fr = f._reqs[target]
                return fr.handoff is not None and any(q is fr for q in f.queue)

            if scenario != "roles":
                while not ticketed(fl):
                    run.steps += 1
                    assert run.steps < 200
                    fl.step()
                if scenario == "roles_cancel":
                    run.extra["cancel_ok"] = int(fl.cancel(target))
                elif scenario == "roles_deadline":
                    # The deadline passes while the ticket waits.
                    fl._reqs[target].deadline_s = 1e-9
                    fl._reqs[target].t_deadline = 0.0
                elif scenario == "roles_decode_death":
                    fl._fail_replica(fl.replicas[1], RuntimeError("injected"), "crash")
            run.drive(fl, fl)
        elif scenario == "wfq":
            fl = mk_fleet(1, wfq_weights={"interactive": 3.0, "bulk": 1.0})
            for i, (p, nw) in enumerate(fleet_prompts(12, 8)):
                run.submit(fl, pkg, p, nw, slo_class=("bulk", "interactive")[i % 3 == 0])
            run.drive(fl, fl)
            for cls, n in sorted(fl.wfq_dispatches.items()):
                run.extra[f"wfq_{cls}"] = n
        elif scenario == "journal":
            jdir = os.path.join(workdir, "journal")
            ddir = os.path.join(workdir, "disk")
            kw = dict(prefix_cache=True, kv_offload=True, kv_disk_dir=ddir)
            fl = mk_fleet(2, engine_kw=kw, journal_dir=jdir, journal_every=4)
            for i, (p, nw) in enumerate(fleet_prompts(13, 6, new_lo=12, new_hi=24)):
                run.submit(fl, pkg, p, nw, session=f"sess-{i % 2}")
            for _ in range(4):
                fl.step()
            run.digests.append(_journal_digest(jdir))
            fl.journal_now()
            run.digests.append(_journal_digest(jdir))
            fl.close()
            for name, src in (("journal", jdir), ("disk", ddir)):
                shutil.copytree(src, os.path.join(workdir, "at-close", name))
            fresh = mk_fleet(2, engine_kw=kw, journal_dir=jdir)
            run.extra["restored"] = fresh.restore()
            run.drive(fresh, fresh)
            fresh.journal_now()
            run.digests.append(_journal_digest(jdir))
            fl = fresh
        elif scenario in ("supervisor", "supervisor_quarantine"):
            clock = StepClock(0.25)
            fl = mk_fleet(2, fault_injector=pkg.faults.FaultInjector({"replica_crash": 4}))
            respawn = ({"replica_respawn": [1, 2, 3]} if scenario == "supervisor_quarantine"
                       else None)
            sup = pkg.supervisor.FleetSupervisor(
                fl, lambda slot: make_engine(),
                backoff=pkg.backoff.Backoff(base_s=1.0, factor=2.0, max_s=4.0, jitter=0.0),
                crash_loop_k=3, crash_loop_window_s=1e6, probe=([1, 2, 3], 4),
                fault_injector=pkg.faults.FaultInjector(respawn) if respawn else None,
                clock=clock,
            )
            sup.calibrate_probe()
            for p, nw in fleet_prompts(14, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.drive(sup, fl)
            for _ in range(60):
                if all(s.state in ("serving", "quarantined") for s in sup.slots):
                    break
                sup.step()
            run.events = [e.kind for e in sup.events]
            run.extra["restarts"] = sup.restarts_total
            run.extra["restart_failures"] = sup.restart_failures
            run.extra["quarantined"] = len(sup.quarantined)
        elif scenario == "autoscaler":
            clock = StepClock(0.25)
            fl = mk_fleet(1)
            fast = pkg.backoff.Backoff(base_s=0.5, factor=2.0, max_s=1.0, jitter=0.0)
            asc = pkg.autoscaler.FleetAutoscaler(
                fl, lambda slot: make_engine(), min_replicas=1, max_replicas=2,
                depth_high=1.0, queue_wait_p99_target_s=1e9, window_s=1.0,
                up_backoff=fast, down_backoff=fast, down_consecutive=2,
                probe=([1, 2, 3], 4), clock=clock,
            )
            asc.calibrate_probe()
            for p, nw in fleet_prompts(15, 8, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.drive(asc, fl)
            for _ in range(80):
                if asc.scale_downs and len(fl.alive) == 1:
                    break
                asc.step()
            run.events = [e.kind for e in asc.events]
            run.extra["scale_ups"] = asc.scale_ups
            run.extra["scale_downs"] = asc.scale_downs
            run.extra["alive"] = len(fl.alive)
        elif scenario == "control":
            clock = StepClock(0.25)
            kw = dict(superstep_k=4, ledger=None)
            engines = []
            for i in range(2):
                eng = make_engine(superstep_k=4)
                eng.ledger = pkg.ledger.ChipTimeLedger(name=str(i))
                engines.append(eng)
            fl = F.Fleet(engines, chip_ids=["chip-0", "chip-1"], hang_timeout_s=None,
                         ledger=pkg.ledger.FleetLedger())
            ctrl = pkg.control.GoodputController(
                fl, min_sample_tokens=8, clock=clock,
                retune_backoff=pkg.backoff.Backoff(base_s=0.5, factor=2.0, max_s=1.0,
                                                   jitter=0.0),
            )
            for p, nw in fleet_prompts(16, 8, new_lo=2, new_hi=4):
                run.submit(fl, pkg, p, nw)
            run.drive(ctrl, fl)
            for p, nw in fleet_prompts(17, 6, new_lo=2, new_hi=4):
                run.submit(fl, pkg, p, nw)
            run.drive(ctrl, fl)
            run.events = [e.kind for e in ctrl.events]
            run.extra["retunes"] = ctrl.retunes_applied
            run.extra["superstep_k"] = sum(e.superstep_k for e in engines)
            del kw
        elif scenario == "ledger":
            engines = []
            for i in range(2):
                eng = make_engine()
                eng.ledger = pkg.ledger.ChipTimeLedger(name=str(i))
                engines.append(eng)
            fl = F.Fleet(engines, chip_ids=["chip-0", "chip-1"], hang_timeout_s=None,
                         ledger=pkg.ledger.FleetLedger(),
                         fault_injector=pkg.faults.FaultInjector({"replica_crash": 6}))
            for p, nw in fleet_prompts(18, 6, new_lo=6):
                run.submit(fl, pkg, p, nw)
            run.script[3] = [lambda f: f.cancel(run.rids[2])]
            run.drive(fl, fl)
            snap = fl.ledger.snapshot()
            run.extra["goodput_tokens"] = snap["goodput_tokens"]
            for cls, n in snap["waste_tokens"].items():
                run.extra[f"waste_{cls}"] = n
            run.extra["reconcile_ok"] = int(fl.ledger.reconcile(expect_quiescent=True)["ok"])
        else:
            raise ValueError(scenario)
        _leak_free(fl, pkg)
        out = _result(fl, run)
        fl.close()
        return out
    finally:
        if owned is not None:
            owned.cleanup()


FLEET_SCENARIOS = (
    "route", "admission", "cancel_deadline", "crash", "hang", "slow_drain", "health",
    "remove_add", "roles", "roles_cancel", "roles_deadline", "roles_decode_death", "wfq",
    "journal", "supervisor", "supervisor_quarantine", "autoscaler", "control", "ledger",
)


def traffic_arrays(pkg) -> dict:
    """TrafficGen's schedules as numbers: offsets, prompts, budgets and
    classes of a plain, a classed, a per-class and a profiled schedule."""
    gen = pkg.fleet.TrafficGen(seed=7, vocab=256, max_prompt=24, max_new=16)
    scheds = {
        "plain": gen.schedule(16),
        "classed": gen.schedule_classed(16),
        "per_class": gen.schedule_per_class(16),
        "step": gen.schedule(16, profile=gen.step_profile(0.05, 0.1, 4.0)),
        "ramp": gen.schedule(16, profile=gen.ramp_profile(0.05, 0.1, 3.0)),
    }
    out = {}
    for name, sched in scheds.items():
        prompts = np.full((len(sched), 24), -1, np.int64)
        for i, entry in enumerate(sched):
            prompts[i, : len(entry[1])] = entry[1]
        out[f"traffic/{name}/offsets"] = np.asarray([e[0] for e in sched], np.float64)
        out[f"traffic/{name}/prompts"] = prompts
        out[f"traffic/{name}/new"] = np.asarray([e[2] for e in sched], np.int64)
        out[f"traffic/{name}/classes"] = np.asarray([e[3] if len(e) > 3 else "" for e in sched])
    return out


@pytest.fixture(scope="module")
def fleet_golden():
    with np.load(FLEET_GOLDEN) as f:
        return {k: f[k] for k in f.files}


def make_port_engine(golden):
    params = _params(golden, FLEET_CASE)
    config = tiny_config(FLEET_CASE)

    def make(**kw):
        return ServeEngine(params, config, device="cpu", **{**FLEET_KW, **kw})

    return make


@pytest.mark.parametrize("scenario", FLEET_SCENARIOS)
def test_fleet_scenario_matches_jax(golden, fleet_golden, scenario):  # noqa: F811
    """Streams, statuses, attempt routing, failovers, counters, event
    kinds and journal digests equal the JAX fleet's run."""
    got = run_fleet_scenario(port_package(), make_port_engine(golden), scenario)
    for name, value in got.items():
        np.testing.assert_array_equal(value, fleet_golden[f"{scenario}/{name}"],
                                      err_msg=f"{scenario}/{name}")


def test_goldens_cover_what_the_scenarios_do(fleet_golden):
    """The frozen runs exercise each mechanism: a failover, a hang, a
    drain, a handoff, a rejection, WFQ by class, a restore that replays,
    a resurrection and a quarantine, a scale-up and -down, a retune."""
    def c(scenario, name):
        names = list(fleet_golden[f"{scenario}/counter_names"])
        return int(fleet_golden[f"{scenario}/counters"][names.index(name)])

    assert c("crash", "replica_crashes") == 1 and c("crash", "failover_requeues") > 0
    assert c("hang", "replica_hangs") == 1
    assert c("slow_drain", "draining") == 1
    assert c("admission", "queue_rejections") > 0
    assert c("roles", "kv_handoffs") == 5 and c("roles", "handoff_pages") > 0
    assert c("wfq", "wfq_interactive") > 0 and c("wfq", "wfq_bulk") > 0
    assert c("journal", "restored") > 0 and c("journal", "tokens_replayed") > 0
    assert c("supervisor", "restarts") == 1
    assert c("supervisor_quarantine", "quarantined") == 1
    assert c("autoscaler", "scale_ups") >= 1 and c("autoscaler", "scale_downs") >= 1
    assert c("control", "retunes") >= 1
    assert c("ledger", "reconcile_ok") == 1
    assert "rejoin" in list(fleet_golden["supervisor/events"])
    statuses = set(fleet_golden["cancel_deadline/statuses"])
    assert {"ok", "cancelled", "expired"} <= statuses


def test_traffic_schedules_match_jax(fleet_golden):
    got = traffic_arrays(port_package())
    for name, value in got.items():
        np.testing.assert_array_equal(value, fleet_golden[name], err_msg=name)


def test_jax_journal_restores_in_the_port(golden, fleet_golden, tmp_path):  # noqa: F811
    """The journal and disk pages the JAX fleet left when it closed
    mid-stream restore into the port's fleet, which continues every
    stream to the JAX fleet's tokens."""
    for key in fleet_golden:
        if key.startswith("cross/file/"):
            rel = key[len("cross/file/"):]
            path = tmp_path / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(fleet_golden[key].tobytes())
    make = make_port_engine(golden)
    kw = dict(prefix_cache=True, kv_offload=True, kv_disk_dir=str(tmp_path / "disk"))
    fl = fleet.Fleet([make(**kw) for _ in range(2)], chip_ids=["chip-0", "chip-1"],
                     hang_timeout_s=None, journal_dir=str(tmp_path / "journal"))
    assert fl.restore() == int(fleet_golden["journal/counters"][-1])
    fl.run()
    rids = list(fleet_golden["cross/rids"])
    want = fleet_golden["journal/tokens"]
    for i, rid in enumerate(rids):
        fr = fl._reqs[rid]
        assert fr.status == "ok", rid
        assert fr.tokens == [int(t) for t in want[i] if t >= 0], rid
    _leak_free(fl, port_package())
    fl.close()
