"""The JAX package's observability contracts, ported to the PyTorch port
on the CPU: its tests/test_obs.py (the engine observer: spans, step
records, the Prometheus bridge, the trace export), test_fleet_trace.py
(attempt spans across failover, the merged fleet trace, SLO classes),
test_ledger.py (the chip-time ledger on real engines), test_postmortem.py
(the ledger's phases and token classes and the flight recorder on
fakes) and test_metrics_lint.py, which scans the port's obs.py and
fleet.py.

Each section is the JAX test file's text with its imports pointed at
``workloads_torch`` and its engines built on ``device="cpu"``; where a
helper's name would clash across sections it is renamed, as the section
heading says.  torch, numpy and the port only (plus the jax-free parts
of the device plugin that the JAX tests import), so it runs in the fast
tier.
"""

from __future__ import annotations

import json
import numpy as np
import os
import pytest
import re
import sys
import urllib.request
import torch

from tpu_device_plugin.metrics import MetricsServer, Registry
from types import SimpleNamespace
from workloads_torch.errors import InvalidRequest
from workloads_torch.faults import FaultInjector
from workloads_torch.fleet import DEFAULT_SLO_CLASSES, Fleet, SLOClass, TrafficGen
from workloads_torch.generate import generate as _port_generate
from workloads_torch.ledger import ChipTimeLedger, FleetLedger, FlightRecorder, PHASES, WASTE_CLASSES, BUNDLE_SCHEMA
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.obs import EngineObserver, trace_events, FleetObserver, export_fleet_trace, fleet_trace_events
from workloads_torch.serve import ServeEngine as _PortEngine
from workloads_torch.supervisor import make_engine_factory as _port_make_engine_factory
from tests.test_torch_superstep import one_torch_thread  # noqa: F401


class ServeEngine(_PortEngine):
    """The port's engine on the CPU: the JAX contracts build engines
    with no device, and the port's default is the card."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def generate(*args, device="cpu", **kw):
    return _port_generate(*args, device=device, **kw)


def make_engine_factory(*args, device="cpu", **kw):
    return _port_make_engine_factory(*args, device=device, **kw)


# ==== tests/test_obs.py
CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
DRAFT_CONFIG = ModelConfig(
    max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
    dtype=torch.float32,
)


@pytest.fixture(scope="module")
def models():
    params = init_params(CONFIG, torch.Generator().manual_seed(0))
    draft = init_params(DRAFT_CONFIG, torch.Generator().manual_seed(7))
    return params, draft


def _engine(params, observer=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("prompt_bucket", 8)
    return ServeEngine(params, CONFIG, observer=observer, **kw)


# A backpressured mixed stream: queue wait, instant finish
# (max_new_tokens=1), mid-stream retirement and slot turnover all occur.
STREAM = (([1, 2, 3], 10), ([4, 5], 6), ([7, 8, 9, 10], 4), ([6], 1))


def _run_stream(engine):
    rids = [engine.submit(p, n) for p, n in STREAM]
    out = engine.run()
    return [list(out[r]) for r in rids]


def test_token_streams_bit_identical_observer_on_off(models):
    """The tentpole guarantee: the observer (rings AND registry bridge
    live) changes no token, no telemetry counter, under sampling —
    where any RNG-order disturbance would show instantly."""
    params, _ = models

    def run(observer):
        engine = _engine(
            params, observer, temperature=0.8, top_k=5,
            generator=torch.Generator().manual_seed(3),
        )
        return engine, _run_stream(engine)

    obs = EngineObserver()
    obs.bind_registry(Registry())
    e_on, streams_on = run(obs)
    e_off, streams_off = run(None)
    assert streams_on == streams_off
    for attr in (
        "generated_tokens", "chunks_run", "prefill_dispatches",
        "admission_readbacks", "requests_admitted", "requests_retired",
    ):
        assert getattr(e_on, attr) == getattr(e_off, attr), attr


def test_step_records_describe_the_run(models):
    params, _ = models
    obs = EngineObserver()
    engine = _engine(params, obs)
    _run_stream(engine)
    steps = obs.drain_steps()
    assert steps and not obs.steps  # drained clear
    assert [r.index for r in steps] == list(range(len(steps)))
    assert sum(r.tokens for r in steps) == engine.generated_tokens
    assert sum(r.admitted for r in steps) == engine.requests_admitted == 4
    assert sum(r.retired for r in steps) == engine.requests_retired == 4
    assert sum(r.decode_dispatches for r in steps) == engine.chunks_run
    assert sum(r.sweeps for r in steps) == engine.prefill_sweeps
    for r in steps:
        assert r.mode in ("plain", "idle")
        assert 0 <= r.occupancy <= engine.slots
        assert r.dur_secs >= r.readback_secs >= 0.0
    assert obs.dropped_steps == 0


def test_request_spans_and_segments(models):
    params, _ = models
    obs = EngineObserver()
    engine = _engine(params, obs)
    _run_stream(engine)
    spans = obs.drain_spans()
    assert len(spans) == 4 and not obs.spans
    by_rid = {s.rid: s for s in spans}
    for (prompt, n), rid in zip(STREAM, ("req-0", "req-1", "req-2", "req-3")):
        span = by_rid[rid]
        assert span.n_tokens <= n
        # Stamp ordering -> non-negative segments that add up to e2e.
        assert span.queue_wait_secs >= 0
        assert span.prefill_secs >= 0
        assert span.decode_secs >= 0
        total = span.queue_wait_secs + span.prefill_secs + span.decode_secs
        assert total == pytest.approx(span.e2e_secs, abs=1e-9)
        assert span.ttft_secs == pytest.approx(
            span.queue_wait_secs + span.prefill_secs, abs=1e-9
        )
    # The instant-EOS-shaped request (max_new_tokens=1) finished AT
    # admission: first token is last token.
    assert by_rid["req-3"].t_first == by_rid["req-3"].t_done
    # Later waves queued behind the first: someone actually waited.
    assert max(s.queue_wait_secs for s in spans) > 0


def test_prometheus_bridge_scrapes_next_to_plugin_metrics(models):
    """The engine series land on a shared registry, scrapeable over the
    REAL MetricsServer — on an ephemeral port that the server reports
    back (the port-0 contract parallel CI relies on)."""
    params, _ = models
    reg = Registry()
    reg.describe("allocations_total", "plugin-side neighbour")
    reg.inc("allocations_total", {"resource": "google.com/tpu"}, 2)
    obs = EngineObserver(name="scrape")
    obs.bind_registry(reg)
    engine = _engine(params, obs)
    _run_stream(engine)
    server = MetricsServer(0, reg)
    assert server.port == 0
    port = server.start()
    try:
        assert port > 0 and server.port == port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics"
        ).read().decode()
    finally:
        server.stop()
    assert 'tpu_device_plugin_allocations_total{resource="google.com/tpu"} 2' in body
    assert (
        f'tpu_device_plugin_engine_tokens_total{{engine="scrape"}} '
        f"{engine.generated_tokens}" in body
    )
    assert 'engine_requests_admitted_total{engine="scrape"} 4' in body
    assert 'engine_queue_depth{engine="scrape"} 0' in body
    assert 'engine_slots{engine="scrape"} 2' in body
    # Serve histograms carry the seconds-scale ladder, not the
    # sub-second Allocate default.
    assert 'engine_e2e_seconds_bucket{engine="scrape",le="60.0"}' in body
    assert "TYPE tpu_device_plugin_engine_e2e_seconds histogram" in body


def test_unbind_registry_releases_gauges_and_engine(models):
    """A retiring engine must not keep scraping as live state: unbind
    removes the gauge collectors (whose closures pin the engine) while
    the accumulated counter/histogram series stay, monotonic."""
    params, _ = models
    reg = Registry()
    obs = EngineObserver()
    obs.bind_registry(reg)
    engine = _engine(params, obs)
    _run_stream(engine)
    before = reg.render()
    assert 'engine_slots{engine="0"} 2' in before
    tokens_line = f'engine_tokens_total{{engine="0"}} {engine.generated_tokens}'
    assert tokens_line in before
    obs.unbind_registry()
    after = reg.render()
    assert "engine_slots{" not in after  # dead engine's gauges gone
    assert "engine_queue_depth{" not in after
    assert tokens_line in after  # counters persist, monotonic
    assert obs._engine is None and obs._registry is None
    obs.unbind_registry()  # idempotent


def test_export_trace_covers_spec_mode_switches(models, tmp_path):
    """A spec="auto" run whose occupancy crosses the threshold: the
    exported timeline is schema-valid trace_event JSON carrying BOTH
    decode modes' step events plus every request's lanes."""
    from tools.trace_export import validate_file

    params, draft = models
    obs = EngineObserver(name="trace")
    engine = ServeEngine(
        params, CONFIG, slots=3, page_size=4, prompt_bucket=8,
        draft_params=draft, draft_config=DRAFT_CONFIG, gamma=3,
        spec="auto", spec_breakeven=1.5, observer=obs,
    )
    for prompt, new in (([5, 6, 7], 24), ([1, 2], 6), ([9], 4)):
        engine.submit(prompt, new)
    engine.run()
    assert engine.mode_switches >= 1  # the crossing actually happened
    path = tmp_path / "trace.json"
    n = engine.export_trace(str(path))
    assert validate_file(str(path)) == []
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert len(events) == n
    step_names = {e["name"] for e in events if e.get("cat") == "step"}
    assert "step[plain]" in step_names and "step[spec]" in step_names
    lanes = {e["args"]["rid"] for e in events if e.get("cat") == "request"}
    assert lanes == {"req-0", "req-1", "req-2"}
    segs = {e["name"] for e in events if e.get("cat") == "request"}
    assert segs == {"queued", "prefill", "decode"}
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert counters == {"occupancy", "queue_depth"}
    # trace_events is non-destructive: the rings still hold the run.
    assert obs.steps and obs.spans
    assert trace == trace_events(obs)


def test_mode_trace_knob_and_drain(models):
    """The decode_mode_trace bound is a constructor knob with a
    drain-style API — history is handed back, not silently dropped."""
    params, draft = models

    def spec_engine(**kw):
        engine = ServeEngine(
            params, CONFIG, slots=2, page_size=4, prompt_bucket=8,
            draft_params=draft, draft_config=DRAFT_CONFIG, gamma=3,
            spec="auto", spec_breakeven=2.0, **kw,
        )
        engine.submit([1, 2, 3], 12)
        engine.run()
        return engine

    bounded = spec_engine(mode_trace_limit=2)
    assert bounded.decode_mode_trace.maxlen == 2
    assert len(bounded.decode_mode_trace) <= 2
    unbounded = spec_engine(mode_trace_limit=None)
    assert unbounded.decode_mode_trace.maxlen is None
    assert len(unbounded.decode_mode_trace) == (
        unbounded.spec_mode_steps + unbounded.plain_mode_steps
    )
    drained = unbounded.drain_mode_trace()
    assert drained and not unbounded.decode_mode_trace
    for occ, mode in drained:
        assert mode in ("spec", "plain") and 1 <= occ <= 2
    with pytest.raises(ValueError, match="mode_trace_limit"):
        _engine(params, mode_trace_limit=0)


def test_export_trace_without_observer_is_a_loud_error(models):
    params, _ = models
    engine = _engine(params)
    with pytest.raises(RuntimeError, match="observer"):
        engine.export_trace("/tmp/never-written.json")


def test_observer_constructor_validates_ring_bounds():
    with pytest.raises(ValueError, match="step_limit"):
        EngineObserver(step_limit=0)


# ==== tests/test_fleet_trace.py (renamed here: _engine -> _fleet_trace_engine)
PARAMS = init_params(CONFIG, torch.Generator().manual_seed(0))
DRAFT_PARAMS = init_params(DRAFT_CONFIG, torch.Generator().manual_seed(7))

PROMPTS = [([3, 1, 4, 1, 5], 12), ([2, 7], 9), ([9] * 11, 13), ([5, 5], 8)]
CLASSES = ["interactive", "bulk", "interactive", "bulk"]


def _fleet_trace_engine(observer=None, **kw):
    base = dict(slots=2, page_size=4, prompt_bucket=8)
    base.update(kw)
    return ServeEngine(PARAMS, CONFIG, observer=observer, **base)


def _observed_fleet(n=2, *, engine_kw=None, registry=None, **fleet_kw):
    observers = [
        EngineObserver(name=str(i), replica=str(i)) for i in range(n)
    ]
    fleet_obs = FleetObserver()
    if registry is not None:
        for o in observers:
            o.bind_registry(registry)
        fleet_obs.bind_registry(registry)
    fleet_kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
    fleet_kw.setdefault("hang_timeout_s", None)
    fleet = Fleet(
        [_fleet_trace_engine(observers[i], **(engine_kw or {})) for i in range(n)],
        observer=fleet_obs, **fleet_kw,
    )
    return fleet, observers, fleet_obs


def _bare_fleet(n=2, *, engine_kw=None, **fleet_kw):
    fleet_kw.setdefault("chip_ids", [f"chip-{i}" for i in range(n)])
    fleet_kw.setdefault("hang_timeout_s", None)
    return Fleet(
        [_fleet_trace_engine(**(engine_kw or {})) for _ in range(n)], **fleet_kw
    )


def _oracle(prompt, new):
    return [int(t) for t in np.asarray(generate(
        PARAMS, torch.tensor([prompt]), CONFIG,
        max_new_tokens=new,
    )[0])]


def _validate(trace: dict) -> list:
    sys.path.insert(0, "tools")
    from trace_export import validate_trace

    return validate_trace(trace)


# ---- span stitching through a seeded crash -------------------------------


def _crashed_run():
    """Two replicas, replica_crash at crossing 3 (= replica 0's second
    step, mid-stream with work in flight), closed-loop classed
    submissions; returns (streams, spans, fleet) after convergence."""
    fleet, observers, fleet_obs = _observed_fleet(
        2, fault_injector=FaultInjector({"replica_crash": [3]}),
    )
    rids = [
        fleet.submit(p, n, slo_class=c)
        for (p, n), c in zip(PROMPTS, CLASSES)
    ]
    streams = fleet.run()
    assert fleet.replica_crashes == 1
    spans = {s.rid: s for s in fleet_obs.spans}
    assert set(spans) == set(rids)
    return streams, spans, fleet, observers, fleet_obs


def test_crash_spans_link_attempts_with_fault_kind_and_one_terminal():
    streams, spans, fleet, _, fleet_obs = _crashed_run()
    # Streams bit-identical to the dense oracle through the failover
    # (rids are fleet-0..3 in submission order).
    for i, (p, n) in enumerate(PROMPTS):
        assert streams[f"fleet-{i}"] == _oracle(p, n), i
    failed_over = [s for s in spans.values() if len(s.attempts) > 1]
    assert failed_over, "the scheduled crash failed nothing over"
    for span in failed_over:
        first, last = span.attempts[0], span.attempts[-1]
        assert first.outcome == "crash" and first.charged
        assert last.outcome == "ok" and not last.charged
        assert first.replica != last.replica
        assert span.failovers >= 1
        assert span.status == "ok"
        # Attempts tile the span: dispatch/end stamps are ordered and
        # the retry child starts after its parent ended.
        assert first.t_end is not None and last.t_end is not None
        assert first.t_dispatch <= first.t_end <= last.t_dispatch
    # Exactly one terminal per rid, and every span carries its class.
    assert [s.status for s in spans.values()].count("ok") == len(spans)
    assert {s.slo_class for s in spans.values()} == {"interactive", "bulk"}
    fleet.close()


def test_crash_keeps_first_segment_queue_wait_and_ttft_attribution():
    """A failover's re-admission must not reset queue-wait/TTFT: the
    span's t_admit/t_first are the FIRST attempt's stamps, not the
    survivor's."""
    _, spans, fleet, _, _ = _crashed_run()
    for span in spans.values():
        if len(span.attempts) < 2:
            continue
        first = span.attempts[0]
        assert span.t_admit == first.t_admit
        if first.t_first is not None:
            # The client saw its first token from the FIRST segment;
            # the replay on the survivor happened strictly later.
            assert span.t_first == first.t_first
            assert span.t_first < span.attempts[1].t_dispatch
        assert span.queue_wait_secs is not None
        assert span.queue_wait_secs <= span.ttft_secs
    fleet.close()


def test_merged_trace_validates_with_all_lanes_and_flow_links(tmp_path):
    _, spans, fleet, observers, fleet_obs = _crashed_run()
    path = str(tmp_path / "fleet-trace.json")
    n_events, n_replicas = export_fleet_trace(path, fleet_obs, observers)
    assert n_replicas == 2
    sys.path.insert(0, "tools")
    from trace_export import validate_file

    assert validate_file(path) == []
    trace = json.load(open(path))["traceEvents"]
    assert len(trace) == n_events
    procs = {
        ev["args"]["name"] for ev in trace
        if ev["ph"] == "M" and ev["name"] == "process_name"
    }
    assert "fleet router" in procs and "supervisor" in procs
    assert {"requests (engine 0)", "requests (engine 1)"} <= procs
    # Failover flow links survive the round trip, s/f paired by id.
    s_ids = [ev["id"] for ev in trace if ev["ph"] == "s"]
    f_ids = [ev["id"] for ev in trace if ev["ph"] == "f"]
    assert s_ids and sorted(s_ids) == sorted(f_ids)
    # Exactly one terminal instant per request span.
    terminals = [
        ev for ev in trace
        if ev["ph"] == "i" and ev["name"].startswith("terminal:")
    ]
    assert len(terminals) == len(spans)
    assert {ev["name"] for ev in terminals} == {"terminal:ok"}
    fleet.close()


# ---- supervisor events on the same timeline ------------------------------


def test_supervisor_events_land_on_the_merged_trace():
    from workloads_torch.backoff import Backoff
    from workloads_torch.supervisor import FleetSupervisor

    fleet, observers, fleet_obs = _observed_fleet(
        2, fault_injector=FaultInjector({"replica_crash": [3]}),
    )
    factory, oracle = make_engine_factory(
        PARAMS, CONFIG, engine_kw=dict(slots=2, page_size=4, prompt_bucket=8),
        probe=([1, 2, 3], 4),
    )
    sup = FleetSupervisor(
        fleet, factory,
        backoff=Backoff(base_s=1e-3, factor=2.0, max_s=8e-3, jitter=0.0),
        probe=([1, 2, 3], 4), probe_oracle=oracle,
    )
    for (p, n), c in zip(PROMPTS, CLASSES):
        sup.submit(p, n, slo_class=c)
    sup.run()
    assert sup.wait_healed(timeout_s=30.0)
    kinds = [ev.kind for ev in sup.events]
    for expected in ("death", "backoff", "probe", "rejoin"):
        assert expected in kinds, (expected, kinds)
    trace = fleet_trace_events(fleet_obs, observers, sup.events)
    assert _validate(trace) == []
    instants = [
        ev["name"] for ev in trace["traceEvents"]
        if ev["ph"] == "i" and ev.get("cat") == "supervisor"
    ]
    assert set(instants) >= {"death", "backoff", "probe", "rejoin"}
    # drain_events hands the ring back and clears it.
    drained = sup.drain_events()
    assert [ev.kind for ev in drained] == kinds and not sup.events
    fleet.close()


# ---- inert parity --------------------------------------------------------


@pytest.mark.parametrize("engine_kw", [
    {},
    {"pipelined": True},
    {"superstep_k": 2},
    {
        "draft_params": DRAFT_PARAMS, "draft_config": DRAFT_CONFIG,
        "gamma": 3, "spec": "auto", "spec_breakeven": 1.0,
    },
], ids=["serial", "pipelined", "superstep", "spec-auto"])
def test_tracing_and_slo_classes_are_inert(engine_kw):
    """Greedy streams must be bit-identical with the FULL fleet
    observability treatment (per-replica observers + fleet observer +
    registry + SLO class tags) on vs off, per engine mode."""
    from tpu_device_plugin.metrics import Registry

    bare = _bare_fleet(2, engine_kw=engine_kw)
    rids = [bare.submit(p, n) for p, n in PROMPTS]
    ref = bare.run()
    bare.close()

    fleet, observers, fleet_obs = _observed_fleet(
        2, engine_kw=engine_kw, registry=Registry(),
    )
    rids2 = [
        fleet.submit(p, n, slo_class=c)
        for (p, n), c in zip(PROMPTS, CLASSES)
    ]
    assert rids2 == rids
    out = fleet.run()
    assert out == ref, "fleet tracing + SLO classes moved a token"
    assert len(fleet_obs.spans) == len(PROMPTS)
    fleet.close()


# ---- SLO classes, attainment, burn rate ----------------------------------


def test_unknown_slo_class_is_a_typed_invalid_request():
    fleet = _bare_fleet(1)
    with pytest.raises(InvalidRequest, match="unknown slo_class"):
        fleet.submit([1, 2], 4, slo_class="platinum")
    fleet.close()


def test_slo_class_validation():
    with pytest.raises(ValueError, match="at least one"):
        SLOClass("empty")
    with pytest.raises(ValueError, match="objective"):
        SLOClass("bad", ttft_target_s=1.0, objective=1.5)
    with pytest.raises(ValueError, match="ttft_target_s"):
        SLOClass("bad", ttft_target_s=-1.0)
    cls = SLOClass("t", ttft_target_s=1.0, tpot_target_s=0.1)
    assert cls.met(0.5, 0.05)
    assert not cls.met(2.0, 0.05)  # ttft blown
    assert not cls.met(0.5, 0.2)  # tpot blown
    assert not cls.met(None, None)  # no first token against a ttft bound
    assert cls.met(0.5, None)  # one-token stream has no tpot to miss


def test_attainment_and_burn_rate_score_against_class_targets():
    """An impossible target misses every request (attainment 0, burn =
    1/error-budget); a generous one attains everything (burn 0)."""
    fleet = _bare_fleet(2, slo_classes=(
        SLOClass("strict", ttft_target_s=1e-9, objective=0.99),
        SLOClass("loose", ttft_target_s=1e9, objective=0.99),
    ))
    for i, (p, n) in enumerate(PROMPTS):
        fleet.submit(p, n, slo_class="strict" if i % 2 else "loose")
    fleet.run()
    att = fleet.slo_attainment()
    assert att["strict"] == 0.0 and att["loose"] == 1.0
    burn = fleet.slo_burn_rates()
    assert burn["strict"] == pytest.approx(100.0)  # 100% miss / 1% budget
    assert burn["loose"] == 0.0
    # The sliding window forgets: far enough in the future the strict
    # class's misses age out and burn reads 0 (no fresh evidence).
    import time as _time

    future = _time.perf_counter() + fleet.slo_window_s + 1.0
    assert fleet.slo_burn_rates(now=future)["strict"] == 0.0
    fleet.close()


def test_cancelled_requests_are_excluded_from_attainment():
    fleet = _bare_fleet(1)
    rid = fleet.submit([1, 2, 3], 8, slo_class="interactive")
    assert fleet.cancel(rid)
    fleet.step()
    assert fleet.slo_request_counts["interactive"] == 0
    done = fleet.drain_completed()
    assert [fr.status for fr in done] == ["cancelled"]
    assert done[0].slo_attained is None
    fleet.close()


def test_classed_schedule_is_bit_identical_to_unclassed():
    gen = TrafficGen(seed=11, class_mix=(("interactive", 3), ("bulk", 1)))
    plain = gen.schedule(32)
    classed = gen.schedule_classed(32)
    assert [e[:3] for e in classed] == plain  # tagging moves nothing
    assert {e[3] for e in classed} <= {"interactive", "bulk"}
    assert classed == gen.schedule_classed(32)  # deterministic per seed
    names = {c.name for c in DEFAULT_SLO_CLASSES}
    assert {e[3] for e in classed} <= names


# ---- the make slo-check smoke --------------------------------------------


def test_slo_check_smoke(tmp_path):
    """The CI tripwire (make slo-check): a seeded two-replica crash
    under the full observability treatment — merged trace round-trips
    the validator with every lane present, per-class attainment
    counters land on the registry, streams stay oracle-true."""
    from tpu_device_plugin.metrics import PREFIX, Registry

    reg = Registry()
    fleet, observers, fleet_obs = _observed_fleet(
        2, registry=reg,
        fault_injector=FaultInjector({"replica_crash": [3]}),
    )
    for (p, n), c in zip(PROMPTS, CLASSES):
        fleet.submit(p, n, slo_class=c)
    streams = fleet.run()
    for i, (p, n) in enumerate(PROMPTS):
        assert streams[f"fleet-{i}"] == _oracle(p, n), i
    assert fleet.replica_crashes == 1
    path = str(tmp_path / "slo-check-trace.json")
    n_events, n_replicas = export_fleet_trace(path, fleet_obs, observers)
    assert n_replicas == 2 and n_events > 0
    sys.path.insert(0, "tools")
    from trace_export import validate_file

    assert validate_file(path) == []
    render = reg.render()
    for cls, count in fleet.slo_request_counts.items():
        assert count > 0
        line = (
            f'{PREFIX}_fleet_slo_requests_total{{fleet="0",'
            f'slo_class="{cls}"}} {count}'
        )
        assert line in render, (line, render)
    assert f"{PREFIX}_fleet_slo_burn_rate" in render
    fleet.close()


# ==== tests/test_ledger.py (renamed here: _engine -> _ledger_engine, STREAM -> LEDGER_STREAM, _oracle -> _ledger_oracle)
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"),
)


def _ledger_engine(params, **kw):
    base = dict(slots=2, page_size=4, prompt_bucket=8)
    base.update(kw)
    return ServeEngine(params, CONFIG, **base)


LEDGER_STREAM = (([1, 2, 3], 10), ([4, 5], 6), ([7, 8, 9, 10], 4), ([6], 1))


def _ledger_oracle(params, prompt, n):
    return [int(t) for t in np.asarray(generate(
        params, torch.tensor([prompt]), CONFIG,
        max_new_tokens=n,
    )[0])]


# ---- inertness ----------------------------------------------------------


def test_streams_bit_identical_ledger_on_off(models):
    """The headline pin: the ledger (and the flight recorder) never
    move a token, across serial / pipelined / spec="auto" / superstep
    engines — sampling on for one arm so the RNG key schedule is
    pinned too."""
    params, draft = models
    configs = [
        dict(),
        dict(pipelined=True, temperature=0.8, top_k=20, top_p=0.9,
             generator=torch.Generator().manual_seed(5)),
        dict(superstep_k=2),
        dict(draft_params=draft, draft_config=DRAFT_CONFIG, gamma=2,
             spec="auto", spec_breakeven=1.0),
    ]
    def fresh(kw):
        # A JAX key is a value and both engines start from it; a torch
        # generator is consumed, so each engine gets its own copy.
        kw = dict(kw)
        if "generator" in kw:
            kw["generator"] = torch.Generator().set_state(kw["generator"].get_state())
        return kw

    for kw in configs:
        bare = _run_stream(_ledger_engine(params, **fresh(kw)))
        led = ChipTimeLedger()
        rec_engine = _ledger_engine(params, ledger=led, **fresh(kw))
        recorder = FlightRecorder(out_dir="/tmp")
        recorder.attach_engine("0", rec_engine)
        rids = [rec_engine.submit(p, n) for p, n in LEDGER_STREAM]
        while not rec_engine.idle:
            rec_engine.step()
            recorder.poll()
        by_rid = {r.rid: list(r.tokens) for r in rec_engine.completed}
        got = [by_rid[r] for r in rids]
        assert got == bare, kw
        assert led.reconcile(expect_quiescent=True)["ok"], kw
        assert not recorder.dumped  # a clean run triggers nothing


# ---- taxonomy contracts -------------------------------------------------


def test_quarantine_replay_charges_exact_tokens(models):
    """A quarantined step requeues its victims for replay; the ledger's
    `replay` class must carry EXACTLY the tokens the replay will
    re-prefill — prompt + everything emitted before the fault — and
    the resumed stream must still reconcile to full goodput."""
    params, _ = models
    prompt, n_new = [1, 2, 3, 4], 12
    led = ChipTimeLedger()
    engine = _ledger_engine(
        params, slots=1, ledger=led,
        fault_injector=FaultInjector({"decode_dispatch": [3]}),
        max_retries=3,
    )
    rid = engine.submit(prompt, n_new)
    while engine.steps_quarantined == 0:
        engine.step()
    # The faulted dispatch emitted nothing, so everything generated so
    # far is exactly what the replay re-prefills on top of the prompt.
    expected = len(prompt) + engine.generated_tokens
    assert engine.tokens_replayed == expected
    out = engine.run()
    assert led.waste_tokens["replay"] == expected
    assert list(out[rid]) == _ledger_oracle(params, prompt, n_new)
    verdict = led.reconcile(expect_quiescent=True)
    assert verdict["ok"], verdict
    assert led.goodput_tokens == len(out[rid])


def test_preempt_resume_charges_only_recompute(models):
    """Preemption-via-offload parks the prompt's full pages; the
    resume's re-prefill reloads them, so only the tail past the last
    full page plus the emitted tokens recompute — the exact charge
    pinned here, with the resumed stream an exact continuation."""
    params, _ = models
    page = 4
    prompt = list(range(1, 10))  # 9 tokens -> 2 full pages parked
    led = ChipTimeLedger()
    engine = _ledger_engine(
        params, slots=1, page_size=page, ledger=led,
        prefix_cache=True, kv_offload=True,
    )
    rid = engine.submit(prompt, 40)
    for _ in range(3):
        engine.step()
    ereq = engine.preempt(rid)
    assert ereq is not None
    emitted = list(ereq.tokens)
    assert emitted  # work was actually displaced
    covered = (len(prompt) // page) * page
    expected = len(prompt) + len(emitted) - covered
    assert engine.preempt_recompute_tokens == expected
    assert led.waste_tokens["preempt_recompute"] == 0  # not yet stepped
    # Resume exactly as the fleet would: prompt + emitted, remaining
    # budget; the continuation must be bit-identical to the oracle.
    resumed = engine.submit(prompt + emitted, 40 - len(emitted))
    out = engine.run()
    assert emitted + list(out[resumed]) == _ledger_oracle(params, prompt, 40)
    assert led.waste_tokens["preempt_recompute"] == expected
    # The preempted first segment is STATUSLESS at engine scope (the
    # fleet owns its terminal status), so exactly its emissions stay
    # pending here — the FleetLedger test covers full quiescence.
    verdict = led.reconcile()
    assert verdict["ok"], verdict
    assert verdict["pending"] == len(emitted)
    assert led.goodput_tokens == len(out[resumed])


def test_midprefill_preempt_excludes_prefix_hit_region(models):
    """A budget-parked admission that BEGAN at a prefix-cache hit only
    redoes the buckets it actually swept: the cached region was never
    prefilled here and the resume's lookup re-serves it, so the
    preempt_recompute charge must exclude it."""
    params, _ = models
    page, bucket = 4, 8
    shared = list(range(1, 17))  # 16 tokens = 4 full pages = 2 buckets
    engine = _ledger_engine(
        params, slots=1, page_size=page, prompt_bucket=bucket,
        prefix_cache=True, prefill_budget=bucket,
        ledger=ChipTimeLedger(),
    )
    warm = engine.submit(shared, 4)
    engine.run()  # the shared prefix is now cached
    tail = shared + list(range(30, 46))  # +16 fresh -> 4 buckets total
    rid = engine.submit(tail, 8)
    engine.step()  # budget sweeps ONE fresh bucket; the rest parks
    parked = [p for p in engine._inflight_prefill
              if p["req"].rid == rid]
    assert parked, "the admission must be parked mid-prefill"
    cursor = int(parked[0]["cursor"])
    start_page = int(parked[0]["start_page"])
    assert start_page * page == len(shared)  # the hit covered 2 buckets
    assert cursor > start_page * page // bucket  # and one bucket swept
    before = engine.preempt_recompute_tokens
    assert engine.preempt(rid) is not None
    charged = engine.preempt_recompute_tokens - before
    # Exactly the swept-beyond-the-hit tokens — NOT the cached region.
    assert charged == cursor * bucket - start_page * page
    engine.close()


def test_cancelled_stream_tokens_classify_as_waste(models):
    params, _ = models
    led = ChipTimeLedger()
    engine = _ledger_engine(params, slots=1, ledger=led)
    keep = engine.submit([1, 2], 4)
    doomed = engine.submit([3, 4, 5], 40)
    while not engine._occupied.any():
        engine.step()
    # Let the doomed stream emit, then cancel it mid-flight.
    for _ in range(3):
        engine.step()
    assert engine.cancel(doomed)
    engine.run()
    by_rid = {r.rid: r for r in engine.completed}
    assert by_rid[doomed].status == "cancelled"
    n_doomed = len(by_rid[doomed].tokens)
    assert led.waste_tokens["cancelled"] == n_doomed
    assert led.goodput_tokens == len(by_rid[keep].tokens)
    assert led.reconcile(expect_quiescent=True)["ok"]


def test_spec_engine_charges_rejects_and_reconciles(models):
    """Speculative serving: drafted-but-unaccepted tokens land in
    spec_rejected, chained supersteps' dead rounds in overdecode, and
    the books still balance — with spec phase time attributed across
    draft/verify/commit."""
    params, draft = models
    for kw in (
        dict(gamma=3),
        dict(gamma=2, spec_superstep_k=2),
    ):
        led = ChipTimeLedger()
        engine = _ledger_engine(
            params, draft_params=draft, draft_config=DRAFT_CONFIG,
            ledger=led, **kw,
        )
        _run_stream(engine)
        assert led.waste_tokens["spec_rejected"] == (
            engine.spec_tokens_rejected
        )
        assert led.waste_tokens["overdecode"] == engine.tokens_overdecoded
        assert led.reconcile(expect_quiescent=True)["ok"], kw
        spec_s = (
            led.phase_s["spec_draft"] + led.phase_s["spec_verify"]
            + led.phase_s["spec_commit"]
        )
        assert spec_s > 0, kw


def test_totals_reconcile_across_engine_modes(models):
    """goodput + waste == tokens accounted (pending 0) at quiescence
    for serial / pipelined / budgeted / superstep runs, with goodput
    cross-checked against the completed ok streams."""
    params, _ = models
    for kw in (
        dict(),
        dict(pipelined=True),
        dict(prefill_budget=8),
        dict(superstep_k=4),
    ):
        led = ChipTimeLedger()
        engine = _ledger_engine(params, ledger=led, **kw)
        _run_stream(engine)
        verdict = led.reconcile(expect_quiescent=True)
        assert verdict["ok"], (kw, verdict)
        ok_tokens = sum(
            len(r.tokens) for r in engine.completed if r.status == "ok"
        )
        assert led.goodput_tokens == ok_tokens, kw
        assert verdict["goodput"] + verdict["waste"] == (
            verdict["accounted"]
        ), kw
        # Time identity: every charged second landed in exactly one
        # phase, and a serving run is mostly busy.
        assert abs(sum(led.phase_s.values()) - led.wall_s) < 1e-6, kw
        assert 0.0 < led.busy_fraction <= 1.0, kw


def test_warmup_phase_classifies_whole_request_offbook(models):
    params, _ = models
    led = ChipTimeLedger()
    engine = _ledger_engine(params, ledger=led)
    engine.ledger_phase = "warmup"
    engine.submit([1], 3)
    engine.run()
    engine.ledger_phase = "serve"
    assert led.waste_tokens["probe_warmup"] == 3
    assert led.goodput_tokens == 0
    assert led.phase_s["warmup"] > 0
    assert led.reconcile(expect_quiescent=True)["ok"]
    # Back on the books: later traffic is ordinary goodput.
    out = engine.run() if engine.idle else None
    rid = engine.submit([2, 3], 4)
    out = engine.run()
    assert led.goodput_tokens == len(out[rid])
    assert led.reconcile(expect_quiescent=True)["ok"]


def test_engine_close_classifies_inflight_as_waste(models):
    params, _ = models
    led = ChipTimeLedger()
    engine = _ledger_engine(params, slots=1, ledger=led)
    engine.submit([1, 2, 3], 40)
    for _ in range(4):
        engine.step()
    emitted = engine.generated_tokens
    assert emitted > 0
    engine.close()
    assert led.waste_tokens["cancelled"] == emitted
    assert led.reconcile(expect_quiescent=True)["ok"]


# ---- fleet roll-up ------------------------------------------------------


def test_fleet_failover_ledger_reconciles(models):
    """A replica crash mid-stream: the fleet ledger charges the
    failover's re-prefill to `replay`, classifies the survivors'
    terminal tokens per class, and the fleet-wide books balance."""
    params, _ = models
    n = 2
    engines = [
        _ledger_engine(params, ledger=ChipTimeLedger(name=str(i)))
        for i in range(n)
    ]
    fled = FleetLedger()
    fleet = Fleet(
        engines, chip_ids=[f"chip-{i}" for i in range(n)],
        hang_timeout_s=None, ledger=fled,
        fault_injector=FaultInjector({"replica_crash": 2 * n + 1}),
    )
    rids = [
        fleet.submit(p, n_new, slo_class="interactive" if i % 2 else "bulk")
        for i, (p, n_new) in enumerate(LEDGER_STREAM)
    ]
    out = fleet.run()
    assert fleet.replica_crashes == 1
    for (p, n_new), rid in zip(LEDGER_STREAM, rids):
        assert list(out[rid]) == _ledger_oracle(params, p, n_new)
    snap = fled.snapshot()
    assert snap["waste_tokens"]["replay"] > 0
    assert snap["goodput_tokens"] == sum(
        len(r.tokens) for r in fleet.completed if r.status == "ok"
    )
    assert set(snap["per_class"]) == {"interactive", "bulk"}
    verdict = fled.reconcile(expect_quiescent=True)
    assert verdict["ok"], (verdict, snap)
    # The healthz block carries the fractions + per-waste-class views.
    hz = fled.healthz()
    assert set(hz["waste_tokens"]) == set(WASTE_CLASSES)
    assert 0.0 < hz["goodput_fraction"] <= 1.0
    fleet.close()


def test_fleet_out_of_step_cancel_keeps_token_identity(models):
    """Regression: cancelling a running rid between fleet steps drains
    the engine's pipelined in-flight chunks, emitting tokens (for
    co-batched rows too) OUTSIDE step()'s delta window — the fleet must
    fold that emission into `generated_tokens` or the ledger's
    emitted-token base undercounts and quiescent reconciliation goes
    negative-pending."""
    params, _ = models
    led = FleetLedger()
    engine = _ledger_engine(
        params, pipelined=True, ledger=ChipTimeLedger(name="0"),
    )
    fleet = Fleet(
        [engine], chip_ids=["chip-0"], hang_timeout_s=None, ledger=led,
    )
    keep = fleet.submit([1, 2, 3], 12)
    drop = fleet.submit([4, 5], 12)
    while len(fleet._reqs[keep].tokens) + sum(
        len(r.tokens) for r in engine._slot_req.values()
    ) < 2:
        fleet.step()
    g0 = engine.generated_tokens
    assert fleet.cancel(drop)
    # The pipelined drain inside cancel() emitted for the co-batched
    # row — exactly the out-of-window emission this test pins.
    assert engine.generated_tokens > g0
    out = fleet.run()
    assert list(out[keep]) == _ledger_oracle(params, [1, 2, 3], 12)
    assert list(out[drop]) == _ledger_oracle(params, [4, 5], 12)[: len(out[drop])]
    assert fleet.generated_tokens == engine.generated_tokens
    verdict = led.reconcile(expect_quiescent=True)
    assert verdict["ok"], verdict
    snap = led.snapshot()
    assert snap["goodput_tokens"] == sum(
        len(r.tokens) for r in fleet.completed if r.status == "ok"
    )
    fleet.close()


# ---- flight recorder / postmortem --------------------------------------


def test_ledger_check_smoke(models, tmp_path):
    """The `make ledger-check` smoke: a seeded fault run with ledger +
    recorder armed — streams bit-identical to the unledgered oracle,
    the scripted quarantine triggers a postmortem bundle that
    tools/postmortem.py validates, and the totals reconcile."""
    from postmortem import validate_file

    params, _ = models
    bare = _run_stream(_ledger_engine(
        params, fault_injector=FaultInjector({"decode_dispatch": [3]}),
        max_retries=3,
    ))
    led = ChipTimeLedger()
    engine = _ledger_engine(
        params, ledger=led,
        fault_injector=FaultInjector({"decode_dispatch": [3]}),
        max_retries=3,
    )
    recorder = FlightRecorder(out_dir=str(tmp_path))
    recorder.attach_engine("0", engine)
    rids = [engine.submit(p, n) for p, n in LEDGER_STREAM]
    while not engine.idle:
        engine.step()
        recorder.poll()
    by_rid = {r.rid: list(r.tokens) for r in engine.completed}
    assert [by_rid[r] for r in rids] == bare
    assert engine.steps_quarantined >= 1
    assert led.waste_tokens["replay"] > 0
    assert led.reconcile(expect_quiescent=True)["ok"]
    assert recorder.dumped, "the quarantine must have triggered a bundle"
    assert [k for k, _ in recorder.triggers][0] == "quarantine"
    for path in recorder.dumped:
        assert validate_file(path) == [], path
    # The bundle names the replay waste the incident cost.
    import json

    with open(recorder.dumped[0]) as f:
        bundle = json.load(f)
    assert bundle["replicas"]["0"]["ledger"]["waste_tokens"]["replay"] > 0
    assert bundle["replicas"]["0"]["counters"]["steps_quarantined"] >= 1


# ==== tests/test_postmortem.py
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"),
)

from postmortem import validate_bundle, validate_file  # noqa: E402


def _fake_engine(**over):
    base = dict(
        generated_tokens=0, tokens_overdecoded=0, spec_tokens_rejected=0,
        tokens_replayed=0, preempt_recompute_tokens=0, kv_spill_s=0.0,
        kv_reload_s=0.0, kv_handoff_s=0.0, prefill_dispatches=0,
        prefill_tokens=0, chunks_run=0, spec_rounds=0, superstep_k=1,
        spec_lookahead=1, spec_superstep_k=1, gamma=4,
        steps_quarantined=0, host_sync_s=0.0, ledger_phase="serve",
        _obs=None,
    )
    base.update(over)
    return SimpleNamespace(**base)


def _step(led, eng, *, emit=0, chunks=0, prefill=0, spec_rounds=0,
          finish=(), **bumps):
    snap = led.step_begin(eng)
    eng.generated_tokens += emit
    eng.chunks_run += chunks
    eng.prefill_dispatches += prefill
    eng.prefill_tokens += prefill * 8
    eng.spec_rounds += spec_rounds
    for attr, delta in bumps.items():
        setattr(eng, attr, getattr(eng, attr) + delta)
    led.step_end(eng, snap, list(finish))


# ---- attribution rules --------------------------------------------------


def test_phase_catalog_and_time_identity():
    led = ChipTimeLedger()
    eng = _fake_engine()
    _step(led, eng, emit=4, chunks=1)                   # decode step
    _step(led, eng, prefill=2)                          # admission step
    _step(led, eng)                                     # idle step
    _step(led, eng, emit=2, chunks=1, prefill=1)        # mixed: splits
    assert set(led.phase_s) == set(PHASES)
    assert abs(sum(led.phase_s.values()) - led.wall_s) < 1e-9
    assert led.phase_s["decode"] > 0
    assert led.phase_s["prefill"] > 0
    assert led.phase_s["idle"] > 0
    assert 0 < led.busy_fraction < 1


def test_kv_seconds_charge_their_phases_even_between_steps():
    """KV work timed OUTSIDE step() (an export_kv park, a preempt
    spill) still lands in its phase, and the per-step charge is
    max(dur, kv) so the time identity survives."""
    led = ChipTimeLedger()
    eng = _fake_engine()
    _step(led, eng, emit=4, chunks=1)
    eng.kv_spill_s += 0.5     # between steps: a park's gathered spill
    eng.kv_handoff_s += 0.25  # and its export packaging
    _step(led, eng, emit=4, chunks=1, kv_reload_s=0.125)
    assert led.phase_s["kv_spill"] == pytest.approx(0.5)
    assert led.phase_s["kv_handoff"] == pytest.approx(0.25)
    assert led.phase_s["kv_reload"] == pytest.approx(0.125)
    assert abs(sum(led.phase_s.values()) - led.wall_s) < 1e-9


def test_spec_split_subdivides_the_fused_window():
    led = ChipTimeLedger(spec_split=(2, 1, 1))
    eng = _fake_engine(spec_lookahead=2)
    _step(led, eng, emit=6, spec_rounds=2)
    draft, verify, commit = (
        led.phase_s["spec_draft"], led.phase_s["spec_verify"],
        led.phase_s["spec_commit"],
    )
    assert draft > 0 and verify > 0 and commit > 0
    assert draft == pytest.approx(verify * 2, rel=1e-6)
    assert verify == pytest.approx(commit, rel=1e-6)
    with pytest.raises(ValueError):
        ChipTimeLedger(spec_split=(0, 0, 0))


def test_offbook_phase_classifies_emissions_immediately():
    led = ChipTimeLedger()
    eng = _fake_engine(ledger_phase="probe")
    done = SimpleNamespace(rid="canary", tokens=[1, 2, 3], status="ok")
    _step(led, eng, emit=3, chunks=1, finish=[done])
    assert led.phase_s["probe"] > 0
    assert led.waste_tokens["probe_warmup"] == 3
    assert led.goodput_tokens == 0  # offbook terminals never classify
    assert led.reconcile(expect_quiescent=True)["ok"]


def test_token_identity_and_waste_classes():
    led = ChipTimeLedger()
    eng = _fake_engine()
    ok = SimpleNamespace(rid="a", tokens=[1] * 6, status="ok")
    bad = SimpleNamespace(rid="b", tokens=[1] * 2, status="expired")
    _step(led, eng, emit=8, chunks=1, tokens_overdecoded=3,
          spec_tokens_rejected=2, tokens_replayed=5,
          preempt_recompute_tokens=1, finish=[ok, bad])
    assert set(led.waste_tokens) == set(WASTE_CLASSES)
    assert led.waste_tokens == {
        "overdecode": 3, "spec_rejected": 2, "replay": 5,
        "preempt_recompute": 1, "cancelled": 2, "probe_warmup": 0,
    }
    assert led.goodput_tokens == 6
    assert led.tokens_accounted == 8 + 3 + 2 + 5 + 1
    verdict = led.reconcile(expect_quiescent=True)
    assert verdict["ok"], verdict
    # Waste chip-second estimates cover every class and never exceed
    # the phase budget they scale.
    waste_s = led.waste_chip_s()
    assert set(waste_s) == set(WASTE_CLASSES)
    assert all(v >= 0 for v in waste_s.values())


def test_pending_tracks_unterminated_emissions():
    led = ChipTimeLedger()
    eng = _fake_engine()
    _step(led, eng, emit=5, chunks=1)
    assert led.pending_tokens == 5
    assert led.reconcile()["ok"]
    assert not led.reconcile(expect_quiescent=True)["ok"]
    done = SimpleNamespace(rid="a", tokens=[1] * 5, status="ok")
    _step(led, eng, finish=[done])
    assert led.pending_tokens == 0
    assert led.reconcile(expect_quiescent=True)["ok"]


def test_snapshot_round_trips_to_dict():
    led = ChipTimeLedger(name="r7")
    eng = _fake_engine()
    _step(led, eng, emit=4, chunks=1)
    snap = led.snapshot().to_dict()
    assert snap["name"] == "r7"
    assert json.loads(json.dumps(snap)) == snap
    assert set(snap["phase_s"]) == set(PHASES)


# ---- fleet roll-up ------------------------------------------------------


def test_fleet_ledger_merges_replicas_and_classifies_per_class():
    led0, led1 = ChipTimeLedger(name="0"), ChipTimeLedger(name="1")
    e0, e1 = _fake_engine(), _fake_engine()
    _step(led0, e0, emit=6, chunks=1, tokens_overdecoded=2)
    _step(led1, e1, emit=4, chunks=1)
    fled = FleetLedger()
    fleet = SimpleNamespace(
        replicas=[
            SimpleNamespace(index=0, engine=SimpleNamespace(ledger=led0)),
            SimpleNamespace(index=1, engine=SimpleNamespace(ledger=led1)),
        ],
        generated_tokens=10, tokens_replayed=7,
    )
    fled.step_end(fleet, [
        SimpleNamespace(rid="a", tokens=[1] * 6, status="ok",
                        slo_class="interactive"),
        SimpleNamespace(rid="b", tokens=[1] * 4, status="failed",
                        slo_class="bulk"),
    ])
    snap = fled.snapshot()
    assert snap["waste_tokens"]["replay"] == 7     # fleet failover bill
    assert snap["waste_tokens"]["overdecode"] == 2  # engine-local waste
    assert snap["waste_tokens"]["cancelled"] == 4   # fleet-terminal
    assert snap["goodput_tokens"] == 6
    assert snap["tokens_accounted"] == 10 + 7 + 2
    assert snap["pending_tokens"] == 0
    assert snap["per_class"] == {
        "interactive": {"goodput": 6, "waste": 0},
        "bulk": {"goodput": 0, "waste": 4},
    }
    assert set(snap["per_replica"]) == {"0", "1"}
    assert fled.reconcile(expect_quiescent=True)["ok"]
    hz = fled.healthz()
    assert set(hz["waste_chip_s"]) == set(WASTE_CLASSES)


# ---- flight recorder ----------------------------------------------------


def _recorder(tmp_path, **kw):
    return FlightRecorder(out_dir=str(tmp_path), **kw)


def test_burn_trigger_needs_a_sustained_streak(tmp_path):
    rec = _recorder(tmp_path, burn_threshold=1.5, burn_polls=3)
    burns = {"interactive": 0.0}
    rec.attach_fleet(SimpleNamespace(
        replicas=[], slo_burn_rates=lambda: burns,
    ))
    assert rec.poll() == []
    burns["interactive"] = 9.0
    assert rec.poll() == [] and rec.poll() == []  # streak 1, 2
    written = rec.poll()                          # streak 3: fires once
    assert len(written) == 1
    assert rec.poll() == []                       # latched until clear
    burns["interactive"] = 0.0
    rec.poll()                                    # clears the latch
    burns["interactive"] = 9.0
    for _ in range(3):
        out = rec.poll()
    assert len(out) == 1                          # re-arms after clear
    for path in rec.dumped:
        assert validate_file(path) == []


def test_bundle_budget_counts_skips(tmp_path):
    rec = _recorder(tmp_path, bundle_limit=2)
    assert rec.trigger("manual", "one") and rec.trigger("manual", "two")
    assert rec.trigger("manual", "three") is None
    assert rec.bundles_skipped == 1
    assert len(rec.dumped) == 2
    with pytest.raises(ValueError):
        rec.trigger("not-a-kind")


def test_event_cursor_survives_ring_eviction(tmp_path):
    """The supervisor-event cursor is dropped_events + len(ring), so
    evicted (or drained) events can never replay old triggers — and a
    quarantine that arrives after eviction still fires."""
    from collections import deque

    rec = _recorder(tmp_path)
    sup = SimpleNamespace(events=deque(maxlen=2), dropped_events=0)
    rec.attach_supervisor(sup)

    def push(kind, detail=""):
        if len(sup.events) == sup.events.maxlen:
            sup.dropped_events += 1
        sup.events.append(SimpleNamespace(
            t=1.0, kind=kind, chip_id="c0", detail=detail,
        ))

    push("death")
    push("backoff")
    push("probe")  # evicts "death"
    assert rec.poll() == []  # nothing trigger-worthy
    push("quarantine", "crash-loop: 3 failures")
    push("restart_failed", "canary stream diverged from oracle")
    written = rec.poll()
    assert len(written) == 2
    kinds = [k for k, _ in rec.triggers]
    assert kinds == ["crash_loop", "probe_divergence"]
    assert rec.poll() == []  # cursor advanced; no replay


def test_bundle_embeds_rings_and_validates(tmp_path):
    rec = _recorder(tmp_path, snapshot_limit=2)
    led = ChipTimeLedger()
    eng = _fake_engine(ledger=led)
    rec.attach_engine("0", eng)
    for _ in range(4):
        _step(led, eng, emit=2, chunks=1,
              finish=[SimpleNamespace(rid="r", tokens=[1, 1],
                                      status="ok")])
        rec.poll()
    tap = rec._taps["0"]
    assert len(tap.snapshots) == 2 and tap.dropped_snapshots == 2
    path = rec.dump_bundle(trigger="manual", detail="unit")
    assert validate_file(path) == []
    with open(path) as f:
        bundle = json.load(f)
    assert bundle["schema"] == BUNDLE_SCHEMA
    assert len(bundle["replicas"]["0"]["ledger_snapshots"]) == 2
    assert bundle["replicas"]["0"]["reconcile"]["ok"]


# ---- validator rejections -----------------------------------------------


def _minimal_bundle():
    return {
        "schema": BUNDLE_SCHEMA,
        "created_unix": 1.0,
        "trigger": {"kind": "manual", "detail": ""},
        "replicas": {},
    }


def test_validator_rejects_broken_bundles():
    assert validate_bundle({"schema": "nope"})  # unknown schema
    bad_trigger = _minimal_bundle()
    bad_trigger["trigger"]["kind"] = "vibes"
    assert any("trigger.kind" in e for e in validate_bundle(bad_trigger))
    shuffled = _minimal_bundle()
    shuffled["replicas"]["0"] = {
        "steps": [{"index": 5}, {"index": 3}], "spans": [],
    }
    assert any("not increasing" in e for e in validate_bundle(shuffled))
    cooked = _minimal_bundle()
    cooked["replicas"]["0"] = {
        "steps": [], "spans": [],
        "ledger": {
            "phase_s": {p: 0.0 for p in PHASES},
            "waste_tokens": {c: 0 for c in WASTE_CLASSES},
            "goodput_tokens": 5, "pending_tokens": 0,
            "tokens_accounted": 9, "wall_s": 0.0,
        },
    }
    assert any("reconcile" in e for e in validate_bundle(cooked))
    assert validate_bundle(_minimal_bundle()) == []


# ==== tests/test_metrics_lint.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Call-site patterns for the emission APIs.  \s* spans newlines, so
# multi-line calls (plugin.py's health_events_total) are caught.
_INC_RE = re.compile(r"\.inc\(\s*\n?\s*[\"']([a-z0-9_]+)[\"']")
_OBSERVE_RE = re.compile(r"\.observe_seconds\(\s*\n?\s*[\"']([a-z0-9_]+)[\"']")
_TIMED_RE = re.compile(r"(?:metrics_timed|metrics\.timed|\btimed)\(\s*[\"']([a-z0-9_]+)[\"']")
_GAUGE_RE = re.compile(r"\.register_gauge\(\s*\n?\s*[\"']([a-z0-9_]+)[\"']")
# The observer registers its gauges by iterating _GAUGE_READERS, so the
# emitted names are that mapping's keys: "name": lambda e: ...
_GAUGE_READER_RE = re.compile(r"[\"']([a-z0-9_]+)[\"']:\s*lambda e:")


def _emitted_names() -> set[str]:
    """Every family name the plugin daemon or the engine bridge emits,
    scraped from source text (histogram call names normalised to their
    rendered ``<x>_seconds`` family)."""
    names: set[str] = set()
    roots = []
    plugin_dir = os.path.join(REPO, "tpu_device_plugin")
    for fn in os.listdir(plugin_dir):
        if fn.endswith(".py") and fn != "metrics.py":  # skip definitions
            roots.append(os.path.join(plugin_dir, fn))
    roots.append(os.path.join(REPO, "workloads_torch", "obs.py"))
    roots.append(os.path.join(REPO, "workloads_torch", "fleet.py"))
    for path in roots:
        text = open(path, encoding="utf-8").read()
        names |= set(_INC_RE.findall(text))
        names |= {f"{n}_seconds" for n in _OBSERVE_RE.findall(text)}
        names |= {f"{n}_seconds" for n in _TIMED_RE.findall(text)}
        names |= set(_GAUGE_RE.findall(text))
        names |= set(_GAUGE_READER_RE.findall(text))
    return names


def _described_names() -> set[str]:
    from tpu_device_plugin import metrics
    from workloads_torch.obs import AUTOSCALER_METRICS, CONTROL_METRICS, ENGINE_METRICS, FLEET_METRICS, LEDGER_METRICS, SUPERVISOR_METRICS

    return (
        set(metrics.registry._help)
        | {m.name for m in ENGINE_METRICS}
        | {m.name for m in FLEET_METRICS}
        | {m.name for m in SUPERVISOR_METRICS}
        | {m.name for m in AUTOSCALER_METRICS}
        | {m.name for m in CONTROL_METRICS}
        | {m.name for m in LEDGER_METRICS}
    )


def test_every_emitted_metric_has_help_text():
    emitted = _emitted_names()
    assert emitted, "the scanner found no emission call sites at all"
    # Sanity-pin a few names the scan must catch (a regex rot tripwire:
    # an over-narrow pattern would silently lint nothing).
    for expected in (
        "allocations_total", "health_events_total", "allocate_seconds",
        "devices", "engine_tokens_total", "engine_ttft_seconds",
        "engine_queue_depth",
    ):
        assert expected in emitted, f"scanner missed {expected}"
    undescribed = emitted - _described_names()
    assert not undescribed, (
        f"metric names emitted without describe() help text: "
        f"{sorted(undescribed)} — add them to the module-level describes "
        f"(tpu_device_plugin/metrics.py) or ENGINE_METRICS (workloads/obs.py)"
    )


def test_engine_catalog_is_fully_described_on_bind():
    """bind_registry must describe EVERY catalog family (the rendered
    docs table promises them all)."""
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import ENGINE_METRICS, EngineObserver

    reg = Registry()
    EngineObserver().bind_registry(reg)
    missing = {m.name for m in ENGINE_METRICS} - set(reg._help)
    assert not missing, missing


def test_gauge_readers_match_the_catalog():
    """bind/unbind both iterate _GAUGE_READERS; if it drifts from the
    catalog's gauge families, either a documented gauge never registers
    or an unregistered one leaks past unbind_registry."""
    from workloads_torch.obs import ENGINE_METRICS, EngineObserver

    catalog_gauges = {m.name for m in ENGINE_METRICS if m.type == "gauge"}
    assert catalog_gauges == set(EngineObserver._GAUGE_READERS)


def test_fleet_gauge_readers_match_the_catalog():
    """Same drift pin for the fleet bridge's gauge families."""
    from workloads_torch.obs import FLEET_METRICS, FleetObserver

    catalog_gauges = {m.name for m in FLEET_METRICS if m.type == "gauge"}
    assert catalog_gauges == set(FleetObserver._FLEET_GAUGE_READERS)


def test_ledger_gauge_readers_match_the_catalog():
    """Drift pin for the chip-time-ledger gauge families: the
    engine-labeled ones ride EngineObserver._LEDGER_GAUGE_READERS, the
    fleet-labeled one FleetObserver._FLEET_LEDGER_GAUGE_READERS —
    nothing documented can fail to register, nothing registered can
    leak past unbind."""
    from workloads_torch.obs import LEDGER_METRICS, EngineObserver, FleetObserver

    engine_gauges = {
        m.name for m in LEDGER_METRICS
        if m.type == "gauge" and m.labels[0] == "engine"
    }
    assert engine_gauges == set(EngineObserver._LEDGER_GAUGE_READERS)
    fleet_gauges = {
        m.name for m in LEDGER_METRICS
        if m.type == "gauge" and m.labels[0] == "fleet"
    }
    assert fleet_gauges == set(FleetObserver._FLEET_LEDGER_GAUGE_READERS)


def test_ledger_catalog_is_fully_described_on_bind():
    """Both bridges together must describe every LEDGER_METRICS family
    (the rendered docs table promises them all)."""
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import LEDGER_METRICS, EngineObserver, FleetObserver

    reg = Registry()
    EngineObserver().bind_registry(reg)
    FleetObserver().bind_registry(reg)
    missing = {m.name for m in LEDGER_METRICS} - set(reg._help)
    assert not missing, missing


def test_fleet_catalog_is_fully_described_on_bind():
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import FLEET_METRICS, FleetObserver

    reg = Registry()
    FleetObserver().bind_registry(reg)
    missing = {m.name for m in FLEET_METRICS} - set(reg._help)
    assert not missing, missing


def test_supervisor_gauge_readers_match_the_catalog():
    """Same drift pin for the supervisor bridge's gauge families."""
    from workloads_torch.obs import SUPERVISOR_METRICS, SupervisorObserver

    catalog_gauges = {
        m.name for m in SUPERVISOR_METRICS if m.type == "gauge"
    }
    assert catalog_gauges == set(
        SupervisorObserver._SUPERVISOR_GAUGE_READERS
    )


def test_supervisor_catalog_is_fully_described_on_bind():
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import SUPERVISOR_METRICS, SupervisorObserver

    reg = Registry()
    SupervisorObserver().bind_registry(reg)
    missing = {m.name for m in SUPERVISOR_METRICS} - set(reg._help)
    assert not missing, missing


def test_autoscaler_gauge_readers_match_the_catalog():
    """Same drift pin for the autoscaler bridge's gauge families."""
    from workloads_torch.obs import AUTOSCALER_METRICS, AutoscalerObserver

    catalog_gauges = {
        m.name for m in AUTOSCALER_METRICS if m.type == "gauge"
    }
    assert catalog_gauges == set(
        AutoscalerObserver._AUTOSCALER_GAUGE_READERS
    )


def test_autoscaler_catalog_is_fully_described_on_bind():
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import AUTOSCALER_METRICS, AutoscalerObserver

    reg = Registry()
    AutoscalerObserver().bind_registry(reg)
    missing = {m.name for m in AUTOSCALER_METRICS} - set(reg._help)
    assert not missing, missing


def test_control_gauge_readers_match_the_catalog():
    """Same drift pin for the goodput-controller bridge's gauge
    families."""
    from workloads_torch.obs import CONTROL_METRICS, ControlObserver

    catalog_gauges = {
        m.name for m in CONTROL_METRICS if m.type == "gauge"
    }
    assert catalog_gauges == set(ControlObserver._CONTROL_GAUGE_READERS)


def test_control_catalog_is_fully_described_on_bind():
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import CONTROL_METRICS, ControlObserver

    reg = Registry()
    ControlObserver().bind_registry(reg)
    missing = {m.name for m in CONTROL_METRICS} - set(reg._help)
    assert not missing, missing


def test_control_bridge_render_is_valid_exposition():
    """Drive the control bridge against a fake controller (no jax):
    actuation counters land as running-total deltas, the per-action
    decisions counter carries the action label, the EWMA gauges emit
    no sample until measured and scrape once they are — then unbind
    releases the gauges."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import ControlObserver

    reg = Registry()
    obs = ControlObserver(name="ctl0")
    obs.bind_registry(reg)
    ctrl = SimpleNamespace(
        retunes_applied=0, wfq_reweights=0, dropped_events=0,
        decisions={},
        goodput_fraction_ewma=None, spec_rejected_fraction_ewma=None,
        overdecode_fraction_ewma=None,
    )
    obs._bind(ctrl)
    obs._control_poll_end(ctrl)
    # Unmeasured EWMAs emit NO gauge sample (0.0 would read as
    # "perfect waste" on a dashboard).
    assert f"{PREFIX}_control_goodput_fraction{{" not in reg.render()
    ctrl.retunes_applied = 3
    ctrl.wfq_reweights = 1
    ctrl.decisions = {"retune": 3, "wfq_reweight": 1}
    ctrl.goodput_fraction_ewma = 0.75
    ctrl.spec_rejected_fraction_ewma = 0.15
    ctrl.overdecode_fraction_ewma = 0.05
    obs._control_poll_end(ctrl)
    obs._control_poll_end(ctrl)  # unchanged totals push no deltas
    families = _parse_exposition(reg.render())
    assert families[
        f"{PREFIX}_control_retunes_total"
    ]["samples"][0][2] == 3.0
    assert families[
        f"{PREFIX}_control_wfq_reweights_total"
    ]["samples"][0][2] == 1.0
    decisions = families[f"{PREFIX}_control_decisions_total"]["samples"]
    assert {
        (labels["action"], v) for _, labels, v in decisions
    } == {("retune", 3.0), ("wfq_reweight", 1.0)}
    assert families[
        f"{PREFIX}_control_goodput_fraction"
    ]["samples"][0][2] == 0.75
    assert families[
        f"{PREFIX}_control_overdecode_fraction"
    ]["samples"][0][2] == 0.05
    obs.unbind_registry()
    assert f"{PREFIX}_control_goodput_fraction" not in _parse_exposition(
        reg.render()
    )


# ---- exposition-format parsing -----------------------------------------


def _parse_exposition(text: str):
    """Parse Prometheus text format into {family: {"type": ..., "help":
    ..., "samples": [(name, labels dict, value)]}}, asserting the
    structural rules as it goes: HELP and TYPE precede every family's
    first sample, sample lines parse, label values stay escaped."""
    families: dict[str, dict] = {}
    line_re = re.compile(
        r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
    )
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            fam = line.split()[2]
            families.setdefault(fam, {"samples": []})["help"] = line
            continue
        if line.startswith("# TYPE "):
            _, _, fam, mtype = line.split(None, 3)
            assert fam in families and "help" in families[fam], (
                f"TYPE before HELP for {fam}"
            )
            assert "type" not in families[fam], f"duplicate TYPE for {fam}"
            families[fam]["type"] = mtype
            continue
        assert not line.startswith("#"), f"unknown comment line: {line}"
        m = line_re.match(line)
        assert m, f"unparseable sample line: {line!r}"
        name = m.group("name")
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)].endswith("_seconds"):
                fam = name[: -len(suffix)]
        assert fam in families and "type" in families[fam], (
            f"sample {name} before its family's HELP/TYPE"
        )
        labels = {}
        if m.group("labels"):
            for part in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group("labels")):
                labels[part[0]] = part[1]
        value = float(m.group("value").replace("+Inf", "inf").replace("-Inf", "-inf").replace("NaN", "nan"))
        families[fam]["samples"].append((name, labels, value))
    return families


def _assert_histogram_sound(fam: str, info: dict):
    assert info["type"] == "histogram", fam
    by_series: dict[tuple, list] = {}
    counts, sums = {}, {}
    for name, labels, value in info["samples"]:
        if name.endswith("_bucket"):
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            by_series.setdefault(key, []).append((labels["le"], value))
        elif name.endswith("_count"):
            counts[tuple(sorted(labels.items()))] = value
        elif name.endswith("_sum"):
            sums[tuple(sorted(labels.items()))] = value
    assert by_series and counts and sums, f"{fam}: incomplete triple"
    for key, buckets in by_series.items():
        les = [le for le, _ in buckets]
        assert les[-1] == "+Inf", f"{fam}: +Inf not last: {les}"
        floats = [float(le) for le in les[:-1]]
        assert floats == sorted(floats), f"{fam}: le out of order: {les}"
        values = [v for _, v in buckets]
        assert values == sorted(values), (
            f"{fam}: buckets not cumulative: {values}"
        )
        assert counts[key] == values[-1], (
            f"{fam}: _count {counts[key]} != +Inf bucket {values[-1]}"
        )


def test_render_parses_as_valid_exposition_format():
    """A registry exercising every series shape — counters with and
    without labels, default- and override-bucket histograms, gauges —
    renders to text the parser accepts with sound histograms."""
    from tpu_device_plugin.metrics import PREFIX, Registry

    reg = Registry()
    reg.describe("allocations_total", "allocs")
    reg.describe("allocate_seconds", "latency")
    reg.describe("engine_e2e_seconds", "e2e", buckets=(0.5, 2.5, 10.0))
    reg.describe("devices", "devices by health")
    reg.inc("allocations_total", {"resource": "google.com/tpu"})
    reg.inc("allocations_total")
    for s in (0.003, 0.07, 4.2):
        reg.observe_seconds("allocate", s, {"resource": "r"})
        reg.observe_seconds("engine_e2e", s, {"engine": "0"})
    reg.register_gauge("devices", lambda: [({"health": "Healthy"}, 4.0)])
    families = _parse_exposition(reg.render())
    assert f"{PREFIX}_allocations_total" in families
    assert families[f"{PREFIX}_allocations_total"]["type"] == "counter"
    assert families[f"{PREFIX}_devices"]["type"] == "gauge"
    for fam in (f"{PREFIX}_allocate_seconds", f"{PREFIX}_engine_e2e_seconds"):
        _assert_histogram_sound(fam, families[fam])
    # The override ladder actually applied: 4.2 s lands in a finite
    # bucket of the serve family but only +Inf of the default one.
    e2e_les = {
        labels["le"]
        for name, labels, _ in families[f"{PREFIX}_engine_e2e_seconds"]["samples"]
        if name.endswith("_bucket")
    }
    assert e2e_les == {"0.5", "2.5", "10.0", "+Inf"}


def test_engine_bridge_render_is_valid_exposition():
    """Drive the full observer bridge against a FAKE engine (no jax:
    the hooks only read counters/mirrors) and parse the rendered
    output — the engine families obey the same exposition rules as the
    plugin's."""
    import numpy as np

    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import EngineObserver

    reg = Registry()
    obs = EngineObserver(name="lint")
    obs.bind_registry(reg)

    class _Ctrl(SimpleNamespace):
        pass

    eng = SimpleNamespace(
        generated_tokens=0, requests_admitted=0, requests_retired=0,
        prefill_dispatches=0, prefill_sweeps=0, chunks_run=0, spec_rounds=0,
        mode_switches=0, admission_readbacks=0, spec_lookahead=1,
        prefill_deferred_tokens=0, _inflight_prefill=[],
        pending=[], _occupied=np.zeros(4, bool), slots=4,
        ctrl=_Ctrl(used_pages=0),
    )
    obs._bind(eng)
    finished = SimpleNamespace(
        rid="req-0", t_submit=1.0, t_admit=1.1, t_first=1.5, t_done=3.0,
        tokens=[7, 8, 9],
    )
    for i in range(3):
        snap = obs._step_begin(eng)
        eng.generated_tokens += 4
        eng.chunks_run += 1
        if i == 0:
            eng.requests_admitted += 2
            eng.prefill_dispatches += 1
            eng.prefill_sweeps += 1
            # A budget-deferred admission: the counter pushes as a
            # step delta and the in-flight gauge reads it.
            eng.prefill_deferred_tokens += 16
            eng._inflight_prefill = [SimpleNamespace()]
        done = []
        if i == 2:
            eng.requests_retired += 1
            eng.spec_rounds += 1  # exercise the spec-mode label too
            eng.chunks_run -= 1
            done = [finished]
        obs._step_end(eng, snap, done)
    families = _parse_exposition(reg.render())
    assert families[f"{PREFIX}_engine_tokens_total"]["samples"][0][2] == 12.0
    assert (
        families[f"{PREFIX}_engine_prefill_deferred_tokens_total"][
            "samples"
        ][0][2]
        == 16.0
    )
    for fam in (
        f"{PREFIX}_engine_ttft_seconds",
        f"{PREFIX}_engine_e2e_seconds",
        f"{PREFIX}_engine_step_seconds",
    ):
        _assert_histogram_sound(fam, families[fam])
    modes = {
        labels.get("mode")
        for _, labels, _ in families[f"{PREFIX}_engine_decode_steps_total"]["samples"]
    }
    assert modes == {"plain", "spec"}
    gauges = {
        fam for fam, info in families.items() if info["type"] == "gauge"
    }
    assert f"{PREFIX}_engine_queue_depth" in gauges
    assert f"{PREFIX}_engine_resident_pages" in gauges


def _drive_fake_engine(obs, steps: int = 2):
    """Minimal fake-engine bridge drive shared by the replica-label
    pins (no jax: the hooks only read counters/mirrors)."""
    import numpy as np

    eng = SimpleNamespace(
        generated_tokens=0, requests_admitted=0, requests_retired=0,
        prefill_dispatches=0, prefill_sweeps=0, chunks_run=0, spec_rounds=0,
        mode_switches=0, admission_readbacks=0, spec_lookahead=1,
        prefill_deferred_tokens=0, _inflight_prefill=[],
        pending=[], _occupied=np.zeros(2, bool), slots=2,
        ctrl=SimpleNamespace(used_pages=0), paused=False,
    )
    obs._bind(eng)
    for _ in range(steps):
        snap = obs._step_begin(eng)
        eng.generated_tokens += 3
        eng.chunks_run += 1
        obs._step_end(eng, snap, [])
    return eng


def test_single_engine_scrape_has_no_replica_label():
    """The replica label is OPT-IN: with the default empty ``replica``
    the rendered output carries no replica label anywhere and gauges
    register name-keyed — single-engine scrape output stays
    byte-compatible with the pre-fleet bridge (the multi-engine
    collision fix must not move anyone's dashboards)."""
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import EngineObserver

    reg = Registry()
    obs = EngineObserver(name="solo")
    obs.bind_registry(reg)
    _drive_fake_engine(obs)
    text = reg.render()
    assert 'engine="solo"' in text
    assert "replica=" not in text
    # Keyless gauges keep the replace-by-name contract: a successor
    # observer's registration replaces, never duplicates.
    obs2 = EngineObserver(name="solo2")
    obs2.bind_registry(reg)
    _drive_fake_engine(obs2)
    depth_lines = [
        ln for ln in reg.render().splitlines()
        if ln.startswith("tpu_device_plugin_engine_queue_depth{")
    ]
    assert len(depth_lines) == 1, depth_lines


def test_multi_replica_engines_share_one_registry():
    """Fleet mode: N observers with distinct ``replica`` ids coexist on
    one registry — every engine family series carries its replica
    label, per-replica gauges all scrape (no last-binder-wins
    collision), the exposition stays valid, and one replica unbinding
    leaves its siblings' collectors alone."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import EngineObserver

    reg = Registry()
    observers = [
        EngineObserver(name=str(i), replica=str(i)) for i in range(3)
    ]
    for obs in observers:
        obs.bind_registry(reg)
        _drive_fake_engine(obs)
    families = _parse_exposition(reg.render())
    depth = families[f"{PREFIX}_engine_queue_depth"]["samples"]
    assert {labels["replica"] for _, labels, _ in depth} == {"0", "1", "2"}
    tokens = families[f"{PREFIX}_engine_tokens_total"]["samples"]
    assert {labels["replica"] for _, labels, _ in tokens} == {"0", "1", "2"}
    assert all(v == 6.0 for _, _, v in tokens)
    # Replica 1 retires: its gauges go, 0 and 2 keep scraping.
    observers[1].unbind_registry()
    families = _parse_exposition(reg.render())
    depth = families[f"{PREFIX}_engine_queue_depth"]["samples"]
    assert {labels["replica"] for _, labels, _ in depth} == {"0", "2"}


def _fake_fleet_request(
    rid="fr-0", *, status="ok", slo_class=None, slo_attained=None,
    n_tokens=5, t_first=1.05,
):
    """A terminal FleetRequest stand-in carrying the stamp/class fields
    FleetSpan.from_fleet_request flattens (no jax, no fleet)."""
    return SimpleNamespace(
        rid=rid, t_submit=1.0, t_admit=1.01, t_first=t_first,
        t_done=1.3, status=status, tokens=[7] * n_tokens,
        slo_class=slo_class, slo_attained=slo_attained, failovers=0,
        attempts=[],
    )


def test_fleet_bridge_render_is_valid_exposition():
    """Drive the fleet bridge against a fake fleet (no jax) next to a
    replica-labeled engine bridge and parse the render: fleet families
    obey the exposition rules, per-replica state/paused gauges emit one
    sample per live replica, counters land as running-total deltas, and
    the SLO-class families carry the class label."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import FleetObserver

    reg = Registry()
    obs = FleetObserver(name="f0")
    obs.bind_registry(reg)
    replicas = [
        SimpleNamespace(index=0, state="active", paused=False),
        SimpleNamespace(index=1, state="draining", paused=True),
        SimpleNamespace(index=2, state="dead", paused=False),
    ]
    fleet = SimpleNamespace(
        queue=[1, 2], replicas=replicas, requests_submitted=5,
        generated_tokens=40, failover_requeues=2, drain_requeues=1,
        queue_rejections=3, replica_crashes=1, replica_hangs=0,
        slo_burn_rates=lambda: {"interactive": 1.5, "bulk": 0.0},
    )
    obs._bind(fleet)
    finished = [
        _fake_fleet_request(
            "fr-0", slo_class="interactive", slo_attained=True,
        ),
        _fake_fleet_request(
            "fr-1", status="failed", slo_class="interactive",
            slo_attained=False,
        ),
        _fake_fleet_request("fr-2", slo_class="bulk", slo_attained=True),
        # Cancelled before the verdict: excluded from attainment but
        # its stamps still pool into the unclassed histograms.
        _fake_fleet_request(
            "fr-3", status="cancelled", slo_class="bulk",
        ),
        _fake_fleet_request("fr-4"),  # untagged
    ]
    obs._fleet_step_end(fleet, finished)
    obs._fleet_step_end(fleet, [])  # unchanged totals push no deltas
    families = _parse_exposition(reg.render())
    assert families[f"{PREFIX}_fleet_requests_total"]["samples"][0][2] == 5.0
    assert families[f"{PREFIX}_fleet_tokens_total"]["samples"][0][2] == 40.0
    assert families[f"{PREFIX}_fleet_failovers_total"]["samples"][0][2] == 2.0
    crash = families[f"{PREFIX}_fleet_replica_failures_total"]["samples"]
    assert [(labels["kind"], v) for _, labels, v in crash] == [("crash", 1.0)]
    states = families[f"{PREFIX}_fleet_replica_state"]["samples"]
    assert {
        (labels["replica"], labels["state"]) for _, labels, _ in states
    } == {("0", "active"), ("1", "draining")}
    paused = families[f"{PREFIX}_fleet_replica_paused"]["samples"]
    assert {
        (labels["replica"], v) for _, labels, v in paused
    } == {("0", 0.0), ("1", 1.0)}
    by_state = families[f"{PREFIX}_fleet_replicas"]["samples"]
    assert {
        (labels["state"], v) for _, labels, v in by_state
    } == {("active", 1.0), ("draining", 1.0), ("dead", 1.0)}
    for fam in (
        f"{PREFIX}_fleet_ttft_seconds",
        f"{PREFIX}_fleet_e2e_seconds",
        f"{PREFIX}_fleet_queue_wait_seconds",
        f"{PREFIX}_fleet_class_ttft_seconds",
        f"{PREFIX}_fleet_class_tpot_seconds",
    ):
        _assert_histogram_sound(fam, families[fam])
    # Per-class attainment counters: every series carries the class
    # label; the cancelled request is excluded, the untagged one never
    # lands in a classed family.
    slo_req = families[f"{PREFIX}_fleet_slo_requests_total"]["samples"]
    assert {
        (labels["slo_class"], v) for _, labels, v in slo_req
    } == {("interactive", 2.0), ("bulk", 1.0)}
    slo_att = families[f"{PREFIX}_fleet_slo_attained_total"]["samples"]
    assert {
        (labels["slo_class"], v) for _, labels, v in slo_att
    } == {("interactive", 1.0), ("bulk", 1.0)}
    burn = families[f"{PREFIX}_fleet_slo_burn_rate"]["samples"]
    assert {
        (labels["slo_class"], v) for _, labels, v in burn
    } == {("interactive", 1.5), ("bulk", 0.0)}
    class_ttft = families[f"{PREFIX}_fleet_class_ttft_seconds"]["samples"]
    assert {
        labels["slo_class"] for _, labels, _ in class_ttft
    } == {"interactive", "bulk"}
    # The span ring filled alongside the registry pushes.
    assert [s.rid for s in obs.spans] == [
        "fr-0", "fr-1", "fr-2", "fr-3", "fr-4",
    ]
    assert obs.drain_spans() and not obs.spans


def test_fleet_spans_record_without_a_registry():
    """--trace-out without --metrics-port: the span ring must fill with
    no registry bound (the merged trace's raw material), bounded with
    counted drops."""
    from workloads_torch.obs import FleetObserver

    obs = FleetObserver(name="f1", span_limit=2)
    fleet = SimpleNamespace(replicas=[], queue=[])
    obs._bind(fleet)
    obs._fleet_step_end(
        fleet, [_fake_fleet_request(f"fr-{i}") for i in range(3)]
    )
    assert [s.rid for s in obs.spans] == ["fr-1", "fr-2"]
    assert obs.dropped_spans == 1


def test_supervisor_bridge_render_is_valid_exposition():
    """Drive the supervisor bridge against a fake supervisor (no jax):
    counters land as running-total deltas (re-polling unchanged totals
    pushes nothing), the slots-by-state gauge emits every state, and
    the restore-time histogram obeys the exposition rules."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import SupervisorObserver

    reg = Registry()
    obs = SupervisorObserver(name="sup0")
    obs.bind_registry(reg)
    sup = SimpleNamespace(
        slots=[
            SimpleNamespace(state="serving"),
            SimpleNamespace(state="backoff"),
            SimpleNamespace(state="quarantined"),
        ],
        restarts_total=2, restart_failures=3, crash_loops=1,
        health_deferrals=0, restore_s=[0.08, 1.4],
    )
    obs._bind(sup)
    obs._supervisor_poll_end(sup)
    obs._supervisor_poll_end(sup)  # unchanged totals push no deltas
    families = _parse_exposition(reg.render())
    assert families[
        f"{PREFIX}_supervisor_restarts_total"
    ]["samples"][0][2] == 2.0
    assert families[
        f"{PREFIX}_supervisor_restart_failures_total"
    ]["samples"][0][2] == 3.0
    assert families[
        f"{PREFIX}_supervisor_crash_loops_total"
    ]["samples"][0][2] == 1.0
    slots = families[f"{PREFIX}_supervisor_slots"]["samples"]
    assert {
        (labels["state"], v) for _, labels, v in slots
    } == {
        ("serving", 1.0), ("backoff", 1.0), ("probing", 0.0),
        ("quarantined", 1.0), ("forgotten", 0.0),
    }
    restore = f"{PREFIX}_supervisor_restore_seconds"
    _assert_histogram_sound(restore, families[restore])
    count = [
        v for name, _, v in families[restore]["samples"]
        if name.endswith("_count")
    ]
    assert count == [2.0]  # both restores observed exactly once
    obs.unbind_registry()
    assert f"{PREFIX}_supervisor_slots" not in _parse_exposition(
        reg.render()
    )


def test_autoscaler_bridge_render_is_valid_exposition():
    """Drive the autoscaler bridge against a fake autoscaler (no jax):
    actuation counters land as running-total deltas, the per-action
    decisions counter carries the action label, and the ladder/target/
    live gauges scrape — then unbind releases the gauges."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import AutoscalerObserver

    reg = Registry()
    obs = AutoscalerObserver(name="asc0")
    obs.bind_registry(reg)
    asc = SimpleNamespace(
        scale_ups=3, scale_downs=1, spawn_failures=2, brownouts=1,
        preemptions_total=4, ladder_level=2, target_replicas=3,
        decisions={"scale_up": 3, "brownout": 1, "preempt": 2},
        fleet=SimpleNamespace(alive=[1, 2]),
    )
    obs._bind(asc)
    obs._autoscaler_poll_end(asc)
    obs._autoscaler_poll_end(asc)  # unchanged totals push no deltas
    families = _parse_exposition(reg.render())
    assert families[
        f"{PREFIX}_autoscaler_scale_ups_total"
    ]["samples"][0][2] == 3.0
    assert families[
        f"{PREFIX}_autoscaler_preemptions_total"
    ]["samples"][0][2] == 4.0
    decisions = families[
        f"{PREFIX}_autoscaler_decisions_total"
    ]["samples"]
    assert {
        (labels["action"], v) for _, labels, v in decisions
    } == {("scale_up", 3.0), ("brownout", 1.0), ("preempt", 2.0)}
    assert families[
        f"{PREFIX}_autoscaler_ladder_level"
    ]["samples"][0][2] == 2.0
    assert families[
        f"{PREFIX}_autoscaler_replicas_target"
    ]["samples"][0][2] == 3.0
    assert families[
        f"{PREFIX}_autoscaler_replicas_live"
    ]["samples"][0][2] == 2.0
    obs.unbind_registry()
    assert f"{PREFIX}_autoscaler_ladder_level" not in _parse_exposition(
        reg.render()
    )


def test_ring_overflow_counters_are_scrapeable():
    """Satellite contract: observer ring evictions (dropped_steps /
    dropped_spans / dropped_events) land on the registry as counters,
    so silent history loss is a scrapeable signal."""
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.obs import EngineObserver, FleetObserver, SupervisorObserver

    reg = Registry()
    obs = EngineObserver(name="tiny", step_limit=1, span_limit=1)
    obs.bind_registry(reg)
    _drive_fake_engine(obs, steps=4)  # 4 steps into a 1-deep ring
    families = _parse_exposition(reg.render())
    drops = families[f"{PREFIX}_engine_observer_dropped_steps_total"]
    assert drops["samples"][0][2] == 3.0
    assert f"{PREFIX}_engine_observer_dropped_spans_total" not in families

    fobs = FleetObserver(name="f0", span_limit=1)
    fobs.bind_registry(reg)
    fleet = SimpleNamespace(
        queue=[], replicas=[], requests_submitted=0, generated_tokens=0,
        failover_requeues=0, drain_requeues=0, queue_rejections=0,
        replica_crashes=0, replica_hangs=0,
        slo_burn_rates=lambda: {},
    )
    fobs._bind(fleet)
    fobs._fleet_step_end(
        fleet, [_fake_fleet_request(f"fr-{i}") for i in range(3)]
    )
    families = _parse_exposition(reg.render())
    fdrops = families[f"{PREFIX}_fleet_observer_dropped_spans_total"]
    assert fdrops["samples"][0][2] == 2.0

    sobs = SupervisorObserver(name="s0")
    sobs.bind_registry(reg)
    sup = SimpleNamespace(
        slots=[], restarts_total=0, restart_failures=0, crash_loops=0,
        health_deferrals=0, restore_s=[], dropped_events=5,
    )
    sobs._bind(sup)
    sobs._supervisor_poll_end(sup)
    sobs._supervisor_poll_end(sup)  # unchanged total pushes no delta
    families = _parse_exposition(reg.render())
    sdrops = families[f"{PREFIX}_supervisor_dropped_events_total"]
    assert sdrops["samples"][0][2] == 5.0


def test_ledger_families_render_as_valid_exposition():
    """Drive the engine bridge over a fake engine carrying a REAL
    ChipTimeLedger (still no jax): the phase/token counter families
    push as deltas, the fraction/pending gauges and the per-class
    waste-seconds gauge scrape, and a ledger-less engine emits no
    ledger series at all."""
    import numpy as np

    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.ledger import ChipTimeLedger, WASTE_CLASSES
    from workloads_torch.obs import EngineObserver

    reg = Registry()
    obs = EngineObserver(name="led")
    obs.bind_registry(reg)
    led = ChipTimeLedger()
    eng = SimpleNamespace(
        generated_tokens=0, requests_admitted=0, requests_retired=0,
        prefill_dispatches=0, prefill_sweeps=0, chunks_run=0, spec_rounds=0,
        mode_switches=0, admission_readbacks=0, spec_lookahead=1,
        prefill_deferred_tokens=0, _inflight_prefill=[],
        pending=[], _occupied=np.zeros(2, bool), slots=2,
        ctrl=SimpleNamespace(used_pages=0), paused=False,
        tokens_overdecoded=0, spec_tokens_rejected=0, tokens_replayed=0,
        preempt_recompute_tokens=0, kv_spill_s=0.0, kv_reload_s=0.0,
        kv_handoff_s=0.0, prefill_tokens=0, superstep_k=1,
        spec_superstep_k=1, host_sync_s=0.0, ledger_phase="serve",
        ledger=led,
    )
    obs._bind(eng)
    finished = SimpleNamespace(
        rid="req-0", t_submit=1.0, t_admit=1.1, t_first=1.5, t_done=3.0,
        tokens=[7] * 6, status="ok",
    )
    for i in range(2):
        lsnap = led.step_begin(eng)
        snap = obs._step_begin(eng)
        eng.generated_tokens += 3
        eng.chunks_run += 1
        if i == 1:
            eng.tokens_replayed += 4
        done = [finished] if i == 1 else []
        led.step_end(eng, lsnap, done)
        obs._step_end(eng, snap, done)
    families = _parse_exposition(reg.render())
    tokens = families[f"{PREFIX}_ledger_tokens_total"]["samples"]
    by_class = {labels["class"]: v for _, labels, v in tokens}
    assert by_class["goodput"] == 6.0
    assert by_class["replay"] == 4.0
    chip = families[f"{PREFIX}_ledger_chip_seconds_total"]["samples"]
    assert {labels["phase"] for _, labels, _ in chip} >= {"decode"}
    assert families[f"{PREFIX}_ledger_pending_tokens"]["samples"][0][2] == 0.0
    frac = families[f"{PREFIX}_ledger_goodput_fraction"]["samples"][0][2]
    assert frac == pytest.approx(6.0 / 10.0)
    waste_s = families[f"{PREFIX}_ledger_waste_chip_seconds"]["samples"]
    assert {labels["class"] for _, labels, _ in waste_s} == set(WASTE_CLASSES)
    # A ledger-less engine emits no ledger SAMPLES (described help
    # text is fine; series are not).
    reg2 = Registry()
    obs2 = EngineObserver(name="bare")
    obs2.bind_registry(reg2)
    _drive_fake_engine(obs2)
    samples = [
        ln for ln in reg2.render().splitlines()
        if not ln.startswith("#") and ln.startswith(f"{PREFIX}_ledger_")
    ]
    assert samples == []


def test_fleet_ledger_families_render_as_valid_exposition():
    from tpu_device_plugin.metrics import PREFIX, Registry
    from workloads_torch.ledger import ChipTimeLedger, FleetLedger
    from workloads_torch.obs import FleetObserver

    reg = Registry()
    obs = FleetObserver(name="fl")
    obs.bind_registry(reg)
    fled = FleetLedger()
    fled.attach("0", ChipTimeLedger())
    fleet = SimpleNamespace(
        queue=[], replicas=[], requests_submitted=2, generated_tokens=9,
        failover_requeues=0, drain_requeues=0, queue_rejections=0,
        replica_crashes=0, replica_hangs=0, tokens_replayed=0,
        slo_burn_rates=lambda: {}, ledger=fled,
    )
    obs._bind(fleet)
    finished = [
        _fake_fleet_request("fr-0", slo_class="interactive",
                            slo_attained=True, n_tokens=6),
        _fake_fleet_request("fr-1", status="failed", slo_class="bulk",
                            n_tokens=3),
    ]
    fled.step_end(fleet, finished)
    obs._fleet_step_end(fleet, finished)
    obs._fleet_step_end(fleet, [])  # unchanged totals push no deltas
    families = _parse_exposition(reg.render())
    tokens = families[f"{PREFIX}_fleet_ledger_tokens_total"]["samples"]
    assert {
        (labels["slo_class"], labels["kind"], v)
        for _, labels, v in tokens
    } == {("interactive", "goodput", 6.0), ("bulk", "waste", 3.0)}
    frac = families[f"{PREFIX}_fleet_ledger_goodput_fraction"]
    assert frac["samples"][0][2] == pytest.approx(6.0 / 9.0)


def test_metrics_http_scrape_sets_prometheus_content_type():
    """HTTP scrape contract: /metrics serves the standard Prometheus
    text exposition content type (``text/plain; version=0.0.4``) — the
    version parameter is what lets scrapers negotiate the format — and
    the body it ships is valid exposition of the bound registry."""
    import urllib.request

    from tpu_device_plugin.metrics import PREFIX, MetricsServer, Registry
    from workloads_torch.obs import EngineObserver

    reg = Registry()
    obs = EngineObserver()
    obs.bind_registry(reg)
    _drive_fake_engine(obs)

    server = MetricsServer(0, reg)  # ephemeral port
    port = server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10
        ) as resp:
            assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
            body = resp.read().decode()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            # /healthz is NOT exposition; it must not claim the format.
            assert resp.headers["Content-Type"] == "text/plain"
    finally:
        server.stop()

    families = _parse_exposition(body)
    assert f"{PREFIX}_engine_decode_steps_total" in families
    for fam, info in families.items():
        if info["type"] == "histogram":
            _assert_histogram_sound(fam, info)
