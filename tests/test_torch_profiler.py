"""Device-time profiling & regression sentry units, ported from the
JAX package's tests/test_profiler.py and tests/test_profile_capture.py
to workloads_torch/profiler.py on the CPU.

The sentry fires EXACTLY ONE perf_regression trigger per incident
under a scripted regression on a fake clock, re-arms after recovery,
and stays quiet under baseline noise at the committed artifact's own
spread (the port's docs/bench-torch-latest.json); the DeviceTimeTable
round-trips its calibration; the chrome-trace validator rejects empty
traces and pid/tid lane collisions across replicas; FleetServer's
/profile endpoints translate the session's refusals.  The capture
tests drive a real torch.profiler capture (CPU activities): a served
engine's trace lands on disk with its bytes accounted, and a capture
started on one thread and stopped on another records the operators a
third thread ran.
"""

import json
import os
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"),
)

from workloads_torch import prng
from workloads_torch.profiler import (  # noqa: E402
    DeviceTimeTable,
    ProfileSession,
    RegressionSentry,
    SentryFeed,
    artifact_spread_fraction,
    device_report,
    load_committed_artifact,
    sentry_from_artifact,
    _pow2_bucket,
)

from postmortem import validate_file  # noqa: E402
from trace_export import validate_trace  # noqa: E402
from tests.test_torch_superstep import one_torch_thread  # noqa: E402,F401


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def advance(self, secs: float) -> None:
        self.t += secs


# ---- device-time attribution table --------------------------------------


def test_pow2_bucketing():
    assert [_pow2_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [
        0, 1, 2, 4, 8, 8, 16,
    ]
    assert DeviceTimeTable.key("plain", 5, 3) == "plain|s8|b4"


def test_device_table_observe_estimate_and_roundtrip():
    table = DeviceTimeTable(alpha=0.5)
    table.observe("plain", 8, 4, 10.0)
    table.observe("plain", 8, 4, 20.0)  # EWMA: 10 + 0.5*(20-10) = 15
    assert table.estimate("plain", 8, 4) == pytest.approx(15.0)
    # Unknown bucket of a KNOWN program falls back to the nearest
    # same-program entry (a coarse prior beats attributing nothing)...
    assert table.estimate("plain", 64, 1) == pytest.approx(15.0)
    # ...but never crosses programs.
    assert table.estimate("spec", 8, 4) is None
    # JSON round-trip; existing live entries win over persisted ones.
    table2 = DeviceTimeTable()
    table2.observe("plain", 8, 4, 99.0)
    adopted = table2.load(json.loads(json.dumps(table.to_dict())))
    assert adopted == 0
    assert table2.estimate("plain", 8, 4) == pytest.approx(99.0)
    table3 = DeviceTimeTable()
    assert table3.load(table.to_dict()) == len(table)
    assert table3.estimate("plain", 8, 4) == pytest.approx(15.0)
    # Artifact refresh reads the measure_profiler key.
    table4 = DeviceTimeTable()
    n = table4.refresh_from_artifact(
        {"profiler_device_time_table": table.to_dict()}
    )
    assert n == len(table) and len(table4) == len(table)
    # Negative samples and malformed entries are ignored.
    table4.observe("plain", 8, 4, -1.0)
    assert table4.load({"bad": "nope", "worse": {"ms": -3}}) == 0


# ---- profile session budgets (the capture itself: the end of this file) --


def test_profile_session_validates_budgets(tmp_path):
    with pytest.raises(ValueError):
        ProfileSession(str(tmp_path), max_secs=0)
    with pytest.raises(ValueError):
        ProfileSession(str(tmp_path), max_bytes=0)
    sess = ProfileSession(str(tmp_path), max_secs=5.0, max_bytes=1024)
    assert not sess.active and sess.bytes_spent == 0
    state = sess.state()
    assert state["active"] is False and state["captures"] == []
    # A spent disk budget refuses the NEXT capture before any profiler
    # starts — the budget check runs first.
    sess.captures.append({"dir": "x", "secs": 1.0, "bytes": 2048})
    with pytest.raises(RuntimeError, match="disk budget"):
        sess.start(1.0)
    assert sess.stop() is None  # idempotent when nothing is active


# ---- regression sentry ---------------------------------------------------


def _scripted(sentry, name, values):
    incidents = []
    for v in values:
        inc = sentry.observe(name, v)
        if inc:
            incidents.append(inc)
    return incidents


def test_sentry_scripted_regression_fires_exactly_once():
    clock = FakeClock()
    sentry = RegressionSentry(
        z_threshold=4.0, alpha=0.5, confirm=3, rearm=5, clock=clock,
    )
    sentry.watch("tokens_per_sec", 100.0, 2.0, direction="down_bad")
    # In-band noise: no breach.
    assert _scripted(sentry, "tokens_per_sec",
                     [101.0, 99.0, 100.5, 98.5, 101.5]) == []
    assert sentry.armed and sentry.fired == 0
    # Sustained collapse: one confirmed incident, then the latch holds
    # however long the regression persists.
    incidents = _scripted(sentry, "tokens_per_sec", [20.0] * 10)
    assert len(incidents) == 1
    assert sentry.fired == 1 and not sentry.armed
    assert incidents[0]["signal"] == "tokens_per_sec"
    assert incidents[0]["z"] >= 4.0
    state = sentry.state()
    assert state["fired"] == 1 and state["armed"] is False
    assert state["detectors"]["tokens_per_sec"]["breaches"] >= 3
    assert state["recent"], "observations must land in the history ring"


def test_sentry_recovery_rearms_and_second_incident_fires():
    sentry = RegressionSentry(
        z_threshold=4.0, alpha=1.0, confirm=2, rearm=3,
        clock=FakeClock(),
    )
    sentry.watch("ttft_p99_ms", 50.0, 2.0, direction="up_bad")
    assert len(_scripted(sentry, "ttft_p99_ms", [500.0] * 4)) == 1
    assert not sentry.armed
    # Recovery: `rearm` consecutive in-band reads clear the breach
    # counter and re-arm the sentry...
    assert _scripted(sentry, "ttft_p99_ms", [50.0, 51.0, 49.0]) == []
    assert sentry.armed
    # ...so the NEXT regression is its own incident.
    assert len(_scripted(sentry, "ttft_p99_ms", [400.0] * 4)) == 1
    assert sentry.fired == 2


def test_sentry_self_baselines_in_live_mode():
    sentry = RegressionSentry(
        z_threshold=4.0, alpha=1.0, confirm=2, rearm=3,
        clock=FakeClock(),
    )
    # baseline=None + relative spread: the live-fleet mode.  The first
    # `warmup` samples fix the operating point (no scoring yet).
    sentry.watch("tokens_per_sec", None, 0.05, direction="down_bad",
                 warmup=4)
    assert _scripted(sentry, "tokens_per_sec",
                     [200.0, 202.0, 198.0, 200.0]) == []
    det = sentry.state()["detectors"]["tokens_per_sec"]
    assert det["baseline"] == pytest.approx(200.0)
    assert det["spread"] == pytest.approx(10.0)  # 0.05 * 200
    assert _scripted(sentry, "tokens_per_sec", [199.0, 201.0]) == []
    assert len(_scripted(sentry, "tokens_per_sec", [100.0] * 3)) == 1


def test_sentry_bad_watch_args_raise():
    sentry = RegressionSentry()
    with pytest.raises(ValueError):
        sentry.watch("x", 1.0, 0.0)
    with pytest.raises(ValueError):
        sentry.watch("x", 1.0, 1.0, direction="sideways_bad")
    with pytest.raises(ValueError):
        RegressionSentry(z_threshold=0)
    with pytest.raises(ValueError):
        RegressionSentry(confirm=0)
    # Unwatched signals are ignored, not errors: the feed may offer
    # more signals than the artifact could anchor.
    assert sentry.observe("unwatched", 1.0) is None


def test_sentry_quiet_under_committed_artifact_noise():
    """The no-false-positive pin from the acceptance criteria: a sentry
    built from the COMMITTED artifact must not fire when fed its own
    baselines jittered within the artifact's measured spread."""
    artifact = load_committed_artifact()
    assert artifact, "docs/bench-torch-latest.json must exist"
    sentry = sentry_from_artifact(artifact, clock=FakeClock())
    assert sentry.signals, (
        "committed artifact must anchor at least one sentry signal"
    )
    rel = artifact_spread_fraction(artifact)
    baselines = {
        name: sentry.state()["detectors"][name]["baseline"]
        for name in sentry.signals
    }
    for i in range(200):
        for name in sentry.signals:
            jitter = 0.9 * rel * baselines[name] * (1 if i % 2 else -1)
            sentry.observe(name, baselines[name] + jitter)
    assert sentry.fired == 0 and sentry.armed, sentry.state()


def test_artifact_spread_fraction_derivation():
    art = {
        "a": 100.0, "a_min": 90.0, "a_max": 110.0, "a_samples": [1],
        "b": 10.0, "b_min": 9.0, "b_max": 11.0, "b_samples": [1],
    }
    assert artifact_spread_fraction(art) == pytest.approx(0.10)
    # Artifacts predating the samples families get the floor.
    assert artifact_spread_fraction({}, floor=0.08) == 0.08


def test_sentry_from_artifact_degrades_on_missing_keys():
    sentry = sentry_from_artifact({"serve_ttft_p99_ms": 12.0})
    assert sentry.signals == ("ttft_p99_ms",)
    # tokens_per_sec falls back to serve_tokens_per_sec when the
    # profiler arm hasn't published yet.
    sentry = sentry_from_artifact({"serve_tokens_per_sec": 500.0})
    assert sentry.signals == ("tokens_per_sec",)
    assert sentry_from_artifact({}).signals == ()


# ---- sentry -> flight recorder: the perf_regression bundle ---------------


def test_scripted_regression_dumps_exactly_one_validating_bundle(tmp_path):
    from workloads_torch.ledger import FlightRecorder

    rec = FlightRecorder(out_dir=str(tmp_path), name="sentrytest")
    sentry = RegressionSentry(
        z_threshold=4.0, alpha=1.0, confirm=3, rearm=4,
        clock=FakeClock(),
    )
    rec.attach_sentry(sentry)
    assert sentry.recorder is rec
    sentry.watch("tokens_per_sec", 100.0, 2.0, direction="down_bad")
    _scripted(sentry, "tokens_per_sec", [100.0, 99.5] + [15.0] * 8)
    bundles = [p for p in rec.dumped if "perf_regression" in p]
    assert len(bundles) == 1 and len(rec.dumped) == 1
    errors = validate_file(bundles[0])
    assert errors == [], errors
    obj = json.load(open(bundles[0]))
    assert obj["trigger"]["kind"] == "perf_regression"
    # The bundle embeds the detector state — the postmortem reader must
    # see WHAT the sentry believed when it fired.
    assert obj["sentry"]["fired"] == 1
    assert obj["sentry"]["detectors"]["tokens_per_sec"]["breaches"] >= 3
    assert obj["sentry"]["incidents"][0]["signal"] == "tokens_per_sec"


def test_perf_regression_bundle_without_sentry_state_fails_validation(
    tmp_path,
):
    from workloads_torch.ledger import FlightRecorder
    from postmortem import validate_bundle

    rec = FlightRecorder(out_dir=str(tmp_path), name="nostate")
    path = rec.trigger("perf_regression", detail="hand-rolled")
    obj = json.load(open(path))
    obj.pop("sentry", None)
    errors = validate_bundle(obj)
    assert any("sentry" in e for e in errors), errors


# ---- observer-side attribution + fleet report ---------------------------


def _drive_observed_engine(obs, steps=3):
    import numpy as np

    eng = SimpleNamespace(
        generated_tokens=0, requests_admitted=0, requests_retired=0,
        prefill_dispatches=0, prefill_sweeps=0, chunks_run=0,
        spec_rounds=0, mode_switches=0, admission_readbacks=0,
        spec_lookahead=1, prefill_deferred_tokens=0, host_sync_s=0.0,
        _inflight_prefill=[], pending=[], _occupied=np.ones(2, bool),
        slots=2, ctrl=SimpleNamespace(used_pages=0), paused=False,
    )
    obs._bind(eng)
    for _ in range(steps):
        snap = obs._step_begin(eng)
        eng.generated_tokens += 4
        eng.chunks_run += 1
        obs._step_end(eng, snap, [])
    return eng


def test_observer_attributes_device_time_and_reports():
    from workloads_torch.obs import EngineObserver

    table = DeviceTimeTable()
    obs = EngineObserver(device_table=table)
    _drive_observed_engine(obs, steps=4)
    assert len(table) > 0
    recs = list(obs.steps)
    assert all(r.device_ms >= 0.0 for r in recs)
    assert any(r.device_ms > 0.0 for r in recs)
    assert 0.0 < obs.device_busy_fraction <= 1.0
    assert obs.host_stall_fraction == pytest.approx(
        1.0 - obs.device_busy_fraction
    )
    report = device_report([obs, None])
    assert 0.0 < report["device_busy_fraction"] <= 1.0
    assert report["device_busy_fraction"] + report[
        "host_stall_fraction"
    ] == pytest.approx(1.0)
    assert "plain" in report["phases"]
    assert report["phases"]["plain"]["steps"] == 4
    # device_ms is a table-smoothed ESTIMATE, so a single µs-scale fake
    # step may estimate past its own wall — the published fractions are
    # clamped instead of asserting per-step wall >= device.
    assert report["wall_ms"] > 0.0 and report["device_ms"] > 0.0
    # Empty observers report a clean zero, not a division error.
    assert device_report([])["device_busy_fraction"] == 0.0


def test_sentry_feed_extracts_windowed_signals():
    from workloads_torch.obs import EngineObserver

    clock = FakeClock()
    sentry = RegressionSentry(
        z_threshold=4.0, alpha=1.0, confirm=2, rearm=3, clock=clock,
    )
    for name, direction in (
        ("tokens_per_sec", "down_bad"),
        ("host_sync_ms", "up_bad"),
        ("device_busy_fraction", "down_bad"),
    ):
        sentry.watch(name, None, 0.25, direction=direction, warmup=2)
    feed = SentryFeed(sentry, min_window_s=0.5, clock=clock)
    obs = EngineObserver(device_table=DeviceTimeTable())
    eng = _drive_observed_engine(obs, steps=2)
    feed.attach(eng, obs)
    assert feed.poll() == []  # first poll only anchors the window
    clock.advance(0.1)
    assert feed.poll() == []  # sub-window polls are free early-returns
    detectors = sentry.state()["detectors"]
    assert detectors["tokens_per_sec"]["samples"] == 0
    for _ in range(4):
        clock.advance(1.0)
        eng.generated_tokens += 10
        eng.host_sync_s += 0.002
        snap = obs._step_begin(eng)
        eng.chunks_run += 1
        obs._step_end(eng, snap, [])
        feed.poll()
    detectors = sentry.state()["detectors"]
    assert detectors["tokens_per_sec"]["samples"] == 4
    assert detectors["host_sync_ms"]["samples"] == 4
    assert detectors["device_busy_fraction"]["samples"] == 4
    assert sentry.fired == 0  # a steady fake load is not a regression


# ---- chrome-trace validator regressions ---------------------------------


def _meta(pid, tid, name, label):
    return {"ph": "M", "name": name, "pid": pid, "tid": tid,
            "args": {"name": label}}


def _valid_trace():
    return {"traceEvents": [
        _meta(1, 0, "process_name", "requests"),
        _meta(2, 0, "process_name", "engine"),
        _meta(2, 1, "thread_name", "step()"),
        _meta(2, 2, "thread_name", "device"),
        {"ph": "X", "name": "step 0", "pid": 2, "tid": 1,
         "ts": 0, "dur": 5},
        {"ph": "X", "name": "device[plain]", "pid": 2, "tid": 2,
         "ts": 0, "dur": 3},
    ]}


def test_trace_validator_accepts_device_lanes():
    assert validate_trace(_valid_trace()) == []


def test_trace_validator_rejects_empty_traces():
    errors = validate_trace({"traceEvents": []})
    assert any("empty" in e.lower() for e in errors), errors


def test_trace_validator_rejects_cross_replica_lane_collisions():
    # Two replicas merged onto the SAME pid with different labels: the
    # rebase-by-replica-index contract broke, and chrome would silently
    # interleave their lanes.
    trace = _valid_trace()
    trace["traceEvents"].append(
        _meta(2, 0, "process_name", "replica 1 engine")
    )
    errors = validate_trace(trace)
    assert any("pid" in e and "collision" in e for e in errors), errors
    # Same pid/tid pair renamed: a thread-lane collision.
    trace2 = _valid_trace()
    trace2["traceEvents"].append(_meta(2, 2, "thread_name", "steps"))
    errors2 = validate_trace(trace2)
    assert any("tid" in e and "collision" in e for e in errors2), errors2
    # Re-declaring the SAME label is idempotent, not a collision (the
    # single-engine export emits metadata once per lane per export).
    trace3 = _valid_trace()
    trace3["traceEvents"].append(_meta(2, 2, "thread_name", "device"))
    assert validate_trace(trace3) == []


# --------------------------------------------------------------------
# FleetServer /profile endpoints (workloads_torch/fleet.py), via a
# duck-typed ProfileSession stub — the handler's contract is "translate
# the session's refusals to HTTP", so the stub only needs to refuse the
# way the real one does (RuntimeError -> 409, ValueError -> 400).


class _StubFleet:
    """Just enough Fleet for FleetServer's driver thread to idle."""

    closed = False
    replicas = ()
    queue_depth = 0

    def serve_forever(self, stop):
        stop.wait()


class _StubProfiler:
    def __init__(self):
        self.active = False
        self.calls = []

    def start(self, secs=None):
        self.calls.append(("start", secs))
        if secs is not None and secs <= 0:
            raise ValueError(f"secs must be > 0, got {secs}")
        if self.active:
            raise RuntimeError("a capture is already active")
        self.active = True
        return {"dir": "/tmp/p/profile-000", "secs": secs or 30.0}

    def stop(self):
        self.calls.append(("stop", None))
        if not self.active:
            return None
        self.active = False
        return {"dir": "/tmp/p/profile-000", "bytes": 7}

    def state(self):
        return {"active": self.active, "captures": []}


def _http(method, port, path):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=b"" if method == "POST" else None,
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_profile_endpoints_drive_the_armed_session():
    from workloads_torch.fleet import FleetServer

    profiler = _StubProfiler()
    server = FleetServer(_StubFleet(), 0, profiler=profiler)
    port = server.start()
    try:
        # start -> capture opens; a second start is refused with 409.
        code, body = _http("POST", port, "/profile?secs=5")
        assert code == 200 and body["ok"] and body["secs"] == 5.0
        code, body = _http("POST", port, "/profile")
        assert code == 409 and "active" in body["error"]
        # state rides GET; stop closes and returns the capture record.
        code, body = _http("GET", port, "/profile")
        assert code == 200 and body["active"]
        code, body = _http("POST", port, "/profile/stop")
        assert code == 200 and body["capture"]["bytes"] == 7
        code, body = _http("POST", port, "/profile/stop")
        assert code == 409 and "no capture" in body["error"]
        # Malformed secs dies in the handler, before the session.
        n_calls = len(profiler.calls)
        code, body = _http("POST", port, "/profile?secs=abc")
        assert code == 400 and "secs" in body["error"]
        assert len(profiler.calls) == n_calls
        # Non-positive secs: the session's ValueError surfaces as 400.
        code, body = _http("POST", port, "/profile?secs=0")
        assert code == 400
    finally:
        server.stop()


def test_fleet_profile_endpoints_409_when_unarmed():
    from workloads_torch.fleet import FleetServer

    server = FleetServer(_StubFleet(), 0)  # no --profile-dir
    port = server.start()
    try:
        code, body = _http("POST", port, "/profile?secs=5")
        assert code == 409 and "--profile-dir" in body["error"]
    finally:
        server.stop()


# ---- real captures (tests/test_profile_capture.py, on the CPU) ----------


_CAPTURE_STREAM = (([1, 2, 3], 6), ([4, 5], 4), ([7, 8, 9], 3))


@pytest.fixture(scope="module")
def capture_params():
    import torch

    from workloads_torch.model import ModelConfig, init_params

    config = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
    return init_params(config, prng.PRNGKey(0, device="cpu")), config


def _run_observed(capture_params, obs):
    from workloads_torch.serve import ServeEngine

    params, config = capture_params
    engine = ServeEngine(
        params=params, config=config, slots=2, page_size=4,
        prompt_bucket=8, observer=obs, device="cpu",
    )
    rids = [engine.submit(p, n) for p, n in _CAPTURE_STREAM]
    out = engine.run()
    return [list(out[r]) for r in rids]


def test_profile_capture_smoke(tmp_path, capture_params, one_torch_thread):
    """A seeded serve loop runs inside a bounded ProfileSession and the
    dump lands on disk; the single-engine chrome trace AND the 2-replica
    merged fleet trace carry device lanes and pass the validator."""
    from workloads_torch.obs import EngineObserver, fleet_trace_events, trace_events

    out_dir = str(tmp_path / "profiles")
    profiler = ProfileSession(out_dir, max_secs=60.0)
    obs0 = EngineObserver(
        name="r0", replica="0", device_table=DeviceTimeTable()
    )
    started = profiler.start()
    assert profiler.active
    streams0 = _run_observed(capture_params, obs0)
    capture = profiler.stop()
    assert not profiler.active

    # The dump exists on disk and the session accounted its bytes.
    assert capture is not None and capture["dir"] == started["dir"]
    dumped = [
        os.path.join(root, fn)
        for root, _, fns in os.walk(capture["dir"]) for fn in fns
    ]
    assert dumped, "the torch.profiler capture must leave files on disk"
    assert capture["bytes"] > 0
    assert profiler.bytes_spent == capture["bytes"]
    assert profiler.state()["captures"] == [capture]
    with open(os.path.join(capture["dir"], "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(names)[:20]

    # The profiled run still served its tokens, and the device table
    # calibrated from the real dispatch cadence.
    assert all(streams0)
    assert len(obs0.device_table) > 0
    assert 0.0 < obs0.device_busy_fraction <= 1.0
    report = device_report([obs0])
    assert 0.0 < report["device_busy_fraction"] <= 1.0

    # Single-engine trace: device lane declared and populated.
    trace = trace_events(obs0)
    assert validate_trace(trace) == []
    device_events = [
        ev for ev in trace["traceEvents"]
        if ev["ph"] == "X" and ev["name"].startswith("device[")
    ]
    assert device_events, "attributed steps must land on the device lane"
    assert all(ev["pid"] == 2 and ev["tid"] == 2 for ev in device_events)

    # Merged 2-replica fleet trace: each replica keeps its own device
    # lane after the pid rebase, and the merge validates end to end
    # through the same file path the serve CLI writes.
    obs1 = EngineObserver(
        name="r1", replica="1", device_table=DeviceTimeTable()
    )
    streams1 = _run_observed(capture_params, obs1)
    assert streams1 == streams0  # same seeded stream on both replicas
    merged = fleet_trace_events(None, [obs0, obs1])
    path = str(tmp_path / "merged-trace.json")
    with open(path, "w") as f:
        json.dump(merged, f)
    from trace_export import validate_file

    assert validate_file(path) == []
    device_lanes = {
        ev["pid"] for ev in merged["traceEvents"]
        if ev["ph"] == "X" and ev["name"].startswith("device[")
    }
    assert len(device_lanes) == 2, (
        "both replicas must keep a device lane after the merge"
    )

    # A second capture into the same session stacks its budget.
    profiler.start(secs=5.0)
    second = profiler.stop()
    assert second is not None and len(profiler.captures) == 2
    assert profiler.bytes_spent >= capture["bytes"]


def test_capture_started_and_stopped_off_the_working_thread(tmp_path):
    """The fleet's shape: a handler thread starts the capture, the
    driver thread runs the work, another thread (the auto-stop timer or
    a second handler) stops it.  The trace holds the driver thread's
    operators, and the session is inactive and reusable after."""
    import threading

    import torch

    sess = ProfileSession(str(tmp_path), max_secs=30.0)
    x = torch.randn(64, 64)
    starter = threading.Thread(target=sess.start)
    starter.start()
    starter.join(timeout=30)
    assert not starter.is_alive() and sess.active

    def work():
        for _ in range(3):
            torch.mm(x, x)

    driver = threading.Thread(target=work)
    driver.start()
    driver.join(timeout=30)
    got = []
    stopper = threading.Thread(target=lambda: got.append(sess.stop()))
    stopper.start()
    stopper.join(timeout=60)
    assert not stopper.is_alive() and not sess.active
    (rec,) = got
    with open(os.path.join(rec["dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(1 for ev in events if ev.get("name") == "aten::mm") == 3
    assert rec["bytes"] == sess.bytes_spent > 0


def test_auto_stop_timer_ends_a_capture(tmp_path):
    """``secs`` arms the auto-stop timer: the capture ends on the
    timer's thread and is accounted without a caller's stop()."""
    import time as _time

    sess = ProfileSession(str(tmp_path), max_secs=30.0)
    sess.start(secs=0.2)
    deadline = _time.monotonic() + 30.0
    while not sess.captures and _time.monotonic() < deadline:
        _time.sleep(0.05)
    assert not sess.active and len(sess.captures) == 1
    assert sess.captures[0]["bytes"] > 0
    assert sess.stop() is None


def test_load_committed_artifact_reads_the_ports_own(tmp_path):
    """The sentry's artifact is docs/bench-torch-latest.json, never the
    JAX package's docs/bench-builder-latest.json (a TPU's numbers):
    with only the latter present there is no artifact; a torn file
    reads as none."""
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "bench-builder-latest.json").write_text('{"serve_tokens_per_sec": 1.0}')
    assert load_committed_artifact(str(tmp_path)) is None
    (docs / "bench-torch-latest.json").write_text("{torn")
    assert load_committed_artifact(str(tmp_path)) is None
    (docs / "bench-torch-latest.json").write_text('{"serve_tokens_per_sec": 2.0}')
    assert load_committed_artifact(str(tmp_path)) == {"serve_tokens_per_sec": 2.0}


# ---- the serve CLI's --profile-dir (workloads_torch/serve.py) ------------


def test_cli_single_engine_profiles_its_timed_loop(tmp_path, capsys, one_torch_thread):
    """``--profile-dir`` captures the timed loop into profile-000 and the
    observer's device-time table reports the split."""
    from workloads_torch.serve import main

    prof = tmp_path / "prof"
    assert main([
        "--device", "cpu", "--requests", "4", "--slots", "2", "--prompt-len", "8",
        "--max-new-tokens", "8", "--profile-dir", str(prof),
        "--trace-out", str(tmp_path / "t.json"),
    ]) == 0
    out = capsys.readouterr().out
    assert f"-> {prof / 'profile-000'}" in out and "profile: " in out
    assert (prof / "profile-000" / "trace.json").stat().st_size > 0
    assert "device: busy_fraction=" in out and "table_entries=" in out


def test_cli_fleet_arms_profile_and_sentry(tmp_path, capsys, one_torch_thread):
    """``--fleet 2 --profile-dir`` without an HTTP front end captures the
    fleet loop; ``--postmortem-dir`` arms the live sentry from the
    committed artifact and reports it; every replica reports its device
    split; ``--compile-cache-dir`` points the kernel-build cache."""
    import workloads_torch.faststart as faststart
    from workloads_torch.ops import _build
    from workloads_torch.serve import main

    build_dir, cache_dir = _build.BUILD_DIR, faststart._cache_dir
    try:
        assert main([
            "--device", "cpu", "--requests", "6", "--slots", "2", "--prompt-len", "8",
            "--max-new-tokens", "6", "--temperature", "0", "--fleet", "2",
            "--profile-dir", str(tmp_path / "prof"),
            "--postmortem-dir", str(tmp_path / "pm"),
            "--compile-cache-dir", str(tmp_path / "kc"),
        ]) == 0
        assert faststart.compile_cache_dir() == str(tmp_path / "kc")
    finally:
        _build.set_build_dir(build_dir)
        faststart._cache_dir = cache_dir
    out = capsys.readouterr().out
    assert "compile cache: " in out
    assert "profile: " in out and (tmp_path / "prof" / "profile-000" / "trace.json").exists()
    assert "device: busy_fraction=" in out
    assert "sentry armed: watching" in out and "sentry: armed=" in out
