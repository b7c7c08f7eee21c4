"""The port's phase spans and per-phase device time on the CPU.

``ServeEngine.step`` records ``engine.step`` ⊃ ``engine.admit`` ⊃
``engine.prefill``, ``engine.decode`` around each decode dispatch and
``engine.sync`` around every host sync; the train step records
``train.loss_grad`` then ``train.optimizer``.  The spans change no
token, loss or weight.  With an observer on a card engine each prefill
sweep and decode dispatch is timed by a pair of CUDA events, read at the
host sync that reads its work back; the CPU has no such events, so
stand-ins take their place here and count the syncs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from workloads_torch import prng, serve, train
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.obs import EngineObserver
from workloads_torch.quant import quantize_params
from workloads_torch.serve import ServeEngine

CONFIG = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                     max_seq_len=64, dtype=torch.float32)
ENGINE_KW = dict(slots=2, page_size=4, prompt_bucket=12, chunk=4)
MODES = {
    "pipelined": dict(pipelined=True),
    "superstep": dict(pipelined=True, superstep_k=2),
    "budgeted": dict(pipelined=True, prefill_budget=12),
    "serial": dict(batched_admission=False),
    "spec": dict(pipelined=True, gamma=2),
    "spec_superstep": dict(pipelined=True, gamma=2, spec_superstep_k=2),
}
PHASES = ("engine.step", "engine.admit", "engine.prefill", "engine.decode", "engine.sync")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, prng.PRNGKey(0, device="cpu"))


def requests() -> list[tuple[list[int], int]]:
    """Five requests whose prompts take one to three prefill chunks, more
    than the slots, so admissions wait for retirements."""
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, n).tolist(), int(rng.integers(3, 12)))
            for n in (30, 5, 17, 9, 26)]


def serve_all(params, mode: str, observer=None, setup=None, profiled=False):
    """(token streams, engine, the profiler's events or None) of the
    requests served to the end in ``mode``."""
    draft = ({"draft_params": quantize_params(params), "draft_config": CONFIG}
             if mode.startswith("spec") else {})
    engine = ServeEngine(params, CONFIG, device="cpu", observer=observer,
                         **ENGINE_KW, **MODES[mode], **draft)
    if setup is not None:
        setup(engine)
    rids = [engine.submit(p, n) for p, n in requests()]
    out: dict[str, list[int]] = {}
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.__enter__()
    try:
        for _ in range(200):
            if engine.idle:
                break
            for req in engine.step():
                out[req.rid] = list(req.tokens)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    assert engine.idle
    events = None
    if prof is not None:
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name in PHASES or e.name.startswith("train.")]
    return [out[r] for r in rids], engine, events


@pytest.fixture(scope="module")
def runs(params):
    """Each mode's run with the profiler off and on, made once."""
    made = {}

    def get(mode: str, profiled: bool):
        if (mode, profiled) not in made:
            made[mode, profiled] = serve_all(params, mode, profiled=profiled)
        return made[mode, profiled]

    return get


def spans(events, name):
    return [(a, b) for n, a, b in events if n == name]


def inside(span, outer) -> bool:
    return any(a <= span[0] and span[1] <= b for a, b in outer)


@pytest.mark.parametrize("mode", ["pipelined", "superstep", "budgeted", "spec",
                                  "spec_superstep"])
def test_engine_spans_nest_as_the_phases_do(runs, mode):
    _, engine, events = runs(mode, True)
    step, admit, prefill, decode, sync = (spans(events, n) for n in PHASES)
    assert step and admit and prefill and decode and sync
    assert all(inside(s, step) for s in admit + decode + sync)
    assert all(inside(s, admit) for s in prefill)
    # The first-token readback is a sync inside the admission.
    assert any(inside(s, admit) for s in sync)
    # A decode dispatch ends with its readback copy: no sync inside it.
    assert not any(inside(s, decode) for s in sync)
    # No span nests inside itself, and one engine.step a step.
    for name in PHASES:
        own = spans(events, name)
        assert not any(inside(s, [o for o in own if o != s]) for s in own), name
    assert engine.prefill_sweeps == len(prefill)


def test_no_admission_span_without_work(params):
    """A step with nothing pending and nothing mid-prefill records no
    ``engine.admit``."""
    engine = ServeEngine(params, CONFIG, device="cpu", **ENGINE_KW, pipelined=True)
    engine.submit(list(range(1, 9)), 10)
    engine.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
    names = [e.name for e in prof.events()]
    assert "engine.step" in names and "engine.decode" in names
    assert "engine.admit" not in names and "engine.prefill" not in names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_are_the_same_with_the_profiler_on(runs, mode):
    assert runs(mode, True)[0] == runs(mode, False)[0]


def test_train_step_spans_and_the_same_update(params):
    optimizer = train.AdamW(lr=1e-2)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 17)))

    def one_step(profiled: bool):
        (p, state), _ = train.make_train_state(CONFIG, seed=5, device="cpu",
                                               optimizer=optimizer)
        step = train.make_train_step(CONFIG, optimizer)
        if not profiled:
            return step(p, state, tokens), None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = step(p, state, tokens)
        return out, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.name.startswith("train.")]

    (p0, s0, loss0), _ = one_step(False)
    (p1, s1, loss1), events = one_step(True)
    grad, opt = spans(events, "train.loss_grad"), spans(events, "train.optimizer")
    assert len(grad) == 1 and len(opt) == 1
    assert grad[0][1] <= opt[0][0]
    assert torch.equal(loss0, loss1)
    for a, b in zip(train.tree_leaves(p0), train.tree_leaves(p1), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(train.tree_leaves(s0["nu"]), train.tree_leaves(s1["nu"]), strict=True):
        assert torch.equal(a, b)


# ---- per-phase device time, with stand-in events ----------------------


class StandInClock:
    """Timing events for a CPU engine.  Each records the step it was
    recorded in and the host syncs made by then; ``elapsed_time`` refuses
    a pair whose end no sync has read since, and gives ``step + 1`` ms for
    a pair started in ``step``, so a record shows whose work it read."""

    def __init__(self):
        self.step = 0
        self.syncs = 0
        self.made = 0

    def event(self):
        self.made += 1
        return StandInEvent(self)

    def count_syncs(self, engine) -> None:
        host_sync = engine._host_sync

        def counted(fetch):
            out = host_sync(fetch)
            self.syncs += 1
            return out

        engine._host_sync = counted


class StandInEvent:
    def __init__(self, clock: StandInClock):
        self.clock = clock
        self.step = self.syncs = None

    def record(self):
        self.step, self.syncs = self.clock.step, self.clock.syncs

    def elapsed_time(self, end: "StandInEvent") -> float:
        assert end.syncs is not None and self.clock.syncs > end.syncs, \
            "a pair read before a sync read its work back"
        assert end.step >= self.step
        return float(self.step + 1)


def timed_engine(params, clock, mode="pipelined", **kw):
    obs = EngineObserver()
    engine = ServeEngine(params, CONFIG, device="cpu", observer=obs,
                         **{**ENGINE_KW, **MODES[mode], **kw})
    engine._phase_event = clock.event
    clock.count_syncs(engine)
    return engine, obs


def test_a_pair_is_read_only_after_its_sync_and_adds_none(params):
    clock = StandInClock()

    def setup(engine):
        engine._phase_event = clock.event
        clock.count_syncs(engine)

    timed, engine, _ = serve_all(params, "pipelined", EngineObserver(), setup)
    plain = StandInClock()
    untimed, bare, _ = serve_all(params, "pipelined", None, plain.count_syncs)
    assert timed == untimed
    # Two events a sweep and a decode dispatch; syncs as without them.
    assert clock.made == 2 * (engine.prefill_sweeps + engine.chunks_run)
    assert clock.syncs == plain.syncs and plain.made == 0
    assert bare._phase_event is None and bare.decode_device_s == 0.0


def test_a_pipelined_chunk_lands_on_the_next_record(params):
    clock = StandInClock()
    engine, obs = timed_engine(params, clock)
    for prompt, n in requests():
        engine.submit(prompt, n)
    dispatched = {}
    while not engine.idle:
        clock.step = len(obs.steps)
        chunks = engine.chunks_run
        engine.step()
        dispatched[clock.step] = engine.chunks_run - chunks
    records = list(obs.steps)
    for rec in records:
        # The chunk a record reads is the one the step before dispatched.
        want = rec.index if dispatched.get(rec.index - 1) else 0.0
        assert rec.decode_device_ms == want, rec
        # A sweep is read back by the first-token readback of its step.
        assert rec.prefill_device_ms % (rec.index + 1) == 0
        assert rec.device_ms == pytest.approx(rec.prefill_device_ms + rec.decode_device_ms)
    assert sum(r.decode_device_ms for r in records) == sum(
        i + 1 for i, n in dispatched.items() if n)
    assert engine.decode_device_s == pytest.approx(
        sum(r.decode_device_ms for r in records) / 1000.0)
    assert obs.device_busy_fraction > 0.0


@pytest.mark.parametrize("mode", ["superstep", "budgeted"])
def test_every_pair_is_read_in_other_modes(params, mode):
    clock = StandInClock()
    engine, obs = timed_engine(params, clock, mode)
    for prompt, n in requests():
        engine.submit(prompt, n)
    while not engine.idle:
        clock.step = len(obs.steps)
        engine.step()
    records = list(obs.steps)
    dispatches = engine.chunks_run // engine.superstep_k
    assert clock.made == 2 * (engine.prefill_sweeps + dispatches)
    assert not engine._prefill_phases
    assert sum(r.device_ms for r in records) == pytest.approx(
        1000.0 * (engine.prefill_device_s + engine.decode_device_s))


def test_no_event_without_an_observer_or_a_card(params, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(k))
    serve_all(params, "pipelined")
    serve_all(params, "pipelined", EngineObserver())
    assert made == []
    engine = ServeEngine(params, CONFIG, device="cpu", **ENGINE_KW)
    assert engine._phase_event is None and engine._phase_start() is None
    assert engine._phase_end(None) is None
    assert serve._phase_events(None, torch.device("cuda")) is None
    assert serve._phase_events(EngineObserver(), torch.device("cpu")) is None
    assert serve._phase_events(EngineObserver(), torch.device("cuda")) is not None


def test_cpu_engines_keep_wall_less_host_syncs(params):
    obs = EngineObserver()
    serve_all(params, "pipelined", obs)
    records = list(obs.steps)
    assert any(r.device_ms > 0 for r in records)
    for rec in records:
        assert rec.prefill_device_ms == 0.0 and rec.decode_device_ms == 0.0
        if rec.mode == "idle" and rec.prefill_dispatches == 0:
            assert rec.device_ms == 0.0
        else:
            want = max(rec.dur_secs * 1000.0 - rec.host_sync_ms, 0.0)
            assert rec.device_ms == pytest.approx(want, abs=2e-3)
