"""The port's speculative decoding (workloads_torch: the paged spec round,
lookahead and chained spec supersteps, spec="auto", the int8 draft, the
draft halves of the KV hierarchy) on the CPU.

torch, numpy and the port only, so it runs in the fast tier.  Two
parts, both against outputs frozen from the JAX package in
tests/test_torch_spec_golden.npz (written by ``write_spec_goldens()`` in
tests/test_torch_parity.py):

* scripted, clock-free engine runs (``golden_runs``) at the tiny GQA
  width in float32, greedy, with an int8 self-draft at gamma 3: a stream
  of six requests (three retire on eos) in ten speculative decode modes
  (spec on, ``spec_lookahead`` 2 and 3, ``spec_superstep_k`` 2 and 3,
  each plain and pipelined) crossed with batched, serial and budgeted
  admission; an int8 target drafting for itself and a one-layer draft;
  and in five of the modes: ``spec="auto"`` at an injected break-even of
  1 and 2 over changing occupancy and with an injected calibration, the
  radix cache with the host tier under pool pressure over three turns
  (draft halves spilled and reloaded), fan-out, a fault at ``spec_dispatch`` and at
  ``spec_readback`` with replay, a cancel with the dispatch in flight, a
  preempt park and an export/import between two spec engines; and a
  retune walk of the spec knobs.  Greedy streams, terminal statuses, the
  auto-mode trace and every step's counters (``SPEC_COUNTERS``) must be
  equal;
* unit goldens at float32 with tests/test_torch_golden.py's tolerance
  (atol = rtol = 1e-4): ``_rowwise_block_core``'s logits and written
  pages (padding redirected to the trash page), ``_spec_round_core``'s
  committed tokens, n and both pools, and ``speculative_generate``'s
  tokens and rounds.

The JAX package's contracts for these modules, ported, are in
tests/test_torch_spec_contracts.py.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

from tests.test_torch_golden import F32_TOL, GOLDEN, params_to_torch, tiny_config
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import paged as tpaged
from workloads_torch.faults import FaultInjector
from workloads_torch.quant import quantize_params
from workloads_torch.serve import ServeEngine
from workloads_torch.speculative import speculative_generate

SPEC_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "test_torch_spec_golden.npz")
SPEC_CASE = ("f32", 2, None)
SPEC_KW = dict(slots=2, page_size=4, prompt_bucket=8, chunk=4, gamma=3)
DECODE = {
    "on": {},
    "on_piped": {"pipelined": True},
    "la2": {"spec_lookahead": 2},
    "la2_piped": {"spec_lookahead": 2, "pipelined": True},
    "la3": {"spec_lookahead": 3},
    "la3_piped": {"spec_lookahead": 3, "pipelined": True},
    "ss2": {"spec_superstep_k": 2},
    "ss2_piped": {"spec_superstep_k": 2, "pipelined": True},
    "ss3": {"spec_superstep_k": 3},
    "ss3_piped": {"spec_superstep_k": 3, "pipelined": True},
}
ADMISSION = {
    "batched": {},
    "serial": {"batched_admission": False},
    "budget": {"prefill_budget": 8},
}
# The decode modes the engine-level scenarios run in.
KEY_MODES = ("on", "on_piped", "la2_piped", "ss2", "ss2_piped")
# Six requests: (prompt length, max_new_tokens, eos); the eos ids sit
# mid-stream in the greedy streams, so three requests retire on eos.
TRAFFIC = ((13, 14, 95), (4, 9, None), (19, 12, 31), (7, 16, 209), (2, 5, None),
           (10, 11, 12))
NEW = 6
SPEC_COUNTERS = (
    "generated_tokens", "spec_rounds", "spec_tokens_rejected", "spec_supersteps_run",
    "tokens_overdecoded", "chunks_run", "prefill_dispatches", "prefill_tokens",
    "prefill_sweeps", "admission_readbacks", "requests_admitted", "requests_retired",
    "requests_cancelled", "steps_quarantined", "requests_retried", "requests_preempted",
    "pages_parked", "kv_handoff_pages_in", "kv_handoff_pages_out", "spec_mode_steps",
    "plain_mode_steps", "mode_switches", "retunes",
)
PREFIX_COUNTERS = ("hits", "misses", "spills", "reloads", "cached_pages", "offloaded_pages")
ALL_COUNTERS = SPEC_COUNTERS + PREFIX_COUNTERS + ("used_pages", "committed_pages")
CALIBRATION = {"plain_dispatch_ms": 2.0, "spec_dispatch_ms": 3.0,
               "plain_tokens_per_dispatch": 4.0, "spec_tokens_per_dispatch_assumed": 3.25,
               "threshold": 2.0}
# The crossing each spec seam fires on, mid-stream in every mode.
SPEC_SEAMS = {"spec_dispatch": 3, "spec_readback": 3}


def spec_traffic():
    rng = np.random.default_rng(808)
    return [([int(t) for t in rng.integers(0, 256, n)], m, eos) for n, m, eos in TRAFFIC]


def conv_traffic():
    """A 16-token system prompt and three turns of three conversations'
    user tokens, 5 each (with two turns every turn-2 hit floors to the
    system pages live requests hold, and nothing reloads)."""
    rng = np.random.default_rng(72)
    system = [int(t) for t in rng.integers(0, 256, 16)]
    turns = [[[int(t) for t in rng.integers(0, 256, 5)] for _ in range(3)] for _ in range(3)]
    return system, turns


def spec_counters(engine) -> list[int]:
    row = [int(getattr(engine, n)) for n in SPEC_COUNTERS]
    row += [int(getattr(engine.prefix, n, 0)) if engine.prefix is not None else 0
            for n in PREFIX_COUNTERS]
    return row + [engine.ctrl.used_pages, engine._committed_pages]


def _array(streams, width: int = 20) -> np.ndarray:
    arr = np.full((len(streams), width), -1, np.int64)
    for i, s in enumerate(streams):
        arr[i, : len(s)] = s
    return arr


def pressure_pages(kw) -> int:
    """A pool a page past the longest conversation request's worst case
    (a 43-token turn-3 prompt): cached pages spill and reload."""
    k = max(kw.get("spec_lookahead", 1), kw.get("spec_superstep_k", 1))
    over = max(kw["chunk"], (kw["gamma"] + 1) * k) * (2 if kw.get("pipelined") else 1)
    return -(-(43 + NEW - 1 + over) // kw["page_size"]) + 1


class _Run:
    """Drive engines to idle, taking ``script[step]`` actions before that
    step; collect streams, statuses, per-step counters and the mode
    trace."""

    def __init__(self, script=None):
        self.script = script or {}
        self.rows, self.served, self.rids, self.step = [], {}, [], 0
        self.taken: dict[str, str] = {}
        self.trace: list[tuple[int, int]] = []

    def drive(self, engine):
        while not engine.idle:
            for action in self.script.get(self.step, ()):
                action(engine, self)
            for req in engine.step():
                self.served[req.rid] = list(req.tokens)
            self.rows.append(spec_counters(engine))
            self.step += 1
        self.trace += [(occ, int(mode == "spec")) for occ, mode in engine.drain_mode_trace()]

    def result(self, engines):
        statuses = {}
        for engine in engines:
            statuses.update({r.rid: r.status for r in engine.completed})
        trace = np.asarray(self.trace, np.int64).reshape(-1, 2)
        return (_array([self.served.get(r, []) for r in self.rids]),
                np.asarray(self.rows, np.int64),
                np.asarray([self.taken.get(r) or statuses.get(r, "live") for r in self.rids]),
                trace)


def _submit_traffic(engine, run, requests=None):
    for prompt, new, eos in requests or spec_traffic():
        run.rids.append(engine.submit(prompt, new, eos_token=eos))


def run_spec_scenario(make_engine, mode, scenario: str, injector_cls=FaultInjector):
    """One frozen run on either engine: ``make_engine(draft, **kwargs)``
    builds it with the named draft ("self8": the target's int8 tree;
    "both8": an int8 target drafting for itself; "small": the target's
    first layer as a one-layer draft).  Returns (tokens, counters,
    statuses, mode trace, the seams that fired)."""
    decode, admission = mode
    kw = {**SPEC_KW, **DECODE[decode], **ADMISSION[admission]}
    run, injector, engines = _Run(), None, []
    with tempfile.TemporaryDirectory():
        if scenario.startswith("traffic_"):
            engine = make_engine(scenario[len("traffic_"):], **kw)
            engines.append(engine)
            _submit_traffic(engine, run)
            run.drive(engine)
        elif scenario.startswith("auto_"):
            arm = ({"spec_calibration": CALIBRATION} if scenario == "auto_calib"
                   else {"spec_breakeven": float(scenario[len("auto_b"):])})
            engine = make_engine("self8", **{**kw, "slots": 3}, spec="auto", **arm)
            engines.append(engine)
            _submit_traffic(engine, run)
            run.drive(engine)
        elif scenario == "hier":
            system, turns = conv_traffic()
            engine = make_engine("self8", **kw, prefix_cache=True, kv_offload=True,
                                 kv_host_pages=2, n_pages=pressure_pages(kw))
            engines.append(engine)
            prompts = [system + u for u in turns[0]]
            for turn in range(3):
                rids = [engine.submit(p, NEW) for p in prompts]
                run.rids += rids
                run.drive(engine)
                if turn < 2:
                    prompts = [p + run.served.get(r, []) + u
                               for p, r, u in zip(prompts, rids, turns[turn + 1])]
        elif scenario == "fanout":
            system, turns = conv_traffic()
            engine = make_engine("self8", **kw, prefix_cache=True)
            engines.append(engine)
            run.rids += engine.submit_fanout(system + turns[0][0], NEW, n_samples=3)
            run.rids.append(engine.submit(system + turns[0][1], NEW))
            run.drive(engine)
        elif scenario.startswith("fault_"):
            seam = scenario[len("fault_"):]
            injector = injector_cls({seam: [SPEC_SEAMS[seam]]})
            engine = make_engine("self8", **kw, fault_injector=injector)
            engines.append(engine)
            _submit_traffic(engine, run)
            run.drive(engine)
        elif scenario == "cancel":
            engine = make_engine("self8", **kw)
            engines.append(engine)

            def cancel(engine, run):
                # Once, at the first step boundary with the request running
                # (a pipelined or chained dispatch then still in flight).
                if not run.taken and any(r.rid == run.rids[1]
                                         for r in engine._slot_req.values()):
                    run.taken["cancel"] = engine.cancel(run.rids[1])

            run.script = {step: [cancel] for step in range(64)}
            _submit_traffic(engine, run)
            run.drive(engine)
        elif scenario == "park":
            system, turns = conv_traffic()
            engine = make_engine("self8", **kw, prefix_cache=True, kv_offload=True)
            engines.append(engine)
            taken = {}

            def park(engine, run):
                taken["req"] = engine.preempt(run.rids[0])

            run.script = {1: [park]}
            run.rids += [engine.submit(system + u, 16) for u in turns[0][:2]]
            run.drive(engine)
            req = taken["req"]
            assert req is not None and 0 < len(req.tokens) < 16
            run.served[req.rid] = list(req.tokens)
            run.taken[req.rid] = "preempted"
            run.rids.append(engine.submit(req.prompt + req.tokens, 16 - len(req.tokens)))
            run.drive(engine)
        elif scenario == "handoff":
            system, turns = conv_traffic()
            prompts = [system + u for u in turns[0]]
            src = make_engine("self8", **kw, prefix_cache=True, kv_offload=True)
            dst = make_engine("self8", **kw, prefix_cache=True, kv_offload=True)
            engines += [src, dst]
            run.rids += [src.submit(p, 1) for p in prompts]
            run.drive(src)
            for p in prompts:
                dst.import_kv(p, src.export_kv(p))
            run.rows += [spec_counters(src), spec_counters(dst)]
            run.rids += [dst.submit(p, NEW) for p in prompts]
            run.drive(dst)
        elif scenario == "retune":
            engine = make_engine("self8", **{**kw, "slots": 3}, spec="auto",
                                 spec_breakeven=3.0)

            def knob(**change):
                return lambda engine, run: engine.retune(**change)

            run.script = {1: [knob(spec_superstep_k=1)], 2: [knob(spec_breakeven=0.0)],
                          3: [knob(spec_breakeven=3.0, spec_superstep_k=2)],
                          4: [knob(spec_superstep_k=3)]}
            engines.append(engine)
            _submit_traffic(engine, run)
            run.drive(engine)
        else:
            raise ValueError(scenario)
        out = run.result(engines)
        for engine in engines:
            engine.close()
            assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0
    return (*out, injector.fired if injector is not None else [])


def golden_runs():
    """(key, mode, scenario) of every frozen run."""
    runs = [(f"traffic_self8/{d}_{a}", (d, a), "traffic_self8")
            for d in DECODE for a in ADMISSION]
    runs += [(f"traffic_{dr}/{d}_batched", (d, "batched"), f"traffic_{dr}")
             for dr in ("both8", "small") for d in KEY_MODES]
    for name in ("auto_b1", "auto_b2", "auto_calib", "hier", "fanout", "fault_spec_dispatch",
                 "fault_spec_readback", "cancel", "park", "handoff"):
        runs += [(f"{name}/{d}_batched", (d, "batched"), name) for d in KEY_MODES]
    runs += [(f"{name}/{d}_{a}", (d, a), name) for name in ("hier", "fanout")
             for d in ("on", "ss2_piped") for a in ("serial", "budget")]
    runs += [(f"retune/{d}_batched", (d, "batched"), "retune") for d in ("ss3", "ss3_piped")]
    return runs


# ---- unit goldens ------------------------------------------------------

UNIT_PS, UNIT_PAGES, UNIT_GAMMA, UNIT_COVER = 4, 24, 3, 4


def unit_inputs() -> dict:
    """Pools, tables, tokens and positions of the unit comparisons."""
    rng = np.random.default_rng(4242)
    shape = (2, UNIT_PAGES + 1, 2, UNIT_PS, 16)
    inp = {f"pool{i}": rng.standard_normal(shape).astype(np.float32) for i in range(4)}
    inp["tables"] = rng.permutation(UNIT_PAGES)[:18].reshape(3, 6).astype(np.int32)
    inp["cur"] = rng.integers(0, 256, 3).astype(np.int64)
    inp["positions"] = np.asarray([5, 9, 0], np.int64)
    inp["block"] = rng.integers(0, 256, (3, UNIT_GAMMA + 1)).astype(np.int64)
    inp["prompt"] = rng.integers(0, 256, (1, 5)).astype(np.int64)
    return inp


def port_units(params: dict, config, inp: dict) -> dict:
    """What the port computes for the unit comparisons."""
    draft = quantize_params(params)

    def pools(a, b):
        return (torch.from_numpy(inp[a].copy()), torch.from_numpy(inp[b].copy()))

    tables = torch.from_numpy(inp["tables"])
    pos = torch.from_numpy(inp["positions"])
    out = {}
    with torch.inference_mode():
        t_pools = pools("pool0", "pool1")
        logits, _ = tpaged._rowwise_block_core(
            params, t_pools, tables[:, :UNIT_COVER], torch.from_numpy(inp["block"]), pos,
            config)
        out["rowwise/logits"] = logits.numpy()
        out["rowwise/k"], out["rowwise/v"] = (p.numpy() for p in t_pools)
        t_pools, d_pools = pools("pool0", "pool1"), pools("pool2", "pool3")
        committed, n = tpaged._spec_round_core(
            params, draft, t_pools, d_pools, tables, torch.from_numpy(inp["cur"]), pos,
            config, config, UNIT_GAMMA, UNIT_COVER)
        out["round/committed"], out["round/n"] = committed.numpy(), n.numpy()
        for name, p in zip(("t_k", "t_v", "d_k", "d_v"), (*t_pools, *d_pools)):
            out[f"round/{name}"] = p.numpy()
    toks, rounds = speculative_generate(params, draft, inp["prompt"], config, config, 12,
                                        gamma=UNIT_GAMMA, device="cpu")
    out["generate/tokens"], out["generate/rounds"] = toks.numpy(), np.asarray(rounds)
    return out


def _params(params_golden, case=SPEC_CASE):
    return params_to_torch(params_golden, f"params_{'gqa' if case[1] else 'mha'}",
                           torch.float32)


def port_engine_factory(params: dict, config):
    """``make_engine`` for the port's engine on the CPU."""
    trees = {}

    def make(draft: str, **kw):
        if not trees:
            trees["self8"] = (params, quantize_params(params), config)
            both = quantize_params(params)
            trees["both8"] = (both, both, config)
            small = {"embed": params["embed"], "unembed": params["unembed"],
                     "layers": params["layers"][:1]}
            from dataclasses import replace

            trees["small"] = (params, small, replace(config, n_layers=1))
        target, d_params, d_config = trees[draft]
        return ServeEngine(target, config, device="cpu", draft_params=d_params,
                           draft_config=d_config, **kw)

    return make


@pytest.fixture(scope="module")
def params_golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files if k.startswith("params_")}


@pytest.fixture(scope="module")
def sgolden():
    with np.load(SPEC_GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def make_port_engine(params_golden):
    return port_engine_factory(_params(params_golden), tiny_config(SPEC_CASE))


_RUNS = golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _RUNS, ids=[r[0] for r in _RUNS])
def test_spec_matches_jax_step_by_step(make_port_engine, sgolden, key, mode, scenario):
    """The port's greedy streams, terminal statuses, auto-mode trace and
    every step's counters (tokens, rounds, rejected drafts, supersteps,
    over-decode, prefill work, quarantines, replays, prefix hits, spills
    and reloads, mode steps and switches, pages in use) equal the JAX
    engine's in the same mode and scenario; a seam fault fires once."""
    tokens, counters, statuses, trace, fired = run_spec_scenario(make_port_engine, mode,
                                                                 scenario)
    if scenario.startswith("fault_"):
        assert [r.seam for r in fired] == [scenario[len("fault_"):]]
    np.testing.assert_array_equal(tokens, sgolden[f"{key}/tokens"])
    np.testing.assert_array_equal(statuses, sgolden[f"{key}/statuses"])
    np.testing.assert_array_equal(trace, sgolden[f"{key}/trace"])
    np.testing.assert_array_equal(counters, sgolden[f"{key}/counters"])


def test_spec_goldens_cover_what_the_scenarios_do(sgolden):
    """The frozen runs exercise each mechanism: the same greedy streams
    in every mode (speculation is lossless), rejections with the small
    draft, rounds per dispatch in the superstep modes, both auto modes
    taken, spills and reloads of draft halves, one quarantine a fault,
    a handoff, a park and the retune walk."""
    def last(key, name):
        return sgolden[f"{key}/counters"][-1][ALL_COUNTERS.index(name)]

    base = sgolden["traffic_self8/on_batched/tokens"]
    for d in DECODE:
        for a in ADMISSION:
            np.testing.assert_array_equal(sgolden[f"traffic_self8/{d}_{a}/tokens"], base)
    for dr in ("both8", "small"):
        for d in KEY_MODES:
            np.testing.assert_array_equal(sgolden[f"traffic_{dr}/{d}_batched/tokens"],
                                          base if dr == "small" else
                                          sgolden["traffic_both8/on_batched/tokens"])
    assert last("traffic_small/on_batched", "spec_tokens_rejected") > \
        last("traffic_self8/on_batched", "spec_tokens_rejected")
    assert last("traffic_self8/ss3_batched", "spec_supersteps_run") > 0
    assert list(sgolden["traffic_self8/on_batched/statuses"]) == ["ok"] * len(TRAFFIC)
    cancelled = switched = 0
    for d in KEY_MODES:
        for name in ("auto_b1", "auto_b2", "auto_calib"):
            modes = set(sgolden[f"{name}/{d}_batched/trace"][:, 1])
            switched += modes == {0, 1}
            assert 0 in modes, (name, d)
            np.testing.assert_array_equal(sgolden[f"{name}/{d}_batched/tokens"], base)
        assert last(f"hier/{d}_batched", "spills") > 0
        assert last(f"hier/{d}_batched", "reloads") > 0
        for seam in SPEC_SEAMS:
            assert last(f"fault_{seam}/{d}_batched", "steps_quarantined") == 1
            np.testing.assert_array_equal(sgolden[f"fault_{seam}/{d}_batched/tokens"], base)
        cancelled += "cancelled" in set(sgolden[f"cancel/{d}_batched/statuses"])
        assert last(f"park/{d}_batched", "pages_parked") > 0
        handoff = sgolden[f"handoff/{d}_batched/counters"]
        assert handoff[:, ALL_COUNTERS.index("kv_handoff_pages_in")].max() > 0
    # With spec_lookahead=2 pipelined the drain before the cancel retires
    # the request first (cancel then returns False), as in the JAX engine.
    assert cancelled == len(KEY_MODES) - 1
    # spec_superstep_k=2 pipelined keeps 3 rows decoding plain supersteps
    # until the stream drains, so only the other modes switch.
    assert switched == 3 * (len(KEY_MODES) - 1)
    for d in ("ss3", "ss3_piped"):
        assert last(f"retune/{d}_batched", "retunes") == 4


def test_spec_golden_fixture_stays_small():
    assert os.path.getsize(SPEC_GOLDEN) < 1_000_000


@pytest.fixture(scope="module")
def units(params_golden):
    return port_units(_params(params_golden), tiny_config(SPEC_CASE), unit_inputs())


@pytest.mark.parametrize("name", ["rowwise/logits", "rowwise/k", "rowwise/v",
                                  "round/t_k", "round/t_v", "round/d_k", "round/d_v"])
def test_spec_units_match_jax(units, sgolden, name):
    """``_rowwise_block_core``'s logits and pages, and
    ``_spec_round_core``'s target and draft pools, against JAX's at
    float32 (atol = rtol = 1e-4); the trash page, where duplicate writes
    land in an unspecified order, is left out."""
    got, want = units[name], sgolden[f"unit/{name}"]
    if got.ndim == 5:
        got, want = got[:, :-1], want[:, :-1]
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_rowwise_block_sends_padding_to_the_trash_page(units):
    """Pages no row's post-block coverage reaches come back unchanged:
    the padding columns' writes went to the trash page."""
    inp = unit_inputs()
    real = -(-(inp["positions"] + UNIT_GAMMA + 1) // UNIT_PS)
    written = {int(inp["tables"][b, c]) for b in range(3) for c in range(real[b])}
    untouched = [p for p in range(UNIT_PAGES) if p not in written]
    assert untouched
    for name, pool in (("rowwise/k", "pool0"), ("rowwise/v", "pool1")):
        np.testing.assert_array_equal(units[name][:, untouched], inp[pool][:, untouched])


@pytest.mark.parametrize("name", ["round/committed", "round/n", "generate/tokens",
                                  "generate/rounds"])
def test_spec_tokens_match_jax(units, sgolden, name):
    """The round's committed tokens and accepted lengths and
    ``speculative_generate``'s tokens and round count, exactly."""
    np.testing.assert_array_equal(units[name], sgolden[f"unit/{name}"])
