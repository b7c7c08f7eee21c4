"""The port's KV-cache hierarchy (workloads_torch: the radix and flat
prefix caches, the host-RAM offload tier, the disk tier, fan-out
groups, the KV handoff and the preempt park) on the CPU.

torch, numpy and the port only, so it runs in the fast tier.  Two
parts:

* scripted, clock-free runs (``golden_runs``) at the tiny GQA width in
  float32, whose streams, terminal statuses and per-step counters
  (``KV_COUNTERS``) were frozen from the JAX engine in the same mode
  (tests/test_torch_kv_golden.npz, written by ``write_kv_goldens()`` in
  tests/test_torch_parity.py): a three-turn conversation script behind a
  shared system prompt under pool pressure with the radix tree, the
  offload tier and the disk tier in all 24 scheduling modes; the same
  script without pressure for no cache, flat, radix and offload in the
  four decode modes (superstep_k 1/2 x pipelined); fan-out in the 24
  modes; and the handoff, the preempt park and a fault at each engine
  and disk seam with the cache on in the four decode modes;
* page files the JAX package's ``KVDiskTier`` wrote, bf16 and float32,
  stored in the golden: the port's tier reads them to the same bits and
  dtype names, and writes the same format.

The JAX package's contracts for these modules, ported, are in
tests/test_torch_kv_contracts.py.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from tests.test_torch_golden import tiny_config
from tests.test_torch_schedule import (
    SCHEDULE_MODES,
    _params,
    golden,  # noqa: F401
    mode_key,
    mode_kwargs,
)
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import durable
from workloads_torch.faults import FaultInjector
from workloads_torch.serve import ServeEngine

KV_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_kv_golden.npz")
KV_CASE = ("f32", 2, None)
KV_KW = dict(slots=2, page_size=4, prompt_bucket=8, chunk=4)
NEW = 6
N_CONV = 4
ENGINE_COUNTERS = (
    "prefill_tokens", "prefill_dispatches", "prefill_sweeps", "prefills_run",
    "admission_readbacks", "requests_admitted", "chunks_run", "generated_tokens",
    "requests_retired", "steps_quarantined", "requests_retried", "requests_preempted",
    "pages_parked", "preempt_recompute_tokens", "kv_handoff_pages_in",
    "kv_handoff_pages_out",
)
PREFIX_COUNTERS = ("hits", "misses", "spills", "reloads", "demotions", "disk_reloads",
                   "grafts", "cached_pages", "offloaded_pages")
KV_COUNTERS = ENGINE_COUNTERS + PREFIX_COUNTERS + ("used_pages", "committed_pages")
DECODE_MODES = [(k, piped, None, True) for k, piped in itertools.product((1, 2), (False, True))]
ARMS = {
    "off": {},
    "radix": {"prefix_cache": True},
    "flat": {"prefix_cache": "flat"},
    "offload": {"prefix_cache": True, "kv_offload": True},
    "hier": {"prefix_cache": True, "kv_offload": True, "kv_host_pages": 2},
}
# The crossing each seam fires on, mid-script in every decode mode.
KV_SEAMS = {"prefill_dispatch": 3, "prefill_readback": 3, "decode_dispatch": 4,
            "decode_readback": 4, "kv_disk_write_fail": 1, "kv_disk_read_corrupt": 1}


def kv_traffic():
    """A 16-token system prompt (4 pages) and three turns of ``N_CONV``
    conversations' user tokens, 5 each."""
    rng = np.random.default_rng(71)
    system = [int(t) for t in rng.integers(0, 256, 16)]
    turns = [[[int(t) for t in rng.integers(0, 256, 5)] for _ in range(N_CONV)] for _ in range(3)]
    return system, turns


def kv_counters(engine) -> list[int]:
    row = [int(getattr(engine, n)) for n in ENGINE_COUNTERS]
    row += [int(getattr(engine.prefix, n, 0)) if engine.prefix is not None else 0
            for n in PREFIX_COUNTERS]
    return row + [engine.ctrl.used_pages, engine._committed_pages]


def kv_array(streams, width: int = 16) -> np.ndarray:
    arr = np.full((len(streams), width), -1, np.int64)
    for i, s in enumerate(streams):
        arr[i, : len(s)] = s
    return arr


def pressure_pages(mode) -> int:
    """A pool one page past the longest request's worst case: cached
    pages spill, demote and reload in every mode."""
    k, piped = mode[0], mode[1]
    overshoot = KV_KW["chunk"] * k * (2 if piped else 1)
    return -(-(43 + NEW - 1 + overshoot) // KV_KW["page_size"]) + 1


class _Run:
    """Drive one engine to idle, taking ``script[step]`` actions before
    that step; collect streams, statuses and per-step counters."""

    def __init__(self, script=None):
        self.script = script or {}
        self.rows, self.served, self.rids, self.step = [], {}, [], 0
        self.taken: dict[str, str] = {}  # rid -> "preempted"

    def drive(self, engine):
        while not engine.idle:
            for action in self.script.get(self.step, ()):
                action(engine, self)
            for req in engine.step():
                self.served[req.rid] = list(req.tokens)
            self.rows.append(kv_counters(engine))
            self.step += 1

    def result(self, engines):
        statuses = {}
        for engine in engines:
            statuses.update({r.rid: r.status for r in engine.completed})
        return (kv_array([self.served.get(r, []) for r in self.rids]),
                np.asarray(self.rows, np.int64),
                np.asarray([self.taken.get(r) or statuses.get(r, "live") for r in self.rids]))


def _conversations(engine, run, turns_run: int = 3):
    """The three-turn script: each turn's prompt is the last one plus
    its reply and the next user turn, submitted after the last drains."""
    system, turns = kv_traffic()
    prompts = [system + u for u in turns[0]]
    for turn in range(turns_run):
        rids = [engine.submit(p, NEW) for p in prompts]
        run.rids += rids
        run.drive(engine)
        if turn + 1 < turns_run:
            prompts = [p + run.served.get(r, []) + u
                       for p, r, u in zip(prompts, rids, turns[turn + 1])]


def run_kv_scenario(make_engine, mode, scenario: str, injector_cls=FaultInjector):
    """One frozen run on either engine (``make_engine(**kwargs)`` builds
    it, ``injector_cls`` its package's FaultInjector, whose fault the
    disk tier catches): (tokens, counters, statuses, the seams that
    fired).  Scenarios: ``turns_<arm>``, ``fanout``, ``handoff``,
    ``park`` and ``fault_<seam>``."""
    kw = {**KV_KW, **mode_kwargs(mode)}
    run, injector, engines = _Run(), None, []
    with tempfile.TemporaryDirectory() as disk:
        if scenario.startswith("turns_"):
            arm = dict(ARMS[scenario[len("turns_"):]])
            if scenario == "turns_hier":
                arm.update(kv_disk_dir=disk, n_pages=pressure_pages(mode))
            elif scenario == "turns_offload":
                arm.update(n_pages=pressure_pages(mode))
            engine = make_engine(**kw, **arm)
            engines.append(engine)
            _conversations(engine, run)
        elif scenario == "fanout":
            system, turns = kv_traffic()
            engine = make_engine(**kw, prefix_cache=True)
            engines.append(engine)
            run.rids += engine.submit_fanout(system + turns[0][0], NEW, n_samples=3)
            run.rids.append(engine.submit(system + turns[0][1], NEW))
            run.rids.append(engine.submit(turns[0][2][:3], NEW))
            run.drive(engine)
            run.rids += engine.submit_fanout(system + turns[0][0], NEW, n_samples=2)
            run.drive(engine)
        elif scenario == "handoff":
            system, turns = kv_traffic()
            prompts = [system + u for u in turns[0]]
            src = make_engine(**kw, prefix_cache=True, kv_offload=True)
            dst = make_engine(**kw, prefix_cache=True, kv_offload=True)
            engines += [src, dst]
            run.rids += [src.submit(p, 1) for p in prompts]
            run.drive(src)
            for p in prompts:
                dst.import_kv(p, src.export_kv(p))
            run.rows += [kv_counters(src), kv_counters(dst)]
            run.rids += [dst.submit(p, NEW) for p in prompts]
            run.drive(dst)
        elif scenario == "park":
            system, turns = kv_traffic()
            engine = make_engine(**kw, prefix_cache=True, kv_offload=True)
            engines.append(engine)
            taken = {}

            def park(engine, run):
                taken["req"] = engine.preempt(run.rids[0])

            run.script = {2: [park]}
            run.rids += [engine.submit(system + u, 16) for u in turns[0][:2]]
            run.drive(engine)
            req = taken["req"]
            assert req is not None and 0 < len(req.tokens) < 16
            run.served[req.rid] = list(req.tokens)
            run.taken[req.rid] = "preempted"
            run.rids.append(engine.submit(req.prompt + req.tokens, 16 - len(req.tokens)))
            run.drive(engine)
        elif scenario.startswith("fault_"):
            seam = scenario[len("fault_"):]
            injector = injector_cls({seam: [KV_SEAMS[seam]]})
            engine = make_engine(**kw, **ARMS["hier"], kv_disk_dir=disk,
                                 n_pages=pressure_pages(mode), fault_injector=injector)
            engines.append(engine)
            _conversations(engine, run)
        else:
            raise ValueError(scenario)
        out = run.result(engines)
        for engine in engines:
            engine.close()
            assert engine.ctrl.used_pages == 0 and engine._committed_pages == 0
    return (*out, injector.fired if injector is not None else [])


def golden_runs():
    """(key, mode, scenario) of every frozen run."""
    runs = [(f"turns_hier/{mode_key(m)}", m, "turns_hier") for m in SCHEDULE_MODES]
    runs += [(f"fanout/{mode_key(m)}", m, "fanout") for m in SCHEDULE_MODES]
    for name in ["turns_off", "turns_radix", "turns_flat", "turns_offload", "handoff", "park"] \
            + [f"fault_{s}" for s in KV_SEAMS]:
        runs += [(f"{name}/{mode_key(m)}", m, name) for m in DECODE_MODES]
    return runs


# Page files the JAX package's KVDiskTier wrote (the golden's
# ``disk/<dtype>/file``), one page of the tiny GQA config each.
DISK_SHAPE = (2, 2, 4, 16)
DISK_KEY = "5eed0123abcdef"
DISK_DTYPES = {"bf16": (torch.bfloat16, np.uint16), "f32": (torch.float32, np.uint32)}


@pytest.fixture(scope="module")
def kgolden():
    with np.load(KV_GOLDEN) as f:
        return {k: f[k] for k in f.files}


_RUNS = golden_runs()


@pytest.mark.parametrize("key, mode, scenario", _RUNS, ids=[r[0] for r in _RUNS])
def test_kv_matches_jax_step_by_step(golden, kgolden, key, mode, scenario):  # noqa: F811
    """The port's streams, terminal statuses and every step's counters
    (prefill tokens and dispatches, prefix hits and misses, spills,
    reloads, demotions, cached and offloaded pages, pages in use,
    parks, handoff pages) equal the JAX engine's in the same mode and
    scenario; a seam fault fires exactly once."""
    params, config = _params(golden, KV_CASE), tiny_config(KV_CASE)
    tokens, counters, statuses, fired = run_kv_scenario(
        lambda **kw: ServeEngine(params, config, device="cpu", **kw), mode, scenario)
    if scenario.startswith("fault_"):
        assert [r.seam for r in fired] == [scenario[len("fault_"):]]
    np.testing.assert_array_equal(tokens, kgolden[f"{key}/tokens"])
    np.testing.assert_array_equal(statuses, kgolden[f"{key}/statuses"])
    np.testing.assert_array_equal(counters, kgolden[f"{key}/counters"])


def test_kv_goldens_cover_what_the_scenarios_do(kgolden):
    """The frozen runs exercise each mechanism: spills, reloads, disk
    demotions and disk reloads under pressure in all 24 modes with the
    streams of the cache-off run; fewer prompt tokens with a cache; one
    prefill a fan-out group; handoff pages out and in; parked pages;
    one quarantine a scheduled engine fault."""
    def last(key, name):
        return kgolden[f"{key}/counters"][-1][KV_COUNTERS.index(name)]

    for mode in DECODE_MODES:
        mk = mode_key(mode)
        off = kgolden[f"turns_off/{mk}/tokens"]
        for arm in ("radix", "flat", "offload"):
            np.testing.assert_array_equal(kgolden[f"turns_{arm}/{mk}/tokens"], off)
        assert last(f"turns_radix/{mk}", "prefill_tokens") < last(f"turns_off/{mk}", "prefill_tokens")
        assert last(f"turns_radix/{mk}", "hits") > 0
        assert last(f"turns_offload/{mk}", "spills") > 0 and last(f"turns_offload/{mk}", "reloads") > 0
        handoff = kgolden[f"handoff/{mk}/counters"]
        out_, in_ = (handoff[:, KV_COUNTERS.index(n)].max()
                     for n in ("kv_handoff_pages_out", "kv_handoff_pages_in"))
        # Each ticket ships its whole path (the 4 system pages and the
        # turn's own page); the import grafts each distinct page once.
        assert (out_, in_) == (5 * N_CONV, 4 + N_CONV)
        assert last(f"park/{mk}", "pages_parked") > 0
        assert list(kgolden[f"park/{mk}/statuses"]) == ["preempted", "ok", "ok"]
        for seam in ("prefill_dispatch", "prefill_readback", "decode_dispatch", "decode_readback"):
            assert last(f"fault_{seam}/{mk}", "steps_quarantined") == 1
    for mode in SCHEDULE_MODES:
        mk = mode_key(mode)
        np.testing.assert_array_equal(kgolden[f"turns_hier/{mk}/tokens"],
                                      kgolden[f"turns_off/{mode_key(DECODE_MODES[0])}/tokens"])
        for name in ("spills", "reloads", "demotions", "disk_reloads"):
            assert last(f"turns_hier/{mk}", name) > 0, (mk, name)
        assert last(f"fanout/{mk}", "prefills_run") == 4  # two groups, two solo requests
        assert set(kgolden[f"fanout/{mk}/statuses"]) == {"ok"}


def test_kv_golden_fixture_stays_small():
    assert os.path.getsize(KV_GOLDEN) < 1_000_000


@pytest.mark.parametrize("name", sorted(DISK_DTYPES))
def test_port_reads_jax_disk_pages_bit_exactly(kgolden, tmp_path, name):
    """A page file the JAX package's tier wrote reads back through the
    port's tier with its dtype and every bit."""
    dtype, bits = DISK_DTYPES[name]
    (tmp_path / (DISK_KEY + ".kvpage")).write_bytes(kgolden[f"disk/{name}/file"].tobytes())
    tier = durable.KVDiskTier(str(tmp_path))
    (k, v), draft = tier.get(DISK_KEY)
    assert draft is None and tier.reads == 1
    for got, want in ((k, kgolden[f"disk/{name}/k"]), (v, kgolden[f"disk/{name}/v"])):
        assert got.dtype == dtype and tuple(got.shape) == DISK_SHAPE
        np.testing.assert_array_equal(got.contiguous().view(torch.uint8).numpy().view(bits),
                                      want)


def _file_arrays(data: bytes) -> dict:
    """A page file's npz arrays, checksum checked."""
    import hashlib
    import io

    head = len(durable._PAGE_MAGIC)
    assert data[:head] == durable._PAGE_MAGIC
    assert hashlib.sha256(data[head + 32:]).digest() == data[head:head + 32]
    with np.load(io.BytesIO(data[head + 32:])) as z:
        return {name: z[name] for name in z.files}


@pytest.mark.parametrize("name", sorted(DISK_DTYPES))
def test_port_writes_the_jax_page_format(kgolden, tmp_path, name):
    """The port's file for the same page holds the same arrays: raw
    bytes under the same keys, and the same dtype names and shapes."""
    dtype, bits = DISK_DTYPES[name]
    k, v = (torch.from_numpy(kgolden[f"disk/{name}/{x}"].copy()).view(dtype) for x in "kv")
    tier = durable.KVDiskTier(str(tmp_path))
    assert tier.put(DISK_KEY, ((k, v), None)) and tier.writes == 1
    ours = _file_arrays(open(tier._path(DISK_KEY), "rb").read())
    theirs = _file_arrays(kgolden[f"disk/{name}/file"].tobytes())
    assert sorted(ours) == sorted(theirs) == ["__meta__", "mk", "mv"]
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    meta = json.loads(bytes(ours["__meta__"]).decode())
    assert meta["mk"] == [{"bf16": "bfloat16", "f32": "float32"}[name], list(DISK_SHAPE)]
