"""Fast replica start (workloads_torch/faststart.py), ported from the
JAX package's tests/test_faststart.py and the snapshot and device-table
cases of tests/test_durable.py to the port on the CPU: the kernel-build
cache + warm-state EngineSnapshot subsystem that makes respawns and
scale-ups cheap.

The pinned contracts: a snapshot round-trips through JSON/disk exactly;
a snapshot-primed respawn skips the spec-breakeven calibration's dead
dispatches (``calibration_reused`` ticks) while its streams stay
bit-identical to a cold-spawned oracle engine — greedy AND sampled,
spec="auto" bare and with ``spec_superstep_k`` armed; a stale snapshot
(config or version mismatch) is REJECTED and the engine calibrates cold;
the supervisor and autoscaler consume the snapshot at their
calibrate_probe/resurrection/scale-up seams; the per-engine compile-cache
+ calibration-reuse counters surface through obs.py onto the metrics
registry; and the kernel-build cache counts a library found built as a
hit and a run of nvcc as a miss, in the directory enable_compile_cache
names.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch.backoff import Backoff
from workloads_torch.faststart import (
    SNAPSHOT_VERSION,
    EngineSnapshot,
    cache_stats,
    compile_cache_dir,
    enable_compile_cache,
    fingerprint_engine,
)
from workloads_torch.faults import FaultInjector
from workloads_torch.fleet import Fleet
from workloads_torch.generate import generate as _port_generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import ServeEngine as _PortEngine
from workloads_torch.supervisor import FleetSupervisor
from workloads_torch.supervisor import make_engine_factory as _port_make_engine_factory


class ServeEngine(_PortEngine):
    """The port's engine on the CPU: the JAX contracts build engines
    with no device, and the port's default is the card."""

    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


def make_engine_factory(*args, device="cpu", **kw):
    return _port_make_engine_factory(*args, device=device, **kw)


@pytest.fixture(autouse=True)
def restore_build_dir():
    """enable_compile_cache re-points the process-global build
    directory; each test leaves it as it found it."""
    import workloads_torch.faststart as faststart
    from workloads_torch.ops import _build

    build_dir, cache_dir = _build.BUILD_DIR, faststart._cache_dir
    yield
    _build.set_build_dir(build_dir)
    faststart._cache_dir = cache_dir


CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
DRAFT_CONFIG = ModelConfig(
    max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
    dtype=torch.float32,
)
PROBE = ([1, 2, 3], 4)
ENGINE_KW = dict(slots=2, page_size=4, prompt_bucket=8)
FAST = Backoff(base_s=1e-3, factor=2.0, max_s=8e-3, jitter=0.0)


@pytest.fixture(scope="module")
def models():
    params = init_params(CONFIG, torch.Generator().manual_seed(0))
    draft = init_params(DRAFT_CONFIG, torch.Generator().manual_seed(7))
    return params, draft


def _auto_engine(params, draft, **kw):
    base = dict(ENGINE_KW)
    base.update(kw)
    return ServeEngine(
        params, CONFIG, draft_params=draft, draft_config=DRAFT_CONFIG,
        gamma=3, spec="auto", **base,
    )


def _auto_kw(draft, **kw):
    base = dict(
        ENGINE_KW, draft_params=draft, draft_config=DRAFT_CONFIG,
        gamma=3, spec="auto", device="cpu",
    )
    base.update(kw)
    return base


def _ref(params, prompt, new):
    return [int(t) for t in _port_generate(
        params, torch.tensor([prompt]), CONFIG, max_new_tokens=new,
        device="cpu",
    )[0]]


def _serve(engine, requests):
    rids = [engine.submit(p, n) for p, n in requests]
    out = engine.run()
    return [list(out[r]) for r in rids]


def _calibrated_snapshot(params, draft, **kw):
    """Build, warm (calibration runs at the first decode step) and
    capture — the producer side every consumer test primes from."""
    engine = _auto_engine(params, draft, **kw)
    rid = engine.submit(PROBE[0], PROBE[1])
    out = engine.run()
    assert engine.spec_breakeven is not None
    assert engine.spec_calibration is not None
    assert engine.calibration_reused == 0  # cold producer, by definition
    snap = EngineSnapshot.capture(
        engine, probe=PROBE, probe_oracle=list(out[rid]),
    )
    engine.close()
    return snap


# ---- snapshot round-trip -------------------------------------------------


def test_snapshot_round_trip(models, tmp_path):
    """capture -> to_json -> from_json -> save -> load is exact: every
    field (including the int-keyed kernel table and the probe tuple)
    survives, and the reloaded snapshot still primes."""
    params, draft = models
    from workloads_torch.ops.kernel_select import set_kernel_table

    set_kernel_table({64: "flash", 128: "xla"})
    try:
        snap = _calibrated_snapshot(params, draft)
    finally:
        set_kernel_table(None)
    assert snap.version == SNAPSHOT_VERSION
    assert snap.spec_breakeven is not None
    assert snap.spec_calibration["threshold"] == snap.spec_breakeven
    assert snap.kernel_table == {64: "flash", 128: "xla"}
    assert snap.probe == ([1, 2, 3], 4)
    assert snap.meta["torch"] == torch.__version__
    assert snap.meta["device"] == "cpu"

    again = EngineSnapshot.from_json(snap.to_json())
    assert dataclasses.asdict(again) == dataclasses.asdict(snap)
    assert again.kernel_table == {64: "flash", 128: "xla"}  # int keys

    path = snap.save(str(tmp_path / "snap.json"))
    loaded = EngineSnapshot.load(path)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(snap)

    engine = _auto_engine(params, draft)
    try:
        assert loaded.compatible(engine)
        assert loaded.prime(engine)
        assert engine._injected_calibration == snap.spec_calibration
    finally:
        engine.close()
        set_kernel_table(None)  # prime restored the captured table


def test_fingerprint_tracks_shape_not_weights(models):
    """The compatibility key moves with anything that shapes the
    compile set or calibration verdict — and ONLY with those (two
    same-shape engines share a key)."""
    params, draft = models
    a = _auto_engine(params, draft)
    b = _auto_engine(params, draft)
    c = _auto_engine(params, draft, slots=3)
    d = _auto_engine(params, draft, spec_superstep_k=2)
    try:
        assert fingerprint_engine(a) == fingerprint_engine(b)
        assert fingerprint_engine(a) != fingerprint_engine(c)
        assert fingerprint_engine(a) != fingerprint_engine(d)
    finally:
        for e in (a, b, c, d):
            e.close()


# ---- respawn bit-identity vs a cold oracle engine ------------------------


REQUESTS_GREEDY = [([5, 6, 7], 12), ([1, 2], 6), ([9], 4)]


@pytest.mark.parametrize("extra_kw", [
    {},                        # spec="auto" bare
    {"spec_superstep_k": 2},   # chained spec supersteps armed
])
def test_primed_respawn_streams_bit_identical_greedy(models, extra_kw):
    """The acceptance pin: a snapshot-primed respawn skips calibration
    (calibration_reused == 1, the calibration dict adopted verbatim)
    and its greedy streams are bit-identical to a COLD-spawned engine's
    and to the dense oracle."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft, **extra_kw)

    cold = _auto_engine(params, draft, **extra_kw)
    cold_streams = _serve(cold, REQUESTS_GREEDY)
    assert cold.calibration_reused == 0
    cold.close()

    warm = _auto_engine(params, draft, **extra_kw)
    assert snap.prime(warm)
    warm_streams = _serve(warm, REQUESTS_GREEDY)
    assert warm.calibration_reused == 1
    assert warm.spec_calibration == snap.spec_calibration
    assert warm.spec_breakeven == snap.spec_breakeven
    warm.close()

    assert warm_streams == cold_streams
    for (prompt, new), stream in zip(REQUESTS_GREEDY, warm_streams):
        assert stream == _ref(params, prompt, new)


def test_primed_respawn_streams_bit_identical_sampled(models):
    """Same contract at temperature > 0: calibration uses a private
    generator, so skipping it must not perturb the served sampling
    stream — sampled streams are bit-identical snapshot on/off.  The
    unprimed side is the engine the snapshot was captured from, so both
    sides hold one calibration verdict: a second cold engine times its
    own, and on a loaded CPU the binary verdict can flip, which changes
    which program samples."""
    params, draft = models
    kw = dict(temperature=0.8, top_k=20)
    requests = [([5, 6, 7], 10), ([2, 4], 6)]

    cold = _auto_engine(params, draft, generator=torch.Generator().manual_seed(123), **kw)
    rid = cold.submit(PROBE[0], PROBE[1])
    oracle = list(cold.run()[rid])
    snap = EngineSnapshot.capture(cold, probe=PROBE, probe_oracle=oracle)
    cold_streams = _serve(cold, requests)
    assert cold.calibration_reused == 0
    cold.close()

    warm = _auto_engine(params, draft, generator=torch.Generator().manual_seed(123), **kw)
    assert snap.prime(warm)
    rid = warm.submit(PROBE[0], PROBE[1])
    assert list(warm.run()[rid]) == oracle
    warm_streams = _serve(warm, requests)
    assert warm.calibration_reused == 1
    assert warm.spec_calibration == snap.spec_calibration
    warm.close()
    assert warm_streams == cold_streams


def test_constructor_injection_matches_prime(models):
    """spec_calibration= at construction (the engine_kw() path) is the
    same seam prime() rides: calibration skipped, same streams."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft)
    assert snap.engine_kw() == {"spec_calibration": snap.spec_calibration}
    engine = _auto_engine(params, draft, **snap.engine_kw())
    streams = _serve(engine, REQUESTS_GREEDY)
    assert engine.calibration_reused == 1
    assert engine.spec_breakeven == snap.spec_breakeven
    engine.close()
    for (prompt, new), stream in zip(REQUESTS_GREEDY, streams):
        assert stream == _ref(params, prompt, new)


def test_spec_calibration_kwarg_contract(models):
    params, draft = models
    with pytest.raises(ValueError, match="spec_calibration"):
        ServeEngine(params, CONFIG, spec_calibration={"threshold": 1.0})
    with pytest.raises(ValueError, match="threshold"):
        _auto_engine(params, draft, spec_calibration={"bogus": 1.0})


# ---- stale-snapshot rejection --------------------------------------------


def test_stale_snapshot_rejected_config_mismatch(models):
    """A snapshot from a different engine shape must NOT apply: prime
    returns False, nothing is injected, and the engine calibrates
    itself cold — wrong-threshold poisoning is structurally
    impossible."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft)
    other = _auto_engine(params, draft, slots=3)
    assert not snap.compatible(other)
    assert snap.prime(other) is False
    assert other._injected_calibration is None
    rid = other.submit([1, 2, 3], 6)
    out = other.run()
    assert other.calibration_reused == 0          # cold path ran
    assert other.spec_calibration is not None     # ... and measured
    assert list(out[rid]) == _ref(params, [1, 2, 3], 6)
    other.close()


def test_stale_snapshot_rejected_version_mismatch(models):
    params, draft = models
    snap = _calibrated_snapshot(params, draft)
    blob = json.loads(snap.to_json())
    blob["version"] = SNAPSHOT_VERSION + 1
    foreign = EngineSnapshot.from_json(json.dumps(blob))
    engine = _auto_engine(params, draft)
    assert not foreign.compatible(engine)
    assert foreign.prime(engine) is False
    assert engine._injected_calibration is None
    engine.close()


def test_factory_with_incompatible_snapshot_spawns_cold(models):
    """make_engine_factory(snapshot=) with a foreign-shape snapshot
    still spawns working engines — prime no-ops, the cold path
    serves."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft, slots=3)  # foreign shape
    factory, oracle = make_engine_factory(
        params, CONFIG, engine_kw=_auto_kw(draft), snapshot=snap,
    )
    assert oracle == snap.probe_oracle  # the oracle still seeds
    engine = factory(None)
    assert engine._injected_calibration is None
    rid = engine.submit([1, 2, 3], 6)
    out = engine.run()
    assert engine.calibration_reused == 0
    assert list(out[rid]) == _ref(params, [1, 2, 3], 6)
    engine.close()


# ---- supervisor + autoscaler reuse ---------------------------------------


def test_supervisor_calibrate_probe_reuses_snapshot_oracle(models):
    """FleetSupervisor(snapshot=): the snapshot's captured probe oracle
    seeds the canary — calibrate_probe() returns WITHOUT building a
    scratch engine — and a crashed replica's respawn consumes the
    snapshot (calibration_reused ticks) while ok streams stay
    bit-identical to the dense oracle through the failover."""
    params, draft = models
    engine_kw = _auto_kw(draft)
    snap = _calibrated_snapshot(params, draft)
    factory_calls = []
    base_factory, oracle = make_engine_factory(
        params, CONFIG, engine_kw=engine_kw, snapshot=snap,
    )
    assert oracle == snap.probe_oracle

    def factory(slot):
        factory_calls.append(slot)
        return base_factory(slot)

    fleet = Fleet(
        [ServeEngine(params, CONFIG, **engine_kw) for _ in range(2)],
        chip_ids=["chip-0", "chip-1"], hang_timeout_s=None,
        fault_injector=FaultInjector({"replica_crash": 3}),
    )
    sup = FleetSupervisor(
        fleet, factory, backoff=FAST, probe=PROBE, snapshot=snap,
    )
    # The scratch-calibration seam: with the snapshot's oracle seeded,
    # arming builds NO scratch engine.
    assert sup.calibrate_probe() == snap.probe_oracle
    assert factory_calls == []

    reqs = REQUESTS_GREEDY * 2
    rids = [fleet.submit(p, n) for p, n in reqs]
    sup.run()
    terminal = {fr.rid: fr.status for fr in fleet.completed}
    assert fleet.replica_crashes == 1
    assert sup.wait_healed(20.0), sup.states()
    for rid, (p, n) in zip(rids, reqs):
        ref = _ref(params, p, n)
        fr = fleet._reqs[rid]
        if terminal.get(rid) == "ok":
            assert fr.tokens == ref, rid
        else:
            assert fr.tokens == ref[: len(fr.tokens)], rid
    # Exactly the resurrection went through the factory, and the
    # respawned replica consumed the snapshot instead of re-calibrating.
    assert len(factory_calls) >= 1
    reused = sum(
        r.engine.calibration_reused for r in fleet.replicas
        if r.engine is not None
    )
    assert reused >= 1
    fleet.close()


def test_supervisor_ignores_snapshot_with_foreign_probe(models):
    """A snapshot captured against a DIFFERENT canary must not seed the
    oracle — the supervisor keeps its scratch-calibration path."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft)  # snap.probe == PROBE
    fleet = Fleet(
        [ServeEngine(params, CONFIG, **_auto_kw(draft))],
        chip_ids=["chip-0"], hang_timeout_s=None,
    )
    sup = FleetSupervisor(
        fleet, lambda slot: None, probe=([7, 8], 3), snapshot=snap,
    )
    assert sup._probe_oracle is None
    fleet.close()


def test_autoscaler_scaleup_consumes_snapshot(models):
    """FleetAutoscaler(snapshot=): the oracle seeds from the snapshot
    (calibrate_probe builds nothing) and a probed scale-up joins a
    replica whose calibration came from the snapshot — and that
    replica serves oracle-true."""
    from workloads_torch.autoscaler import FleetAutoscaler

    params, draft = models
    engine_kw = _auto_kw(draft)
    snap = _calibrated_snapshot(params, draft)
    factory, _ = make_engine_factory(
        params, CONFIG, engine_kw=engine_kw, snapshot=snap,
    )
    fleet = Fleet(
        [ServeEngine(params, CONFIG, **engine_kw)],
        chip_ids=["chip-0"], hang_timeout_s=None,
    )
    asc = FleetAutoscaler(
        fleet, factory, min_replicas=1, max_replicas=2,
        probe=PROBE, snapshot=snap,
        up_backoff=Backoff(base_s=1e-3, max_s=8e-3, jitter=0.0),
    )
    assert asc.calibrate_probe() == snap.probe_oracle
    assert asc._try_scale_up(asc._clock())
    assert len(fleet.replicas) == 2
    joined = fleet.replicas[1].engine
    assert joined.calibration_reused == 1
    assert joined.spec_breakeven == snap.spec_breakeven
    rids = [fleet.submit(p, n) for p, n in REQUESTS_GREEDY]
    out = fleet.run()
    for rid, (p, n) in zip(rids, REQUESTS_GREEDY):
        assert out[rid] == _ref(params, p, n)
    fleet.close()


def test_fleet_add_replica_primes(models):
    """Fleet.add_replica(snapshot=): a live joiner is primed before it
    takes traffic — drain the incumbent and the joiner serves with the
    snapshot's calibration, never re-running the dead dispatches."""
    params, draft = models
    snap = _calibrated_snapshot(params, draft)
    engine_kw = _auto_kw(draft)
    fleet = Fleet(
        [ServeEngine(params, CONFIG, **engine_kw)],
        chip_ids=["chip-0"], hang_timeout_s=None,
    )
    joiner = ServeEngine(params, CONFIG, **engine_kw)
    index = fleet.add_replica(joiner, "chip-1", snapshot=snap)
    assert index == 1
    assert joiner._injected_calibration == snap.spec_calibration
    fleet.drain(0)  # route everything to the primed joiner
    rid = fleet.submit([1, 2, 3], 6)
    out = fleet.run()
    assert out[rid] == _ref(params, [1, 2, 3], 6)
    assert joiner.calibration_reused == 1
    fleet.close()


# ---- compile cache + counters --------------------------------------------


def test_compile_cache_enable_and_engine_deltas(models, tmp_path):
    """enable_compile_cache points the kernel-build cache at the directory (idempotently,
    returning the canonical path) and each engine reports hit/miss
    DELTAS against the process-wide counters from its own birth."""
    params, draft = models
    cache = str(tmp_path / "cc")
    enabled = enable_compile_cache(cache)
    assert enabled == compile_cache_dir() == os.path.abspath(cache)
    assert enable_compile_cache(cache) == enabled  # idempotent
    before = cache_stats()
    engine = _auto_engine(params, draft)
    rid = engine.submit([1, 2, 3], 6)
    out = engine.run()
    assert list(out[rid]) == _ref(params, [1, 2, 3], 6)
    after = cache_stats()
    assert engine.compile_cache_hits == after["hits"] - before["hits"]
    assert engine.compile_cache_misses == (
        after["misses"] - before["misses"]
    )
    engine.close()


def test_faststart_counters_reach_registry(models):
    """The obs.py mirror: calibration_reused (and the compile-cache
    families) are catalogued ENGINE_METRICS, and a primed engine's
    skip lands on a bound metrics registry as a counter series."""
    from tpu_device_plugin.metrics import Registry
    from workloads_torch.obs import ENGINE_METRICS, EngineObserver

    names = {m.name for m in ENGINE_METRICS}
    for name in (
        "engine_calibration_reused_total",
        "engine_compile_cache_hits_total",
        "engine_compile_cache_misses_total",
    ):
        assert name in names
    params, draft = models
    snap = _calibrated_snapshot(params, draft)
    reg = Registry()
    obs = EngineObserver()
    engine = _auto_engine(params, draft, observer=obs)
    obs.bind_registry(reg)
    assert snap.prime(engine)
    rid = engine.submit([1, 2, 3], 6)
    out = engine.run()
    assert list(out[rid]) == _ref(params, [1, 2, 3], 6)
    assert engine.calibration_reused == 1
    text = reg.render()
    assert "engine_calibration_reused_total" in text
    engine.close()


def test_serve_cli_and_constructor_expose_compile_cache(models, tmp_path):
    """The two wiring points: the ServeEngine constructor kwarg enables
    the process cache before its first kernel load, and the serve CLI
    carries the matching --compile-cache-dir flag."""
    from workloads_torch import serve

    params, draft = models
    cache = str(tmp_path / "ctor-cc")
    engine = _auto_engine(params, draft, compile_cache_dir=cache)
    assert compile_cache_dir() == os.path.abspath(cache)
    engine.close()
    assert "--compile-cache-dir" in inspect.getsource(serve.main)


def test_smoke(models):
    """A seeded crash under supervision with the
    snapshot armed — the respawn skips calibration and ok streams stay
    bit-identical to the dense oracle (the acceptance contract in one
    fast pin)."""
    test_supervisor_calibrate_probe_reuses_snapshot_oracle(models)


# ---- degrade hardening (tests/test_durable.py: snapshot + device table) --


def test_engine_snapshot_corrupt_artifact_degrades_to_cold(tmp_path):
    path = str(tmp_path / "snap.json")
    with open(path, "w", encoding="utf-8") as f:
        f.write('{"version": 1, "config_fingerprint"')  # torn
    before = EngineSnapshot.load_errors
    assert EngineSnapshot.load(path) is None
    assert EngineSnapshot.load(str(tmp_path / "missing.json")) is None
    assert EngineSnapshot.load_errors == before + 2


def test_device_table_corrupt_artifact_adopts_nothing(tmp_path):
    from workloads_torch.profiler import DeviceTimeTable

    path = str(tmp_path / "bench.json")
    with open(path, "w", encoding="utf-8") as f:
        f.write("{torn artifact")
    table = DeviceTimeTable()
    assert table.refresh_from_artifact(path) == 0
    assert table.refresh_from_artifact(["not", "a", "dict"]) == 0
    assert table.refresh_errors == 2


# ---- the port's kernel-build cache ---------------------------------------


def _fake_nvcc(tmp_path, monkeypatch):
    """An nvcc stand-in that writes the ``-o`` file, so a build runs
    without the CUDA toolkit; returns its invocation log."""
    from workloads_torch.ops import _build

    log = tmp_path / "nvcc-calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi\n'
        "  shift\n"
        "done\n"
    )
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    return log


def test_build_cache_counts_a_run_of_nvcc_as_a_miss_and_a_reuse_as_a_hit(
    tmp_path, monkeypatch
):
    """enable_compile_cache on a fresh directory: each kernel source
    builds there (one miss each, one nvcc run each); a second enable of
    the same directory finds every library built (one hit each, no
    nvcc run).  The library names carry the source hash."""
    from workloads_torch.ops import _build

    log = _fake_nvcc(tmp_path, monkeypatch)
    cache = str(tmp_path / "kernels")
    assert enable_compile_cache(cache) == os.path.abspath(cache)
    c0 = cache_stats()
    for name in _build.KERNELS:
        assert _build.build(name) > 0.0
        assert _build.library_path(name).parent == tmp_path / "kernels"
        assert _build.library_path(name).exists()
    c1 = cache_stats()
    assert (c1["hits"] - c0["hits"], c1["misses"] - c0["misses"]) == (0, len(_build.KERNELS))
    assert len(log.read_text().splitlines()) == len(_build.KERNELS)
    enable_compile_cache(str(tmp_path / "elsewhere"))
    enable_compile_cache(cache)
    for name in _build.KERNELS:
        assert _build.build(name) == 0.0
    c2 = cache_stats()
    assert (c2["hits"] - c1["hits"], c2["misses"] - c1["misses"]) == (len(_build.KERNELS), 0)
    assert len(log.read_text().splitlines()) == len(_build.KERNELS)


def test_build_cache_hits_in_a_fresh_process(tmp_path, monkeypatch):
    """The cache outlives the process that filled it: a second
    interpreter pointed at the same directory counts hits and runs no
    nvcc."""
    import subprocess
    import sys

    from workloads_torch.ops import _build

    _fake_nvcc(tmp_path, monkeypatch)
    cache = str(tmp_path / "kernels")
    enable_compile_cache(cache)
    for name in _build.KERNELS:
        _build.build(name)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, sys\n"
        "from workloads_torch.faststart import cache_stats, enable_compile_cache\n"
        "from workloads_torch.ops import _build\n"
        "_build._nvcc = lambda: sys.exit('nvcc must not run')\n"
        f"enable_compile_cache({cache!r})\n"
        "for name in _build.KERNELS:\n"
        "    _build.build(name)\n"
        "print(json.dumps(cache_stats()))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "hits": len(_build.KERNELS), "misses": 0}
