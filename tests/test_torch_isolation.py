"""The PyTorch port stands alone: no module of workloads_torch and not
chip_smoke.py imports jax, anything of the JAX package (workloads) or
ml_dtypes (which comes with jax; the port's disk tier reads bf16 pages
without it), checked by importing everything with all three blocked and
by scanning the sources."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "workloads_torch")

# An import statement naming jax, the JAX package or ml_dtypes
# (workloads_torch is a different name and passes).
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|workloads|ml_dtypes)(?![\w])", re.MULTILINE
)


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_speculation_modules_are_scanned():
    """The scan reaches the speculation slice's modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", "quant.py"),
            os.path.join("workloads_torch", "speculative.py")} <= scanned


def test_lora_modules_are_scanned():
    """The scan reaches the LoRA slice's modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", "lora.py"),
            os.path.join("workloads_torch", "multi_lora.py")} <= scanned


def test_fleet_modules_are_scanned():
    """The scan reaches the fleet and control plane's modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", f"{m}.py") for m in (
        "backoff", "obs", "ledger", "fleet", "supervisor", "autoscaler", "control",
    )} <= scanned


def test_profiling_and_bench_modules_are_scanned():
    """The scan reaches the profiling, fast-start and perfbench modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", f"{m}.py") for m in (
        "profiler", "faststart", "perfbench",
    )} <= scanned


def test_mfu_sweep_is_scanned():
    """The scan reaches the MFU sweep beside perfbench."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert os.path.join("workloads_torch", "mfu_sweep.py") in scanned


def test_tensor_parallel_modules_are_scanned():
    """The scan reaches the tensor-parallel slice's modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", f"{m}.py") for m in (
        "tp_serve", "distributed", "lease",
    )} <= scanned


def test_scan_catches_forbidden_lines():
    """The scan itself: it flags the JAX package and jax, not the port."""
    flagged = [
        "im" + "port jax", "fr" + "om jax import numpy", "  im" + "port workloads.model",
        "fr" + "om workloads import serve", "fr" + "om workloads.ops import x",
        "im" + "port ml_dtypes",
    ]
    allowed = ["fr" + "om workloads_torch import serve", "im" + "port workloads_torch.model",
               "x = 'import jax'"]
    assert all(_FORBIDDEN.search(line) for line in flagged)
    assert not any(_FORBIDDEN.search(line) for line in allowed)


def test_every_module_imports_with_jax_and_workloads_blocked():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter where importing jax or workloads raises."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "sys.modules['jax'] = None",
        "sys.modules['workloads'] = None",
        "sys.modules['ml_dtypes'] = None",
        f"sys.path.insert(0, {ROOT!r})",
        "pkg = importlib.import_module('workloads_torch')",
        "names = ['chip_smoke'] + [m.name for m in pkgutil.walk_packages("
        "pkg.__path__, 'workloads_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert sys.modules['jax'] is None and sys.modules['workloads'] is None",
        "assert sys.modules['ml_dtypes'] is None",
        "assert {'workloads_torch.quant', 'workloads_torch.speculative'} <= set(names)",
        "assert {'workloads_torch.lora', 'workloads_torch.multi_lora'} <= set(names)",
        "assert {'workloads_torch.' + m for m in ('backoff', 'obs', 'ledger', 'fleet',"
        " 'supervisor', 'autoscaler', 'control')} <= set(names)",
        "assert {'workloads_torch.perfbench', 'workloads_torch.mfu_sweep'} <= set(names)",
        "assert {'workloads_torch.' + m for m in ('pipeline', 'moe', 'vision')} <= set(names)",
        "assert {'workloads_torch.busy_probe', 'workloads_torch.oversubscribe'} <= set(names)",
        "print(len(names))",
    ])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 43  # chip_smoke + every port module


# Run time, not just import time: the control plane's lazy imports.  A
# meta-path finder refuses jax, the JAX package and grpc (the card's
# host has no gRPC; ``tpu_device_plugin.api`` imports it), then the
# paths that hold lazy imports run: publish_stats, note_health with
# duck-typed events (``tpu_device_plugin.device.HealthEvent`` would
# load gRPC), the flight recorder's bundle write and the HTTP front end.
_RUNTIME = """
import importlib.abc, json, os, sys, tempfile, types, urllib.request

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "workloads", "grpc", "ml_dtypes"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "workloads", "grpc"):
        del sys.modules[name]
sys.path.insert(0, ROOT)
import torch
from workloads_torch.fleet import Fleet, FleetServer
from workloads_torch.ledger import ChipTimeLedger, FlightRecorder
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import ServeEngine
from workloads_torch.supervisor import FleetSupervisor, make_engine_factory

torch.set_num_threads(1)
config = ModelConfig(max_seq_len=32, n_layers=1, dtype=torch.float32)
params = init_params(config, torch.Generator().manual_seed(0))
kw = dict(slots=2, page_size=4, prompt_bucket=8)
engines = [ServeEngine(params, config, device="cpu", ledger=ChipTimeLedger(name=str(i)), **kw)
           for i in range(2)]
fleet = Fleet(engines, chip_ids=["chip-0", "chip-1"], hang_timeout_s=None)
fleet.submit([1, 2, 3], 3)
fleet.run()
tmp = tempfile.mkdtemp()
path = fleet.publish_stats(os.path.join(tmp, "fleet-stats.json"))
doc = json.load(open(path))
assert set(doc["chips"]) == {"chip-0", "chip-1"} and doc["epoch"] == 1, doc

factory, oracle = make_engine_factory(params, config, engine_kw=kw, probe=([1, 2], 2),
                                      device="cpu")
sup = FleetSupervisor(fleet, factory, probe=([1, 2], 2), probe_oracle=oracle)
Ev = lambda chip_id, health: types.SimpleNamespace(chip_id=chip_id, health=health)
sup.note_health([Ev("chip-1", "Unhealthy")])
assert sup._unhealthy == {"chip-1"}
sup.note_health([Ev("chip-1", "Healthy")])
assert not sup._unhealthy

rec = FlightRecorder(out_dir=os.path.join(tmp, "pm"))
rec.attach_engine("0", engines[0])
rec.attach_fleet(fleet)
rec.attach_supervisor(sup)
rec.poll()
bundle = rec.trigger("manual", "isolation check")
assert bundle and os.path.exists(bundle), bundle

server = FleetServer(fleet, 0, supervisor=sup)
port = server.start()
with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
    assert resp.status == 200
server.stop()
fleet.close()
assert not any(n.split(".")[0] in ("jax", "workloads", "grpc") for n in sys.modules)
print("ok")
"""


def test_control_plane_runs_with_jax_workloads_and_grpc_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _RUNTIME],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_sequence_parallel_modules_are_scanned():
    """The scan reaches the training layouts' attention modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", "ops", f"{m}.py") for m in (
        "ring", "ulysses", "usp",
    )} <= scanned


def test_pipeline_moe_and_vision_modules_are_scanned():
    """The scan reaches the pipeline, expert-parallel and vision modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", f"{m}.py") for m in (
        "pipeline", "moe", "vision",
    )} <= scanned


def test_busy_probe_and_oversubscribe_are_scanned():
    """The scan reaches the sharing slice's modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {os.path.join("workloads_torch", f"{m}.py") for m in (
        "busy_probe", "oversubscribe",
    )} <= scanned


# A pod, or the card's host, may have no gRPC: the lease client and the
# busy probe import without it (and without protobuf, jax and the JAX
# package), a chip lease and the claim leases are taken, and the
# harness's pod half imports with gRPC left unloaded.
_LEASE_RUNTIME = """
import importlib.abc, os, sys, tempfile

BLOCKED = ("jax", "jaxlib", "workloads", "grpc", "ml_dtypes")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED or name == "google.protobuf" \\
                or name.startswith("google.protobuf."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
from workloads_torch import lease
import workloads_torch.busy_probe
from workloads_torch.oversubscribe import run_pods

tmp = tempfile.mkdtemp()
leases = os.path.join(tmp, "leases")
with lease.chip_lease(["tpu-0", "a/b"], leases):
    assert lease.try_chip_lease(["tpu-0"], leases) is None
release = lease.try_chip_lease(["tpu-0"], leases)
assert release is not None
release()
os.environ["TPU_VISIBLE_CHIPS"] = "tpu-0"
os.environ["TPU_CLAIM_EPOCH"] = "e1"
assert lease.hold_claim_leases(lease_dir=leases) == 1
assert sorted(os.listdir(leases)) == ["chip-a_b.lock", "chip-tpu-0.lock", "claim-tpu-0.e1.lock"]
loaded = [n for n in sys.modules if n.split(".")[0] in BLOCKED or n.startswith("google.protobuf")]
assert not loaded, loaded
print("ok")
"""


def test_lease_and_busy_probe_run_with_grpc_protobuf_jax_and_workloads_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _LEASE_RUNTIME],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
