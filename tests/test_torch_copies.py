"""The port's copies of the JAX package's jax-free modules stay copies.

For each copied module both files are parsed with ``ast``, every
docstring is stripped, and each top-level function and class, and each
method, must ``ast.unparse`` equal: comments, docstrings and line
wrapping may differ, code may not.  Only the allowlist below may differ,
each for a reason the port's module docstring gives.  The JAX files are
read as text; nothing of the JAX package is imported, so this stays in
the fast tier.
"""

from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = ["errors", "faults", "backoff", "durable", "obs", "ledger", "fleet",
          "supervisor", "autoscaler", "control", "profiler", "faststart",
          "ops/kernel_select", "lease", "busy_probe", "oversubscribe"]

# (module, definition): the port builds its own engine on a device
# (make_fleet, make_engine_factory), writes the device plugin's stats
# document without the JAX package's durable (publish_stats), reads
# HEALTHY from a copy instead of the gRPC-importing package
# (note_health), and keeps the disk tier's page codec on tensors
# (KVDiskTier itself is JAX's code and is held to it).  One fixes a
# fault of the reference: JAX's journal_now leaves cancelled, expired
# and failed sessions out, so restore() re-mints the rid of one that
# ended just before the restart (tests/test_torch_fleet_contracts.py
# test_restore_never_remints_a_rid_that_ended_before_the_restart).
# The profiler captures with torch.profiler on an owner thread
# (ProfileSession.start/stop) and reads the port's own bench artifact
# (load_committed_artifact); fast start points the kernel-build cache,
# not jax.config (enable_compile_cache, no jax.monitoring listener), and
# fingerprints the torch version and the card's name (fingerprint_engine,
# _device_name, EngineSnapshot.capture).  The kernel table reads the
# CUDA card's name (device_kind, kernel_table) and takes the crossover
# from its caller instead of importing the JAX model (kernel_for_seq).
# The lease client keeps its own copy of the daemon's lease-file names
# (lease_path, claim_lease_path; held to tpu_device_plugin/sharing.py
# below), since the daemon's module loads gRPC.  The busy probe's bursts
# build on a torch device (make_burst_fn, make_train_burst_fn,
# make_serve_burst_fn, run_probe, main: --device, no JAX_PLATFORMS);
# the harness's pods run the port's probe on a torch device type
# (run_pods, the pod half of run; main's --device), and its gRPC loads
# on first use (_LazyModule) so that the pod half runs without it.  On a
# card engine the observer's device time is CUDA-event time split into
# prefill and decode (StepRecord, EngineObserver._step_begin/_step_end),
# which the trace's device lane draws (trace_events).
ALLOWED = {
    ("lease", "lease_path"),
    ("lease", "claim_lease_path"),
    ("busy_probe", "make_burst_fn"),
    ("busy_probe", "make_train_burst_fn"),
    ("busy_probe", "make_serve_burst_fn"),
    ("busy_probe", "run_probe"),
    ("busy_probe", "main"),
    ("oversubscribe", "_LazyModule"),
    ("oversubscribe", "run_pods"),
    ("oversubscribe", "run"),
    ("oversubscribe", "main"),
    ("fleet", "make_fleet"),
    ("fleet", "Fleet.publish_stats"),
    ("fleet", "Fleet.journal_now"),
    ("supervisor", "FleetSupervisor.note_health"),
    ("supervisor", "make_engine_factory"),
    ("durable", "_np_dtype"),
    ("durable", "_torch_dtype"),
    ("durable", "_raw"),
    ("durable", "_pack_blob"),
    ("durable", "_unpack_blob"),
    ("profiler", "ProfileSession.start"),
    ("profiler", "ProfileSession.stop"),
    ("profiler", "load_committed_artifact"),
    ("faststart", "_on_event"),
    ("faststart", "enable_compile_cache"),
    ("faststart", "fingerprint_engine"),
    ("faststart", "_device_name"),
    ("faststart", "EngineSnapshot.capture"),
    ("ops/kernel_select", "device_kind"),
    ("ops/kernel_select", "kernel_table"),
    ("ops/kernel_select", "kernel_for_seq"),
    ("obs", "StepRecord"),
    ("obs", "EngineObserver._step_begin"),
    ("obs", "EngineObserver._step_end"),
    ("obs", "trace_events"),
}


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _definitions(path: str) -> dict[str, str]:
    """{name: unparsed code} for every top-level function and class and
    every method (``Class.method``); a class's own entry is its body
    without its methods (fields, class attributes, decorators, bases)."""
    with open(path, encoding="utf-8") as f:
        tree = _strip_docstrings(ast.parse(f.read()))
    out = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, funcs):
            out[node.name] = ast.unparse(node)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, funcs):
                    out[f"{node.name}.{item.name}"] = ast.unparse(item)
            node.body = [i for i in node.body if not isinstance(i, funcs)] or [ast.Pass()]
            out[node.name] = ast.unparse(node)
    return out


def _allowed(module: str, name: str) -> bool:
    return any(m == module and (name == d or name.startswith(d + "."))
               for m, d in ALLOWED)


def _pair(module: str):
    jax_defs = _definitions(os.path.join(ROOT, "workloads", f"{module}.py"))
    port_defs = _definitions(os.path.join(ROOT, "workloads_torch", f"{module}.py"))
    return jax_defs, port_defs


@pytest.mark.parametrize("module", COPIED)
def test_copy_defines_what_jax_defines(module):
    jax_defs, port_defs = _pair(module)
    missing = sorted(n for n in set(jax_defs) - set(port_defs) if not _allowed(module, n))
    extra = sorted(n for n in set(port_defs) - set(jax_defs) if not _allowed(module, n))
    assert not missing and not extra, (missing, extra)


@pytest.mark.parametrize("module", COPIED)
def test_copy_code_equals_jax(module):
    jax_defs, port_defs = _pair(module)
    drifted = sorted(
        n for n in set(jax_defs) & set(port_defs)
        if not _allowed(module, n) and jax_defs[n] != port_defs[n]
    )
    assert not drifted, drifted


def test_allowlist_names_real_differences():
    """Every allowlisted definition does differ (or exists on one side
    only), so the allowlist cannot quietly outgrow the port's changes."""
    for module, name in sorted(ALLOWED):
        jax_defs, port_defs = _pair(module)
        keys = {n for n in set(jax_defs) | set(port_defs)
                if n == name or n.startswith(name + ".")}
        assert keys, (module, name)
        assert any(jax_defs.get(n) != port_defs.get(n) for n in keys), (module, name)


def test_strip_and_compare_catch_a_change():
    """The comparison itself: a docstring or a comment may change, a
    constant in the code may not."""
    a = _strip_docstrings(ast.parse('def f(x):\n    """doc"""\n    return x + 1\n'))
    b = _strip_docstrings(ast.parse('def f(x):\n    """other"""\n    # note\n    return x + 1\n'))
    c = _strip_docstrings(ast.parse('def f(x):\n    return x + 2\n'))
    assert ast.unparse(a) == ast.unparse(b) != ast.unparse(c)


def test_lease_names_equal_the_daemons():
    """The lease client's copy of the daemon's lease-file naming contract
    (tpu_device_plugin/sharing.py, imported here: the tier-1 host has
    gRPC): each constant, each path, and the two functions' code."""
    from tpu_device_plugin import sharing

    from workloads_torch import lease

    for name in ("DEFAULT_LEASE_DIR", "LEASE_DIR_ENV", "CLAIM_LEASE_DIR_ENV",
                 "CLAIM_EPOCH_ENV"):
        assert getattr(lease, name) == getattr(sharing, name), name
    for chip in ("tpu-0", "tpu-13", "a/b", "tray/0/chip/1"):
        assert lease.lease_path("/d", chip) == sharing.lease_path("/d", chip)
        for epoch in (None, "", "18f3a2b4c5d6e7f8"):
            assert lease.claim_lease_path("/d", chip, epoch) == \
                sharing.claim_lease_path("/d", chip, epoch)
    daemon = _definitions(os.path.join(ROOT, "tpu_device_plugin", "sharing.py"))
    port = _definitions(os.path.join(ROOT, "workloads_torch", "lease.py"))
    for name in ("lease_path", "claim_lease_path"):
        assert port[name] == daemon[name], name
