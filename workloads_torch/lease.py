"""Cooperative per-chip lease client for time-sliced pods, copied from
``workloads/lease.py`` (it imports no JAX: ``fcntl`` locks over the
device plugin's lease files), with its own copy of the lease-file names
of ``tpu_device_plugin/sharing.py``.

Pods oversubscribed onto a chip cooperate: each takes the chip lease
(an flock on a per-chip file in the host-shared lease directory the
plugin mounts into every shared pod), runs a burst of steps, releases,
repeats.  The kernel guarantees fairness by queueing and releases the
lease when a pod dies mid-burst (flocks drop with the fd).  Under the
mixed strategy ``hold_claim_leases`` declares the workload's lifetime
to the daemon; the serve, training, vision and busy-probe CLIs and the
MFU sweep take those leases before they touch the device.

Usage inside a pod (env vars are injected by the plugin's Allocate):

    from workloads_torch import lease
    with lease.chip_lease():          # blocks until this pod owns its chips
        ... run a burst of steps ...
    # released: another pod's turn
"""

from __future__ import annotations

import fcntl
import os
import time
from contextlib import contextmanager

# The lease-file naming contract with the device-plugin daemon, copied
# from ``tpu_device_plugin/sharing.py``: importing that module loads
# ``tpu_device_plugin.api`` and with it gRPC and protobuf, which a pod
# (and the card's host) need not have.  tests/test_torch_copies.py holds
# the copies equal to the daemon's.
DEFAULT_LEASE_DIR = "/var/run/tpu-device-plugin/leases"
LEASE_DIR_ENV = "TPU_SHARED_LEASE_DIR"
CLAIM_LEASE_DIR_ENV = "TPU_CLAIM_LEASE_DIR"
CLAIM_EPOCH_ENV = "TPU_CLAIM_EPOCH"


def lease_path(lease_dir: str, chip_id: str) -> str:
    """Host path of a chip's lease file."""
    return os.path.join(lease_dir, f"chip-{chip_id.replace('/', '_')}.lock")


def claim_lease_path(
    lease_dir: str, chip_id: str, epoch: str | None = None
) -> str:
    """Host path of a chip's lifetime claim lease (distinct from the
    cooperative time-slice lease: this one is held from workload start to
    exit, not per burst).  With ``epoch`` the file is scoped to one
    allocation: ``claim-<chip>.<epoch>.lock``."""
    base = f"claim-{chip_id.replace('/', '_')}"
    if epoch:
        return os.path.join(lease_dir, f"{base}.{epoch}.lock")
    return os.path.join(lease_dir, f"{base}.lock")


def chip_ids_from_env() -> list[str]:
    """Chip ids the plugin granted this pod (from TPU_VISIBLE_CHIPS)."""
    raw = os.environ.get("TPU_VISIBLE_CHIPS", "")
    return [c for c in raw.split(",") if c]


# fds of lifetime claim leases, held until process exit (the kernel drops
# the flocks with the fds — crash-safe by construction), and the paths
# they cover (idempotence).
_claim_fds: list[int] = []
_claim_paths: set[str] = set()


def hold_claim_leases(
    chip_ids: list[str] | None = None, lease_dir: str | None = None
) -> int:
    """Declare this workload's lifetime to the device-plugin daemon.

    Under the mixed strategy the daemon's ClaimLedger needs to observe
    workload exits to release cross-view chip claims; with the chart's
    default ``hostPID: false`` it cannot see other namespaces' /proc, so
    the contract is filesystem-level: take a per-chip flock here and hold
    it until the process exits.  The daemon reads held = alive, dropped =
    exited (released within one probe interval), and treats workloads
    that never call this as unknown (their claims fall back to the TTL).

    The flock is SHARED: every pod time-sliced onto a chip holds its own
    shared lock on the same file, the daemon's probe takes a momentary
    exclusive lock to test for holders, and acquisition here BLOCKS —
    which only ever waits out that probe's microsecond hold, never a
    sibling (shared locks compose).

    The claim file name carries this allocation's epoch (TPU_CLAIM_EPOCH,
    injected by Allocate) so the daemon reads death evidence only from
    the allocation it belongs to — a predecessor pod's dropped flock can
    never read as THIS pod's exit.

    No-op (returns 0) when TPU_CLAIM_LEASE_DIR is absent — non-mixed
    deployments inject no claim-lease env.  Idempotent per process.
    Returns the number of flocks newly taken."""
    lease_dir = lease_dir or os.environ.get(CLAIM_LEASE_DIR_ENV, "")
    if not lease_dir:
        return 0
    epoch = os.environ.get(CLAIM_EPOCH_ENV) or None
    chip_ids = sorted(chip_ids if chip_ids is not None else chip_ids_from_env())
    os.makedirs(lease_dir, exist_ok=True)
    taken = 0
    for cid in chip_ids:
        path = claim_lease_path(lease_dir, cid, epoch)
        if path in _claim_paths:
            continue  # this process already declares this chip
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
        fcntl.flock(fd, fcntl.LOCK_SH)
        _claim_fds.append(fd)
        _claim_paths.add(path)
        taken += 1
    return taken


@contextmanager
def chip_lease(chip_ids: list[str] | None = None, lease_dir: str | None = None):
    """Blocks until ALL of this pod's chips are leased, then yields.

    Chips are locked in sorted order, which makes concurrent gang
    acquisitions deadlock-free.  Defaults come from the environment the
    plugin injected (TPU_VISIBLE_CHIPS, TPU_SHARED_LEASE_DIR).
    """
    lease_dir = lease_dir or os.environ.get(LEASE_DIR_ENV, DEFAULT_LEASE_DIR)
    chip_ids = sorted(chip_ids if chip_ids is not None else chip_ids_from_env())
    os.makedirs(lease_dir, exist_ok=True)
    fds: list[int] = []
    try:
        for cid in chip_ids:
            fd = os.open(lease_path(lease_dir, cid), os.O_CREAT | os.O_RDWR, 0o666)
            fcntl.flock(fd, fcntl.LOCK_EX)
            fds.append(fd)
        yield
    finally:
        for fd in reversed(fds):
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)


def try_chip_lease(chip_ids: list[str] | None = None, lease_dir: str | None = None):
    """Non-blocking variant: returns a release() callable or None if any
    chip is currently owned by another pod."""
    lease_dir = lease_dir or os.environ.get(LEASE_DIR_ENV, DEFAULT_LEASE_DIR)
    chip_ids = sorted(chip_ids if chip_ids is not None else chip_ids_from_env())
    os.makedirs(lease_dir, exist_ok=True)
    fds: list[int] = []

    def release():
        for fd in reversed(fds):
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    for cid in chip_ids:
        fd = os.open(lease_path(lease_dir, cid), os.O_CREAT | os.O_RDWR, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            os.close(fd)
            release()
            return None
        fds.append(fd)
    return release


def run_leased_bursts(
    burst_fn,
    duration_secs: float,
    chip_ids: list[str] | None = None,
    lease_dir: str | None = None,
    backoff_secs: float = 0.002,
) -> dict:
    """Interleave with sibling pods for ``duration_secs``: lease, run one
    burst_fn() (a batch of steps), release, repeat.  Returns busy/wall
    accounting used by the busy probe."""
    t_start = time.monotonic()
    busy = 0.0
    bursts = 0
    while time.monotonic() - t_start < duration_secs:
        with chip_lease(chip_ids, lease_dir):
            t0 = time.monotonic()
            burst_fn()
            busy += time.monotonic() - t0
        bursts += 1
        time.sleep(backoff_secs)  # let a waiting sibling grab the flock
    wall = time.monotonic() - t_start
    return {"busy_secs": busy, "wall_secs": wall, "bursts": bursts}
