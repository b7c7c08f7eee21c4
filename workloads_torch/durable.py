"""The KV disk tier below host RAM, ported from ``workloads/durable.py``.

The port's own copy of the JAX package's disk tier (the session journal
comes with the fleet): per-page files named by the same ``_chain_key``
hex the radix tree uses, each ``magic + sha256(payload) + payload`` with
the payload an ``.npz`` of the page's raw bytes beside a
``[dtype name, shape]`` sidecar.  The format is the JAX package's byte
for byte in meaning, so a page file written by either engine reads back
bit-exactly, dtype and all, in the other.

Blobs here are torch tensors: ``((k, v), draft_or_None)``, each
``[layers, kv_heads, page_size, head_dim]`` on the CPU.  numpy knows no
bfloat16, so the codec moves every tensor through a ``uint8`` view of
its bytes and names its dtype by torch's own name (``"bfloat16"``,
``"float32"``), which are the names the JAX package writes.

Contracts, as in the JAX package:

  * **atomic**: every write goes through :func:`atomic_write_bytes`
    (temp file, fsync, ``os.replace``), so a reader never sees a torn
    file;
  * **checksum-verified, degrade-to-miss**: a corrupt read is counted,
    its file unlinked, and it reads as a miss (a shorter prefix hit); a
    failed write returns False and the caller keeps its host copy;
  * **dedup by construction**: files are named by chain key, so a
    ``put`` of a key already on disk is a touch, not a write.

The ``kv_disk_write_fail`` and ``kv_disk_read_corrupt`` fault seams
(``faults.py``) fire inside ``put`` and ``get``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time

import numpy as np
import torch


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` so that a concurrent reader sees either
    the old complete file or the new one, never a prefix: a temp file in
    the same directory (``os.replace`` must not cross filesystems),
    flushed and fsynced before the rename."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


# File format: magic + sha256(payload) + payload (an .npz archive of the
# page's arrays as raw bytes, plus a JSON sidecar of dtype names and
# shapes).  The checksum covers the payload, so a torn or bit-flipped
# file never deserializes into wrong k/v bytes.
_PAGE_MAGIC = b"KVDPAGE1"
_PAGE_SUFFIX = ".kvpage"


def _torch_dtype(name: str) -> torch.dtype:
    """A dtype name of the file format (``"bfloat16"``, ``"float32"``,
    ...) as the torch dtype of that name."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"disk page names an unknown dtype {name!r}")
    return dtype


def _raw(t) -> tuple[np.ndarray, list]:
    """A tensor as (its bytes as a uint8 array, [dtype name, shape])."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    data = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)
    return data, [name, list(t.shape)]


def _pack_blob(blob) -> bytes:
    """Serialize one host-tier page blob, ``((k, v), draft_or_None)`` in
    the engine's spill format, to self-verifying bytes."""
    (mk, mv), draft = blob
    tensors = {"mk": mk, "mv": mv}
    if draft is not None:
        tensors["dk"], tensors["dv"] = draft
    raw, meta = {}, {}
    for name, t in tensors.items():
        raw[name], meta[name] = _raw(t)
    raw["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8
    )
    bio = io.BytesIO()
    np.savez(bio, **raw)
    payload = bio.getvalue()
    return _PAGE_MAGIC + hashlib.sha256(payload).digest() + payload


def _unpack_blob(data: bytes):
    """Inverse of :func:`_pack_blob`: CPU tensors of the stored dtypes.
    Raises ValueError on any damage (bad magic, checksum mismatch,
    malformed archive)."""
    if data[: len(_PAGE_MAGIC)] != _PAGE_MAGIC:
        raise ValueError("bad disk-page magic")
    digest = data[len(_PAGE_MAGIC) : len(_PAGE_MAGIC) + 32]
    payload = data[len(_PAGE_MAGIC) + 32 :]
    if hashlib.sha256(payload).digest() != digest:
        raise ValueError("disk-page checksum mismatch")
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        try:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        except KeyError as exc:
            raise ValueError("disk-page meta missing") from exc

        def _tensor(name: str) -> torch.Tensor:
            dtype_name, shape = meta[name]
            flat = torch.from_numpy(np.array(z[name], dtype=np.uint8))
            return flat.view(_torch_dtype(dtype_name)).reshape(shape)

        mk, mv = _tensor("mk"), _tensor("mv")
        draft = (_tensor("dk"), _tensor("dv")) if "dk" in z.files else None
    return ((mk, mv), draft)


class KVDiskTier:
    """Per-page KV files under one directory: the tier below the radix
    tree's host-RAM budget.

    Keys are chain-key hex strings, so the file namespace is the dedup:
    every engine and process sharing the directory stores a given prefix
    page once, and a restart finds the pages again by recomputing the
    same hashes.  ``budget_pages`` caps the file count with mtime-LRU
    eviction (get and put touch); None is unbounded.

    Every failure degrades to a miss: a failed write keeps the blob in
    host RAM (the caller checks the return), a corrupt read is
    quarantined (file unlinked, counter bumped) and the lookup's prefix
    hit ends one page earlier."""

    def __init__(self, root: str, budget_pages: int | None = None, injector=None):
        if budget_pages is not None and budget_pages < 1:
            raise ValueError(
                f"budget_pages must be >= 1 or None (unbounded), got {budget_pages}"
            )
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.budget_pages = budget_pages
        self._faults = injector
        self.writes = 0  # pages newly written to disk
        self.dedup_hits = 0  # puts satisfied by an existing file
        self.reads = 0  # pages read back intact
        self.read_corrupt = 0  # reads that failed verification
        self.write_failures = 0  # puts that could not land
        self.evictions = 0  # files dropped by the budget
        # Wall seconds inside put and get; the engine folds them into its
        # kv_spill_s and kv_reload_s.
        self.put_s = 0.0
        self.get_s = 0.0

    def _path(self, key_hex: str) -> str:
        if not key_hex or any(c not in "0123456789abcdef" for c in key_hex):
            raise ValueError(f"disk-tier keys are hex digests, got {key_hex!r}")
        return os.path.join(self.root, key_hex + _PAGE_SUFFIX)

    def _files(self) -> list[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in names if n.endswith(_PAGE_SUFFIX)]

    @property
    def pages(self) -> int:
        """Files in the tier now: the directory's truth, since the
        directory is shared across engines and processes."""
        return len(self._files())

    def contains(self, key_hex: str) -> bool:
        return os.path.exists(self._path(key_hex))

    def _evict_to_budget(self, incoming: int = 1) -> None:
        if self.budget_pages is None:
            return
        files = self._files()
        excess = len(files) + incoming - self.budget_pages
        if excess <= 0:
            return

        def mtime(p: str) -> float:
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0

        # Coldest first by mtime (get and put touch).
        for path in sorted(files, key=mtime)[:excess]:
            try:
                os.unlink(path)
                self.evictions += 1
            except OSError:
                pass

    def put(self, key_hex: str, blob) -> bool:
        """Store one page blob under its chain key; True when a durable
        copy exists afterwards (a fresh write or a dedup hit).  False
        means the write failed and the caller keeps its host copy."""
        t0 = time.perf_counter()
        try:
            return self._put_impl(key_hex, blob)
        finally:
            self.put_s += time.perf_counter() - t0

    def _put_impl(self, key_hex: str, blob) -> bool:
        path = self._path(key_hex)
        if self._faults is not None:
            from .faults import InjectedFault

            try:
                self._faults.check("kv_disk_write_fail")
            except InjectedFault:
                self.write_failures += 1
                return False
        if os.path.exists(path):
            self.dedup_hits += 1
            try:
                os.utime(path)
            except OSError:
                pass
            return True
        try:
            self._evict_to_budget(incoming=1)
            atomic_write_bytes(path, _pack_blob(blob))
        except (OSError, ValueError):
            self.write_failures += 1
            return False
        self.writes += 1
        return True

    def get(self, key_hex: str):
        """The page blob for ``key_hex``, or None when it is absent or
        corrupt.  A file that fails verification is unlinked, so the
        tier converges back to a clean state."""
        t0 = time.perf_counter()
        try:
            return self._get_impl(key_hex)
        finally:
            self.get_s += time.perf_counter() - t0

    def _get_impl(self, key_hex: str):
        path = self._path(key_hex)
        corrupt = False
        if self._faults is not None:
            from .faults import InjectedFault

            try:
                self._faults.check("kv_disk_read_corrupt")
            except InjectedFault:
                corrupt = True
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if corrupt:
            # The seam models a read returning damaged bytes; verification
            # catches it, so it takes the same path.
            data = data[: max(len(data) // 2, len(_PAGE_MAGIC))]
        try:
            blob = _unpack_blob(data)
        except (ValueError, KeyError, OSError):
            self.read_corrupt += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.reads += 1
        try:
            os.utime(path)
        except OSError:
            pass
        return blob

    def clear(self) -> int:
        """Drop every page file (tests and operator resets; the engine's
        ``close`` does not call this: pages outliving the process are the
        tier's point)."""
        n = 0
        for path in self._files():
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n
