"""Checkpoint and resume for the training step.  Port of
``workloads/checkpoint.py`` (which wraps orbax) with the same interface:

  * ``save(step, (params, opt_state))`` writes one versioned file and
    keeps the newest ``max_to_keep``;
  * ``restore_latest(like)`` returns the newest state, each tensor on the
    device and in the dtype of the matching leaf of ``like``.

A checkpoint is one ``torch.save`` file, ``step_<step>.pt``, written to
a temporary name, flushed to disk and renamed into place, so a crash
mid-save leaves the previous checkpoint as the newest one.  Saves are
synchronous, so ``wait`` has nothing to wait for.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _restore_like(saved, like):
    """``saved`` with every tensor moved to the device and dtype of the
    leaf at the same place in ``like``; raises on a structure mismatch."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
            raise ValueError(
                f"checkpoint leaf {getattr(saved, 'shape', type(saved))} does "
                f"not match {tuple(like.shape)}"
            )
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError("checkpoint tree does not match the target's keys")
        return {k: _restore_like(saved[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError("checkpoint tree does not match the target's length")
        return type(like)(_restore_like(s, l) for s, l in zip(saved, like))
    return saved


class TrainCheckpointer:
    """Versioned training checkpoints in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._closed = False

    def _steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for name in os.listdir(self.directory)
            if (m := _NAME.match(name))
        )

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state) -> None:
        if self._closed:
            raise RuntimeError("checkpointer is closed")
        final = self._path(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    @property
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like):
        """The newest checkpoint shaped like ``like`` (a live state tree),
        or None if there is none."""
        step = self.latest_step
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return _restore_like(saved, like)

    def close(self) -> None:
        self._closed = True
