"""A profiled slice of a run and what it reads: device busy time, kernel
time by name, the device operations that took most time and the longest
idle gaps by what the host was doing.

``Slice`` synchronises (on the card), starts ``torch.profiler`` with CPU and CUDA
activities, and on exit synchronises again, so every device operation
of the work inside it, and none from before, is in the trace.  The trace
is written as a Chrome trace into the run's scratch directory, read and
deleted by ``read``, which the runners call once the slice is over.  A trace can drop a few kernel records; ``kernel_s`` therefore
also returns how many records it found, so a reader can scale by the
launches it expects.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def span(name: str):
    """A host span the trace labels idle gaps with (``bench.*``)."""
    return torch.profiler.record_function(name)


class Slice:
    def __init__(self, scratch: str, cuda: bool = True):
        self.cuda = cuda
        # Written and deleted at once; the process id keeps runs apart.
        self.path = os.path.join(scratch, f"slice_trace.{os.getpid()}.json")
        self.prof = None
        self.wall_s = 0.0
        self.device: list[tuple[float, float, str]] = []  # (start us, end us, name)
        self.host: list[tuple[float, float, str]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def read(self) -> None:
        """Write the trace out, read its events and delete it."""
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self.prof = None
        self._keep(events)

    def _keep(self, events: list[dict]) -> None:
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                self.device.append((start, end, e.get("name", "?")))
            elif e.get("cat") in HOST_CATS:
                self.host.append((start, end, e.get("name", "?")))
        self.device.sort()

    def merged(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for start, end, _ in self.device:
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-6

    def kernel_s(self, *markers: str) -> tuple[float, int]:
        """(seconds, records) of the device operations whose name holds
        any of ``markers``."""
        picked = [(b - a) for a, b, n in self.device if any(m in n for m in markers)]
        return sum(picked) * 1e-6, len(picked)

    def device_ops(self) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            total[n[:160]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle time between device operations, summed by the host's
        innermost span or call at each gap's middle (under the
        ``bench.*`` span around it), longest first."""
        merged = self.merged()
        host = sorted(self.host)
        spans = [h for h in host if h[2].startswith("bench.")]
        total: dict[str, float] = defaultdict(float)
        for (_, end), (start, _) in zip(merged, merged[1:]):
            mid = 0.5 * (end + start)
            label = _covering(host, mid) or "(no host event)"
            outer = _covering(spans, mid)
            if outer and outer != label:
                label = f"{outer} > {label}"
            total[label[:160]] += (start - end) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:TOP]]


def _covering(events: list[tuple[float, float, str]], t: float, look: int = 256) -> str | None:
    """The name of the latest-starting event of ``events`` (sorted by
    start) that covers ``t``: the innermost of nested spans."""
    i = bisect.bisect_right(events, (t, float("inf"), "")) - 1
    for j in range(i, max(i - look, -1), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None
