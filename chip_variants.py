#!/usr/bin/env python3
"""Time the port's kernels from several copies of their CUDA sources, in
turns, in one process on one GPU.

    python3 chip_variants.py DIR [DIR ...]
    python3 chip_variants.py --spill-anatomy

Each DIR holds a ``flash_attention.cu`` and/or a ``paged_attention.cu``
(a kernel whose source a DIR lacks is copied there from the checkout); ``.``
stands for the checkout's own ``workloads_torch/ops/csrc``.  Two cards,
or one card at two moments, differ by more than most changes to a
kernel do, so two versions are compared only inside one call: the
directories are timed in the order given and then in reverse (A B B A),
each reading on a line of its own.

What is timed: K2, K3 and K4 at the training path's attention shape
(batch 8, 16 heads, seq 2,047, head_dim 128, causal, bf16) with CUDA
events, and K1 at the serving path's (8 rows of 544 positions, 16
heads, head_dim 128, page_size 64, cycling 8 layers) as a CUDA graph of
64 launches.  K2's out and lse and K1's out are compared bit for bit
with the first directory's, so a variant that changes results says so.
Nothing is checked against the plain versions here: ``chip_smoke.py``
does that for the checkout's sources.

``--spill-anatomy`` times instead what a KV spill's host time is made of
on the idle card (``spill_anatomy``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke as cs


def spill_anatomy(torch) -> None:
    """What ``ServeEngine._spill_pages`` spends its host time on, at
    phase 4c's page (a page's k or v: 8 layers x 16 kv heads x 64
    positions x head_dim 128 in bf16, 2 MiB): 8 pinned allocations of
    that size (a size class the caching host allocator has not seen,
    then the same blocks again from its cache), and 8 copies of it to
    pinned host memory behind one event."""
    import time

    f = cs.FULL
    shape = (f["n_layers"], f["n_heads"], cs.KV["page_size"], f["d_model"] // f["n_heads"])
    src = torch.zeros((8, *shape), dtype=torch.bfloat16, device="cuda")
    nbytes = src[0].numel() * src.element_size()
    alloc_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hosts = [torch.empty(src[0].numel() + 1, dtype=torch.bfloat16, pin_memory=True)
                 for _ in range(8)]
        alloc_ms.append((time.perf_counter() - t0) / 8 * 1e3)
        del hosts
    hosts = [torch.empty(shape, dtype=torch.bfloat16, pin_memory=True) for _ in range(8)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h, s in zip(hosts, src):
        h.copy_(s, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    copy_ms = (time.perf_counter() - t0) / 8 * 1e3
    print(f"spill anatomy (a page's k or v is {nbytes / 2**20:.0f} MiB): pinned allocation "
          f"{alloc_ms[0]:.3f} ms fresh, {alloc_ms[1]:.3f} ms from the cache; copy to the "
          f"host {copy_ms:.3f} ms ({nbytes / copy_ms / 1e6:.1f} GB/s), 8 copies behind one "
          f"event", flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    import subprocess

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    if argv == ["--spill-anatomy"]:
        spill_anatomy(torch)
        return 0
    from workloads_torch.ops import _build
    from workloads_torch.ops import attention as fa
    from workloads_torch.ops import paged_attention as pa

    own = _build.CSRC
    dirs = [own if d == "." else Path(d).resolve() for d in argv]

    def use(directory: Path) -> None:
        """Build and load from ``directory`` from here on."""
        _build._loaded.clear()
        _build.CSRC = directory
        for name in _build.KERNELS:
            if not (directory / f"{name}.cu").exists():
                (directory / f"{name}.cu").write_bytes((own / f"{name}.cu").read_bytes())
            _build.build(name)

    f = cs.FULL
    B, H, hd, L = f["train_batch"], f["n_heads"], f["d_model"] // f["n_heads"], f["n_layers"]
    q, k, v, dout, _ = cs.flash_inputs(torch, batch=B, seq=f["train_seq"] - 1, heads=H,
                                       kv_heads=H, hd=hd, segments=False,
                                       dtype=torch.bfloat16, seed=4)
    depth = f["decode_prompt"] + f["decode_lens"][1]
    pq, pk, pv, tables, lens = cs.paged_inputs(
        torch, batch=f["slots"], heads=H, kv_heads=H, head_dim=hd, page_size=f["page_size"],
        lengths=[depth] * f["slots"], layers=L, dtype=torch.bfloat16, seed=3)

    first = None
    for directory in dirs + dirs[::-1]:
        use(directory)
        out, lse = fa.flash_fwd(q, k, v)
        paged = pa.paged_attention(pq, pk, pv, tables, lens, layer=0)
        torch.cuda.synchronize()
        if first is None:
            first = (out, lse, paged)
        same = all(torch.equal(a, b) for a, b in zip(first, (out, lse, paged)))
        delta = fa._delta(out, dout)
        k2 = cs.cuda_ms(lambda i: fa.flash_fwd(q, k, v), 30, 3)
        k3 = cs.cuda_ms(lambda i: fa.flash_bwd_dq(q, k, v, dout, lse, delta), 30, 3)
        k4 = cs.cuda_ms(lambda i: fa.flash_bwd_dkv(q, k, v, dout, lse, delta), 30, 3)
        k1 = cs.graph_ms(
            lambda i: pa.paged_attention(pq, pk, pv, tables, lens, layer=i % L), 8 * L)
        print(f"{directory}: K2 {k2:.4f} ms, K3 {k3:.4f} ms, K4 {k4:.4f} ms, K1 "
              f"{k1 * 1e3:.2f} us; K2 and K1 results bit-identical to the first "
              f"directory's: {same}", flush=True)
    _build.CSRC = own
    _build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
