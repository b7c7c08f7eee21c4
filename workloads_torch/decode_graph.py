"""The serving engine's decode step as one captured CUDA graph.

Eager PyTorch launches every operation of a decode step from the host:
about 50 small kernels a layer, so on the card a step's wall time is set
by the host's enqueue, not by the device (the JAX package never pays
this: its decode chunk is one jitted ``lax.scan``, one dispatch).
``DecodeGraph`` captures ONE step, ``paged.decode_superstep_step``
(``_decode_core`` with the paged-attention kernel, ``sample_logits`` and
the live/budget/eos update), on static buffers, and replays it once per
step from a host loop: a replay costs microseconds of host time.  One
step-graph serves the plain chunk (budget unbounded, no eos, so ``live``
is the occupancy and stays so) and the superstep of any ``k``.

The graph holds addresses: the parameters, the page pools (updated in
place, never rebound), and its own buffers ``tables``, ``tok``, ``pos``,
``live``, ``budget``, ``eos`` (the step's inputs, which it overwrites
with its carry) and ``out`` (column ``i`` holds step ``i``'s emitted
tokens).  Sampling draws from the engine's generator, registered with
the graph so that each replay advances it as an eager step would.

The paged-attention wrapper counts its launches as the step runs, which
under a graph is once, at capture; ``run`` adds what one captured step
launched to ``paged_attention.launches`` at every replay instead, and
the warm-up and capture leave the count as they found it.  CPU engines
never build a ``DecodeGraph``: they run the eager functions.
"""

from __future__ import annotations

import torch

from .ops.paged_attention import paged_attention
from .paged import decode_superstep_step


class DecodeGraph:
    """One decode step over ``slots`` rows captured as a CUDA graph and
    replayed up to ``max_steps`` times a dispatch.  ``params``, ``pools``
    and ``generator`` (for ``sampling``) must keep their storage for the
    graph's life.  Capture happens at the first ``run``."""

    def __init__(
        self, params: dict, pools: tuple[torch.Tensor, torch.Tensor], config,
        *, slots: int, max_pages: int, max_steps: int,
        generator: torch.Generator | None, temperature: float, top_k: int,
        top_p: float, sampling: bool,
    ):
        device = pools[0].device
        self.params, self.pools, self.config = params, pools, config
        self.generator = generator if sampling else None
        self.sampling = sampling
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.max_steps = max_steps
        with torch.inference_mode():
            self.tables = torch.empty((slots, max_pages), dtype=torch.int32, device=device)
            self.tok = torch.zeros(slots, dtype=torch.long, device=device)
            self.pos = torch.zeros(slots, dtype=torch.long, device=device)
            self.live = torch.zeros(slots, dtype=torch.bool, device=device)
            self.budget = torch.zeros(slots, dtype=torch.int32, device=device)
            self.eos = torch.full((slots,), -1, dtype=torch.int32, device=device)
            self.out = torch.zeros((slots, max_steps), dtype=torch.long, device=device)
            self.col = torch.zeros(1, dtype=torch.long, device=device)
        self.graph = None
        self.captures = 0  # completed captures: 1 for the graph's life
        self.k1_per_step = 0  # paged_attention launches in one captured step

    def _step(self) -> None:
        """The captured step: one decode step from the buffers, its
        emitted tokens into ``out[:, col]``, its carry back into the
        buffers."""
        nxt, tok, pos, live, budget = decode_superstep_step(
            self.params, self.pools, self.tables, self.tok, self.pos, self.live,
            self.budget, self.eos, self.generator, self.temperature, self.top_k,
            self.top_p, self.config, self.sampling,
        )
        self.out.index_copy_(1, self.col, nxt[:, None])
        self.col.add_(1)
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        self.live.copy_(live)
        self.budget.copy_(budget)

    @torch.inference_mode()
    def capture(self) -> None:
        """Warm up on a side stream (kernel build, library handles, the
        kernel's per-stream ticket buffer), then capture one step on it.
        The warm-up runs every row parked on the pools' trash page, and
        the generator's state and the launch count come back as they
        were: neither the pools' live pages, the draws nor the count see
        it.  If anything raises, ``graph`` stays None (the next ``run``
        captures afresh) and the count and the generator come back too."""
        trash = self.pools[0].shape[1] - 1
        self.tables.fill_(trash)
        self.live.fill_(False)
        self.pos.zero_()
        self.col.zero_()
        launches = paged_attention.launches
        rng_state = self.generator.get_state() if self.generator is not None else None
        try:
            side = torch.cuda.Stream(self.tok.device)
            side.wait_stream(torch.cuda.current_stream(self.tok.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.col.zero_()
                    self._step()
            torch.cuda.current_stream(self.tok.device).wait_stream(side)
            torch.cuda.synchronize(self.tok.device)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                self.generator.set_state(rng_state)
                graph.register_generator_state(self.generator)
            before = paged_attention.launches
            with torch.cuda.graph(graph, stream=side):
                self._step()
            self.k1_per_step = paged_attention.launches - before
        finally:
            paged_attention.launches = launches
            if self.generator is not None:
                self.generator.set_state(rng_state)
        self.graph = graph
        self.captures += 1

    @torch.inference_mode()
    def run(self, tables, tok, pos, live, budget, eos, steps: int):
        """``steps`` decode steps from these inputs (device tensors,
        [slots] and [slots, max_pages]), as replays of the captured step.
        Returns (emitted [slots, steps], tok, pos, live, budget): a view
        of ``out`` and the carry buffers, which the next ``run``
        overwrites; read or copy them before it."""
        if not 1 <= steps <= self.max_steps:
            raise ValueError(f"steps must be in [1, {self.max_steps}], got {steps}")
        if self.graph is None:
            self.capture()
        for buf, src in ((self.tables, tables), (self.tok, tok), (self.pos, pos),
                         (self.live, live), (self.budget, budget), (self.eos, eos)):
            buf.copy_(src)
        self.col.zero_()
        for _ in range(steps):
            self.graph.replay()
            # The replay launched what one captured step launched.
            paged_attention.launches += self.k1_per_step
        return self.out[:, :steps], self.tok, self.pos, self.live, self.budget
