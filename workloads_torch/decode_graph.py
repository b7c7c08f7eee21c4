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
tokens).  Sampling draws under a key, as the JAX package's scan body
does: the graph holds a ``keys`` buffer [max_steps, 2], ``run`` copies
in the dispatch's step keys (``prng.split`` of the engine key, made by
the caller), and step ``i`` reads row ``i``, so a replay draws what an
eager step would, through the threefry kernel.

The kernel wrappers count their launches as the step runs, which under
a graph is once, at capture; ``run`` adds what one captured step
launched to ``paged_attention.launches`` and ``threefry.launches`` at
every replay instead, and the warm-up and capture leave the counts as
they found them.  CPU engines
never build a ``DecodeGraph``: they run the eager functions.

With an expert config the captured step holds the expert layer
(``moe.expert_ffn``: routing, the sort by expert and the grouped
products, all on static shapes) and, given ``moe_reads`` (an int64 [1]
device tensor), adds to it on the device at every replay the experts
the step's expert-layer calls read.  The warm-up and capture leave it
as they found it, as they leave the launch counts.

``SpecGraph`` does the same for speculative decoding: it captures ONE
round of the chained-retirement superstep (``paged.spec_chained_round``:
gamma + 1 draft decode steps through the paged-attention kernel, the
target's rowwise verify block, and the greedy or sampling commit with
the chained carry and the retirement masks) and replays it k times a
dispatch, for the lookahead superstep (budget unbounded, no eos, so
``live`` stays the occupancy) and the chained superstep alike.  The
verify block's view is as wide as a static cover of table columns, so
one graph is captured per cover on its first use.

With stacked LoRA adapters (``multi_lora.stack_adapters``) both graphs
hold the stack by address and take one more static buffer, ``aidx``
(int32 [slots]), each row's adapter index, filled in ``run`` as
``tables`` and ``pos`` are: a change of the adapter mix between
dispatches replays the same graph.  Without adapters the captured graph
is the same as before: no extra buffer, no extra launch.  In a spec
round only the target's verify reads ``aidx``; the draft is unadapted.
"""

from __future__ import annotations

import torch

from .ops.paged_attention import paged_attention
from .ops.threefry import threefry
from .paged import decode_superstep_step, spec_chained_round


def _check_keys(buf, keys, n: int) -> None:
    """A sampling graph takes one key [2] a step (or round); a greedy
    one takes none."""
    if (buf is None) != (keys is None):
        raise ValueError(
            "step keys go with a sampling graph and only with one: graph samples: "
            f"{buf is not None}, keys given: {keys is not None}"
        )
    if keys is not None and tuple(keys.shape) != (n, 2):
        raise ValueError(f"keys must be [{n}, 2], got {tuple(keys.shape)}")


def _launch_counts() -> tuple[int, int]:
    return paged_attention.launches, threefry.launches


def _restore_counts(counts: tuple[int, int]) -> None:
    paged_attention.launches, threefry.launches = counts


def _check_aidx(buf, aidx) -> None:
    """A graph with adapters takes each run's adapter indices; one
    without takes none."""
    if (buf is None) != (aidx is None):
        raise ValueError(
            "adapter indices (aidx) go with an adapter graph and only with one: "
            f"graph has adapters: {buf is not None}, aidx given: {aidx is not None}"
        )


class DecodeGraph:
    """One decode step over ``slots`` rows captured as a CUDA graph and
    replayed up to ``max_steps`` times a dispatch.  ``params`` and
    ``pools`` must keep their storage for the graph's life.  Capture
    happens at the first ``run``."""

    def __init__(
        self, params: dict, pools: tuple[torch.Tensor, torch.Tensor], config,
        *, slots: int, max_pages: int, max_steps: int, temperature: float, top_k: int,
        top_p: float, sampling: bool, lora_stacked: list | None = None,
        lora_alpha: float = 1.0, moe_reads: torch.Tensor | None = None,
    ):
        device = pools[0].device
        self.params, self.pools, self.config = params, pools, config
        self.moe_reads = moe_reads
        self.lora_stacked, self.lora_alpha = lora_stacked, lora_alpha
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
            self.aidx = (torch.zeros(slots, dtype=torch.int32, device=device)
                         if lora_stacked is not None else None)
            self.keys = (torch.zeros((max_steps, 2), dtype=torch.int64, device=device)
                         if sampling else None)
        self.graph = None
        self.captures = 0  # completed captures: 1 for the graph's life
        self.k1_per_step = 0  # paged_attention launches in one captured step
        self.threefry_per_step = 0  # threefry launches in one captured step

    def _step(self) -> None:
        """The captured step: one decode step from the buffers, its
        emitted tokens into ``out[:, col]``, its carry back into the
        buffers."""
        lora = (None if self.aidx is None
                else (self.lora_stacked, self.aidx, self.lora_alpha))
        key = None if self.keys is None else self.keys.index_select(0, self.col).reshape(2)
        nxt, tok, pos, live, budget = decode_superstep_step(
            self.params, self.pools, self.tables, self.tok, self.pos, self.live,
            self.budget, self.eos, key, self.temperature, self.top_k,
            self.top_p, self.config, self.sampling, lora=lora, moe_reads=self.moe_reads,
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
        the launch counts come back as they were: neither the pools' live
        pages nor the counts see it.  If anything raises, ``graph`` stays
        None (the next ``run`` captures afresh) and the counts come back
        too."""
        trash = self.pools[0].shape[1] - 1
        self.tables.fill_(trash)
        self.live.fill_(False)
        self.pos.zero_()
        self.col.zero_()
        if self.aidx is not None:
            self.aidx.zero_()
        if self.keys is not None:
            self.keys.zero_()
        counts = _launch_counts()
        reads = None if self.moe_reads is None else self.moe_reads.clone()
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
            before = _launch_counts()
            with torch.cuda.graph(graph, stream=side):
                self._step()
            self.k1_per_step = paged_attention.launches - before[0]
            self.threefry_per_step = threefry.launches - before[1]
        finally:
            _restore_counts(counts)
            if reads is not None:
                self.moe_reads.copy_(reads)
        self.graph = graph
        self.captures += 1

    @torch.inference_mode()
    def run(self, tables, tok, pos, live, budget, eos, steps: int, aidx=None, keys=None):
        """``steps`` decode steps from these inputs (device tensors,
        [slots] and [slots, max_pages]), as replays of the captured step;
        ``aidx`` ([slots] adapter indices) is required with adapters and
        refused without, ``keys`` ([steps, 2], one key a step) with
        sampling and refused without.  Returns (emitted [slots, steps], tok, pos,
        live, budget): a view of ``out`` and the carry buffers, which the
        next ``run`` overwrites; read or copy them before it."""
        if not 1 <= steps <= self.max_steps:
            raise ValueError(f"steps must be in [1, {self.max_steps}], got {steps}")
        _check_aidx(self.aidx, aidx)
        _check_keys(self.keys, keys, steps)
        if self.graph is None:
            self.capture()
        for buf, src in ((self.tables, tables), (self.tok, tok), (self.pos, pos),
                         (self.live, live), (self.budget, budget), (self.eos, eos)):
            buf.copy_(src)
        if self.aidx is not None:
            self.aidx.copy_(aidx)
        if self.keys is not None:
            self.keys[:steps].copy_(keys)
        self.col.zero_()
        for _ in range(steps):
            self.graph.replay()
            # The replay launched what one captured step launched.
            paged_attention.launches += self.k1_per_step
            threefry.launches += self.threefry_per_step
        return self.out[:, :steps], self.tok, self.pos, self.live, self.budget


class SpecGraph:
    """One speculative round over ``slots`` rows captured as a CUDA graph
    per cover bucket and replayed up to ``max_rounds`` times a dispatch.
    The graph holds the two parameter trees, both pool pairs (updated in
    place, never rebound) and its own buffers: the inputs ``tables``,
    ``cur``, ``pos``, ``live``, ``budget``, ``eos`` (overwritten with the
    carry at every replay), with sampling ``keys`` (row ``i`` is round
    ``i``'s key) and
    the outputs ``committed`` [max_rounds, slots, gamma+1], ``n`` and
    ``round_live`` [max_rounds, slots], row ``i`` from round ``i``.  A
    capture that raises leaves that cover's graph absent (the next
    ``run`` captures afresh); ``captures`` counts completed captures, by
    cover in ``captures_by_cover``."""

    def __init__(
        self, t_params: dict, d_params: dict, t_pools, d_pools, t_config, d_config, *,
        gamma: int, slots: int, max_pages: int, max_rounds: int, temperature: float,
        top_k: int, top_p: float, sampling: bool, lora_stacked: list | None = None,
        lora_alpha: float = 1.0,
    ):
        device = t_pools[0].device
        self.lora_stacked, self.lora_alpha = lora_stacked, lora_alpha
        self.t_params, self.d_params = t_params, d_params
        self.t_pools, self.d_pools = t_pools, d_pools
        self.t_config, self.d_config = t_config, d_config
        self.gamma = gamma
        self.sampling = sampling
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.max_rounds = max_rounds
        with torch.inference_mode():
            self.tables = torch.empty((slots, max_pages), dtype=torch.int32, device=device)
            self.cur = torch.zeros(slots, dtype=torch.long, device=device)
            self.pos = torch.zeros(slots, dtype=torch.long, device=device)
            self.live = torch.zeros(slots, dtype=torch.bool, device=device)
            self.budget = torch.zeros(slots, dtype=torch.int32, device=device)
            self.eos = torch.full((slots,), -1, dtype=torch.int32, device=device)
            self.committed = torch.zeros((max_rounds, slots, gamma + 1), dtype=torch.long,
                                         device=device)
            self.n = torch.zeros((max_rounds, slots), dtype=torch.long, device=device)
            self.round_live = torch.zeros((max_rounds, slots), dtype=torch.bool,
                                          device=device)
            self.row = torch.zeros(1, dtype=torch.long, device=device)
            self.aidx = (torch.zeros(slots, dtype=torch.int32, device=device)
                         if lora_stacked is not None else None)
            self.keys = (torch.zeros((max_rounds, 2), dtype=torch.int64, device=device)
                         if sampling else None)
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.captures = 0
        self.captures_by_cover: dict[int, int] = {}
        self.k1_per_round = 0  # paged_attention launches in one captured round
        self.threefry_per_round = 0  # threefry launches in one captured round

    def _round(self, cover: int) -> None:
        """The captured round: one chained round from the buffers, its
        outputs into row ``row`` of the output buffers, its carry back
        into the input buffers."""
        self.round_live.index_copy_(0, self.row, self.live[None])
        t_lora = (None if self.aidx is None
                  else (self.lora_stacked, self.aidx, self.lora_alpha))
        key = None if self.keys is None else self.keys.index_select(0, self.row).reshape(2)
        committed, n, cur, pos, live, budget = spec_chained_round(
            self.t_params, self.d_params, self.t_pools, self.d_pools, self.tables,
            self.cur, self.pos, self.live, self.budget, self.eos, self.t_config,
            self.d_config, self.gamma, cover, sampling=self.sampling,
            rng=key, temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, t_lora=t_lora,
        )
        self.committed.index_copy_(0, self.row, committed[None])
        self.n.index_copy_(0, self.row, n[None])
        self.row.add_(1)
        self.cur.copy_(cur)
        self.pos.copy_(pos)
        self.live.copy_(live)
        self.budget.copy_(budget)

    @torch.inference_mode()
    def capture(self, cover: int) -> None:
        """Warm up on a side stream, then capture one round at ``cover``
        on it.  The warm-up runs every row parked at position 0 on the
        trash page; the launch counts come back as they were.  If
        anything raises, no graph is kept for ``cover`` and the counts
        come back too."""
        device = self.cur.device
        trash = self.t_pools[0].shape[1] - 1
        self.tables.fill_(trash)
        self.live.fill_(False)
        self.pos.zero_()
        if self.aidx is not None:
            self.aidx.zero_()
        if self.keys is not None:
            self.keys.zero_()
        counts = _launch_counts()
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.row.zero_()
                    self._round(cover)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            self.row.zero_()
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.graph(graph, stream=side):
                self._round(cover)
            self.k1_per_round = paged_attention.launches - before[0]
            self.threefry_per_round = threefry.launches - before[1]
        finally:
            _restore_counts(counts)
        self.graphs[cover] = graph
        self.captures += 1
        self.captures_by_cover[cover] = self.captures_by_cover.get(cover, 0) + 1

    @torch.inference_mode()
    def run(self, tables, cur, pos, live, budget, eos, rounds: int, cover: int, aidx=None,
            keys=None):
        """``rounds`` chained rounds from these inputs (device tensors),
        as replays of the round captured at ``cover``; ``aidx`` as in
        ``DecodeGraph.run``, ``keys`` ([rounds, 2], each round's own key)
        with sampling.  Returns
        (committed [rounds, slots, gamma+1], n [rounds, slots],
        round_live [rounds, slots], cur, pos, live, budget): views of the
        graph's buffers, which the next ``run`` overwrites; read or copy
        them before it."""
        if not 1 <= rounds <= self.max_rounds:
            raise ValueError(f"rounds must be in [1, {self.max_rounds}], got {rounds}")
        _check_aidx(self.aidx, aidx)
        _check_keys(self.keys, keys, rounds)
        if cover not in self.graphs:
            self.capture(cover)
        graph = self.graphs[cover]
        for buf, src in ((self.tables, tables), (self.cur, cur), (self.pos, pos),
                         (self.live, live), (self.budget, budget), (self.eos, eos)):
            buf.copy_(src)
        if self.aidx is not None:
            self.aidx.copy_(aidx)
        if self.keys is not None:
            self.keys[:rounds].copy_(keys)
        self.row.zero_()
        for _ in range(rounds):
            graph.replay()
            # The replay launched what one captured round launched.
            paged_attention.launches += self.k1_per_round
            threefry.launches += self.threefry_per_round
        return (self.committed[:rounds], self.n[:rounds], self.round_live[:rounds],
                self.cur, self.pos, self.live, self.budget)
