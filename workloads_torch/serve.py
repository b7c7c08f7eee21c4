"""A serving engine with continuous batching over the paged KV cache,
ported from ``workloads/serve.py``.

``ServeEngine`` holds a fixed set of batch SLOTS, admits pending
requests into free slots with one BATCHED ragged prefill sweep per step
(every admission of the step rides the same [slots, bucket] chunks and
one first-token readback), decodes every occupied slot in CHUNKS of
``chunk`` tokens, and retires finished sequences mid-stream, so a new
request takes the slot at the next chunk boundary.  Occupancy is data:
empty slots park with a frozen position and an all-trash page table.

Pages are committed at admission for a request's worst-case lifetime
and released at retirement, so allocation can never fail mid-stream;
a request that does not fit yet waits in the queue.

This slice ports the core engine: batched admission, plain chunked
decode, eos/budget retirement, back-pressure (``max_pending``) and
``close``.  Pipelining, supersteps, prefix caching, fan-out,
speculation, adapters and the fleet are not ported yet.

Run on the card with ``python -m workloads_torch.serve``; pass
``--device cpu`` for the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import resolve_device
from .errors import EngineClosed, InvalidRequest, QueueFull, RequestTooLarge
from .generate import sample_logits
from .model import ModelConfig, cast_params, init_params
from .paged import (
    PagePool,
    init_page_pools,
    paged_decode_chunk,
    paged_prefill_chunk,
)


@dataclass
class Request:
    """One sequence through the engine.  ``tokens`` accumulates generated
    tokens (the prompt is not echoed); ``done`` flips at
    ``max_new_tokens`` or on ``eos_token``.

    ``t_submit``/``t_admit``/``t_first``/``t_done`` are host
    perf_counter stamps.  ``status`` is ``"queued"`` -> ``"running"`` ->
    one terminal status: ``"ok"``, or ``"failed"`` when the engine closed
    with the request in flight (``error`` says so).  A ``QueueFull``
    rejection never enters the engine; its record, with status
    ``"rejected"``, rides on the raised exception."""

    rid: str
    prompt: list[int]
    max_new_tokens: int
    eos_token: int | None = None
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    status: str = "queued"
    error: str | None = None

    @property
    def ttft_secs(self) -> float | None:
        """Submission -> first observed token (None until then)."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def e2e_secs(self) -> float | None:
        """Submission -> retirement (None until done)."""
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait_secs(self) -> float | None:
        """Submission -> admission out of the pending queue."""
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit


class ServeEngine:
    """Continuous-batching serving engine over the paged KV cache.

    Static once constructed: ``slots`` batch rows, a ``prompt_bucket``
    prefill width, a ``chunk`` decode length and a page pool, on
    ``device`` (default ``cuda``; pass ``"cpu"`` explicitly).  ``params``
    must already live on that device, in ``config.dtype``."""

    def __init__(
        self,
        params: dict,
        config: ModelConfig,
        *,
        slots: int = 4,
        page_size: int = 16,
        n_pages: int | None = None,
        prompt_bucket: int | None = None,
        chunk: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        generator: torch.Generator | None = None,
        max_pending: int | None = None,
        completed_limit: int | None = None,
        device=None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None (unbounded), got "
                f"{max_pending}"
            )
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs "
                f"on {self.device}: move them first"
            )
        self.params, self.config = params, config
        self.page_size = page_size
        self.chunk = chunk or page_size
        self.prompt_bucket = prompt_bucket or min(
            config.max_seq_len, 2 * page_size
        )
        if self.prompt_bucket > config.max_seq_len:
            raise ValueError(
                f"prompt_bucket {self.prompt_bucket} exceeds max_seq_len "
                f"{config.max_seq_len}"
            )
        if self.prompt_bucket % page_size:
            raise ValueError(
                f"prompt_bucket {self.prompt_bucket} must be a multiple of "
                f"page_size {page_size} (chunked prefill is page-aligned)"
            )
        # A chunk may overshoot a request's retirement point, so tables
        # and the position range cover one chunk past it; chunked
        # prefill also needs bucket-aligned page coverage.
        self._overshoot = self.chunk
        bucket_pages = self.prompt_bucket // page_size
        prefill_cover = -(-config.max_seq_len // self.prompt_bucket) * bucket_pages
        self.max_pages = max(
            -(-(config.max_seq_len + self._overshoot) // page_size),
            prefill_cover,
        )
        n_pages = n_pages if n_pages is not None else slots * self.max_pages
        self.ctrl = PagePool(n_pages=n_pages, page_size=page_size)
        self.pools = init_page_pools(config, n_pages, page_size, self.device)
        self.slots = slots
        self.temperature = float(temperature)
        self.top_k, self.top_p = int(top_k), float(top_p)
        self.sampling = self.temperature > 0.0
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

        trash = self.ctrl.trash
        self._tables = np.full((slots, self.max_pages), trash, np.int32)
        self._positions = np.zeros(slots, np.int64)
        self._tokens = np.zeros(slots, np.int64)
        self._occupied = np.zeros(slots, bool)
        self._slot_req: dict[int, Request] = {}
        self._slot_commit: dict[int, int] = {}
        self._committed_pages = 0
        self.pending: deque[Request] = deque()
        self._ids = itertools.count()
        self.max_pending = max_pending
        self._closed = False
        # Telemetry.
        self.chunks_run = 0
        self.generated_tokens = 0
        self.prefill_dispatches = 0
        self.requests_retired = 0
        self.requests_failed = 0
        self.queue_rejections = 0
        # Finished requests in retirement order; bounded by
        # ``completed_limit`` or drained with ``drain_completed``.
        self.completed: deque[Request] = deque(maxlen=completed_limit)

    # ---- submission -----------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int | None = None,
        *,
        eos_token: int | None = None,
        rid: str | None = None,
    ) -> str:
        if self._closed:
            raise EngineClosed("engine is closed; submissions are refused")
        prompt = [int(t) for t in prompt]
        limit = self.config.max_seq_len - 1
        if not 1 <= len(prompt) <= limit:
            raise RequestTooLarge(
                f"prompt length {len(prompt)} must be in [1, {limit}] "
                "(max_seq_len minus one generated token; prompts beyond "
                "the bucket prefill in page-aligned chunks)"
            )
        if max_new_tokens is None:
            max_new_tokens = self.config.max_seq_len - len(prompt)
        if max_new_tokens < 1:
            raise InvalidRequest(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if len(prompt) + max_new_tokens > self.config.max_seq_len:
            raise RequestTooLarge(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len {self.config.max_seq_len}"
            )
        need = self._worst_case_pages(len(prompt), max_new_tokens)
        if need > self.ctrl.n_pages:
            raise RequestTooLarge(
                f"request needs up to {need} pages but the pool holds "
                f"{self.ctrl.n_pages} — it could never be admitted"
            )
        if self.max_pending is not None and len(self.pending) >= self.max_pending:
            self.queue_rejections += 1
            rejected = Request(
                rid if rid is not None else "(rejected)", prompt,
                max_new_tokens, eos_token, t_submit=time.perf_counter(),
                status="rejected", error="QueueFull",
            )
            exc = QueueFull(
                f"pending queue is full ({len(self.pending)} >= "
                f"max_pending {self.max_pending}); resubmit after "
                "retirements drain it"
            )
            exc.request = rejected
            raise exc
        rid = rid if rid is not None else f"req-{next(self._ids)}"
        in_flight = {r.rid for r in self.pending} | {
            r.rid for r in self._slot_req.values()
        }
        if rid in in_flight:
            raise InvalidRequest(f"request id {rid!r} is already in flight")
        self.pending.append(
            Request(rid, prompt, max_new_tokens, eos_token,
                    t_submit=time.perf_counter())
        )
        return rid

    # ---- engine internals ----------------------------------------------

    def _seq_id(self, slot: int, req: Request):
        return ("slot", slot, req.rid)

    def _worst_case_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request can hold over its lifetime: retirement is seen
        at chunk boundaries, so its final position can overshoot
        prompt + max_new - 1 by up to one chunk."""
        return self.ctrl.pages_needed(
            prompt_len + max_new_tokens - 1 + self._overshoot
        )

    def _release_slot(self, slot: int) -> Request:
        """Reclaim one occupied slot: pages released, commitment rolled
        back, mirrors parked."""
        req = self._slot_req.pop(slot)
        self.ctrl.release(self._seq_id(slot, req))
        self._committed_pages -= self._slot_commit.pop(slot)
        self._occupied[slot] = False
        self._tables[slot] = self.ctrl.trash
        self._positions[slot] = 0
        self._tokens[slot] = 0
        return req

    def _retire(self, slot: int) -> Request:
        req = self._release_slot(slot)
        req.status = "ok"
        req.t_done = time.perf_counter()
        self.requests_retired += 1
        self.completed.append(req)
        return req

    def _fail(self, req: Request, error: str) -> Request:
        req.status = "failed"
        req.error = error
        req.done = True
        req.t_done = time.perf_counter()
        self.requests_failed += 1
        self.completed.append(req)
        return req

    def _dev(self, mirror: np.ndarray) -> torch.Tensor:
        """A host mirror as a fresh device tensor (a copy: the mirror
        changes after the dispatch)."""
        return torch.tensor(mirror, device=self.device)

    # ---- batched admission: plan -> sweep -> finish ---------------------

    def _admit(self) -> list[Request]:
        """Fill free slots from the pending queue: plan every admission
        of this step, run one prefill sweep over all of them, sample the
        first tokens in one call.  Returns the requests that finished at
        admission (max_new_tokens == 1 or an instant eos); a retirement
        there frees budget, so the loop plans again on untouched slots."""
        finished: list[Request] = []
        used: set[int] = set()
        while True:
            plans = self._plan_admissions(used)
            if not plans:
                return finished
            used.update(p["slot"] for p in plans)
            emitted = self._sweep_prefill(plans)
            batch_finished, retry = self._finish_admissions(plans, emitted)
            finished += batch_finished
            if not retry:
                return finished

    def _plan_admissions(self, used: set) -> list[dict]:
        """Scan the queue in order (free slots ascending, FIFO, stop at
        the first request the page budget defers), committing worst-case
        pages and allocating the prompt's pages; no device work."""
        plans: list[dict] = []
        for slot in range(self.slots):
            if slot in used or self._occupied[slot] or not self.pending:
                continue
            head = self.pending[0]
            need = self._worst_case_pages(len(head.prompt), head.max_new_tokens)
            if self._committed_pages + need > self.ctrl.n_pages:
                # FIFO: no queue-jumping by smaller requests.
                break
            req = self.pending.popleft()
            req.t_admit = time.perf_counter()
            req.status = "running"
            seq = self._seq_id(slot, req)
            self.ctrl.allocate(seq, len(req.prompt))
            self._committed_pages += need
            plans.append({
                "slot": slot, "req": req, "seq": seq, "n": len(req.prompt),
                "need": need,
            })
        return plans

    def _sweep_prefill(self, plans: list[dict]) -> torch.Tensor:
        """Stack the planned rows into one ragged [slots, bucket] batch and
        run paged_prefill_chunk over the page-aligned chunks any row
        covers; each row's logits are taken from the chunk where its
        prompt ends.  Dead rows compute on trash tables.  Returns the
        [slots, vocab] first-token logits."""
        B, S = self.prompt_bucket, self.slots
        bp = B // self.page_size
        lengths = np.zeros(S, np.int32)
        tables = np.full((S, self.max_pages), self.ctrl.trash, np.int32)
        for p in plans:
            lengths[p["slot"]] = p["n"]
            t = self.ctrl.tables[p["seq"]]
            tables[p["slot"], : len(t)] = t
        tables_dev, lengths_dev = self._dev(tables), self._dev(lengths)
        emitted = torch.zeros(
            (S, self.config.vocab_size), dtype=torch.float32, device=self.device
        )
        for ci in range(-(-int(lengths.max()) // B)):
            start = ci * B
            chunk = np.zeros((S, B), np.int64)
            for p in plans:
                width = min(B, p["n"] - start)
                if width > 0:
                    chunk[p["slot"], :width] = p["req"].prompt[start : start + width]
            logits, self.pools = paged_prefill_chunk(
                self.params, self.pools, tables_dev, self._dev(chunk),
                lengths_dev, self.config, start_page=ci * bp,
                cover_pages=(ci + 1) * bp, emit=True,
            )
            self.prefill_dispatches += 1
            emit_mask = (lengths > start) & (lengths <= start + B)
            emitted = torch.where(self._dev(emit_mask)[:, None], logits, emitted)
        return emitted

    def _finish_admissions(
        self, plans: list[dict], emitted: torch.Tensor
    ) -> tuple[list[Request], bool]:
        """Sample every row's first token in one call, read the batch back
        once, then apply emission and at-admission retirement.  Returns
        (requests finished at admission, whether one of them rolled back
        its page commitment)."""
        toks = sample_logits(
            emitted, self.generator if self.sampling else None,
            self.temperature, self.top_k, self.top_p,
        ).cpu().numpy()
        finished, retry = [], False
        for p in plans:
            slot, req, seq = p["slot"], p["req"], p["seq"]
            tok = int(toks[slot])
            req.tokens.append(tok)
            req.t_first = time.perf_counter()
            self.generated_tokens += 1
            if len(req.tokens) >= req.max_new_tokens or tok == req.eos_token:
                req.done = True
                req.status = "ok"
                req.t_done = req.t_first
                self.ctrl.release(seq)
                self._committed_pages -= p["need"]
                finished.append(req)
                self.requests_retired += 1
                self.completed.append(req)
                retry = True
                continue
            self._slot_req[slot] = req
            self._occupied[slot] = True
            self._slot_commit[slot] = p["need"]
            table = self.ctrl.tables[seq]
            self._tables[slot, : len(table)] = table
            self._positions[slot] = p["n"]
            self._tokens[slot] = tok
        return finished, retry

    # ---- decode ---------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One engine iteration: admit into free slots, run one decode
        chunk for every occupied slot, retire finished requests.  Returns
        the requests that finished during this step."""
        if self._closed:
            raise EngineClosed("engine is closed; no further steps")
        finished = self._admit()
        return finished + self._step_decode()

    def _step_decode(self) -> list[Request]:
        if not self._occupied.any():
            return []
        # Page coverage for the whole chunk, allocated on demand (within
        # the admission-time commitment).
        for slot, req in self._slot_req.items():
            table = self.ctrl.extend(
                self._seq_id(slot, req), int(self._positions[slot]) + self.chunk
            )
            self._tables[slot, : len(table)] = table
        toks, self.pools = paged_decode_chunk(
            self.params, self.pools, self._dev(self._tables),
            self._dev(self._tokens), self._dev(self._positions),
            self._dev(self._occupied), self.generator, self.temperature,
            self.top_k, self.top_p, self.config, self.chunk, self.sampling,
        )
        self.chunks_run += 1
        snapshot = dict(self._slot_req)
        for slot in snapshot:
            self._positions[slot] += self.chunk
        return self._consume_chunk(toks, snapshot)

    def _emit(self, req: Request, toks_row) -> None:
        """Append a row's decoded tokens to its request, flipping ``done``
        at eos or max_new_tokens."""
        for tok in toks_row:
            req.tokens.append(int(tok))
            self.generated_tokens += 1
            if int(tok) == req.eos_token or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                break

    def _consume_chunk(self, toks_dev, snapshot: dict) -> list[Request]:
        """Read a chunk's tokens back (the host sync point) and apply
        emission and retirement."""
        toks = toks_dev.cpu().numpy()
        finished = []
        for slot, req in snapshot.items():
            self._emit(req, toks[slot])
            self._tokens[slot] = toks[slot, -1]
            if req.done:
                finished.append(self._retire(slot))
        return finished

    # ---- lifecycle ------------------------------------------------------

    def drain_completed(self) -> list[Request]:
        """Hand back (and clear) the finished-request ring."""
        out = list(self.completed)
        self.completed.clear()
        return out

    def close(self) -> None:
        """Idempotent shutdown: pending and running requests fail with
        ``EngineClosed`` recorded, their pages release; later submit and
        step raise ``EngineClosed``."""
        if self._closed:
            return
        self._closed = True
        err = "EngineClosed: engine closed with the request in flight"
        for slot in sorted(self._slot_req):
            self._fail(self._release_slot(slot), err)
        while self.pending:
            self._fail(self.pending.popleft(), err)

    @property
    def idle(self) -> bool:
        return not self.pending and not self._occupied.any()

    def run(self) -> dict[str, list[int]]:
        """Drive step() until every submitted request has finished;
        returns {rid: generated tokens}."""
        out = {}
        while not self.idle:
            for req in self.step():
                out[req.rid] = req.tokens
        return out


def main(argv=None) -> int:
    """``python -m workloads_torch.serve --requests 12 --slots 4`` — run a
    stream of synthetic mixed-length requests through the engine and
    report tokens/s.  Runs on the card; ``--device cpu`` for the CPU."""
    import argparse

    parser = argparse.ArgumentParser(description="serving engine example (PyTorch)")
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=16)
    parser.add_argument("--max-new-tokens", type=int, default=64)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top-k", type=int, default=50)
    parser.add_argument("--top-p", type=float, default=0.95)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="grouped-query kv heads (default: n_heads)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = ModelConfig(
        d_model=512, n_heads=8, n_layers=4, d_ff=2048, vocab_size=8192,
        max_seq_len=args.prompt_len + args.max_new_tokens,
        n_kv_heads=args.kv_heads,
    )
    params = cast_params(
        init_params(config, torch.Generator(device).manual_seed(0)), config.dtype
    )
    # Page-aligned bucket within the context window; longer prompts
    # admit via chunked prefill.
    page_size = 16 if config.max_seq_len >= 32 else 4
    bucket = min(
        -(-args.prompt_len // page_size) * page_size,
        config.max_seq_len // page_size * page_size,
    )
    engine = ServeEngine(
        params, config, slots=args.slots, page_size=page_size,
        prompt_bucket=bucket, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        generator=torch.Generator(device).manual_seed(42), device=device,
    )
    rng = np.random.default_rng(7)
    for i in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        prompt = rng.integers(0, config.vocab_size, plen)
        # Mixed lengths: the stream the engine's slot turnover exists for.
        engine.submit(prompt, max(1, args.max_new_tokens // (1 + i % 3)))

    engine.step()  # warm-up: first launches and kernel build
    tokens_before = engine.generated_tokens
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
    elapsed = time.perf_counter() - t0
    generated = engine.generated_tokens - tokens_before
    rate = generated / elapsed if elapsed > 0 and generated else 0.0
    print(
        f"done: {args.requests} requests, {engine.generated_tokens} tokens, "
        f"{engine.chunks_run} chunks, steady-state ≈ {rate:.0f} tok/s "
        f"(device={device}, kv_heads={config.kv_heads}, "
        f"pool={engine.ctrl.n_pages} pages, "
        f"pages in use after drain: {engine.ctrl.used_pages})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
