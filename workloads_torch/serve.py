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

Scheduling, as in the JAX engine: ``batched_admission=False`` admits
one request per prefill dispatch and first-token readback;
``prefill_budget`` caps each step's prefill chunks and carries
half-prefilled admissions across steps; ``pipelined`` reads a chunk
back only after the next one is dispatched; ``superstep_k > 1`` runs
``k`` chunks a dispatch with retirement decided on the device, and
turns the step around (dispatch, then admission while the device
computes, then one readback).  Greedy streams are the same in every
mode.

On the card every decode step is a replay of one captured CUDA graph
(``decode_graph.DecodeGraph``); host mirrors go up through pinned
buffers without a synchronise, and readbacks land in pinned buffers
behind an event, so a dispatch returns while the device computes.  CPU
engines run the eager ``paged_decode_chunk`` and
``paged_decode_superstep``.

The request lifecycle, as in the JAX engine: ``cancel``, ``withdraw``
and ``preempt`` (no prefix park), ``submit(deadline_s=)``, fault seams
at every prefill and decode dispatch and readback (``faults.py``) whose
failures quarantine the step and replay its requests (prompt plus
emitted tokens re-prefilled) under ``max_retries``, a health bridge
that pauses on an unhealthy chip, ``retune(superstep_k=)`` and
``close``/the context manager.  A quarantine drops the work in flight
unread: a dropped superstep still runs on the stream, ahead of
everything queued after it, and the next dispatch uploads every row
from the host mirrors.  Prefix caching, fan-out, speculation, adapters
and the fleet are not ported yet.

Run on the card with ``python -m workloads_torch.serve``; pass
``--device cpu`` for the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import itertools
import queue
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import resolve_device
from .decode_graph import DecodeGraph
from .errors import EngineClosed, InvalidRequest, QueueFull, RequestTooLarge
from .generate import sample_logits
from .model import ModelConfig, cast_params, init_params
from .paged import (
    PagePool,
    init_page_pools,
    paged_decode_chunk,
    paged_decode_superstep,
    paged_prefill,
    paged_prefill_chunk,
)

# tpu_device_plugin.api.constants.UNHEALTHY, the health state a
# HealthEvent carries for a failed chip; copied, so that the engine does
# not import the daemon's package, whose ``api`` loads gRPC.
UNHEALTHY = "Unhealthy"

# The chunk path's budget on the graph route: larger than any request's,
# so a live row stays live through the chunk (eos -1 matches no token).
_UNBOUNDED = 2**30


@dataclass
class Request:
    """One sequence through the engine.  ``tokens`` accumulates generated
    tokens (the prompt is not echoed); ``done`` flips at
    ``max_new_tokens`` or on ``eos_token``.

    ``t_submit``/``t_admit``/``t_first``/``t_done`` are host
    perf_counter stamps.  ``status`` is ``"queued"`` -> ``"running"`` ->
    exactly one terminal status: ``"ok"``, ``"cancelled"``
    (``engine.cancel``), ``"expired"`` (``deadline_s`` passed) or
    ``"failed"`` (retry budget spent after seam faults, or the engine
    closed; ``error`` says which).  A ``QueueFull`` rejection never
    enters the engine; its record, with status ``"rejected"``, rides on
    the raised exception.  ``retries`` counts fault replays (each
    re-prefills prompt + emitted tokens, so the greedy stream goes on
    as if uninterrupted)."""

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
    retries: int = 0
    deadline_s: float | None = None
    t_deadline: float | None = None  # absolute perf_counter deadline

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


class _Readback:
    """Decoded tokens on their way to the host.  From the card they are
    copied into pinned memory behind an event as soon as they are
    dispatched (before anything later can overwrite their buffer), so
    the host blocks only when it reads them."""

    def __init__(self, toks: torch.Tensor):
        self.event = None
        if toks.is_cuda:
            self.host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            self.host.copy_(toks, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = toks

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ServeEngine:
    """Continuous-batching serving engine over the paged KV cache.

    Static once constructed: ``slots`` batch rows, a ``prompt_bucket``
    prefill width, a ``chunk`` decode length, the scheduling mode
    (``pipelined``, ``superstep_k``, ``batched_admission``,
    ``prefill_budget``) and a page pool, on ``device`` (default
    ``cuda``; pass ``"cpu"`` explicitly).  ``params`` must already live
    on that device, in ``config.dtype``.  ``pools`` keep their storage
    for the engine's life: on the card a captured graph holds them."""

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
        pipelined: bool = False,
        superstep_k: int = 1,
        batched_admission: bool = True,
        prefill_budget: int | None = None,
        fault_injector=None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.0,
        health_events=None,
        device=None,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None (unbounded), got "
                f"{max_pending}"
            )
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}"
            )
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1 token/step or None "
                f"(unbudgeted), got {prefill_budget}"
            )
        if superstep_k < 1:
            raise ValueError(f"superstep_k must be >= 1, got {superstep_k}")
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
        self.pipelined = pipelined
        self.superstep_k = superstep_k
        # retune() steps superstep_k down and back up to this ceiling,
        # never above: the overshoot, max_pages, every commitment and the
        # graph's max_steps are sized from it.
        self._superstep_k_max = superstep_k
        self.retunes = 0
        self.batched_admission = batched_admission
        # With a budget (tokens a step) each step dispatches at most
        # max(1, budget // prompt_bucket) prefill chunks; admissions
        # whose prompts need more wait in ``_inflight_prefill`` with
        # their pages committed, so one long prompt never holds up the
        # step's decode.  A budget always sweeps (the serial path cannot
        # park a half-prefilled prompt).
        self.prefill_budget = prefill_budget
        # A dispatch may overshoot a request's retirement point by its
        # k chunks, and pipelined stepping sees retirement one dispatch
        # later still, so tables and the position range cover that far
        # past it; chunked prefill also needs bucket-aligned page
        # coverage.
        self._overshoot = self.chunk * superstep_k * (2 if pipelined else 1)
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
        # Fault tolerance: a failed dispatch or readback quarantines the
        # step (work in flight dropped, slots and pages released) and
        # requeues its requests for replay under ``max_retries``.
        self.max_retries = max_retries
        self.retry_backoff_s = float(retry_backoff_s)
        self._faults = fault_injector
        self._t_last_fault: float | None = None
        self._consecutive_faults = 0
        # Requests finished outside step()'s own return (cancel, retune's
        # drain, deadline expiry) surface through the next step().
        self._finished_buffer: list[Request] = []
        # Health bridge: a queue of tpu_device_plugin HealthEvents polled
        # each step; an unhealthy chip pauses admission and requeues the
        # work in flight, recovery resumes.
        self._health_events = health_events
        self._health_fanout = None
        self._unhealthy_chips: set[str] = set()
        self._paused = False
        # Mid-prefill admissions (plan dicts with a chunk "cursor"): their
        # slots are reserved but not occupied until the first token lands.
        self._inflight_prefill: list[dict] = []
        # Slots admitted since the last decode dispatch: a chained
        # dispatch takes their host state, the device carry for the rest.
        self._fresh_slots: set[int] = set()
        # Pipelined chunk path: the unread chunk (readback, slot->request
        # snapshot at dispatch) and the device-side last tokens.
        self._pending_read = None
        self._chained_tok: torch.Tensor | None = None
        # Supersteps dispatched but not consumed, and (pipelined) the
        # device-side (tok, pos, live, budget) carry the next one chains on.
        self._pending_super: deque = deque()
        self._super_chained: tuple | None = None
        # On the card: the decode step as a CUDA graph, replayed per step.
        self._graph = None
        if self.device.type == "cuda":
            self._graph = DecodeGraph(
                params, self.pools, config, slots=slots,
                max_pages=self.max_pages, max_steps=self.chunk * superstep_k,
                generator=self.generator, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, sampling=self.sampling,
            )
            self._unbounded = (
                torch.full((slots,), _UNBOUNDED, dtype=torch.int32, device=self.device),
                torch.full((slots,), -1, dtype=torch.int32, device=self.device),
            )
        # Telemetry.
        self.chunks_run = 0
        self.supersteps_run = 0
        # Decode steps computed past a row's retirement (a superstep's
        # dead tail), reconciled at each superstep readback.
        self.tokens_overdecoded = 0
        self.generated_tokens = 0
        self.prefills_run = 0
        self.prefill_tokens = 0  # prompt tokens forwarded
        self.prefill_sweeps = 0  # batched-admission sweeps
        self.prefill_dispatches = 0  # prefill program calls
        self.prefill_deferred_tokens = 0  # prompt tokens the budget parked
        self.admission_readbacks = 0  # first-token host reads
        self.requests_admitted = 0
        self.requests_retired = 0
        self.requests_failed = 0
        self.requests_cancelled = 0
        self.requests_expired = 0
        self.requests_retried = 0  # replay requeues after a quarantine
        self.requests_preempted = 0  # statusless reclaims by preempt()
        self.queue_rejections = 0
        self.steps_quarantined = 0
        self.fault_recovery_s: list[float] = []  # quarantine -> next good readback
        # prompt + emitted tokens requeued for re-prefill, and what a
        # preempted request's resume recomputes
        self.tokens_replayed = 0
        self.preempt_recompute_tokens = 0
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
        deadline_s: float | None = None,
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
        if deadline_s is not None and deadline_s <= 0:
            raise InvalidRequest(
                f"deadline_s must be > 0 (or None), got {deadline_s}"
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
        in_flight = (
            {r.rid for r in self.pending}
            | {r.rid for r in self._slot_req.values()}
            | {p["req"].rid for p in self._inflight_prefill}
        )
        if rid in in_flight:
            raise InvalidRequest(f"request id {rid!r} is already in flight")
        t_submit = time.perf_counter()
        self.pending.append(Request(
            rid, prompt, max_new_tokens, eos_token, t_submit=t_submit,
            deadline_s=deadline_s,
            t_deadline=t_submit + deadline_s if deadline_s is not None else None,
        ))
        return rid

    # ---- engine internals ----------------------------------------------

    def _seq_id(self, slot: int, req: Request):
        return ("slot", slot, req.rid)

    def _worst_case_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request can hold over its lifetime: retirement is seen
        at dispatch boundaries, so its final position can overshoot
        prompt + max_new - 1 by ``_overshoot``."""
        return self.ctrl.pages_needed(
            prompt_len + max_new_tokens - 1 + self._overshoot
        )

    def _release_slot(self, slot: int) -> Request:
        """Reclaim one occupied slot without deciding the request's fate:
        pages released, commitment rolled back, mirrors parked.  The
        caller retires it, finishes it terminally (cancel, expiry,
        close) or requeues it for replay (quarantine, health pause)."""
        req = self._slot_req.pop(slot)
        self.ctrl.release(self._seq_id(slot, req))
        self._committed_pages -= self._slot_commit.pop(slot)
        self._occupied[slot] = False
        self._tables[slot] = self.ctrl.trash
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self._fresh_slots.discard(slot)
        return req

    def _retire(self, slot: int) -> Request:
        req = self._release_slot(slot)
        req.status = "ok"
        req.t_done = time.perf_counter()
        self.requests_retired += 1
        self.completed.append(req)
        return req

    def _finish_terminal(
        self, req: Request, status: str, error: str | None = None
    ) -> Request:
        """Move a request, already out of its slot or queue, to a non-ok
        terminal status, counted under that status.  One terminal status
        a rid: callers reach this only for requests not yet done."""
        req.status = status
        req.error = error
        req.done = True
        req.t_done = time.perf_counter()
        counter = {
            "cancelled": "requests_cancelled",
            "expired": "requests_expired",
            "failed": "requests_failed",
        }[status]
        setattr(self, counter, getattr(self, counter) + 1)
        self.completed.append(req)
        return req

    # ---- fault tolerance ------------------------------------------------

    def _maybe_fault(self, seam: str) -> None:
        """The injector's hook at each dispatch and readback seam (one
        attribute test without an injector)."""
        if self._faults is not None:
            self._faults.check(seam)

    def _note_recovery(self) -> None:
        """After every good host readback: close the recovery window the
        last quarantine opened and reset the backoff ladder."""
        self._consecutive_faults = 0
        if self._t_last_fault is not None:
            self.fault_recovery_s.append(time.perf_counter() - self._t_last_fault)
            self._t_last_fault = None

    def _requeue_or_fail(
        self, req: Request, exc: BaseException, *, count_retry: bool = True
    ) -> Request | None:
        """Requeue one quarantined request at the front of the queue for
        replay (prompt + emitted tokens), or fail it once its retry budget
        is spent.  Health pauses pass ``count_retry=False``: a sick chip
        is not the request's fault.  Returns the request iff it failed."""
        if count_retry:
            req.retries += 1
            if req.retries > self.max_retries:
                return self._finish_terminal(
                    req, "failed",
                    error=f"{type(exc).__name__}: {exc} "
                          f"(after {self.max_retries} retries)",
                )
        req.status = "queued"
        self.requests_retried += 1
        self.tokens_replayed += len(req.prompt) + len(req.tokens)
        self.pending.appendleft(req)
        return None

    def _quarantine_step(
        self, exc: BaseException, extra: list[Request] | None = None,
        *, count_retry: bool = True,
    ) -> list[Request]:
        """Step-level recovery after a failed dispatch or readback (an
        injected fault, a CUDA error).  Device-facing state cannot be
        trusted, so it is dropped, not drained: the readbacks and
        supersteps in flight, the device carries a chained dispatch would
        take, every occupied slot and mid-prefill admission.  Their
        requests, and ``extra`` (admissions that never took a slot),
        requeue for replay under the retry budget; the next dispatch
        uploads every row from the host mirrors.  A dropped superstep
        still runs on the stream and may write pages released here;
        whatever reuses them is queued behind it on the same stream.  A
        dropped readback's pinned block goes back to the caching host
        allocator, which hands it out again only after its copy's event.
        Returns the requests that failed."""
        self.steps_quarantined += 1
        self._consecutive_faults += 1
        self._pending_read = None
        self._chained_tok = None
        self._pending_super.clear()
        self._super_chained = None
        self._fresh_slots.clear()
        victims = [self._release_slot(slot) for slot in sorted(self._slot_req)]
        partials, self._inflight_prefill = self._inflight_prefill, []
        victims += [self._abort_partial(p) for p in partials]
        victims += extra or []
        finished: list[Request] = []
        # appendleft in reverse keeps the victims' order at the queue's
        # front: replays go before newer submissions.
        for req in reversed(victims):
            failed = self._requeue_or_fail(req, exc, count_retry=count_retry)
            if failed is not None:
                finished.append(failed)
        self._t_last_fault = time.perf_counter()
        if self.retry_backoff_s and count_retry:
            time.sleep(min(
                self.retry_backoff_s * (2 ** (self._consecutive_faults - 1)),
                30 * self.retry_backoff_s,
            ))
        return finished

    def _quarantine_admissions(
        self, plans: list[dict], exc: BaseException
    ) -> list[Request]:
        """Admission recovery: the prefill (or its first-token readback)
        failed with ``plans`` in flight, their pages allocated and maybe
        unwritten.  Roll each plan back and hand its request, with every
        occupied slot, to the step quarantine."""
        extra = []
        for p in plans:
            req = self._abort_partial(p)
            if p["slot"] not in self._slot_req:
                extra.append(req)
        return self._quarantine_step(exc, extra)

    # ---- cancel, withdraw, preempt --------------------------------------

    def _find_slot(self, rid: str) -> int | None:
        for slot, req in self._slot_req.items():
            if req.rid == rid:
                return slot
        return None

    def cancel(self, rid: str) -> bool:
        """Cancel one request: a queued one leaves the queue unstarted; a
        running one stops at the step boundary, after the work in flight
        is drained (a superstep or pipelined chunk is read back first),
        with the tokens it emitted kept.  Returns True iff the rid was
        live; it surfaces through the next step() (and is on
        ``completed`` at once)."""
        if self._closed:
            raise EngineClosed("engine is closed")
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self._finished_buffer.append(self._finish_terminal(req, "cancelled"))
                return True
        for plan in self._inflight_prefill:
            if plan["req"].rid == rid:
                # Mid-prefill: no readback in flight, its pages release.
                req = self._reclaim_partial(plan)
                self._finished_buffer.append(self._finish_terminal(req, "cancelled"))
                return True
        target = self._find_slot(rid)
        if target is None:
            return False
        # The drain may retire the request (nothing left to cancel) or,
        # on a fault, quarantine it back into the queue (cancel it there).
        self._finished_buffer.extend(self._drain_all_pending())
        if target in self._slot_req and self._slot_req[target].rid == rid:
            req = self._release_slot(target)
            self._finished_buffer.append(self._finish_terminal(req, "cancelled"))
            return True
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self._finished_buffer.append(self._finish_terminal(req, "cancelled"))
                return True
        return False

    def withdraw(self, rid: str) -> Request | None:
        """Remove one queued request without a terminal status, for a
        router that will dispatch it elsewhere.  Running and mid-prefill
        requests return None (``cancel`` and ``preempt`` reach those)."""
        if self._closed:
            raise EngineClosed("engine is closed")
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                return req
        return None

    def preempt(self, rid: str) -> Request | None:
        """Reclaim one queued, mid-prefill or running request without a
        terminal status, for a scheduler that replays prompt + emitted
        tokens later (greedy continuations are the same).  A running one
        drains the work in flight first, so ``req.tokens`` is complete.
        ``preempt_recompute_tokens`` counts what the resume recomputes:
        without a prefix cache, every prefilled and emitted token.
        Returns the request, or None when the rid is not live here."""
        if self._closed:
            raise EngineClosed("engine is closed")
        got = self.withdraw(rid)
        if got is not None:
            self.requests_preempted += 1
            return got
        for plan in self._inflight_prefill:
            if plan["req"].rid == rid:
                self.preempt_recompute_tokens += min(
                    plan["cursor"] * self.prompt_bucket, plan["n"]
                )
                self.requests_preempted += 1
                return self._reclaim_partial(plan)
        target = self._find_slot(rid)
        if target is None:
            return None
        self._finished_buffer.extend(self._drain_all_pending())
        if target not in self._slot_req or self._slot_req[target].rid != rid:
            got = self.withdraw(rid)
            if got is not None:
                self.requests_preempted += 1
            return got
        req = self._release_slot(target)
        self.preempt_recompute_tokens += len(req.prompt) + len(req.tokens)
        self.requests_preempted += 1
        return req

    def _dev(self, mirror: np.ndarray) -> torch.Tensor:
        """A host mirror as a fresh device tensor, copied first: the
        mirror changes after the dispatch.  To the card it goes through a
        pinned copy without a synchronise, so the upload queues behind
        the work in flight instead of waiting for it; the pinned block
        is not reused before the copy has run."""
        host = torch.from_numpy(np.ascontiguousarray(mirror))
        if self.device.type == "cpu":
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def _fresh_mask(self) -> torch.Tensor:
        """[slots] bool device mask of the slots admitted since the last
        decode dispatch, which a chained dispatch takes from the host."""
        fresh = np.zeros(self.slots, bool)
        fresh[list(self._fresh_slots)] = True
        return self._dev(fresh)

    # ---- admission ------------------------------------------------------

    def _admit(self) -> list[Request]:
        """Fill free slots from the pending queue.  Batched (the
        default): every admission of the step rides one prefill sweep and
        one first-token readback; serial: one prefill and one readback
        per admission; with a ``prefill_budget``: the resumable budgeted
        sweep.  Returns the requests that finished at admission
        (max_new_tokens == 1 or an instant eos); in the batched loop a
        retirement there frees budget, so it plans again on untouched
        slots."""
        if self.prefill_budget is not None:
            return self._admit_budgeted()
        if not self.batched_admission:
            return self._admit_serial()
        finished: list[Request] = []
        used: set[int] = set()
        while True:
            plans = self._plan_admissions(used)
            if not plans:
                return finished
            used.update(p["slot"] for p in plans)
            try:
                emitted = self._sweep_prefill(plans)
                batch_finished = self._finish_admissions(plans, emitted)
            except Exception as exc:  # noqa: BLE001 — recovery seam
                return finished + self._quarantine_admissions(plans, exc)
            finished += batch_finished
            if not batch_finished:
                return finished

    def _admission_tokens(self, req: Request) -> list[int]:
        """The tokens an admission prefills: the prompt, and for a replay
        every token already emitted, so the stream goes on where it
        stopped."""
        return req.prompt + req.tokens if req.tokens else req.prompt

    def _admission_need(self, req: Request) -> int:
        """Worst-case pages of an admission (a replay's remaining budget
        is what it has not emitted yet)."""
        return self._worst_case_pages(
            len(self._admission_tokens(req)), req.max_new_tokens - len(req.tokens)
        )

    def _take_head(self) -> Request:
        req = self.pending.popleft()
        req.t_admit = time.perf_counter()
        req.status = "running"
        self.requests_admitted += 1
        return req

    def _admit_serial(self) -> list[Request]:
        """Serial admission: allocate the prompt's pages, prefill it (one
        batch-1 call per admission), sample its first token with a
        readback of its own."""
        finished = []
        for slot in range(self.slots):
            if self._occupied[slot] or not self.pending:
                continue
            need = self._admission_need(self.pending[0])
            if self._committed_pages + need > self.ctrl.n_pages:
                break  # FIFO: no queue-jumping by smaller requests
            req = self._take_head()
            seq = self._seq_id(slot, req)
            prompt = self._admission_tokens(req)
            n = len(prompt)
            try:
                self._maybe_fault("prefill_dispatch")
                table = np.full((1, self.max_pages), self.ctrl.trash, np.int32)
                pages = self.ctrl.allocate(seq, n)
                table[0, : len(pages)] = pages
                logits = self._run_prefill(self._dev(table), prompt)
                self._maybe_fault("prefill_readback")
                tok = int(sample_logits(
                    logits, self.generator if self.sampling else None,
                    self.temperature, self.top_k, self.top_p,
                )[0])
            except Exception as exc:  # noqa: BLE001 — recovery seam
                plan = {"slot": slot, "req": req, "seq": seq, "need": 0}
                return finished + self._quarantine_admissions([plan], exc)
            self.admission_readbacks += 1
            self._note_recovery()
            if self._land_first_token(slot, req, seq, need, n, tok):
                finished.append(req)
            else:
                self._committed_pages += need
        return finished

    def _run_prefill(self, table: torch.Tensor, prompt: list[int]) -> torch.Tensor:
        """Prefill one admission: one bucket-wide ``paged_prefill`` for a
        prompt that fits, page-aligned ``paged_prefill_chunk`` calls for a
        longer one.  Returns its [1, vocab] next-token logits."""
        n, B = len(prompt), self.prompt_bucket
        bp = B // self.page_size
        self.prefills_run += 1
        self.prefill_tokens += n
        lengths = self._dev(np.asarray([n], np.int32))
        if n <= B:
            self.prefill_dispatches += 1
            tokens = np.zeros((1, B), np.int64)
            tokens[0, :n] = prompt
            logits, _ = paged_prefill(
                self.params, self.pools, table, self._dev(tokens), lengths,
                self.config,
            )
            return logits
        n_chunks = -(-n // B)
        for ci in range(n_chunks):
            self.prefill_dispatches += 1
            tokens = np.zeros((1, B), np.int64)
            width = min(B, n - ci * B)
            tokens[0, :width] = prompt[ci * B : ci * B + width]
            logits, _ = paged_prefill_chunk(
                self.params, self.pools, table, self._dev(tokens), lengths,
                self.config, start_page=ci * bp, cover_pages=(ci + 1) * bp,
                emit=ci == n_chunks - 1,
            )
        return logits

    def _plan_admissions(self, used: set) -> list[dict]:
        """Scan the queue in the serial path's order (free slots
        ascending, FIFO, stop at the first request the page budget
        defers), committing worst-case pages and allocating the prompt's
        pages; no device work.  ``used`` excludes slots taken earlier in
        this step and slots mid-prefill."""
        plans: list[dict] = []
        for slot in range(self.slots):
            if slot in used or self._occupied[slot] or not self.pending:
                continue
            need = self._admission_need(self.pending[0])
            if self._committed_pages + need > self.ctrl.n_pages:
                # FIFO: no queue-jumping by smaller requests.
                break
            req = self._take_head()
            seq = self._seq_id(slot, req)
            prompt = self._admission_tokens(req)
            self.ctrl.allocate(seq, len(prompt))
            self._committed_pages += need
            plans.append({
                "slot": slot, "req": req, "seq": seq, "n": len(prompt),
                "prompt": prompt, "need": need,
            })
        return plans

    def _prefill_row_arrays(self, rows: list[dict]):
        """The prefill sweep's per-row inputs: host lengths, and device
        tables and lengths (rows not in ``rows`` keep trash tables and
        length 0, as parked decode rows do)."""
        lengths = np.zeros(self.slots, np.int32)
        tables = np.full((self.slots, self.max_pages), self.ctrl.trash, np.int32)
        for p in rows:
            lengths[p["slot"]] = p["n"]
            t = self.ctrl.tables[p["seq"]]
            tables[p["slot"], : len(t)] = t
        return lengths, self._dev(tables), self._dev(lengths)

    def _dispatch_prefill_ci(
        self, rows: list[dict], ci: int, lengths: np.ndarray, tables_dev,
        lengths_dev, emitted: torch.Tensor,
    ) -> torch.Tensor:
        """ONE [slots, bucket] prefill chunk at chunk index ``ci`` for
        ``rows``; a row's logits land in ``emitted`` from the chunk where
        its prompt ends.  The unbudgeted and the budgeted sweep both
        dispatch through here."""
        B, bp = self.prompt_bucket, self.prompt_bucket // self.page_size
        start = ci * B
        chunk = np.zeros((self.slots, B), np.int64)
        for p in rows:
            width = min(B, p["n"] - start)
            if width > 0:
                chunk[p["slot"], :width] = p["prompt"][start : start + width]
        logits, _ = paged_prefill_chunk(
            self.params, self.pools, tables_dev, self._dev(chunk), lengths_dev,
            self.config, start_page=ci * bp, cover_pages=(ci + 1) * bp, emit=True,
        )
        self.prefill_dispatches += 1
        emit_mask = (lengths > start) & (lengths <= start + B)
        return torch.where(self._dev(emit_mask)[:, None], logits, emitted)

    def _sweep_prefill(self, plans: list[dict]) -> torch.Tensor:
        """Stack the planned rows into one ragged [slots, bucket] batch and
        run the page-aligned chunks any row covers.  Returns the
        [slots, vocab] first-token logits."""
        self._maybe_fault("prefill_dispatch")
        for p in plans:
            self.prefills_run += 1
            self.prefill_tokens += p["n"]
        lengths, tables_dev, lengths_dev = self._prefill_row_arrays(plans)
        emitted = torch.zeros(
            (self.slots, self.config.vocab_size), dtype=torch.float32,
            device=self.device,
        )
        self.prefill_sweeps += 1
        for ci in range(-(-int(lengths.max()) // self.prompt_bucket)):
            emitted = self._dispatch_prefill_ci(
                plans, ci, lengths, tables_dev, lengths_dev, emitted
            )
        return emitted

    def _finish_admissions(
        self, plans: list[dict], emitted: torch.Tensor
    ) -> list[Request]:
        """Sample every row's first token in one call, read the batch back
        once, then apply emission and at-admission retirement (which
        rolls the plan's page commitment back).  Returns the requests
        finished at admission."""
        self._maybe_fault("prefill_readback")
        toks = sample_logits(
            emitted, self.generator if self.sampling else None,
            self.temperature, self.top_k, self.top_p,
        ).cpu().numpy()
        self.admission_readbacks += 1
        self._note_recovery()
        finished = []
        for p in plans:
            slot = p["slot"]
            if self._land_first_token(slot, p["req"], p["seq"], p["need"], p["n"],
                                      int(toks[slot])):
                self._committed_pages -= p["need"]  # the plan's, rolled back
                finished.append(p["req"])
        return finished

    def _land_first_token(
        self, slot: int, req: Request, seq, need: int, n: int, tok: int
    ) -> bool:
        """Emit an admission's first token.  A request that ends there
        retires at once, its pages released; any other takes its slot,
        to decode from position ``n`` at the next dispatch.  Returns
        whether it retired.  A replay keeps its first ``t_first``."""
        req.tokens.append(tok)
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
        self.generated_tokens += 1
        if len(req.tokens) >= req.max_new_tokens or tok == req.eos_token:
            req.done = True
            req.status = "ok"
            req.t_done = now
            self.ctrl.release(seq)
            self.requests_retired += 1
            self.completed.append(req)
            return True
        self._slot_req[slot] = req
        self._occupied[slot] = True
        self._fresh_slots.add(slot)
        self._slot_commit[slot] = need
        table = self.ctrl.tables[seq]
        self._tables[slot, : len(table)] = table
        self._positions[slot] = n
        self._tokens[slot] = tok
        return False

    # ---- budgeted chunked-prefill interleaving --------------------------

    def _admit_budgeted(self) -> list[Request]:
        """Resumable admission under ``prefill_budget``: plan new
        admissions as the unbudgeted path does, dispatch at most
        ``max(1, prefill_budget // prompt_bucket)`` chunks across every
        mid-prefill row, finish the rows whose last chunk ran (one fused
        readback) and carry the rest to the next step.  Under
        ``pipelined`` the decode readback due is consumed between the
        sweep's dispatch and its readback, so it overlaps the prefill.
        No same-step re-plan after an at-admission retirement: the freed
        budget admits next step."""
        budget = max(1, self.prefill_budget // self.prompt_bucket)
        finished: list[Request] = []
        used = {p["slot"] for p in self._inflight_prefill}
        new_plans = self._plan_admissions(used)
        for p in new_plans:
            p["cursor"] = 0
            p["last_ci"] = -(-p["n"] // self.prompt_bucket) - 1
            self.prefills_run += 1
            self.prefill_tokens += p["n"]
        self._inflight_prefill.extend(new_plans)
        if not self._inflight_prefill:
            return finished
        try:
            emitted = self._sweep_prefill_budgeted(budget)
            if self.pipelined:
                if self._pending_read is not None:
                    read, snapshot = self._pending_read
                    self._pending_read = None
                    finished += self._consume_chunk(read, snapshot)
                if len(self._pending_super) > 1:
                    # The superstep loop admits with the newest superstep
                    # in flight; the previous one's readback overlaps the
                    # sweep.
                    read, snapshot = self._pending_super.popleft()
                    finished += self._consume_superstep(read, snapshot)
            completed = [p for p in self._inflight_prefill if p["cursor"] > p["last_ci"]]
            if completed:
                finished += self._finish_admissions(completed, emitted)
                self._inflight_prefill = [
                    p for p in self._inflight_prefill if p["cursor"] <= p["last_ci"]
                ]
        except Exception as exc:  # noqa: BLE001 — recovery seam
            plans, self._inflight_prefill = self._inflight_prefill, []
            return finished + self._quarantine_admissions(plans, exc)
        for p in self._inflight_prefill:
            self.prefill_deferred_tokens += max(
                0, p["n"] - p["cursor"] * self.prompt_bucket
            )
        return finished

    def _sweep_prefill_budgeted(self, max_chunks: int) -> torch.Tensor:
        """Dispatch up to ``max_chunks`` prompt-bucket chunks across the
        mid-prefill rows, oldest admission first; every row whose cursor
        sits at the same chunk index rides the same dispatch.  Returns the
        [slots, vocab] logits of the rows whose last chunk ran."""
        emitted = torch.zeros(
            (self.slots, self.config.vocab_size), dtype=torch.float32,
            device=self.device,
        )
        if not any(p["cursor"] <= p["last_ci"] for p in self._inflight_prefill):
            return emitted
        self._maybe_fault("prefill_dispatch")
        self.prefill_sweeps += 1
        group_key, arrays = None, None
        for _ in range(max_chunks):
            todo = [p for p in self._inflight_prefill if p["cursor"] <= p["last_ci"]]
            if not todo:
                break
            ci = todo[0]["cursor"]
            group = [p for p in todo if p["cursor"] == ci]
            key = tuple(id(p) for p in group)
            if key != group_key:
                # A group's inputs depend only on its rows: an unchanged
                # group reuses one upload.
                arrays, group_key = self._prefill_row_arrays(group), key
            emitted = self._dispatch_prefill_ci(group, ci, *arrays, emitted)
            for p in group:
                p["cursor"] += 1
        return emitted

    def _abort_partial(self, plan: dict) -> Request:
        """Drop one mid-prefill admission: release its pages and roll back
        its commitment.  The request's fate is the caller's."""
        self._inflight_prefill = [q for q in self._inflight_prefill if q is not plan]
        if plan["seq"] in self.ctrl.tables:
            self.ctrl.release(plan["seq"])
        self._committed_pages -= plan["need"]
        return plan["req"]

    def _reclaim_partial(self, plan: dict) -> Request:
        """Reclaim one mid-prefill admission for cancel, expiry or
        preempt: its pages and commitment go back.  (The JAX engine's
        fan-out branch, which requeues a group's siblings, comes with
        fan-out.)"""
        return self._abort_partial(plan)

    # ---- decode ---------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One engine iteration: admit into free slots, run one decode
        chunk for every occupied slot, retire finished requests.  Returns
        the requests that finished during this step.

        With ``pipelined`` a chunk's tokens are read back only after the
        next chunk is dispatched on its device-side last tokens, so
        emission and retirement lag one chunk; tokens are the same.  With
        ``superstep_k > 1`` the step runs ``_step_superstep``.  A failed
        dispatch or readback quarantines the step."""
        return self._step_impl()

    def _step_impl(self) -> list[Request]:
        if self._closed:
            raise EngineClosed("engine is closed; no further steps")
        # Requests finished outside step() (cancel, retune) surface here.
        finished = list(self._finished_buffer)
        self._finished_buffer.clear()
        finished += self._poll_health()
        finished += self._expire_deadlines()
        if self._paused:
            # Health hold: no admission, no dispatch; the work in flight
            # was requeued when the chip went unhealthy.
            return finished
        # The decode paths accumulate into this alias, so retirements made
        # before a later seam fault still surface in this step's return.
        self._decode_finished: list[Request] = []
        if self.superstep_k > 1:
            try:
                return finished + self._step_superstep()
            except Exception as exc:  # noqa: BLE001 — recovery seam
                return finished + self._decode_finished + self._quarantine_step(exc)
        finished += self._admit()
        try:
            return finished + self._step_decode()
        except Exception as exc:  # noqa: BLE001 — recovery seam
            return finished + self._decode_finished + self._quarantine_step(exc)

    def _step_decode(self) -> list[Request]:
        finished = self._decode_finished
        if not self._occupied.any():
            if self._pending_read is not None:
                read, snapshot = self._pending_read
                self._pending_read = None
                finished += self._consume_chunk(read, snapshot)
            return finished
        self._cover_chunk()
        tok_in = self._dev(self._tokens)
        if self.pipelined and self._chained_tok is not None:
            tok_in = torch.where(self._fresh_mask(), tok_in, self._chained_tok)
        self._fresh_slots.clear()
        tables, pos, occupied = (
            self._dev(self._tables), self._dev(self._positions),
            self._dev(self._occupied),
        )
        self._maybe_fault("decode_dispatch")
        if self._graph is None:
            toks, _ = paged_decode_chunk(
                self.params, self.pools, tables, tok_in, pos, occupied,
                self.generator, self.temperature, self.top_k, self.top_p,
                self.config, self.chunk, self.sampling,
            )
            last = toks[:, -1]
        else:
            toks, last, *_ = self._graph.run(
                tables, tok_in, pos, occupied, *self._unbounded, self.chunk
            )
        self.chunks_run += 1
        read = _Readback(toks)
        snapshot = dict(self._slot_req)
        for slot in snapshot:
            self._positions[slot] += self.chunk
        if not self.pipelined:
            return finished + self._consume_chunk(read, snapshot)
        self._chained_tok = last
        prev, self._pending_read = self._pending_read, (read, snapshot)
        if prev is not None:
            # Reading the previous chunk now overlaps the one in flight.
            finished += self._consume_chunk(*prev)
        return finished

    def _cover_chunk(self) -> None:
        """Extend every occupied row's table one chunk past its position
        (which already counts chunks dispatched and not read), within the
        admission-time commitment."""
        for slot, req in self._slot_req.items():
            table = self.ctrl.extend(
                self._seq_id(slot, req), int(self._positions[slot]) + self.chunk
            )
            self._tables[slot, : len(table)] = table

    def _emit(self, req: Request, toks_row) -> None:
        """Append a row's decoded tokens to its request, flipping ``done``
        at eos or max_new_tokens."""
        for tok in toks_row:
            req.tokens.append(int(tok))
            self.generated_tokens += 1
            if int(tok) == req.eos_token or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                break

    def _consume_chunk(self, read: _Readback, snapshot: dict) -> list[Request]:
        """Read a chunk's tokens back (the host sync point) and apply
        emission and retirement for the slots as they were at dispatch."""
        self._maybe_fault("decode_readback")
        toks = read.numpy()
        self._note_recovery()
        finished = []
        for slot, req in snapshot.items():
            if req.done:
                # Retired between dispatch and read (pipelined lag).
                continue
            self._emit(req, toks[slot])
            self._tokens[slot] = toks[slot, -1]
            if req.done:
                finished.append(self._retire(slot))
        return finished

    # ---- decode supersteps (superstep_k > 1) ----------------------------

    def _step_superstep(self) -> list[Request]:
        """One double-buffered iteration: the superstep for the slots
        occupied NOW is dispatched first, admission (planning, prefill
        sweeps) runs while it computes, and its one readback comes last.
        Requests admitted in that window join the next superstep, and a
        second lifecycle poll there acts on health events and deadlines
        while the device computes.  Under ``pipelined`` the newest
        superstep stays in flight, chained on the device, while the
        previous one is consumed."""
        finished = self._decode_finished
        dispatched = False
        if self._occupied.any():
            self._dispatch_superstep()
            dispatched = True
        finished += self._admit()
        finished += self._poll_health()
        finished += self._expire_deadlines()
        keep = 1 if (self.pipelined and dispatched) else 0
        while len(self._pending_super) > keep:
            read, snapshot = self._pending_super.popleft()
            finished += self._consume_superstep(read, snapshot)
        return finished

    def _dispatch_superstep(self) -> None:
        """Dispatch one superstep (``superstep_k`` chunks, retirement on
        the device) for the occupied slots.  Page pre-commitment: each
        live row's table extends up front over the whole superstep
        (position + k*chunk, two supersteps while one is still in flight
        for it), capped at the row's retirement ceiling (the last position
        its budget can reach, +1 for the frozen slot dead steps keep
        writing), so nothing is allocated mid-superstep and the admission
        commitment is never overrun."""
        span = self.superstep_k * self.chunk
        in_flight: set[int] = set()
        for _, snap in self._pending_super:
            in_flight.update(snap)
        eos = np.full(self.slots, -1, np.int32)
        budget = np.zeros(self.slots, np.int32)
        for slot, req in self._slot_req.items():
            pos = int(self._positions[slot])
            # Position and emitted count advance together at consume, so
            # the ceiling holds while a superstep is in flight.
            ceiling = pos + (req.max_new_tokens - len(req.tokens)) + 1
            bound = pos + span * (2 if slot in in_flight else 1)
            table = self.ctrl.extend(self._seq_id(slot, req), min(bound, ceiling))
            self._tables[slot, : len(table)] = table
            if req.eos_token is not None:
                eos[slot] = req.eos_token
            budget[slot] = req.max_new_tokens - len(req.tokens)
        tok_in = self._dev(self._tokens)
        pos_in = self._dev(self._positions)
        live_in = self._dev(self._occupied)
        budget_in = self._dev(budget)
        if self.pipelined and self._super_chained is not None:
            # Chain on the previous superstep's device carry; only fresh
            # slots take their host state.
            fresh = self._fresh_mask()
            carry = self._super_chained
            tok_in, pos_in, live_in, budget_in = (
                torch.where(fresh, host, chained)
                for host, chained in zip((tok_in, pos_in, live_in, budget_in), carry)
            )
        self._fresh_slots.clear()
        tables, eos_in = self._dev(self._tables), self._dev(eos)
        self._maybe_fault("decode_dispatch")
        if self._graph is None:
            toks, *carry, _ = paged_decode_superstep(
                self.params, self.pools, tables, tok_in, pos_in, live_in,
                budget_in, eos_in, self.generator, self.temperature, self.top_k,
                self.top_p, self.config, self.chunk, self.superstep_k, self.sampling,
            )
        else:
            toks, *carry = self._graph.run(
                tables, tok_in, pos_in, live_in, budget_in, eos_in, span
            )
        self.chunks_run += self.superstep_k
        self.supersteps_run += 1
        if self.pipelined:
            self._super_chained = tuple(carry)
        self._pending_super.append((_Readback(toks), dict(self._slot_req)))

    def _consume_superstep(self, read: _Readback, snapshot: dict) -> list[Request]:
        """The superstep's one readback: emit each row's live prefix
        (``_emit``'s eos/max_new rule is the device's retirement mask, so
        the host mirrors advance as the device did), retire finished
        rows, and count the dead steps each retiring row sat frozen for."""
        self._maybe_fault("decode_readback")
        toks = read.numpy()
        self._note_recovery()
        span = toks.shape[1]
        finished = []
        for slot, req in snapshot.items():
            if req.done:
                # Retired between dispatch and read (pipelined lag): the
                # chained live mask parked it for the whole superstep.
                self.tokens_overdecoded += span
                continue
            before = len(req.tokens)
            self._emit(req, toks[slot])
            advance = len(req.tokens) - before
            self._positions[slot] += advance
            self._tokens[slot] = toks[slot, advance - 1]
            if req.done:
                self.tokens_overdecoded += span - advance
                finished.append(self._retire(slot))
        return finished

    # ---- lifecycle ------------------------------------------------------

    def drain_completed(self) -> list[Request]:
        """Hand back (and clear) the finished-request ring."""
        out = list(self.completed)
        self.completed.clear()
        return out

    def _drain_pending_plain(self) -> list[Request]:
        """Consume the pipelined chunk in flight (the host mirrors catch
        up) and drop the device-chained tokens: the next dispatch takes
        every row from the mirrors."""
        finished: list[Request] = []
        if self._pending_read is not None:
            read, snapshot = self._pending_read
            self._pending_read = None
            finished = self._consume_chunk(read, snapshot)
        self._chained_tok = None
        return finished

    def _drain_pending_super(self) -> list[Request]:
        """Consume every superstep in flight and drop the device carry:
        the next dispatch takes every row from the mirrors."""
        finished: list[Request] = []
        while self._pending_super:
            read, snapshot = self._pending_super.popleft()
            finished += self._consume_superstep(read, snapshot)
        self._super_chained = None
        return finished

    def _drain_all_pending(self) -> list[Request]:
        """Consume whatever is in flight, so the host mirrors hold what
        the device computed: what cancel, expiry, preempt and retune need
        before they touch a slot or a knob.  A seam failure during the
        drain quarantines the step."""
        try:
            return self._drain_pending_plain() + self._drain_pending_super()
        except Exception as exc:  # noqa: BLE001 — recovery seam
            return self._quarantine_step(exc)

    def _expire_deadlines(self) -> list[Request]:
        """Move queued, mid-prefill and running requests whose deadline
        has passed to ``expired`` (a running one after the work in flight
        is drained, as cancel does)."""
        now = time.perf_counter()

        def due(req: Request) -> bool:
            return req.t_deadline is not None and now >= req.t_deadline

        finished: list[Request] = []
        for req in [r for r in self.pending if due(r)]:
            self.pending.remove(req)
            finished.append(self._finish_terminal(req, "expired"))
        for plan in [p for p in self._inflight_prefill if due(p["req"])]:
            finished.append(self._finish_terminal(self._reclaim_partial(plan), "expired"))
        expired_slots = [slot for slot, r in self._slot_req.items() if due(r)]
        if expired_slots:
            finished += self._drain_all_pending()
            for slot in expired_slots:
                req = self._slot_req.get(slot)
                if req is None or not due(req):
                    continue  # the drain retired or replaced it
                finished.append(self._finish_terminal(self._release_slot(slot), "expired"))
        return finished

    # ---- health bridge --------------------------------------------------

    def bind_health(self, fanout) -> None:
        """Subscribe to a tpu_device_plugin ``HealthFanout``: an unhealthy
        chip pauses admission and requeues the work in flight (no retry
        charge), the all-clear resumes.  close() unsubscribes."""
        if self._health_fanout is not None:
            raise RuntimeError("engine is already bound to a health fanout")
        self._health_fanout = fanout
        self._health_events = fanout.subscribe()

    def unbind_health(self) -> None:
        if self._health_fanout is not None:
            self._health_fanout.unsubscribe(self._health_events)
            self._health_fanout = None
        self._health_events = None

    def _poll_health(self) -> list[Request]:
        """Drain the health queue without blocking and apply it: any
        unhealthy chip pauses the engine and drops and requeues the work
        in flight (the device's answers cannot be trusted, so this is the
        quarantine, not a drain); every chip healthy again resumes.  An
        event with ``chip_id`` "" speaks for every chip."""
        q = self._health_events
        if q is None:
            return []
        changed = False
        while True:
            try:
                ev = q.get_nowait()
            except queue.Empty:
                break
            if ev.health == UNHEALTHY:
                self._unhealthy_chips.add(ev.chip_id or "*all*")
            elif not ev.chip_id:
                self._unhealthy_chips.clear()
            else:
                self._unhealthy_chips.discard(ev.chip_id)
            changed = True
        if not changed:
            return []
        if self._unhealthy_chips and not self._paused:
            self._paused = True
            return self._quarantine_step(
                RuntimeError(f"chip(s) unhealthy: {sorted(self._unhealthy_chips)}"),
                count_retry=False,
            )
        if not self._unhealthy_chips and self._paused:
            self._paused = False
        return []

    @property
    def paused(self) -> bool:
        """True while the health bridge holds admission."""
        return self._paused

    # ---- online retune --------------------------------------------------

    def retune(self, *, superstep_k: int | None = None) -> dict:
        """Change ``superstep_k`` on a live engine, between dispatches:
        down from its construction value and back up to it, never above.
        Whatever is in flight drains first, so the next dispatch under the
        new k starts from what the device computed: greedy streams are the
        same across every change, and the card's decode graph (captured
        for the construction k) is replayed, never captured again.
        Requests the drain retires surface through the next step().
        Returns ``{knob: (old, new)}`` for a real change, else ``{}``
        (nothing drained or counted)."""
        if self._closed:
            raise EngineClosed("engine is closed; no retune")
        if superstep_k is None:
            return {}
        if not 1 <= int(superstep_k) <= self._superstep_k_max:
            raise ValueError(
                f"superstep_k must be in [1, {self._superstep_k_max}] (the "
                f"construction-time ceiling), got {superstep_k}"
            )
        if int(superstep_k) == self.superstep_k:
            return {}
        self._finished_buffer.extend(self._drain_all_pending())
        change = {"superstep_k": (self.superstep_k, int(superstep_k))}
        self.superstep_k = int(superstep_k)
        self.retunes += 1
        return change

    # ---- shutdown -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent shutdown: pending, mid-prefill and running requests
        fail with ``EngineClosed`` recorded, their pages release, work in
        flight is dropped unread, the health subscription ends; later
        submit and step raise ``EngineClosed``, and the closed engine
        reads idle."""
        if self._closed:
            return
        self._closed = True
        self._pending_read = None
        self._chained_tok = None
        self._pending_super.clear()
        self._super_chained = None
        self._fresh_slots.clear()
        err = "EngineClosed: engine closed with the request in flight"
        # step() refuses to run after close, so these land on
        # ``completed`` only, and the buffer clears.
        for slot in sorted(self._slot_req):
            self._finish_terminal(self._release_slot(slot), "failed", error=err)
        for plan in list(self._inflight_prefill):
            self._finish_terminal(self._abort_partial(plan), "failed", error=err)
        while self.pending:
            self._finish_terminal(self.pending.popleft(), "failed", error=err)
        self._finished_buffer.clear()
        self.unbind_health()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    @property
    def idle(self) -> bool:
        return (
            not self.pending
            and not self._occupied.any()
            and not self._inflight_prefill
            and self._pending_read is None
            and not self._pending_super
            and not self._finished_buffer
        )

    def run(self) -> dict[str, list[int]]:
        """Drive step() until every submitted request has reached a
        terminal status; returns {rid: generated tokens} (``completed``
        holds the statuses).  While the health bridge holds admission the
        loop sleeps briefly between polls."""
        out = {}
        while not self.idle:
            for req in self.step():
                out[req.rid] = req.tokens
            if self._paused:
                time.sleep(0.001)
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
    parser.add_argument("--prefill-budget", type=int, default=None,
                        metavar="TOKENS",
                        help="cap prefill work at TOKENS a step (at least one "
                        "chunk always runs) and carry the rest of long "
                        "prompts across steps, so a long prefill never holds "
                        "up the decode chunk (omit to prefill each admission "
                        "to the end)")
    parser.add_argument("--pipelined", action="store_true",
                        help="read each chunk back after the next one is "
                        "dispatched (same tokens)")
    parser.add_argument("--superstep-k", type=int, default=1, metavar="K",
                        help="run K chained decode chunks a dispatch with "
                        "eos/max-token retirement on the device, admission "
                        "overlapping the device's work (same greedy tokens "
                        "for every K)")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="per-request deadline in seconds; requests "
                        "still queued or running past it expire")
    parser.add_argument("--max-retries", type=int, default=2,
                        help="replay retries per request after a "
                        "quarantined step before it fails")
    parser.add_argument("--inject-fault", action="append", default=None,
                        metavar="SEAM:N",
                        help="raise at the engine seam's Nth crossing "
                        "(repeatable; seams: prefill_dispatch, "
                        "prefill_readback, decode_dispatch, "
                        "decode_readback) to exercise quarantine and replay")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    injector = None
    if args.inject_fault:
        from .faults import FaultInjector

        seams = ("prefill_dispatch", "prefill_readback", "decode_dispatch",
                 "decode_readback")
        schedule: dict[str, list[int]] = {}
        for spec in args.inject_fault:
            seam, _, n = spec.partition(":")
            if seam not in seams or not n.isdigit():
                parser.error(f"--inject-fault wants SEAM:N with SEAM one of "
                             f"{', '.join(seams)}; got {spec!r}")
            schedule.setdefault(seam, []).append(int(n))
        try:
            injector = FaultInjector(schedule)
        except ValueError as e:
            parser.error(str(e))
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
        generator=torch.Generator(device).manual_seed(42),
        pipelined=args.pipelined, superstep_k=args.superstep_k,
        prefill_budget=args.prefill_budget, fault_injector=injector,
        max_retries=args.max_retries, device=device,
    )
    rng = np.random.default_rng(7)
    for i in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        prompt = rng.integers(0, config.vocab_size, plen)
        # Mixed lengths: the stream the engine's slot turnover exists for.
        engine.submit(prompt, max(1, args.max_new_tokens // (1 + i % 3)),
                      deadline_s=args.deadline_s)

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
        f"{engine.chunks_run} chunks ({engine.supersteps_run} supersteps, "
        f"{engine.tokens_overdecoded} tokens over-decoded), "
        f"steady-state ≈ {rate:.0f} tok/s "
        f"(device={device}, kv_heads={config.kv_heads}, "
        f"pool={engine.ctrl.n_pages} pages, "
        f"pages in use after drain: {engine.ctrl.used_pages})"
    )
    if engine.steps_quarantined or engine.requests_expired or engine.requests_failed:
        from collections import Counter

        statuses = Counter(r.status for r in engine.completed)
        print(
            f"lifecycle: statuses={dict(statuses)} "
            f"quarantined_steps={engine.steps_quarantined} "
            f"replays={engine.requests_retried} "
            f"tokens_replayed={engine.tokens_replayed} "
            f"recoveries_ms={[round(t * 1000, 1) for t in engine.fault_recovery_s]}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
