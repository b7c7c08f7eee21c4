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
and ``preempt`` (a running request's prompt pages park in the prefix
cache, and with the offload tier in host RAM), ``submit(deadline_s=)``,
fault seams
at every prefill and decode dispatch and readback (``faults.py``) whose
failures quarantine the step and replay its requests (prompt plus
emitted tokens re-prefilled) under ``max_retries``, a health bridge
that pauses on an unhealthy chip, ``retune(superstep_k=)`` and
``close``/the context manager.  A quarantine drops the work in flight
unread: a dropped superstep still runs on the stream, ahead of
everything queued after it, and the next dispatch uploads every row
from the host mirrors.

The KV-cache hierarchy, as in the JAX engine: ``prefix_cache`` (True or
"radix", the ``RadixKV`` tree; "flat", the chain-hash ``PrefixCache``)
serves a prompt's cached page-aligned prefix and prefills only the
rest; ``kv_offload`` spills cold cached pages to pinned host RAM
(``kv_host_pages`` bounds it) and ``kv_disk_dir`` demotes the coldest
host pages to checksummed per-page files (``durable.KVDiskTier``), both
reloaded on a later hit; ``submit_fanout`` prefills a prompt once for N
samples; ``export_kv``/``import_kv`` hand a prompt's pages to another
engine.  A spill is one gathered copy into pinned host tensors that the
host waits for (so it waits for any superstep in flight); a reload is an
in-place ``write_page`` queued on the engine's stream ahead of the
prefill that reads it.

Speculative decoding, as in the JAX engine: with ``draft_params`` and
``draft_config`` (for example the model's own int8 quantization,
``quant.quantize_params``) every decode dispatch drafts ``gamma`` tokens
a row, verifies every row's block in one target forward and commits each
row's accepted prefix (``paged.paged_spec_superstep``; greedy
agreement, or lossless rejection sampling under ``temperature``);
``spec_lookahead`` reads k rounds back at once, ``spec_superstep_k``
runs k rounds a dispatch with acceptance and retirement on the device
and turns the step around, and ``spec="auto"`` picks speculative or
plain decode each step from the occupancy against ``spec_breakeven``.
The draft has its own pools under the same page tables, so prefix hits,
spills, reloads, fan-out and handoffs carry both models' pages.  On the
card each round is a replay of ``decode_graph.SpecGraph``.

Multi-LoRA serving, as in the JAX engine: ``adapters={name: adapter}``
(``lora.lora_init`` trees) are stacked once behind a zero base entry at
index 0 (``multi_lora.stack_adapters``), and every prefill, decode step
and spec verify applies each row's own adapter delta on the activation
side, its index a per-slot mirror (``_adapter_idx``) uploaded at each
dispatch; ``submit(adapter=)`` picks one, None the base.  Prefix-cache
keys, parks and KV handoffs are salted ``lora:{i}`` per adapter, so
adapted pages are never served to another tenant.  The draft of a
speculating engine stays unadapted (the target's adapted verify keeps
speculation lossless per tenant).  On the card the adapter index is one
more static buffer of the captured graphs, so a change of mix replays
them.  The fleet is not ported yet.

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
from .decode_graph import DecodeGraph, SpecGraph
from .errors import EngineClosed, InvalidRequest, QueueFull, RequestTooLarge
from .generate import sample_logits
from .model import ModelConfig, cast_params, init_params
from .paged import (
    PagePool,
    PrefixCache,
    RadixKV,
    copy_page,
    init_page_pools,
    paged_decode_chunk,
    paged_decode_superstep,
    paged_prefill,
    paged_prefill_chunk,
    paged_spec_superstep,
    paged_spec_superstep_chained,
    read_pages,
    write_page,
)
from .quant import quantize_params

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
    as if uninterrupted).  ``group`` names the fan-out group of a
    ``submit_fanout`` member until it admits (None for a solo request)."""

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
    group: str | None = None
    adapter: str | None = None  # multi-LoRA: the adapter serving it (None: base)

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
    """Decoded tensors on their way to the host.  From the card they are
    copied into pinned memory behind one event as soon as they are
    dispatched (before anything later, such as a graph replay, can
    overwrite their buffers), so the host blocks only when it reads
    them."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].is_cuda:
            self.hosts = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.hosts.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.hosts = list(tensors)
        self.host = self.hosts[0]

    def arrays(self) -> tuple[np.ndarray, ...]:
        if self.event is not None:
            self.event.synchronize()
        return tuple(h.numpy() for h in self.hosts)

    def numpy(self) -> np.ndarray:
        return self.arrays()[0]


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
        mode_trace_limit: int | None = 256,
        draft_params: dict | None = None,
        draft_config: ModelConfig | None = None,
        gamma: int = 4,
        spec_lookahead: int = 1,
        spec_superstep_k: int = 1,
        spec: str = "on",
        spec_breakeven: float | None = None,
        spec_calibration: dict | None = None,
        prefix_cache: bool | str = False,
        kv_offload: bool = False,
        kv_host_pages: int | None = None,
        kv_disk_dir: str | None = None,
        kv_disk_pages: int | None = None,
        fault_injector=None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.0,
        health_events=None,
        adapters: dict[str, list] | None = None,
        lora_alpha: float = 1.0,
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
        if mode_trace_limit is not None and mode_trace_limit < 1:
            raise ValueError(
                f"mode_trace_limit must be >= 1 or None (unbounded), got "
                f"{mode_trace_limit}"
            )
        if (draft_params is None) != (draft_config is None):
            raise ValueError(
                "draft_params and draft_config come together (speculative "
                "serving needs both)"
            )
        if adapters is not None:
            if not adapters:
                raise ValueError(
                    "adapters must be a non-empty {name: adapter} dict "
                    "(or None to serve the plain base)"
                )
        if draft_params is not None:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("target and draft must share a vocabulary")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
        if spec_lookahead < 1:
            raise ValueError(f"spec_lookahead must be >= 1, got {spec_lookahead}")
        if superstep_k < 1:
            raise ValueError(f"superstep_k must be >= 1, got {superstep_k}")
        if spec_superstep_k < 1:
            raise ValueError(f"spec_superstep_k must be >= 1, got {spec_superstep_k}")
        if spec_lookahead > 1 and draft_params is None:
            raise ValueError(
                "spec_lookahead > 1 is a speculative-serving mode; pass "
                "draft_params/draft_config"
            )
        if spec_superstep_k > 1 and draft_params is None:
            raise ValueError(
                "spec_superstep_k > 1 is a speculative-serving mode; pass "
                "draft_params/draft_config"
            )
        if spec_superstep_k > 1 and spec_lookahead > 1:
            raise ValueError(
                "spec_superstep_k and spec_lookahead both chain rounds "
                "per dispatch; spec_superstep_k (device-side retirement) "
                "supersedes spec_lookahead — use one, not both"
            )
        if spec not in ("on", "auto"):
            raise ValueError(f'spec must be "on" or "auto", got {spec!r}')
        if spec == "auto" and draft_params is None:
            raise ValueError(
                'spec="auto" chooses between the plain and speculative '
                "decode programs per step; pass draft_params/draft_config"
            )
        if spec_breakeven is not None and spec != "auto":
            raise ValueError(
                'spec_breakeven is the spec="auto" occupancy threshold; '
                'it has no effect with spec="on"'
            )
        if spec_calibration is not None:
            if spec != "auto":
                raise ValueError(
                    'spec_calibration injects the spec="auto" break-even '
                    'calibration; it has no effect with spec="on"'
                )
            if "threshold" not in spec_calibration:
                raise ValueError(
                    "spec_calibration must carry the calibrated "
                    '"threshold" (the _calibrate_breakeven dict shape)'
                )
        if prefix_cache not in (False, True, "radix", "flat"):
            raise ValueError(
                f'prefix_cache must be False, True/"radix", or "flat", '
                f"got {prefix_cache!r}"
            )
        if kv_offload and not prefix_cache:
            raise ValueError(
                "kv_offload is the prefix cache's host-RAM eviction tier; "
                "it needs prefix_cache=True"
            )
        if kv_offload and prefix_cache == "flat":
            raise ValueError(
                'the host-RAM offload tier lives on the radix tree; use '
                'prefix_cache=True (radix), not "flat", with kv_offload'
            )
        if kv_host_pages is not None and not kv_offload:
            raise ValueError(
                "kv_host_pages bounds the kv_offload host tier; it has "
                "no effect without kv_offload=True"
            )
        if kv_host_pages is not None and kv_host_pages < 1:
            raise ValueError(
                f"kv_host_pages must be >= 1 or None (unbounded), got "
                f"{kv_host_pages}"
            )
        if kv_disk_dir is not None and not kv_offload:
            raise ValueError(
                "kv_disk_dir is the tier below the host-RAM offload "
                "tier; it needs kv_offload=True"
            )
        if kv_disk_pages is not None and kv_disk_dir is None:
            raise ValueError(
                "kv_disk_pages bounds the kv_disk_dir tier; it has no "
                "effect without kv_disk_dir"
            )
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs "
                f"on {self.device}: move them first"
            )
        if draft_params is not None and draft_params["embed"].device.type != self.device.type:
            raise ValueError(
                f"draft params live on {draft_params['embed'].device}, the "
                f"engine runs on {self.device}: move them first"
            )
        self.params, self.config = params, config
        self.draft_params, self.draft_config = draft_params, draft_config
        self.gamma = gamma
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
        # Speculation: ``spec_lookahead`` rounds a dispatch read back
        # together, or ``spec_superstep_k`` rounds a dispatch with
        # acceptance and retirement on the device and the step turned
        # around as the plain superstep's.  ``spec="auto"`` keeps both
        # decode programs and picks per step from the live occupancy
        # against ``spec_breakeven`` (calibrated at the first decode step
        # when None, or adopted from ``spec_calibration``).
        self.spec_lookahead = spec_lookahead
        self.spec_superstep_k = spec_superstep_k
        self._spec_superstep_k_max = spec_superstep_k
        self.spec = spec
        self.spec_breakeven = spec_breakeven
        self.spec_calibration: dict | None = None
        self._injected_calibration = (
            dict(spec_calibration) if spec_calibration is not None else None
        )
        self.calibration_reused = 0
        # Auto-mode telemetry: decode dispatches by mode, switches, and a
        # bounded (occupancy, mode) trace (``drain_mode_trace``).
        self.spec_mode_steps = 0
        self.plain_mode_steps = 0
        self.mode_switches = 0
        self._last_mode: str | None = None
        self.decode_mode_trace: deque = deque(maxlen=mode_trace_limit)
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
        # coverage.  A speculative dispatch commits up to gamma + 1 tokens
        # a round.
        self._overshoot = max(
            self.chunk * superstep_k * (2 if pipelined else 1),
            ((gamma + 1) * max(spec_lookahead, spec_superstep_k) * (2 if pipelined else 1))
            if draft_params is not None else 0,
        )
        bucket_pages = self.prompt_bucket // page_size
        prefill_cover = -(-config.max_seq_len // self.prompt_bucket) * bucket_pages
        self.max_pages = max(
            -(-(config.max_seq_len + self._overshoot) // page_size),
            prefill_cover,
        )
        n_pages = n_pages if n_pages is not None else slots * self.max_pages
        self.ctrl = PagePool(n_pages=n_pages, page_size=page_size)
        self.pools = init_page_pools(config, n_pages, page_size, self.device)
        # The draft model's own pools under the same control plane: the
        # same page indices and tables, so one allocator serves both
        # caches, and a cached or spilled page holds both models' k/v.
        self.d_pools = (
            init_page_pools(draft_config, n_pages, page_size, self.device)
            if draft_params is not None else None
        )
        # Cross-request prefix caching: cached pages hold the bytes the
        # prefill would write, so streams are the same cache off, flat
        # and radix; a drained engine keeps its cached pages pinned until
        # an allocation evicts them or ``close`` clears the index.
        self._kv_offload = bool(kv_offload)
        self._kv_disk = None
        if kv_disk_dir is not None:
            from .durable import KVDiskTier

            self._kv_disk = KVDiskTier(
                kv_disk_dir, budget_pages=kv_disk_pages, injector=fault_injector,
            )
        if prefix_cache == "flat":
            self.prefix = PrefixCache(self.ctrl)
        elif prefix_cache:
            self.prefix = RadixKV(
                self.ctrl, host_pages=kv_host_pages if kv_offload else 0,
                disk=self._kv_disk,
            )
        else:
            self.prefix = None
        # Host seconds moving pages between the pools and host RAM
        # (``kv_spill_s``/``kv_reload_s`` add the disk tier's file time).
        self._kv_spill_base_s = 0.0
        self._kv_reload_base_s = 0.0
        self.slots = slots
        self.temperature = float(temperature)
        self.top_k, self.top_p = int(top_k), float(top_p)
        self.sampling = self.temperature > 0.0
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator
        # Multi-LoRA: adapters stacked once (index 0 is the zero BASE
        # entry, so adapter-less requests share the code path); the
        # per-slot indices are data, so the adapter mix never recaptures.
        self.lora_alpha = float(lora_alpha)
        if adapters is not None:
            from .multi_lora import stack_adapters

            names = sorted(adapters)
            self._adapter_ids = {name: i + 1 for i, name in enumerate(names)}
            stacked = stack_adapters([adapters[n] for n in names], config)
            self._stacked_adapters = [
                {t: {k: f.to(self.device) for k, f in ab.items()} for t, ab in entry.items()}
                for entry in stacked
            ]
        else:
            self._adapter_ids = {}
            self._stacked_adapters = None
        self._adapter_idx = np.zeros(slots, np.int32)

        trash = self.ctrl.trash
        self._tables = np.full((slots, self.max_pages), trash, np.int32)
        self._positions = np.zeros(slots, np.int64)
        self._tokens = np.zeros(slots, np.int64)
        self._occupied = np.zeros(slots, bool)
        self._slot_req: dict[int, Request] = {}
        self._slot_commit: dict[int, int] = {}
        self._committed_pages = 0
        # Fan-out groups (submit_fanout): gid -> admission bookkeeping.
        self._groups: dict[str, dict] = {}
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
        # Speculative dispatches not consumed (at most one) and the
        # device-side carry a pipelined one chains on: (cur, pos), or
        # (cur, pos, live, budget) for a chained superstep.
        self._pending_spec = None
        self._spec_chained: tuple | None = None
        # On the card: the decode step as a CUDA graph, replayed per step.
        self._graph = None
        if self.device.type == "cuda":
            self._graph = DecodeGraph(
                params, self.pools, config, slots=slots,
                max_pages=self.max_pages, max_steps=self.chunk * superstep_k,
                generator=self.generator, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, sampling=self.sampling,
                lora_stacked=self._stacked_adapters, lora_alpha=self.lora_alpha,
            )
            self._unbounded = (
                torch.full((slots,), _UNBOUNDED, dtype=torch.int32, device=self.device),
                torch.full((slots,), -1, dtype=torch.int32, device=self.device),
            )
        # The speculative round as a CUDA graph, captured per cover bucket
        # on first use and replayed k times a dispatch.
        self._spec_graph = None
        if self.device.type == "cuda" and draft_params is not None:
            self._spec_graph = SpecGraph(
                params, draft_params, self.pools, self.d_pools, config, draft_config,
                gamma=gamma, slots=slots, max_pages=self.max_pages,
                max_rounds=max(spec_lookahead, spec_superstep_k),
                generator=self.generator, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, sampling=self.sampling,
                lora_stacked=self._stacked_adapters, lora_alpha=self.lora_alpha,
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
        self.spec_rounds = 0
        self.spec_supersteps_run = 0  # chained spec supersteps dispatched
        # Drafts proposed to live rows (gamma a row-round) and those the
        # verify pass rejected (gamma - accepted).
        self.spec_drafts_proposed = 0
        self.spec_tokens_rejected = 0
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
        self.pages_parked = 0  # prefix pages pushed to host RAM at preempt
        # KV handoff: pages packaged by export_kv and adopted by
        # import_kv, and the host seconds they took net of spills.
        self.kv_handoff_pages_out = 0
        self.kv_handoff_pages_in = 0
        self.kv_handoff_s = 0.0
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
        adapter: str | None = None,
        deadline_s: float | None = None,
    ) -> str:
        if self._closed:
            raise EngineClosed("engine is closed; submissions are refused")
        prompt = [int(t) for t in prompt]
        if adapter is not None and adapter not in self._adapter_ids:
            raise InvalidRequest(
                f"unknown adapter {adapter!r}: engine serves "
                f"{sorted(self._adapter_ids) or '(base only)'}"
            )
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
                status="rejected", error="QueueFull", adapter=adapter,
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
            adapter=adapter,
        ))
        return rid

    def submit_fanout(
        self,
        prompt,
        max_new_tokens: int | None = None,
        n_samples: int = 2,
        *,
        eos_token: int | None = None,
        adapter: str | None = None,
        deadline_s: float | None = None,
    ) -> list[str]:
        """``n_samples`` independent samples of one prompt sharing its
        prompt pages and its prefill.  The first member to admit
        allocates and prefills the group's pages; later members fork the
        full pages read-only, copy the first member's partial tail page
        (retained for the group's admission lifetime) and sample their
        first token from the group's cached logits.  Greedy members emit
        the same tokens.  Every member runs under ``adapter``.  Returns
        the member request ids."""
        if n_samples < 1:
            raise InvalidRequest(f"n_samples must be >= 1, got {n_samples}")
        if self._closed:
            raise EngineClosed("engine is closed; submissions are refused")
        if self.max_pending is not None and len(self.pending) + n_samples > self.max_pending:
            # All or nothing: a QueueFull halfway would strand members.
            self.queue_rejections += 1
            raise QueueFull(
                f"pending queue cannot take {n_samples} fan-out members "
                f"({len(self.pending)} queued, max_pending "
                f"{self.max_pending}); resubmit after retirements drain it"
            )
        gid = f"grp-{next(self._ids)}"
        # The rids are the engine's own and submit() validates on
        # (prompt, max_new_tokens) alone, so if the first member passes,
        # every member does: an error leaves nothing queued.
        rids = []
        for _ in range(n_samples):
            rids.append(self.submit(prompt, max_new_tokens, eos_token=eos_token,
                                    adapter=adapter, deadline_s=deadline_s))
            self.pending[-1].group = gid
        self._groups[gid] = {"members_left": n_samples, "allocated": False}
        return rids

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

    def _ensure_free(self, need: int) -> None:
        """Evict index-only prefix-cache pages when the free list is short
        of ``need``: the cache may hold every idle page, never one an
        allocation within the commitment needs."""
        if self.prefix is not None and len(self.ctrl.free) < need:
            self._prefix_evict(need - len(self.ctrl.free))

    def _prefix_evict(self, n: int) -> int:
        """The one eviction call site: radix evictions spill to host RAM
        when the offload tier is on; otherwise they drop."""
        if self._kv_offload:
            return self.prefix.evict(n, spill=self._spill_page)
        return self.prefix.evict(n)

    def _allocate_evicting(self, seq, n_tokens: int) -> list:
        self._ensure_free(self.ctrl.pages_needed(n_tokens))
        return self.ctrl.allocate(seq, n_tokens)

    def _extend_evicting(self, seq, n_tokens: int) -> list:
        self._ensure_free(self.ctrl.pages_needed(n_tokens) - len(self.ctrl.tables[seq]))
        return self.ctrl.extend(seq, n_tokens)

    # ---- KV-cache hierarchy: host-RAM and disk tiers ---------------------

    @property
    def kv_spill_s(self) -> float:
        """Host seconds moving pages down the hierarchy: pool-to-host
        spills (each to its synchronise) plus the disk tier's writes."""
        disk = self._kv_disk.put_s if self._kv_disk is not None else 0.0
        return self._kv_spill_base_s + disk

    @property
    def kv_reload_s(self) -> float:
        """Host seconds moving pages up: the reloads' enqueue (a pinned
        blob's copy runs on the stream) plus the disk tier's reads."""
        disk = self._kv_disk.get_s if self._kv_disk is not None else 0.0
        return self._kv_reload_base_s + disk

    @property
    def kv_disk_pages(self) -> int:
        """Files in the disk tier now (0 without one)."""
        return self._kv_disk.pages if self._kv_disk is not None else 0

    def flush_kv_to_disk(self, tokens: list[int], adapter: str | None = None) -> int:
        """Persist ``tokens``' prefix pages to the disk tier without
        moving them (resident pages copy out through the gathered spill).
        Returns the path's pages with a durable copy afterwards; 0
        without a disk tier or a radix index."""
        if self._kv_disk is None or not isinstance(self.prefix, RadixKV):
            return 0
        return self.prefix.flush_to_disk(
            tokens, salt=self._handoff_salt(adapter), copy_many=self._spill_pages,
        )

    def attach_kv_disk(self, tokens: list[int], adapter: str | None = None) -> int:
        """Adopt ``tokens``' chain-key files from the disk tier as
        reloadable nodes (a restart's rehydration).  Returns the nodes
        attached."""
        if self._kv_disk is None or not isinstance(self.prefix, RadixKV):
            return 0
        return self.prefix.attach_disk(tokens, salt=self._handoff_salt(adapter))

    def _spill_page(self, page: int):
        """One cache-owned page's k/v in host RAM: the blob a radix node
        keeps while offloaded (``_spill_pages``'s format)."""
        return self._spill_pages([page])[0]

    def _spill_pages(self, pages: list[int]) -> list:
        """Copy ``pages`` out of the pools in one gather a pool, into host
        tensors each blob owns (a page's k and v, ``[L, Hkv, ps, hd]``,
        and with a draft model the draft pools' k and v), and wait for the
        copy: the disk tier, ``export_kv`` and ``flush_kv_to_disk`` read a
        blob's bytes on the host.  On the card the gathered pages go to
        pinned tensors from the caching host allocator behind one event
        for both halves, so the wait covers whatever the stream runs
        ahead of the gather (a superstep in flight).  Returns
        ``((k, v), draft)`` blobs in page order, ``draft`` a ``(k, v)``
        pair or None without a draft model."""
        if not pages:
            return []
        t0 = time.perf_counter()
        halves = [read_pages(self.pools, list(pages))]  # ([L, n, ...], [L, n, ...])
        if self.d_pools is not None:
            halves.append(read_pages(self.d_pools, list(pages)))
        if self.device.type == "cpu":
            per_page = [[(g[0][:, i].clone(), g[1][:, i].clone()) for g in halves]
                        for i in range(len(pages))]
        else:
            # Page-major on the device, so each page is one contiguous copy.
            majors = [[g.transpose(0, 1).contiguous() for g in half] for half in halves]
            per_page = []
            for i in range(len(pages)):
                page = []
                for major in majors:
                    host = tuple(torch.empty(m.shape[1:], dtype=m.dtype, pin_memory=True)
                                 for m in major)
                    for h, m in zip(host, major):
                        h.copy_(m[i], non_blocking=True)
                    page.append(host)
                per_page.append(page)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        blobs = [(page[0], page[1] if len(page) > 1 else None) for page in per_page]
        self._kv_spill_base_s += time.perf_counter() - t0
        return blobs

    def _reload_page(self, blob):
        """Bring one offloaded page's bytes back into a freshly taken pool
        page (evicting a colder index page if the free list is empty);
        returns the page, or None when no page can be freed (the lookup
        then ends its match there).  The write is in place and queued on
        the engine's stream ahead of the prefill that reads the page; a
        pinned blob's copy is asynchronous, and the caching host
        allocator keeps its block until the copy has run, so the node may
        drop the blob at once.  The timer starts after the eviction,
        whose spill bills ``kv_spill_s``."""
        if not self.ctrl.free:
            self._prefix_evict(1)
        if not self.ctrl.free:
            return None
        t0 = time.perf_counter()
        page = self.ctrl.take_page()
        (k, v), draft = blob
        write_page(self.pools, k, v, page)
        if self.d_pools is not None and draft is not None:
            write_page(self.d_pools, draft[0], draft[1], page)
        self._kv_reload_base_s += time.perf_counter() - t0
        return page

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
        self._adapter_idx[slot] = 0
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

    def _group_abandon(self, req: Request) -> None:
        """A pending fan-out member leaves before admission (cancel,
        deadline, withdraw): run the group countdown it will never run
        at admission, so siblings that did admit still clean up."""
        gid, req.group = req.group, None
        if gid is not None and gid in self._groups:
            self._group_member_done(self._groups[gid], gid)

    def _dissolve_groups(self) -> None:
        """Drop every fan-out group's bookkeeping (retained tail pages,
        group tables, cached logits) and detach pending members, which
        then admit solo (greedy members and solo requests emit the same
        tokens): the quarantine and close path, where half-written group
        state cannot be trusted."""
        for gid in list(self._groups):
            self._group_cleanup(gid)
        for req in self.pending:
            req.group = None

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
        is not the request's fault.  Replays are solo.  Returns the
        request iff it failed."""
        req.group = None
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
        self._pending_spec = None
        self._spec_chained = None
        self._fresh_slots.clear()
        victims = [self._release_slot(slot) for slot in sorted(self._slot_req)]
        # Mid-prefill admissions drop too (their prefix-cache inserts are
        # deferred, so no entry indexes their pages); a partial fan-out
        # member poisons its group's shared state.
        partials, self._inflight_prefill = self._inflight_prefill, []
        partial_reqs = [self._abort_partial(p) for p in partials]
        if any(r.group is not None for r in partial_reqs):
            self._dissolve_groups()
        victims += partial_reqs
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
        unwritten.  Roll each plan back, dissolve fan-out groups (their
        shared pages may be half-written), flush the prefix cache (its
        promissory inserts may index unwritten pages, and a dropped
        superstep still runs on the stream), and hand the requests, with
        every occupied slot, to the step quarantine."""
        extra = []
        for p in plans:
            req = self._abort_partial(p)
            if p["slot"] not in self._slot_req:
                extra.append(req)
        self._dissolve_groups()
        if self.prefix is not None:
            self.prefix.clear()
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
                self._group_abandon(req)
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
        requests return None (``cancel`` and ``preempt`` reach those).
        Fan-out membership is abandoned as a cancel would."""
        if self._closed:
            raise EngineClosed("engine is closed")
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self._group_abandon(req)
                return req
        return None

    def preempt(self, rid: str) -> Request | None:
        """Reclaim one queued, mid-prefill or running request without a
        terminal status, for a scheduler that replays prompt + emitted
        tokens later (greedy continuations are the same).  A running one
        drains the work in flight first, so ``req.tokens`` is complete,
        and parks: its prompt pages re-register in the prefix index
        before the slot releases, and with the offload tier they move to
        host RAM at once (``RadixKV.park``), so the resume's lookup
        serves them back.  ``preempt_recompute_tokens`` counts what the
        resume recomputes: every token past the prompt's last full page
        with a prefix cache, every token without.  Fan-out members are
        not preemptible (None).  Returns the request, or None when the
        rid is not live here."""
        if self._closed:
            raise EngineClosed("engine is closed")
        got = self.withdraw(rid)
        if got is not None:
            self.requests_preempted += 1
            return got
        for plan in self._inflight_prefill:
            if plan["req"].rid == rid:
                if plan["req"].group is not None:
                    return None
                # Inserts are deferred to prefill finish, so the resume
                # redoes every chunk swept; the cursor started at the
                # prefix hit, which the resume's lookup serves again.
                self.preempt_recompute_tokens += max(
                    min(plan["cursor"] * self.prompt_bucket, plan["n"])
                    - plan["start_page"] * self.page_size,
                    0,
                )
                req = self._reclaim_partial(plan)
                req.group = None
                self.requests_preempted += 1
                return req
        target = self._find_slot(rid)
        if target is None or self._slot_req[target].group is not None:
            return None
        self._finished_buffer.extend(self._drain_all_pending())
        if target not in self._slot_req or self._slot_req[target].rid != rid:
            got = self.withdraw(rid)
            if got is not None:
                self.requests_preempted += 1
            return got
        req = self._slot_req[target]
        salt = self._handoff_salt(req.adapter)
        if self.prefix is not None:
            # Idempotent on a cache engine (admission inserted them);
            # refreshes the path's LRU while the sequence owns its table.
            self.prefix.insert(req.prompt, self.ctrl.tables[self._seq_id(target, req)],
                               salt=salt)
        req = self._release_slot(target)
        if self.prefix is not None and self._kv_offload:
            self.pages_parked += self.prefix.park(req.prompt, salt=salt,
                                                  spill_many=self._spill_pages)
        covered = (
            len(req.prompt) // self.page_size * self.page_size
            if self.prefix is not None else 0
        )
        self.preempt_recompute_tokens += max(len(req.prompt) + len(req.tokens) - covered, 0)
        req.group = None
        self.requests_preempted += 1
        return req

    # ---- KV handoff between engines -------------------------------------

    def _handoff_salt(self, adapter: str | None) -> str:
        """The prefix key space of ``adapter``'s pages: ``lora:{i}`` for
        a served adapter, the base's ``""`` for None.  Cached pages hold
        adapted k/v, so the same tokens under two adapters never share
        pages."""
        aidx = self._adapter_ids.get(adapter, 0)
        return f"lora:{aidx}" if aidx else ""

    def export_kv(self, prompt, adapter: str | None = None):
        """Package one finished prompt's KV pages for another engine:
        park the prompt's prefix pages to the host tier (one gathered
        copy for the path; pages a live stream still reads are copied
        without moving), then return the path's host blobs in page
        order.  This engine keeps its host copies, so a later hit here
        still pays.  Returns None without a radix index (the caller
        re-prefills, which gives the same stream)."""
        if self._closed:
            raise EngineClosed("engine is closed")
        prompt = [int(t) for t in prompt]
        if not isinstance(self.prefix, RadixKV):
            return None
        salt = self._handoff_salt(adapter)
        t0, spill0 = time.perf_counter(), self.kv_spill_s
        if self._kv_offload:
            self.pages_parked += self.prefix.park(
                prompt, salt=salt, spill_many=self._spill_pages
            )
        blobs = self.prefix.export_path(prompt, salt=salt, copy_many=self._spill_pages)
        self.kv_handoff_pages_out += len(blobs)
        # Net of the spills, which kv_spill_s already holds.
        self.kv_handoff_s += max(time.perf_counter() - t0 - (self.kv_spill_s - spill0), 0.0)
        return blobs or None

    def _blob_compatible(self, blob) -> bool:
        """Would this engine's pools take the blob's bytes?  A blob from
        an engine of another shape (page size, kv heads, layers) must
        never graft: its reload would raise mid-admission, or fit and be
        wrong.  The draft half must agree in presence too (a draft-less
        blob in a speculating engine would leave stale draft bytes behind
        the page) and in shape."""
        try:
            main, draft = blob
            k_pages = self.pools[0]
            # pool [L, n_pages + 1, Hkv, ps, hd]; blob k [L, Hkv, ps, hd]
            want = (k_pages.shape[0],) + tuple(k_pages.shape[2:])
            if tuple(main[0].shape) != want:
                return False
            if (draft is None) != (self.d_pools is None):
                return False
            if draft is not None:
                d_pages = self.d_pools[0]
                return tuple(draft[0].shape) == (d_pages.shape[0],) + tuple(d_pages.shape[2:])
            return True
        except Exception:  # noqa: BLE001 — an unreadable blob is incompatible
            return False

    def import_kv(self, prompt, blobs: list, adapter: str | None = None) -> int:
        """Adopt a handoff ticket's page blobs into the radix index as
        offloaded nodes: the next admission's lookup reloads them through
        ``write_page``, so the handed-off stream goes on without its
        prefill.  Needs the radix index and the offload tier.  A ticket
        for an adapter this engine does not serve is refused (the base
        salt would poison the base cache with adapted k/v), and so are
        blobs of another shape.  Returns the pages grafted; 0 means the
        caller's re-prefill serves the request, with the same stream."""
        if self._closed:
            raise EngineClosed("engine is closed")
        if not isinstance(self.prefix, RadixKV) or not self._kv_offload:
            return 0
        if adapter is not None and adapter not in self._adapter_ids:
            return 0
        if not blobs or not self._blob_compatible(blobs[0]):
            return 0
        t0 = time.perf_counter()
        n = self.prefix.graft([int(t) for t in prompt], blobs,
                              salt=self._handoff_salt(adapter))
        self.kv_handoff_pages_in += n
        self.kv_handoff_s += time.perf_counter() - t0
        return n

    def retained_pages(self, rid) -> float:
        """The KV pages ``rid``'s sequences hold, each weighted by
        1/refcount (a page shared with forks or the prefix index counts
        fractionally): about what preempting it frees.  0.0 for a rid
        holding no pages."""
        total = 0.0
        refcounts = self.ctrl.refcounts
        for seq, table in self.ctrl.tables.items():
            if isinstance(seq, tuple) and len(seq) == 3 and seq[0] == "slot" and seq[2] == rid:
                for page in table:
                    total += 1.0 / max(1, refcounts.get(page, 1))
        return total

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

    def _aidx_dev(self, aidx: np.ndarray | None = None) -> torch.Tensor | None:
        """The rows' adapter indices (``aidx``, or the per-slot mirror) as
        a device tensor taken NOW through ``_dev``'s pinned copy: under
        ``pipelined`` admission rewrites the mirror while a dispatch is
        in flight, so a dispatch never reads it later.  None without
        adapters."""
        if self._stacked_adapters is None:
            return None
        return self._dev(self._adapter_idx if aidx is None else aidx)

    def _lora(self, aidx_dev: torch.Tensor | None):
        """The ``lora=(stacked, idx, alpha)`` argument for these device
        indices (None without adapters)."""
        if aidx_dev is None:
            return None
        return (self._stacked_adapters, aidx_dev, self.lora_alpha)

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
        """Serial admission: allocate the prompt's pages (past any cached
        prefix), prefill the rest (one batch-1 call per admission), and
        sample its first token with a readback of its own.  A fan-out
        member after the first reuses its group's prefill."""
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
            aidx = self._adapter_ids.get(req.adapter, 0)
            try:
                self._maybe_fault("prefill_dispatch")
                if req.group is not None:
                    logits = self._admit_group_member(req, seq, n)
                else:
                    start_page = self._prefix_admit_pages(
                        seq, prompt, salt=self._handoff_salt(req.adapter))
                    logits = self._run_prefill(self._table_dev(seq), prompt, start_page,
                                               adapter_idx=aidx)
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
            if self._land_first_token(slot, req, seq, need, n, tok, aidx):
                finished.append(req)
            else:
                self._committed_pages += need
        return finished

    def _table_dev(self, seq) -> torch.Tensor:
        """One sequence's table as a [1, max_pages] device tensor, padded
        with the trash page."""
        table = np.full((1, self.max_pages), self.ctrl.trash, np.int32)
        pages = self.ctrl.tables[seq]
        table[0, : len(pages)] = pages
        return self._dev(table)

    def _run_prefill(
        self, table: torch.Tensor, prompt: list[int], start_page: int = 0,
        adapter_idx: int = 0,
    ) -> torch.Tensor:
        """Prefill one admission: one bucket-wide ``paged_prefill`` for a
        prompt that fits, page-aligned ``paged_prefill_chunk`` calls for a
        longer one.  ``start_page`` (a multiple of the bucket's pages)
        skips the positions prefix-cache pages already hold.  With a
        draft model its pools prefill the same remainder (same table,
        its own pages; cached pages hold draft k/v from their first
        prefill; the draft is unadapted).  The target runs under adapter
        ``adapter_idx`` (0: the base).  Returns the target's [1, vocab]
        next-token logits."""
        self.prefills_run += 1
        self.prefill_tokens += len(prompt) - start_page * self.page_size
        lora = self._lora(self._aidx_dev(np.asarray([adapter_idx], np.int32)))
        logits = self._prefill_into(self.params, self.config, self.pools, table, prompt,
                                    start_page, count=True, lora=lora)
        if self.d_pools is not None:
            self._prefill_into(self.draft_params, self.draft_config, self.d_pools, table,
                               prompt, start_page)
        return logits

    def _prefill_into(
        self, params, config, pools, table: torch.Tensor, prompt: list[int],
        start_page: int = 0, count: bool = False, lora=None,
    ) -> torch.Tensor:
        """``_run_prefill``'s dispatches into one model's pools; ``count``
        counts them as the target's prefill dispatches; ``lora`` adapts
        them."""
        n, B = len(prompt), self.prompt_bucket
        bp = B // self.page_size
        if start_page % bp:
            raise ValueError(
                f"prefill start_page {start_page} must be a multiple of "
                f"bucket pages {bp}"
            )
        lengths = self._dev(np.asarray([n], np.int32))
        if start_page == 0 and n <= B:
            self.prefill_dispatches += count
            tokens = np.zeros((1, B), np.int64)
            tokens[0, :n] = prompt
            logits, _ = paged_prefill(params, pools, table, self._dev(tokens), lengths, config,
                                      lora=lora)
            return logits
        n_chunks = -(-n // B)
        for ci in range(start_page // bp, n_chunks):
            self.prefill_dispatches += count
            tokens = np.zeros((1, B), np.int64)
            width = min(B, n - ci * B)
            tokens[0, :width] = prompt[ci * B : ci * B + width]
            logits, _ = paged_prefill_chunk(
                params, pools, table, self._dev(tokens), lengths, config,
                start_page=ci * bp, cover_pages=(ci + 1) * bp, emit=ci == n_chunks - 1,
                lora=lora,
            )
        return logits

    # ---- prefix cache and fan-out groups at admission -------------------

    def _prefix_admit_pages(self, seq, tokens: list[int], insert: bool = True,
                            salt: str = "") -> int:
        """Admission's page bookkeeping with the prefix cache (serial and
        batched alike): look ``tokens`` up, adopt the hit pages and
        extend past them (or allocate afresh), and register the full
        pages in the index.  Hits are capped so that at least one token
        is computed (its logits feed the first sample) and floored to
        whole prompt buckets, so the rest prefills in the usual chunks.
        With the offload tier, hit pages in host RAM or on disk reload
        inside the lookup, queued ahead of this admission's prefill.  The
        insert is promissory, before the prefill runs: nothing looks the
        pages up before they are written (serial prefills run before the
        next lookup; a batched sweep's chunk order writes a column before
        a later row's chunk reads it).  The budgeted path passes
        ``insert=False`` and inserts at admission finish, since its
        sweeps span steps.  ``salt`` is the request's adapter key space
        (``_handoff_salt``): cached pages hold adapted k/v.  Returns the
        row's start page (0 on a miss)."""
        n = len(tokens)
        shared: list[int] = []
        if self.prefix is not None:
            bp = self.prompt_bucket // self.page_size
            cap = (n - 1) // self.page_size // bp * bp
            kw = {"reload": self._reload_page} if self._kv_offload else {}
            shared = self.prefix.lookup(tokens, cap, granularity=bp, salt=salt, **kw)
        if shared:
            self.ctrl.adopt(seq, shared)
            self._extend_evicting(seq, n)
        else:
            self._allocate_evicting(seq, n)
        if self.prefix is not None and insert:
            self.prefix.insert(tokens, self.ctrl.tables[seq], salt=salt)
        return len(shared)

    def _group_admit_pages(self, req: Request, seq, n: int):
        """A fan-out member's pages at admission (serial and batched
        alike): allocate the group's full prompt pages once, fork them
        read-only into the member's table, cover its partial tail.
        Returns (the group's dict, the shared token count)."""
        g = self._groups[req.group]
        shared = n // self.page_size * self.page_size
        gseq = ("group", req.group)
        if shared and not g["allocated"]:
            self._allocate_evicting(gseq, shared)
            g["allocated"] = True
        if shared:
            self.ctrl.fork(gseq, seq, shared)
            if n > shared:
                self._extend_evicting(seq, n)
        else:  # shorter than a page: nothing to share
            self._allocate_evicting(seq, n)
        return g, shared

    def _copy_page(self, src: int, dst: int) -> None:
        """Duplicate one page in the target pools, and in the draft pools
        with a draft model."""
        copy_page(self.pools, src, dst)
        if self.d_pools is not None:
            copy_page(self.d_pools, src, dst)

    def _group_cleanup(self, gid: str) -> None:
        """Drop a group's bookkeeping: the retained tail page and the
        group's own table; the pages live on in the members' tables."""
        g = self._groups.pop(gid)
        if g.get("tail_page") is not None:
            self.ctrl.release_page(g["tail_page"])
        if g["allocated"]:
            self.ctrl.release(("group", gid))

    def _group_member_done(self, g: dict, gid: str) -> None:
        """The group's countdown: after its last member admits (or
        leaves), clean the group up."""
        g["members_left"] -= 1
        if g["members_left"] == 0:
            self._group_cleanup(gid)

    def _admit_group_member(self, req: Request, seq, n: int) -> torch.Tensor:
        """Admit one fan-out member serially: the first prefills, and the
        group keeps its logits and retains its partial tail page; a later
        member copies that page and reuses the logits.  Returns the
        member's [1, vocab] first-token logits."""
        g, shared = self._group_admit_pages(req, seq, n)
        if g.get("logits") is None:
            logits = self._run_prefill(self._table_dev(seq), req.prompt,
                                       adapter_idx=self._adapter_ids.get(req.adapter, 0))
            g["logits"] = logits
            if n > shared:
                # The tail is private per member; pin the first member's
                # as the copy source (it outlives that member's retirement).
                tail = self.ctrl.tables[seq][-1]
                self.ctrl.retain_page(tail)
                g["tail_page"] = tail
        else:
            logits = g["logits"]
            if n > shared:
                self._copy_page(g["tail_page"], self.ctrl.tables[seq][-1])
        self._group_member_done(g, req.group)
        return logits

    def _plan_admissions(self, used: set, defer_prefix_insert: bool = False) -> list[dict]:
        """Scan the queue in the serial path's order (free slots
        ascending, FIFO, stop at the first request the page budget
        defers), doing the host bookkeeping of each admission: worst-case
        page commitment, prefix-cache lookup and adoption or fan-out
        forks, the prompt's pages; no device work.  ``used`` excludes
        slots taken earlier in this step and slots mid-prefill.  A plan's
        ``start_page`` is its cached prefix; ``prefill`` is False for a
        fan-out member that reuses its group's logits."""
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
            n = len(prompt)
            plan = {
                "slot": slot, "req": req, "seq": seq, "n": n, "prompt": prompt,
                "aidx": self._adapter_ids.get(req.adapter, 0),
                "need": need, "start_page": 0, "prefill": True, "logits_from": None,
                "tail_copy": None, "group_done": None, "prefix_insert": None,
            }
            if req.group is not None:
                self._plan_group_member(req, seq, n, plan)
            else:
                salt = self._handoff_salt(req.adapter)
                plan["start_page"] = self._prefix_admit_pages(
                    seq, prompt, insert=not defer_prefix_insert, salt=salt
                )
                if defer_prefix_insert and self.prefix is not None:
                    plan["prefix_insert"] = (prompt, salt)
            self._committed_pages += need
            plans.append(plan)
        return plans

    def _plan_group_member(self, req: Request, seq, n: int, plan: dict) -> None:
        """A planned fan-out member: fork the group's pages; the first
        member joins the prefill sweep, its row becomes the group's
        logits and its partial tail page is retained; a later member
        schedules a one-page copy and reuses the logits.  The last
        member's cleanup waits for admission finish, after the copies."""
        g, shared = self._group_admit_pages(req, seq, n)
        if g.get("logits") is None and "logits_slot" not in g:
            g["logits_slot"] = plan["slot"]
            if n > shared:
                tail = self.ctrl.tables[seq][-1]
                self.ctrl.retain_page(tail)
                g["tail_page"] = tail
        else:
            plan["prefill"] = False
            plan["logits_from"] = g
            if n > shared:
                plan["tail_copy"] = (g["tail_page"], self.ctrl.tables[seq][-1])
        g["members_left"] -= 1
        if g["members_left"] == 0:
            plan["group_done"] = req.group

    def _prefill_row_arrays(self, rows: list[dict]):
        """The prefill sweep's per-row inputs: host lengths, and device
        tables, lengths and start pages, and the rows' ``lora`` (rows not
        in ``rows`` keep trash tables, length 0 and the base adapter, as
        parked decode rows do)."""
        lengths = np.zeros(self.slots, np.int32)
        starts = np.zeros(self.slots, np.int32)
        aidx = np.zeros(self.slots, np.int32)
        tables = np.full((self.slots, self.max_pages), self.ctrl.trash, np.int32)
        for p in rows:
            lengths[p["slot"]] = p["n"]
            starts[p["slot"]] = p["start_page"]
            aidx[p["slot"]] = p["aidx"]
            t = self.ctrl.tables[p["seq"]]
            tables[p["slot"], : len(t)] = t
        return (lengths, self._dev(tables), self._dev(lengths), self._dev(starts),
                self._lora(self._aidx_dev(aidx)))

    def _dispatch_prefill_ci(
        self, rows: list[dict], ci: int, lengths: np.ndarray, tables_dev,
        lengths_dev, row_start, lora, emitted: torch.Tensor,
    ) -> torch.Tensor:
        """ONE [slots, bucket] prefill chunk at chunk index ``ci`` for
        ``rows``, into the target pools and the draft pools; a row's
        logits land in ``emitted`` from the chunk where its prompt ends,
        and ``row_start`` sends the columns of its cached prefix to the
        trash page; ``lora`` adapts the target's rows (the draft's stay
        unadapted).  The unbudgeted and the budgeted sweep both dispatch
        through here."""
        B, bp = self.prompt_bucket, self.prompt_bucket // self.page_size
        start = ci * B
        chunk = np.zeros((self.slots, B), np.int64)
        for p in rows:
            width = min(B, p["n"] - start)
            if width > 0:
                chunk[p["slot"], :width] = p["prompt"][start : start + width]
        chunk_dev = self._dev(chunk)
        logits, _ = paged_prefill_chunk(
            self.params, self.pools, tables_dev, chunk_dev, lengths_dev,
            self.config, start_page=ci * bp, cover_pages=(ci + 1) * bp, emit=True,
            row_start=row_start, lora=lora,
        )
        self.prefill_dispatches += 1
        emit_mask = (lengths > start) & (lengths <= start + B)
        emitted = torch.where(self._dev(emit_mask)[:, None], logits, emitted)
        if self.d_pools is not None:
            # The draft pools run the same chunk (no logits).
            paged_prefill_chunk(
                self.draft_params, self.d_pools, tables_dev, chunk_dev, lengths_dev,
                self.draft_config, start_page=ci * bp, cover_pages=(ci + 1) * bp,
                emit=False, row_start=row_start,
            )
        return emitted

    def _sweep_prefill(self, plans: list[dict]) -> torch.Tensor | None:
        """Stack the planned rows that prefill into one ragged [slots,
        bucket] batch and run the page-aligned chunks some row's uncached
        span covers (a chunk only cached prefixes cover is skipped, so a
        hit keeps its saving beside a miss; a row riding an active chunk
        inside its cached span recomputes the same values and writes
        them to the trash page).  Returns the [slots, vocab] first-token
        logits, or None when no row prefills (only group reuse)."""
        rows = [p for p in plans if p["prefill"]]
        if not rows:
            return None
        self._maybe_fault("prefill_dispatch")
        B, ps = self.prompt_bucket, self.page_size
        bp = B // ps
        for p in rows:
            self.prefills_run += 1
            self.prefill_tokens += p["n"] - p["start_page"] * ps
        active = sorted({ci for p in rows for ci in range(p["start_page"] // bp, -(-p["n"] // B))})
        arrays = self._prefill_row_arrays(rows)
        emitted = torch.zeros(
            (self.slots, self.config.vocab_size), dtype=torch.float32,
            device=self.device,
        )
        self.prefill_sweeps += 1
        for ci in active:
            emitted = self._dispatch_prefill_ci(rows, ci, *arrays, emitted)
        return emitted

    def _finish_admissions(
        self, plans: list[dict], emitted: torch.Tensor | None
    ) -> list[Request]:
        """Register the budget-deferred prefix inserts (every page of the
        row is written now), resolve fan-out groups (the first member's
        row becomes the group's logits, later members' rows take them,
        their tail pages copy, finished groups clean up), sample every
        row's first token in one call, read the batch back once, then
        apply emission and at-admission retirement (which rolls the
        plan's page commitment back).  Returns the requests finished at
        admission."""
        if emitted is None:
            emitted = torch.zeros(
                (self.slots, self.config.vocab_size), dtype=torch.float32,
                device=self.device,
            )
        for p in plans:
            if p.get("prefix_insert") is not None and self.prefix is not None:
                tokens, salt = p["prefix_insert"]
                self.prefix.insert(tokens, self.ctrl.tables[p["seq"]], salt=salt)
        for p in plans:
            if p["prefill"] and p["req"].group is not None:
                g = self._groups[p["req"].group]
                if g.get("logits_slot") == p["slot"]:
                    g["logits"] = emitted[p["slot"]][None].clone()
                    del g["logits_slot"]
        for p in plans:
            if not p["prefill"]:
                emitted[p["slot"]] = p["logits_from"]["logits"][0]
        for p in plans:
            if p["tail_copy"] is not None:
                self._copy_page(*p["tail_copy"])
        for p in plans:
            if p["group_done"] is not None:
                self._group_cleanup(p["group_done"])
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
                                      int(toks[slot]), p["aidx"]):
                self._committed_pages -= p["need"]  # the plan's, rolled back
                finished.append(p["req"])
        return finished

    def _land_first_token(
        self, slot: int, req: Request, seq, need: int, n: int, tok: int, aidx: int = 0
    ) -> bool:
        """Emit an admission's first token.  A request that ends there
        retires at once, its pages released; any other takes its slot
        (with its adapter index ``aidx``), to decode from position ``n``
        at the next dispatch.  Returns whether it retired.  A replay
        keeps its first ``t_first``."""
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
        self._adapter_idx[slot] = aidx
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
        admissions as the unbudgeted path does (prefix inserts deferred
        to finish; a row's cursor starts past its cached prefix),
        dispatch at most ``max(1, prefill_budget // prompt_bucket)``
        chunks across every mid-prefill row, finish the rows whose last
        chunk ran and the fan-out members whose group logits resolved
        (one fused readback) and carry the rest to the next step.  Under
        ``pipelined`` the decode readback due is consumed between the
        sweep's dispatch and its readback, so it overlaps the prefill.
        No same-step re-plan after an at-admission retirement: the freed
        budget admits next step."""
        budget = max(1, self.prefill_budget // self.prompt_bucket)
        bp = self.prompt_bucket // self.page_size
        finished: list[Request] = []
        used = {p["slot"] for p in self._inflight_prefill}
        new_plans = self._plan_admissions(used, defer_prefix_insert=True)
        for p in new_plans:
            p["cursor"] = p["start_page"] // bp
            p["last_ci"] = -(-p["n"] // self.prompt_bucket) - 1
            if p["prefill"]:
                self.prefills_run += 1
                self.prefill_tokens += p["n"] - p["start_page"] * self.page_size
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
                if self._pending_spec is not None and self.spec_superstep_k == 1:
                    # A chained spec superstep (k > 1) in flight was
                    # dispatched this step; reading it here would stall
                    # the host behind it.
                    read, snapshot = self._pending_spec
                    self._pending_spec = None
                    finished += self._consume_spec(read, snapshot)
                if len(self._pending_super) > 1:
                    # The superstep loop admits with the newest superstep
                    # in flight; the previous one's readback overlaps the
                    # sweep.
                    read, snapshot = self._pending_super.popleft()
                    finished += self._consume_superstep(read, snapshot)
            done_slots = {p["slot"] for p in self._inflight_prefill
                          if p["prefill"] and p["cursor"] > p["last_ci"]}
            # A reuse row finishes when its group's logits resolve: cached
            # in an earlier step, or its source row finished this step.
            completed = [
                p for p in self._inflight_prefill
                if (p["prefill"] and p["cursor"] > p["last_ci"])
                or (not p["prefill"] and (
                    p["logits_from"].get("logits") is not None
                    or p["logits_from"].get("logits_slot") in done_slots))
            ]
            if completed:
                finished += self._finish_admissions(completed, emitted)
                done = {id(p) for p in completed}
                self._inflight_prefill = [p for p in self._inflight_prefill
                                          if id(p) not in done]
        except Exception as exc:  # noqa: BLE001 — recovery seam
            plans, self._inflight_prefill = self._inflight_prefill, []
            return finished + self._quarantine_admissions(plans, exc)
        for p in self._inflight_prefill:
            if p["prefill"]:
                self.prefill_deferred_tokens += max(
                    0, p["n"] - p["cursor"] * self.prompt_bucket
                )
        return finished

    def _sweep_prefill_budgeted(self, max_chunks: int) -> torch.Tensor:
        """Dispatch up to ``max_chunks`` prompt-bucket chunks across the
        mid-prefill rows that prefill, oldest admission first; every row
        whose cursor sits at the same chunk index rides the same
        dispatch.  Returns the [slots, vocab] logits of the rows whose
        last chunk ran."""
        emitted = torch.zeros(
            (self.slots, self.config.vocab_size), dtype=torch.float32,
            device=self.device,
        )
        if not any(p["prefill"] and p["cursor"] <= p["last_ci"]
                   for p in self._inflight_prefill):
            return emitted
        self._maybe_fault("prefill_dispatch")
        self.prefill_sweeps += 1
        group_key, arrays = None, None
        for _ in range(max_chunks):
            todo = [p for p in self._inflight_prefill
                    if p["prefill"] and p["cursor"] <= p["last_ci"]]
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
        its commitment.  Group policy and the request's fate are the
        caller's."""
        self._inflight_prefill = [q for q in self._inflight_prefill if q is not plan]
        if plan["seq"] in self.ctrl.tables:
            self.ctrl.release(plan["seq"])
        self._committed_pages -= plan["need"]
        return plan["req"]

    def _reclaim_partial(self, plan: dict) -> Request:
        """Reclaim one mid-prefill admission for cancel, expiry or
        preempt: its pages and commitment go back.  A fan-out group that
        loses a mid-prefill member cannot be trusted to resolve (the
        member may be its logits source), so the group's other in-flight
        members abort and requeue solo at the queue's front (no retry
        charge), pending members detach, and the group's bookkeeping
        goes.  Members already decoding keep their pages."""
        req = self._abort_partial(plan)
        gid, req.group = req.group, None
        if gid is not None and gid in self._groups:
            for q in reversed([q for q in self._inflight_prefill if q["req"].group == gid]):
                sib = self._abort_partial(q)
                sib.group = None
                sib.status = "queued"
                self.pending.appendleft(sib)
            for r in self.pending:
                if r.group == gid:
                    r.group = None
            self._group_cleanup(gid)
        return req

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
        if self.superstep_k > 1 or self.spec_superstep_k > 1:
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
            if self._pending_spec is not None:
                read, snapshot = self._pending_spec
                self._pending_spec = None
                finished += self._consume_spec(read, snapshot)
            return finished
        use_spec = self._decide_spec()
        if use_spec:
            # Mode boundary (spec="auto"): a speculative dispatch starts
            # from the host mirrors, so the plain chunk in flight is
            # consumed first.
            finished += self._drain_pending_plain()
        else:
            # And the other way; that drain can retire slots past the
            # threshold, so decide again on the occupancy after it
            # (drains only lower it: plain -> spec at most once).
            finished += self._drain_pending_spec()
            if self._occupied.any():
                use_spec = self._decide_spec()
                if use_spec:
                    finished += self._drain_pending_plain()
        if not self._occupied.any():
            return finished  # the drains retired every slot
        self._record_mode(use_spec)
        if use_spec:
            return finished + self._step_spec()
        self._cover_chunk()
        tok_in = self._dev(self._tokens)
        if self.pipelined and self._chained_tok is not None:
            tok_in = torch.where(self._fresh_mask(), tok_in, self._chained_tok)
        self._fresh_slots.clear()
        tables, pos, occupied = (
            self._dev(self._tables), self._dev(self._positions),
            self._dev(self._occupied),
        )
        aidx = self._aidx_dev()  # a parked row's index is 0, the base
        self._maybe_fault("decode_dispatch")
        if self._graph is None:
            toks, _ = paged_decode_chunk(
                self.params, self.pools, tables, tok_in, pos, occupied,
                self.generator, self.temperature, self.top_k, self.top_p,
                self.config, self.chunk, self.sampling, lora=self._lora(aidx),
            )
            last = toks[:, -1]
        else:
            toks, last, *_ = self._graph.run(
                tables, tok_in, pos, occupied, *self._unbounded, self.chunk, aidx
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
        admission-time commitment (evicting index-only cached pages when
        the free list is short)."""
        for slot, req in self._slot_req.items():
            table = self._extend_evicting(
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
        previous one is consumed.

        With a draft model the mode is decided on the boundary occupancy
        (a switch drains the other mode's work in flight); a chained
        spec superstep (``spec_superstep_k > 1``) is dispatched first
        too, while with ``spec_superstep_k == 1`` the spec side admits
        before its dispatch, as the step without supersteps does."""
        finished = self._decode_finished
        dispatched: str | bool = False
        if not self._occupied.any():
            # Nothing to dispatch: consume what is still in flight.
            if self._pending_read is not None:
                read, snapshot = self._pending_read
                self._pending_read = None
                finished += self._consume_chunk(read, snapshot)
            if self._pending_spec is not None:
                read, snapshot = self._pending_spec
                self._pending_spec = None
                finished += self._consume_spec(read, snapshot)
        else:
            use_spec = self._decide_spec()
            if use_spec:
                finished += self._drain_pending_super()
            else:
                finished += self._drain_pending_spec()
                if self._occupied.any():
                    use_spec = self._decide_spec()
                    if use_spec:
                        finished += self._drain_pending_super()
            if self._occupied.any():
                self._record_mode(use_spec)
                if use_spec:
                    if self.spec_superstep_k > 1:
                        finished += self._dispatch_spec_superstep()
                        dispatched = "spec"
                    else:
                        finished += self._admit()
                        if self._occupied.any():
                            finished += self._step_spec()
                        return finished
                else:
                    self._dispatch_superstep()
                    dispatched = "plain"
        finished += self._admit()
        finished += self._poll_health()
        finished += self._expire_deadlines()
        keep = 1 if (self.pipelined and dispatched == "plain") else 0
        while len(self._pending_super) > keep:
            read, snapshot = self._pending_super.popleft()
            finished += self._consume_superstep(read, snapshot)
        # The spec superstep's readback: pipelined keeps the newest in
        # flight (its predecessor was consumed at dispatch); a lifecycle
        # poll above may have drained it already.
        if not (self.pipelined and dispatched == "spec") and self._pending_spec is not None:
            read, snapshot = self._pending_spec
            self._pending_spec = None
            finished += self._consume_spec(read, snapshot)
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
            table = self._extend_evicting(self._seq_id(slot, req), min(bound, ceiling))
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
        aidx = self._aidx_dev()
        self._maybe_fault("decode_dispatch")
        if self._graph is None:
            toks, *carry, _ = paged_decode_superstep(
                self.params, self.pools, tables, tok_in, pos_in, live_in,
                budget_in, eos_in, self.generator, self.temperature, self.top_k,
                self.top_p, self.config, self.chunk, self.superstep_k, self.sampling,
                lora=self._lora(aidx),
            )
        else:
            toks, *carry = self._graph.run(
                tables, tok_in, pos_in, live_in, budget_in, eos_in, span, aidx
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

    # ---- speculative decoding --------------------------------------------

    def _decide_spec(self) -> bool:
        """The decode mode at the current occupancy: ``spec="on"`` always
        speculates; ``spec="auto"`` speculates while the live occupancy
        is at or below the break-even threshold (below it a step is bound
        by the weight stream, which a round's one verify saves; above it
        the verify's compute, rows x (gamma+1), eats the saving).  Streams
        are the same either way (both modes emit the target's tokens), so
        the choice is economics only.  ``step`` records the mode it
        dispatches (``_record_mode``)."""
        if self.draft_params is None:
            return False
        if self.spec == "on":
            return True
        if self.spec_breakeven is None:
            self.spec_breakeven = self._calibrate_breakeven()
        return int(self._occupied.sum()) <= self.spec_breakeven

    def _record_mode(self, use_spec: bool) -> None:
        """Auto-mode telemetry for a decode dispatch that runs (steps the
        drains emptied never get here)."""
        if self.spec != "auto":
            return
        occ = int(self._occupied.sum())
        mode = "spec" if use_spec else "plain"
        if self._last_mode is not None and mode != self._last_mode:
            self.mode_switches += 1
        self._last_mode = mode
        self.decode_mode_trace.append((occ, mode))
        if use_spec:
            self.spec_mode_steps += 1
        else:
            self.plain_mode_steps += 1

    def drain_mode_trace(self) -> list[tuple[int, str]]:
        """Hand back (and clear) the (occupancy, mode) decode trace."""
        out = list(self.decode_mode_trace)
        self.decode_mode_trace.clear()
        return out

    def _spec_cover(self, last_position: int) -> int:
        """The verify view's static width for rows that reach
        ``last_position``: its pages rounded up to a multiple of 4 (a
        bounded set of covers, one captured graph each), capped at
        ``max_pages``."""
        need = -(-last_position // self.page_size)
        return min(self.max_pages, -(-need // 4) * 4)

    def _run_spec_lookahead(self, tables, cur, pos, occ, k: int, cover: int,
                            generator=None, aidx=None):
        """``k`` lookahead rounds (``paged_spec_superstep``) for the rows
        ``occ`` marks; on the card as ``k`` replays of the captured round
        (budget unbounded, no eos: ``live`` stays ``occ``); ``aidx``
        adapts the target's verify.  Returns (committed [k, slots,
        gamma+1], n [k, slots], new_cur, new_pos), the carry copied out
        of the graph's buffers."""
        if self._spec_graph is None:
            committed, n, new_cur, new_pos, _, _ = paged_spec_superstep(
                self.params, self.draft_params, self.pools, self.d_pools, tables, cur, pos,
                occ, self.config, self.draft_config, self.gamma, k, cover,
                sampling=self.sampling, generator=generator if generator is not None else self.generator,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                t_lora=self._lora(aidx),
            )
            return committed, n, new_cur, new_pos
        committed, n, _, new_cur, new_pos, _, _ = self._spec_graph.run(
            tables, cur, torch.where(occ, pos, 0), occ, *self._unbounded, k, cover, aidx
        )
        return committed, n, new_cur.clone(), new_pos.clone()

    def _run_spec_chained(self, tables, cur, pos, occ, live, budget, eos, k: int,
                          cover: int, generator=None, aidx=None):
        """``k`` chained-retirement rounds
        (``paged_spec_superstep_chained``); on the card as ``k`` replays
        of the captured round, empty slots pinned to position 0 at entry.
        ``aidx`` adapts the target's verify.  Returns (committed, n,
        round_live, new_cur, new_pos, new_live, new_budget), the carry
        copied out of the graph's buffers."""
        if self._spec_graph is None:
            out = paged_spec_superstep_chained(
                self.params, self.draft_params, self.pools, self.d_pools, tables, cur, pos,
                occ, live, budget, eos, self.config, self.draft_config, self.gamma, k,
                cover, sampling=self.sampling, generator=generator if generator is not None else self.generator,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                t_lora=self._lora(aidx),
            )
            return out[:7]
        committed, n, round_live, *carry = self._spec_graph.run(
            tables, cur, torch.where(occ, pos, 0), live & occ, budget, eos, k, cover, aidx
        )
        return (committed, n, round_live, *(c.clone() for c in carry))

    def _calibrate_breakeven(self) -> float:
        """The start-up calibration of ``spec="auto"`` when no threshold
        was given: time a few DEAD dispatches of each decode program
        (every row parked on trash tables, so no request state moves; a
        dead dispatch costs what a live one does) and compare tokens a
        second at this engine's shape.  The verdict is binary: threshold
        ``slots`` (always speculate) or 0 (never).  The spec side assumes
        an acceptance of 0.75 of gamma, and its verify view is as wide as
        a row at half ``max_seq_len`` needs.  Draws come from a private
        generator, and the engine's generator, which the card's graphs
        draw from, is restored after: the served stream never sees the
        probe.  An injected calibration (``spec_calibration=``) is
        adopted instead and counted in ``calibration_reused``.  On the
        card each timed chain ends in a synchronise."""
        if self._injected_calibration is not None:
            self.spec_calibration = dict(self._injected_calibration)
            self.calibration_reused += 1
            return float(self.spec_calibration["threshold"])
        import statistics

        k = max(self.spec_lookahead, self.spec_superstep_k)
        u = (self.gamma + 1) * k
        cover = self._spec_cover(self.config.max_seq_len // 2 + u)
        tables = torch.full((self.slots, self.max_pages), self.ctrl.trash, dtype=torch.int32,
                            device=self.device)
        occ = torch.zeros(self.slots, dtype=torch.bool, device=self.device)
        zeros = torch.zeros(self.slots, dtype=torch.long, device=self.device)
        zeros32 = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        private = torch.Generator(self.device).manual_seed(0)
        saved = self.generator.get_state()
        aidx = self._aidx_dev(np.zeros(self.slots, np.int32))

        def plain_once(tok):
            if self._graph is None:
                toks, _ = paged_decode_chunk(
                    self.params, self.pools, tables, tok, zeros, occ, private,
                    self.temperature, self.top_k, self.top_p, self.config, self.chunk,
                    self.sampling, lora=self._lora(aidx),
                )
                return toks[:, -1]
            return self._graph.run(tables, tok, zeros, occ, *self._unbounded,
                                   self.chunk, aidx)[1].clone()

        def spec_once(cur):
            if self.spec_superstep_k > 1:
                return self._run_spec_chained(tables, cur, zeros, occ, occ, zeros32 + 1,
                                              zeros32 - 1, k, cover, private, aidx)[3]
            return self._run_spec_lookahead(tables, cur, zeros, occ, k, cover, private,
                                            aidx)[2]

        def timed(once, n: int) -> float:
            tok = zeros
            t0 = time.perf_counter()
            for _ in range(n):
                tok = once(tok)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

        try:
            with torch.inference_mode():
                for once in (plain_once, spec_once):
                    timed(once, 1)  # warm: builds and captures, untimed
                # Two-length slopes, median of interleaved repeats: the
                # constant dispatch and readback cost cancels in each pair.
                n_lo, n_hi = 2, 6
                plain_slopes, spec_slopes = [], []
                for _ in range(3):
                    plain_slopes.append(
                        (timed(plain_once, n_hi) - timed(plain_once, n_lo)) / (n_hi - n_lo))
                    spec_slopes.append(
                        (timed(spec_once, n_hi) - timed(spec_once, n_lo)) / (n_hi - n_lo))
        finally:
            self.generator.set_state(saved)
        per_plain = max(statistics.median(plain_slopes), 1e-9)
        per_spec = max(statistics.median(spec_slopes), 1e-9)
        tokens_plain = float(self.chunk)
        tokens_spec = (1.0 + 0.75 * self.gamma) * k
        spec_wins = tokens_spec / per_spec > tokens_plain / per_plain
        threshold = float(self.slots) if spec_wins else 0.0
        self.spec_calibration = {
            "plain_dispatch_ms": per_plain * 1000,
            "spec_dispatch_ms": per_spec * 1000,
            "plain_tokens_per_dispatch": tokens_plain,
            "spec_tokens_per_dispatch_assumed": tokens_spec,
            "threshold": threshold,
        }
        return threshold

    def _step_spec(self) -> list[Request]:
        """One speculative dispatch of ``spec_lookahead`` rounds: every
        occupied row drafts, verifies and commits its own accepted length
        each round, with its table extended over all k rounds first, so
        the host leaves the loop for k rounds (rows that finish mid-way
        compute dead rounds; admission waits for the dispatch boundary).
        With ``pipelined`` the rounds are read back only after the next
        dispatch goes out, chained on the device's (cur, pos)."""
        k = self.spec_lookahead
        u = (self.gamma + 1) * k
        in_flight = set(self._pending_spec[1]) if self._pending_spec else set()
        ub = {slot: int(self._positions[slot]) + (u if slot in in_flight else 0)
              for slot in self._slot_req}
        for slot, req in self._slot_req.items():
            table = self._extend_evicting(self._seq_id(slot, req), ub[slot] + u)
            self._tables[slot, : len(table)] = table
        cover = self._spec_cover(max(ub.values()) + u)
        self._maybe_fault("spec_dispatch")
        cur = self._dev(self._tokens)
        pos = self._dev(self._positions)
        if self.pipelined and self._spec_chained is not None:
            fresh = self._fresh_mask()
            c_cur, c_pos = self._spec_chained
            cur = torch.where(fresh, cur, c_cur)
            pos = torch.where(fresh, pos, c_pos)
        self._fresh_slots.clear()
        committed, n_acc, new_cur, new_pos = self._run_spec_lookahead(
            self._dev(self._tables), cur, pos, self._dev(self._occupied), k, cover,
            aidx=self._aidx_dev(),
        )
        self.spec_rounds += k
        read = _Readback(committed, n_acc)
        snapshot = dict(self._slot_req)
        if not self.pipelined:
            return self._consume_spec(read, snapshot)
        self._spec_chained = (new_cur, new_pos)
        prev, self._pending_spec = self._pending_spec, (read, snapshot)
        if prev is not None:
            return self._consume_spec(*prev)
        return []

    def _dispatch_spec_superstep(self) -> list[Request]:
        """Dispatch one chained speculative superstep
        (``spec_superstep_k`` rounds, acceptance and eos/budget retirement
        on the device) for the occupied slots; ``_step_superstep``
        overlaps the step's host work with it and consumes
        ``_pending_spec`` last (pipelined: the previous superstep is
        consumed here, the newest stays chained on the device carry).
        Each live row's table extends up front over k rounds (twice that
        for rows a superstep in flight still advances), capped at its
        retirement ceiling, position + remaining budget + gamma + 1 (a
        retiring round commits its whole block; dead writes past it land
        on the mirror's trailing trash columns), so nothing is allocated
        mid-superstep and no commitment is overrun."""
        k = self.spec_superstep_k
        u = (self.gamma + 1) * k
        in_flight = set(self._pending_spec[1]) if self._pending_spec else set()
        targets = {}
        for slot, req in self._slot_req.items():
            pos = int(self._positions[slot])
            ceiling = pos + (req.max_new_tokens - len(req.tokens)) + self.gamma + 1
            targets[slot] = min(pos + u * (2 if slot in in_flight else 1), ceiling)
        for slot, req in self._slot_req.items():
            table = self._extend_evicting(self._seq_id(slot, req), targets[slot])
            self._tables[slot, : len(table)] = table
        cover = self._spec_cover(max(targets.values()))
        eos = np.full(self.slots, -1, np.int32)
        budget = np.zeros(self.slots, np.int32)
        for slot, req in self._slot_req.items():
            if req.eos_token is not None:
                eos[slot] = req.eos_token
            budget[slot] = req.max_new_tokens - len(req.tokens)
        self._maybe_fault("spec_dispatch")
        cur = self._dev(self._tokens)
        pos = self._dev(self._positions)
        occ = self._dev(self._occupied)
        live_in = occ
        budget_in = self._dev(budget)
        if self.pipelined and self._spec_chained is not None:
            # Chain on the previous superstep's device carry; only fresh
            # slots take their host state.
            fresh = self._fresh_mask()
            c_cur, c_pos, c_live, c_budget = self._spec_chained
            cur = torch.where(fresh, cur, c_cur)
            pos = torch.where(fresh, pos, c_pos)
            live_in = torch.where(fresh, live_in, c_live)
            budget_in = torch.where(fresh, budget_in, c_budget)
        self._fresh_slots.clear()
        committed, n_acc, round_live, *carry = self._run_spec_chained(
            self._dev(self._tables), cur, pos, occ, live_in, budget_in, self._dev(eos), k,
            cover, aidx=self._aidx_dev(),
        )
        self.spec_rounds += k
        self.spec_supersteps_run += 1
        snapshot = dict(self._slot_req)
        prev, self._pending_spec = self._pending_spec, (
            _Readback(committed, n_acc, round_live), snapshot)
        if not self.pipelined:
            return []
        self._spec_chained = tuple(carry)
        if prev is not None:
            return self._consume_spec(*prev)
        return []

    def _consume_spec(self, read: _Readback, snapshot: dict) -> list[Request]:
        """Read a speculative dispatch's (committed, n) back, one host
        sync, and apply emission and retirement for the slots as they
        were at dispatch: each round's committed prefix, stopping at eos
        or max_new_tokens; the host mirrors advance by the device's
        whole advance.  A chained superstep's readback also carries each
        round's live mask (``_apply_spec_super``)."""
        self._maybe_fault("spec_readback")
        fetched = read.arrays()
        self._note_recovery()
        if len(fetched) == 3:
            return self._apply_spec_super(fetched, snapshot)
        committed, n_acc = fetched
        finished = []
        for slot, req in snapshot.items():
            if req.done:
                # Retired between dispatch and read (pipelined lag).
                continue
            advance = 0
            for j in range(committed.shape[0]):
                k = int(n_acc[j, slot]) + 1
                if not req.done:
                    self._emit(req, committed[j, slot, :k])
                    # The draft proposed gamma, the verify kept k - 1.
                    self.spec_drafts_proposed += self.gamma
                    self.spec_tokens_rejected += self.gamma - (k - 1)
                advance += k
            self._positions[slot] += advance
            self._tokens[slot] = committed[-1, slot, int(n_acc[-1, slot])]
            if req.done:
                finished.append(self._retire(slot))
        return finished

    def _apply_spec_super(self, fetched, snapshot: dict) -> list[Request]:
        """Emission and retirement for one chained superstep's readback:
        each live round's committed prefix (``round_live`` is the
        device's round-entry mask, ``_emit``'s rule exactly, so the
        mirrors advance as the device did), and the over-decode
        reconciled: every frozen round's full block and the retiring
        round's unemitted tail."""
        committed, n_acc, round_live = fetched
        gp1 = committed.shape[2]
        finished = []
        for slot, req in snapshot.items():
            if req.done:
                # Retired between dispatch and read: the chained live
                # mask parked the row for the whole superstep.
                self.tokens_overdecoded += committed.shape[0] * gp1
                continue
            advance = 0
            emitted_before = len(req.tokens)
            last_live = None
            for j in range(committed.shape[0]):
                if not round_live[j, slot]:
                    self.tokens_overdecoded += gp1
                    continue
                k = int(n_acc[j, slot]) + 1
                self._emit(req, committed[j, slot, :k])
                self.spec_drafts_proposed += self.gamma
                self.spec_tokens_rejected += self.gamma - (k - 1)
                advance += k
                last_live = j
            if last_live is None:
                continue  # cannot arise: the device mask mirrors _emit
            self._positions[slot] += advance
            self._tokens[slot] = committed[last_live, slot, int(n_acc[last_live, slot])]
            if req.done:
                self.tokens_overdecoded += advance - (len(req.tokens) - emitted_before)
                finished.append(self._retire(slot))
        return finished

    def _drain_pending_spec(self) -> list[Request]:
        """Consume the speculative dispatch in flight (the mirrors advance
        by the device's committed lengths) and drop the chained carry:
        the next dispatch takes every row from the mirrors."""
        if self._pending_spec is None and self._spec_chained is None:
            return []
        finished: list[Request] = []
        if self._pending_spec is not None:
            read, snapshot = self._pending_spec
            self._pending_spec = None
            finished = self._consume_spec(read, snapshot)
        self._spec_chained = None
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
        if self._pending_read is None and self._chained_tok is None:
            return []
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
        if not self._pending_super and self._super_chained is None:
            return []
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
            return (self._drain_pending_plain() + self._drain_pending_spec()
                    + self._drain_pending_super())
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

        def expire_queued() -> None:
            for req in [r for r in self.pending if due(r)]:
                self.pending.remove(req)
                self._group_abandon(req)
                finished.append(self._finish_terminal(req, "expired"))

        expire_queued()
        expired_p = [p for p in self._inflight_prefill if due(p["req"])]
        for plan in expired_p:
            if not any(q is plan for q in self._inflight_prefill):
                continue  # a sibling's reclaim already dissolved it
            finished.append(self._finish_terminal(self._reclaim_partial(plan), "expired"))
        if expired_p:
            # A reclaim requeues a dissolved group's in-flight siblings;
            # they usually share the deadline, so expire them now.
            expire_queued()
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

    def retune(
        self,
        *,
        spec_breakeven: float | None = None,
        superstep_k: int | None = None,
        spec_superstep_k: int | None = None,
    ) -> dict:
        """Change knobs on a live engine, between dispatches: move
        ``spec_breakeven`` (``spec="auto"`` only), and step
        ``superstep_k`` / ``spec_superstep_k`` down from their
        construction values and back up to them, never above (the
        overshoot, max_pages, every commitment and the graphs' step and
        round counts are sized from them).  Whatever is in flight drains
        first, so the next dispatch under the new knobs starts from what
        the device computed: greedy streams are the same across every
        change, and the card's graphs are replayed, never captured again.
        Requests the drain retires surface through the next step().
        Returns ``{knob: (old, new)}`` for the knobs that changed (``{}``:
        nothing drained or counted)."""
        if self._closed:
            raise EngineClosed("engine is closed; no retune")
        changes: dict[str, tuple] = {}
        if spec_breakeven is not None:
            if self.spec != "auto" or self.draft_params is None:
                raise ValueError(
                    'spec_breakeven retune needs spec="auto" with a '
                    "draft loaded — other modes never consult the "
                    "threshold"
                )
            if spec_breakeven < 0:
                raise ValueError(f"spec_breakeven must be >= 0, got {spec_breakeven}")
            current = float(self.spec_breakeven) if self.spec_breakeven is not None else None
            if float(spec_breakeven) != current:
                changes["spec_breakeven"] = (self.spec_breakeven, float(spec_breakeven))
        if superstep_k is not None:
            if not 1 <= int(superstep_k) <= self._superstep_k_max:
                raise ValueError(
                    f"superstep_k must be in [1, {self._superstep_k_max}] (the "
                    f"construction-time ceiling), got {superstep_k}"
                )
            if int(superstep_k) != self.superstep_k:
                changes["superstep_k"] = (self.superstep_k, int(superstep_k))
        if spec_superstep_k is not None:
            if not 1 <= int(spec_superstep_k) <= self._spec_superstep_k_max:
                raise ValueError(
                    f"spec_superstep_k must be in "
                    f"[1, {self._spec_superstep_k_max}] (the "
                    f"construction-time ceiling), got {spec_superstep_k}"
                )
            if int(spec_superstep_k) != self.spec_superstep_k:
                changes["spec_superstep_k"] = (self.spec_superstep_k, int(spec_superstep_k))
        if not changes:
            return changes
        # The k knobs route the step and size dispatches, the breakeven
        # flips the mode: none may meet work dispatched under the old ones.
        self._finished_buffer.extend(self._drain_all_pending())
        for knob, (_, new) in changes.items():
            setattr(self, knob, new)
        self.retunes += 1
        return changes

    # ---- shutdown -------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Idempotent shutdown: pending, mid-prefill and running requests
        fail with ``EngineClosed`` recorded, their pages release, work in
        flight is dropped unread, fan-out groups dissolve, the prefix
        index clears (host blobs free; disk files stay), the health
        subscription ends; later
        submit and step raise ``EngineClosed``, and the closed engine
        reads idle."""
        if self._closed:
            return
        self._closed = True
        self._pending_read = None
        self._chained_tok = None
        self._pending_super.clear()
        self._super_chained = None
        self._pending_spec = None
        self._spec_chained = None
        self._fresh_slots.clear()
        err = "EngineClosed: engine closed with the request in flight"
        # step() refuses to run after close, so these land on
        # ``completed`` only, and the buffer clears.
        for slot in sorted(self._slot_req):
            self._finish_terminal(self._release_slot(slot), "failed", error=err)
        for plan in list(self._inflight_prefill):
            req = self._abort_partial(plan)
            req.group = None
            self._finish_terminal(req, "failed", error=err)
        while self.pending:
            req = self.pending.popleft()
            req.group = None
            self._finish_terminal(req, "failed", error=err)
        self._finished_buffer.clear()
        self._dissolve_groups()
        if self.prefix is not None:
            self.prefix.clear()
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
            and self._pending_spec is None
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
    parser.add_argument("--int8", action="store_true",
                        help="serve int8 weight-only quantized weights")
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="grouped-query kv heads (default: n_heads)")
    parser.add_argument("--lora-adapters", type=int, default=0,
                        help="serve N synthetic LoRA adapters multi-tenant over the "
                        "one base (requests round-robin over the base and them)")
    parser.add_argument("--lora-rank", type=int, default=8)
    parser.add_argument("--spec-int8-draft", action="store_true",
                        help="speculative decoding with the int8-quantized model "
                        "drafting for its own self (quantized self-speculation); "
                        "composes with --temperature through lossless "
                        "speculative sampling")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft tokens per speculative round")
    parser.add_argument("--spec-lookahead", type=int, default=1,
                        help="speculative rounds per dispatch: k > 1 extends page "
                        "tables k rounds ahead and reads tokens back once per k "
                        "rounds, at the cost of up to k rounds of emission lag")
    parser.add_argument("--spec-superstep-k", type=int, default=1, metavar="K",
                        help="speculative supersteps: K chained draft->verify->commit "
                        "rounds a dispatch with acceptance and eos/max-token "
                        "retirement on the device and one readback per K rounds "
                        "(same greedy tokens for every K; supersedes "
                        "--spec-lookahead, use one)")
    parser.add_argument("--spec-auto", action="store_true",
                        help="adaptive speculation: pick speculative or plain decode "
                        "per step from the live occupancy against the break-even "
                        "threshold (requires --spec-int8-draft)")
    parser.add_argument("--spec-breakeven", type=float, default=None,
                        help="occupancy threshold for --spec-auto; omit to "
                        "calibrate at the first decode step")
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
                        "decode_readback, spec_dispatch, spec_readback) to "
                        "exercise quarantine and replay")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="cross-request radix-tree prefix caching: "
                        "prompts sharing any page-aligned prefix (system "
                        "prompts, few-shot templates, multi-turn history) "
                        "reuse its k/v pages and skip its prefill")
    parser.add_argument("--kv-offload", action="store_true",
                        help="the prefix cache's host-RAM tier (implies "
                        "--prefix-cache): under pool pressure cold cached "
                        "pages spill to pinned host memory instead of "
                        "dropping and reload on a later hit; greedy "
                        "streams are the same offload on or off")
    parser.add_argument("--kv-host-pages", type=int, default=None, metavar="N",
                        help="with --kv-offload: cap the host tier at N "
                        "offloaded pages (default: unbounded)")
    parser.add_argument("--kv-disk-dir", default=None, metavar="DIR",
                        help="the disk tier below --kv-offload: when host RAM "
                        "is full, the coldest offloaded page moves to a "
                        "chain-key-named, checksummed file under DIR "
                        "instead of dropping; files are shared by engines "
                        "using DIR and outlive the process")
    parser.add_argument("--kv-disk-pages", type=int, default=None, metavar="N",
                        help="with --kv-disk-dir: cap the disk tier at N page "
                        "files, coldest evicted first (default: unbounded)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    if args.superstep_k < 1:
        parser.error("--superstep-k must be >= 1 chained chunks")
    if args.spec_superstep_k < 1:
        parser.error("--spec-superstep-k must be >= 1 chained rounds")
    if args.spec_superstep_k > 1 and not args.spec_int8_draft:
        parser.error("--spec-superstep-k chains speculative rounds; it "
                     "needs --spec-int8-draft (a draft model)")
    if args.spec_superstep_k > 1 and args.spec_lookahead > 1:
        parser.error("--spec-superstep-k supersedes --spec-lookahead; "
                     "use one round-chaining knob, not both")
    if args.spec_auto and not args.spec_int8_draft:
        parser.error("--spec-auto needs --spec-int8-draft (a draft model)")
    if args.kv_offload:
        args.prefix_cache = True  # the offload tier lives on the cache
    if args.kv_host_pages is not None and not args.kv_offload:
        parser.error("--kv-host-pages bounds the --kv-offload host tier")
    if args.kv_host_pages is not None and args.kv_host_pages < 1:
        parser.error("--kv-host-pages must be >= 1 pages")
    if args.kv_disk_dir is not None and not args.kv_offload:
        parser.error("--kv-disk-dir is the tier below --kv-offload; "
                     "pass --kv-offload too")
    if args.kv_disk_pages is not None and args.kv_disk_dir is None:
        parser.error("--kv-disk-pages bounds the --kv-disk-dir tier")
    if args.kv_disk_pages is not None and args.kv_disk_pages < 1:
        parser.error("--kv-disk-pages must be >= 1 page files")
    injector = None
    if args.inject_fault:
        from .faults import FaultInjector

        seams = ("prefill_dispatch", "prefill_readback", "decode_dispatch",
                 "decode_readback", "spec_dispatch", "spec_readback")
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
    if args.int8:
        params = quantize_params(params)
    adapters = None
    names: list = [None]
    if args.lora_adapters > 0:
        from .multi_lora import synthetic_adapters

        adapters = synthetic_adapters(config, args.lora_adapters, rank=args.lora_rank,
                                      seed=99, device=device)
        names += sorted(adapters)
    spec_kw = {}
    if args.spec_int8_draft:
        # The int8 self-draft: the same architecture at half the weight
        # stream.  Under --int8 the target is quantized already, so the
        # draft is the target itself.
        spec_kw = dict(
            draft_params=params if args.int8 else quantize_params(params),
            draft_config=config, gamma=args.gamma, spec_lookahead=args.spec_lookahead,
            spec_superstep_k=args.spec_superstep_k,
        )
        if args.spec_auto:
            spec_kw.update(spec="auto", spec_breakeven=args.spec_breakeven)
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
        prefill_budget=args.prefill_budget, prefix_cache=args.prefix_cache,
        kv_offload=args.kv_offload, kv_host_pages=args.kv_host_pages,
        kv_disk_dir=args.kv_disk_dir, kv_disk_pages=args.kv_disk_pages,
        fault_injector=injector, max_retries=args.max_retries, adapters=adapters,
        device=device, **spec_kw,
    )
    rng = np.random.default_rng(7)
    for i in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        prompt = rng.integers(0, config.vocab_size, plen)
        # Mixed lengths: the stream the engine's slot turnover exists for.
        engine.submit(prompt, max(1, args.max_new_tokens // (1 + i % 3)),
                      adapter=names[i % len(names)], deadline_s=args.deadline_s)

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
        f"adapters={args.lora_adapters}, "
        f"pool={engine.ctrl.n_pages} pages, "
        f"pages in use after drain: {engine.ctrl.used_pages})"
    )
    if args.spec_int8_draft:
        calib = engine.spec_calibration
        verdict = "" if calib is None else (
            f" calibrated threshold={calib['threshold']:.0f} "
            f"(plain {calib['plain_dispatch_ms']:.2f} ms/dispatch, spec "
            f"{calib['spec_dispatch_ms']:.2f} ms/dispatch)"
        )
        print(
            f"spec: gamma={engine.gamma} rounds={engine.spec_rounds} "
            f"drafts_rejected={engine.spec_tokens_rejected} "
            f"spec_supersteps={engine.spec_supersteps_run} spec={engine.spec} "
            f"spec_steps={engine.spec_mode_steps} plain_steps={engine.plain_mode_steps}"
            f"{verdict}"
        )
    if args.prefix_cache:
        print(
            f"prefix cache: hits={engine.prefix.hits} misses={engine.prefix.misses} "
            f"cached_pages={engine.prefix.cached_pages} "
            f"prefill_tokens={engine.prefill_tokens}"
        )
    if (engine.steps_quarantined or engine.requests_expired or engine.requests_failed
            or args.kv_offload):
        from collections import Counter

        statuses = Counter(r.status for r in engine.completed)
        kv = ""
        if args.kv_offload:
            kv = (
                f"kv_offloads={engine.prefix.spills} "
                f"kv_reloads={engine.prefix.reloads} "
                f"kv_host_pages_now={engine.prefix.offloaded_pages} "
            )
            if args.kv_disk_dir is not None:
                kv += (
                    f"kv_disk_demotions={engine.prefix.demotions} "
                    f"kv_disk_reloads={engine.prefix.disk_reloads} "
                    f"kv_disk_pages_now={engine.kv_disk_pages} "
                )
        print(
            f"lifecycle: statuses={dict(statuses)} {kv}"
            f"quarantined_steps={engine.steps_quarantined} "
            f"replays={engine.requests_retried} "
            f"tokens_replayed={engine.tokens_replayed} "
            f"recoveries_ms={[round(t * 1000, 1) for t in engine.fault_recovery_s]}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
