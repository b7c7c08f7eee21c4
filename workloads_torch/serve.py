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
them.

Tensor parallelism, as in the JAX engine: ``mesh=`` serves across the
``"model"`` axis of a ``DeviceMesh``, one engine a rank making the same
calls (``tp_serve.py``), in every mode above but ``kv_offload``; its
steps dispatch eagerly.

Run on the card with ``python -m workloads_torch.serve``; pass
``--device cpu`` for the plain PyTorch path on the CPU.
"""

from __future__ import annotations

import functools
import itertools
import queue
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from . import prng, resolve_device
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
    paged_decode_step,
    paged_decode_superstep,
    paged_prefill,
    paged_prefill_chunk,
    paged_spec_superstep,
    paged_spec_superstep_chained,
    read_pages,
    table_array,
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


def _phase_events(observer, device: torch.device):
    """An engine's timing-event factory: CUDA events that time, for an
    observer of a card engine; else None, and no event is made."""
    if observer is None or device.type != "cuda":
        return None
    return functools.partial(torch.cuda.Event, enable_timing=True)


class _Readback:
    """Decoded tensors on their way to the host.  From the card they are
    copied into pinned memory behind one event as soon as they are
    dispatched (before anything later, such as a graph replay, can
    overwrite their buffers), so the host blocks only when it reads
    them.  ``phase`` is the dispatch's pair of timing events
    (``ServeEngine._phase_end``), recorded before the copies, so the
    read that waits for this event finds the pair complete."""

    def __init__(self, *tensors: torch.Tensor, phase=None):
        self.phase = phase
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
    for the engine's life: on the card a captured graph holds them.

    Pass ``mesh`` (a ``("data", "model")`` ``DeviceMesh`` of data degree
    1, ``train.make_mesh``) to serve tensor-parallel: the engine is SPMD,
    one per rank, and the caller makes the same calls (``submit``,
    ``step``, ``run``, ...) in the same order on every rank of the mesh,
    as under ``torchrun``.  ``params`` (and ``draft_params``, adapters)
    are the FULL trees on the rank's device (the same seed on every
    rank); each rank keeps its ``param_specs`` cut, pools of its kv heads
    and its cut of the adapters (``tp_serve.py``), runs K1 on its own
    heads and all-reduces the ``wo`` and ``w_down`` products over the
    model group.  Scheduling, pages and the request API run the same on
    every rank; what the clock decides (the ``spec="auto"``
    calibration, deadlines) is the first rank's, broadcast.  Under a
    mesh the decode steps dispatch eagerly (no CUDA graph: a gloo
    collective cannot be captured), and ``kv_offload`` is refused."""

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
        rng: torch.Tensor | None = None,
        mesh=None,
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
        compile_cache_dir: str | None = None,
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
        observer=None,
        ledger=None,
        moe_counters: bool = False,
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
        if moe_counters and not config.n_routed_experts:
            raise ValueError("moe_counters counts the expert layer; the config has none")
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
        if kv_offload and mesh is not None:
            raise ValueError(
                "kv_offload is not supported under tensor parallelism "
                "yet (page spills/reloads would round-trip sharded pools)"
            )
        if mesh is not None:
            from . import tp_serve

            tp_serve._check_serving_mesh(mesh)
            tp_serve._check_tp(config, mesh)
            if draft_config is not None:
                tp_serve._check_tp(draft_config, mesh)
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
        # The kernel-build cache (faststart.py): kernel libraries this
        # engine's first launches load are looked up in (or built into)
        # ``compile_cache_dir``; inert for numerics.
        if compile_cache_dir is not None:
            from .faststart import enable_compile_cache

            enable_compile_cache(compile_cache_dir)
        from .faststart import cache_stats

        self._cc_base = cache_stats()
        self._mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = tp_serve.mesh_device(mesh)
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(
                    f"the mesh's ranks run on {self.device.type}, not {device}"
                )
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
        # Under a mesh each rank keeps its cut of the weights (and of the
        # pools and adapters below), and ``_reduce`` sums the row-parallel
        # products over the model group (``tp_serve.py``).
        self._reduce = None
        if mesh is not None:
            params = tp_serve.shard_params(params, config, mesh)
            if draft_params is not None:
                draft_params = tp_serve.shard_params(draft_params, draft_config, mesh)
            self._reduce = tp_serve.model_all_reduce(mesh)
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

        def pools_for(cfg):
            if mesh is None:
                return init_page_pools(cfg, n_pages, page_size, self.device)
            return tp_serve.init_shard_pools(cfg, n_pages, page_size, mesh, self.device)

        self.pools = pools_for(config)
        # The draft model's own pools under the same control plane: the
        # same page indices and tables, so one allocator serves both
        # caches, and a cached or spilled page holds both models' k/v.
        self.d_pools = pools_for(draft_config) if draft_params is not None else None
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
        # The engine's key, split at every draw as the JAX engine's
        # ``_next_key`` splits it (a key is a value: never changed in place).
        self._rng = (rng.to(self.device) if rng is not None
                     else prng.PRNGKey(0, device=self.device))
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
            if mesh is not None:
                self._stacked_adapters = tp_serve.shard_adapters(
                    self._stacked_adapters, config, mesh)
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
        # Under a mesh every step dispatches eagerly: a gloo collective
        # cannot be captured in a graph.
        self._graph = None
        # With ``moe_counters``, the experts the decode steps read
        # (moe_decode_expert_reads), summed on the device inside the
        # step; without, the step carries no counting kernels.
        self._moe_reads = (torch.zeros(1, dtype=torch.int64, device=self.device)
                           if moe_counters else None)
        if self.device.type == "cuda" and mesh is None:
            self._graph = DecodeGraph(
                params, self.pools, config, slots=slots,
                max_pages=self.max_pages, max_steps=self.chunk * superstep_k,
                temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, sampling=self.sampling,
                lora_stacked=self._stacked_adapters, lora_alpha=self.lora_alpha,
                moe_reads=self._moe_reads,
            )
            self._unbounded = (
                torch.full((slots,), _UNBOUNDED, dtype=torch.int32, device=self.device),
                torch.full((slots,), -1, dtype=torch.int32, device=self.device),
            )
        # The speculative round as a CUDA graph, captured per cover bucket
        # on first use and replayed k times a dispatch.
        self._spec_graph = None
        if self.device.type == "cuda" and draft_params is not None and mesh is None:
            self._spec_graph = SpecGraph(
                params, draft_params, self.pools, self.d_pools, config, draft_config,
                gamma=gamma, slots=slots, max_pages=self.max_pages,
                max_rounds=max(spec_lookahead, spec_superstep_k),
                temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, sampling=self.sampling,
                lora_stacked=self._stacked_adapters, lora_alpha=self.lora_alpha,
            )
        # Telemetry.
        self.chunks_run = 0
        self.supersteps_run = 0
        # Decode steps computed past a row's retirement (a superstep's
        # dead tail), reconciled at each superstep readback.
        self.tokens_overdecoded = 0
        # Wall seconds the scheduler spent blocked in host readbacks
        # (``_host_sync``): StepRecord.host_sync_ms and the
        # engine_host_sync_seconds histogram (obs.py).
        self.host_sync_s = 0.0
        self.generated_tokens = 0
        # Routed (token, expert) rows of the live rows of the decode
        # steps, every layer counted (0 without experts): a chunk's
        # occupied rows at its dispatch, a superstep's live steps at its
        # readback.
        self.moe_decode_assignments = 0
        self.prefills_run = 0
        self.prefill_tokens = 0  # prompt tokens forwarded
        self.prefill_sweeps = 0  # batched-admission sweeps
        self.prefill_dispatches = 0  # prefill program calls
        # Token rows the target's prefill dispatches ran, padding included
        # (prefill_tokens / prefill_padded_tokens: the dispatches' fill).
        self.prefill_padded_tokens = 0
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
        # Opt-in observability (obs.py) and the chip-time ledger
        # (ledger.py): both read host counters between steps, never
        # device state, so streams and graph captures are the same with
        # them on or off.  ``ledger_phase`` "probe"/"warmup" charges a
        # pass to that phase (ledger.py OFFBOOK_PHASES).
        self._obs = observer
        if observer is not None:
            observer._bind(self)
        # Device time by phase, for the observer of a card engine: a pair
        # of timing events brackets each prefill sweep's launches and each
        # decode dispatch, and is read at the host sync that reads that
        # work back (never one of its own): StepRecord.prefill_device_ms
        # and decode_device_ms.  Without an observer no event is made.
        self.prefill_device_s = 0.0
        self.decode_device_s = 0.0
        self._phase_event = _phase_events(observer, self.device)
        self._prefill_phases: list = []  # swept, first tokens not read yet
        self.ledger = ledger
        self.ledger_phase = "serve"
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

    def _next_key(self) -> torch.Tensor:
        self._rng, key = prng.split(self._rng).unbind(0)
        return key

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

    # ---- the expert layer's decode counters -----------------------------

    def _count_routed(self, rows: int) -> None:
        """Add ``rows`` live decode rows' routed (token, expert) rows,
        every layer counted, to ``moe_decode_assignments``."""
        self.moe_decode_assignments += rows * self.config.experts_per_token * self.config.n_layers

    @property
    def moe_decode_expert_reads(self) -> int:
        """Experts that received at least one row, summed over the decode
        steps' expert-layer calls (0 without ``moe_counters``).  Summed on
        the device; reading it waits for the work in flight."""
        return 0 if self._moe_reads is None else int(self._moe_reads)

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

    def _host_sync(self, fetch):
        """Run one blocking device-to-host fetch, timing the wall it
        stalls the scheduler for (``host_sync_s``: StepRecord.host_sync_ms
        and the engine_host_sync_seconds histogram).  Every readback goes
        through here, so the account cannot drift from the syncs made."""
        t0 = time.perf_counter()
        with record_function("engine.sync"):
            out = fetch()
        dt = time.perf_counter() - t0
        self.host_sync_s += dt
        if self._obs is not None:
            self._obs._note_readback(dt)
        return out

    def _phase_start(self):
        """A timing event recorded now on the engine's stream, or None
        (and nothing recorded) without an observer on a card engine."""
        if self._phase_event is None:
            return None
        start = self._phase_event()
        start.record()
        return start

    def _phase_end(self, start):
        """``(start, end)`` with ``end`` recorded now, or None."""
        if start is None:
            return None
        end = self._phase_event()
        end.record()
        return start, end

    def _phase_read(self, phase: str, pair) -> None:
        """Add a pair's device seconds to ``prefill_device_s`` or
        ``decode_device_s``.  Called only after the host sync that read
        the pair's work back, so ``elapsed_time`` waits for nothing."""
        if pair is None:
            return
        start, end = pair
        secs = start.elapsed_time(end) / 1000.0
        if phase == "prefill":
            self.prefill_device_s += secs
        else:
            self.decode_device_s += secs

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
        slots.  Spanned ``engine.admit`` when a request waits for a free
        slot or an admission is mid-prefill."""
        if self._inflight_prefill or (self.pending and not self._occupied.all()):
            with record_function("engine.admit"):
                return self._admit_now()
        return self._admit_now()

    def _admit_now(self) -> list[Request]:
        """``_admit``'s work, outside its span."""
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
                    logits, self._next_key() if self.sampling else None,
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
            self.prefill_padded_tokens += count * B
            tokens = np.zeros((1, B), np.int64)
            tokens[0, :n] = prompt
            logits, _ = paged_prefill(params, pools, table, self._dev(tokens), lengths, config,
                                      lora=lora, reduce=self._reduce)
            return logits
        n_chunks = -(-n // B)
        for ci in range(start_page // bp, n_chunks):
            self.prefill_dispatches += count
            self.prefill_padded_tokens += count * B
            tokens = np.zeros((1, B), np.int64)
            width = min(B, n - ci * B)
            tokens[0, :width] = prompt[ci * B : ci * B + width]
            logits, _ = paged_prefill_chunk(
                params, pools, table, self._dev(tokens), lengths, config,
                start_page=ci * bp, cover_pages=(ci + 1) * bp, emit=ci == n_chunks - 1,
                lora=lora, reduce=self._reduce,
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

    def _dispatch_prefill_ci(self, rows: list[dict], ci: int, emitted: torch.Tensor) -> None:
        """ONE compact prefill chunk at chunk index ``ci`` for ``rows``
        (each covers ``ci`` with its uncached span), into the target pools
        and the draft pools: [R, W] for the R rows and W their longest
        remaining span in the chunk, rounded up to a page, not [slots,
        bucket].  Tokens, tables, lengths, start pages (which send the
        columns of a row's cached prefix to the trash page), adapter
        indices and the emitting rows go up in one staged copy.  A row's
        logits land in ``emitted`` at its slot from the chunk where its
        prompt ends; ``lora`` adapts the target's rows (the draft's stay
        unadapted).  The unbudgeted and the budgeted sweep both dispatch
        through here."""
        B, ps = self.prompt_bucket, self.page_size
        start = ci * B
        R = len(rows)
        W = min(B, -(-max(p["n"] - start for p in rows) // ps) * ps)
        cover = ci * (B // ps) + W // ps
        emit = [i for i, p in enumerate(rows) if p["n"] <= start + B]
        adapters = self._stacked_adapters is not None
        sizes = (R * W, R * cover, R, R, R * adapters, len(emit), len(emit))
        staging = np.zeros(sum(sizes), np.int64)
        parts = np.split(staging, np.cumsum(sizes)[:-1])
        parts[1][:] = self.ctrl.trash
        for i, p in enumerate(rows):
            span = p["prompt"][start : start + min(W, p["n"] - start)]
            parts[0][i * W : i * W + len(span)] = span
            t = self.ctrl.tables[p["seq"]][:cover]
            parts[1][i * cover : i * cover + len(t)] = t
            parts[2][i], parts[3][i] = p["n"], p["start_page"]
            if adapters:
                parts[4][i] = p["aidx"]
        parts[5][:] = emit
        parts[6][:] = [rows[i]["slot"] for i in emit]
        tokens, tables, lengths, row_start, aidx, emit_rows, emit_slots = torch.split(
            self._dev(staging), sizes)
        tokens, tables = tokens.view(R, W), tables.view(R, cover)
        logits, _ = paged_prefill_chunk(
            self.params, self.pools, tables, tokens, lengths, self.config,
            start_page=ci * (B // ps), cover_pages=cover, emit=bool(emit),
            row_start=row_start, lora=self._lora(aidx if adapters else None),
            reduce=self._reduce,
        )
        self.prefill_dispatches += 1
        self.prefill_padded_tokens += R * W
        if emit:
            emitted[emit_slots] = logits[emit_rows]
        if self.d_pools is not None:
            # The draft pools run the same chunk (no logits).
            paged_prefill_chunk(
                self.draft_params, self.d_pools, tables, tokens, lengths,
                self.draft_config, start_page=ci * (B // ps), cover_pages=cover,
                emit=False, row_start=row_start, reduce=self._reduce,
            )

    def _sweep_prefill(self, plans: list[dict]) -> torch.Tensor | None:
        """Run the planned rows that prefill through the page-aligned
        chunks some row's uncached span covers, each chunk a compact batch
        of the rows whose uncached span covers it (a chunk only cached
        prefixes cover is skipped, and a row sits out the chunks its
        cached prefix covers and those past its prompt).  Returns the
        [slots, vocab] first-token logits, or None when no row prefills
        (only group reuse)."""
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
        with record_function("engine.prefill"):
            start = self._phase_start()
            emitted = torch.zeros(
                (self.slots, self.config.vocab_size), dtype=torch.float32,
                device=self.device,
            )
            self.prefill_sweeps += 1
            for ci in active:
                chunk_rows = [p for p in rows
                              if p["start_page"] // bp <= ci < -(-p["n"] // B)]
                self._dispatch_prefill_ci(chunk_rows, ci, emitted)
            self._note_sweep(start)
        return emitted

    def _note_sweep(self, start) -> None:
        """Close a sweep's timing pair; the next first-token readback
        reads it (``_finish_admissions``)."""
        pair = self._phase_end(start)
        if pair is not None:
            self._prefill_phases.append(pair)

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
        # One key per admitted request, in plan order: the serial path's
        # draws; each row samples under its own key (the rest under zeros).
        keys = None
        if self.sampling:
            keys = torch.zeros((self.slots, 2), dtype=torch.int64, device=self.device)
            for p in plans:
                keys[p["slot"]] = self._next_key()
        self._maybe_fault("prefill_readback")
        toks_dev = sample_logits(
            emitted, keys, self.temperature, self.top_k, self.top_p,
        )
        toks = self._host_sync(lambda: toks_dev.cpu().numpy())
        for pair in self._prefill_phases:
            self._phase_read("prefill", pair)
        self._prefill_phases.clear()
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
        with record_function("engine.prefill"):
            start = self._phase_start()
            for _ in range(max_chunks):
                todo = [p for p in self._inflight_prefill
                        if p["prefill"] and p["cursor"] <= p["last_ci"]]
                if not todo:
                    break
                ci = todo[0]["cursor"]
                group = [p for p in todo if p["cursor"] == ci]
                self._dispatch_prefill_ci(group, ci, emitted)
                for p in group:
                    p["cursor"] += 1
            self._note_sweep(start)
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
        dispatch or readback quarantines the step.

        An observer brackets the step with its begin/end hooks (one
        StepRecord a call), and a chip-time ledger brackets the same
        window; both read host counters only.  Without either this is a
        passthrough.

        Phase spans (``torch.profiler.record_function``, one enter and
        exit each when no profiler runs): ``engine.step`` around the
        step, ``engine.admit`` around an admission with work,
        ``engine.prefill`` around each prefill sweep, ``engine.decode``
        around each decode dispatch up to its readback copy, and
        ``engine.sync`` around every host sync."""
        obs = self._obs
        led = self.ledger
        if obs is None and led is None:
            with record_function("engine.step"):
                return self._step_impl()
        lsnap = led.step_begin(self) if led is not None else None
        snap = obs._step_begin(self) if obs is not None else None
        with record_function("engine.step"):
            finished = self._step_impl()
        if led is not None:
            led.step_end(self, lsnap, finished)
        if obs is not None:
            obs._step_end(self, snap, finished)
        return finished

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
        with record_function("engine.decode"):
            read, last = self._dispatch_chunk()
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

    def _dispatch_chunk(self) -> tuple[_Readback, torch.Tensor]:
        """Dispatch one decode chunk for the occupied slots: (its
        readback, the device's last tokens a pipelined chunk chains on)."""
        self._cover_chunk()
        start = self._phase_start()
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
        rng = self._next_key() if self.sampling else None
        if self._graph is None:
            toks, _ = paged_decode_chunk(
                self.params, self.pools, tables, tok_in, pos, occupied,
                rng, self.temperature, self.top_k, self.top_p,
                self.config, self.chunk, self.sampling, lora=self._lora(aidx),
                reduce=self._reduce, moe_reads=self._moe_reads,
            )
            last = toks[:, -1]
        else:
            toks, last, *_ = self._graph.run(
                tables, tok_in, pos, occupied, *self._unbounded, self.chunk, aidx,
                keys=None if rng is None else prng.split(rng, self.chunk),
            )
        self._count_routed(int(self._occupied.sum()) * self.chunk)
        self.chunks_run += 1
        return _Readback(toks, phase=self._phase_end(start)), last

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
        toks = self._host_sync(read.numpy)
        self._phase_read("decode", read.phase)
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
                    with record_function("engine.decode"):
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
        start = self._phase_start()
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
        # One engine key per chunk, in the k=1 path's draw order.
        rngs = (torch.stack([self._next_key() for _ in range(self.superstep_k)])
                if self.sampling else None)
        tables, eos_in = self._dev(self._tables), self._dev(eos)
        aidx = self._aidx_dev()
        self._maybe_fault("decode_dispatch")
        if self._graph is None:
            toks, *carry, _ = paged_decode_superstep(
                self.params, self.pools, tables, tok_in, pos_in, live_in,
                budget_in, eos_in, rngs, self.temperature, self.top_k,
                self.top_p, self.config, self.chunk, self.superstep_k, self.sampling,
                lora=self._lora(aidx), reduce=self._reduce, moe_reads=self._moe_reads,
            )
        else:
            toks, *carry = self._graph.run(
                tables, tok_in, pos_in, live_in, budget_in, eos_in, span, aidx,
                keys=None if rngs is None else prng.split(rngs, self.chunk).reshape(span, 2),
            )
        self.chunks_run += self.superstep_k
        self.supersteps_run += 1
        if self.pipelined:
            self._super_chained = tuple(carry)
        self._pending_super.append(
            (_Readback(toks, phase=self._phase_end(start)), dict(self._slot_req)))

    def _consume_superstep(self, read: _Readback, snapshot: dict) -> list[Request]:
        """The superstep's one readback: emit each row's live prefix
        (``_emit``'s eos/max_new rule is the device's retirement mask, so
        the host mirrors advance as the device did), retire finished
        rows, and count the dead steps each retiring row sat frozen for."""
        self._maybe_fault("decode_readback")
        toks = self._host_sync(read.numpy)
        self._phase_read("decode", read.phase)
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
            self._count_routed(advance)
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

    def export_trace(self, path: str) -> int:
        """Write the observer's timeline (request lifecycle spans and step
        records) as chrome://tracing trace_event JSON; returns the event
        count.  Needs ``observer=EngineObserver()`` at construction."""
        if self._obs is None:
            raise RuntimeError(
                "export_trace needs an observer: construct the engine "
                "with observer=workloads_torch.obs.EngineObserver()"
            )
        return self._obs.export_trace(path)

    def _spec_cover(self, last_position: int) -> int:
        """The verify view's static width for rows that reach
        ``last_position``: its pages rounded up to a multiple of 4 (a
        bounded set of covers, one captured graph each), capped at
        ``max_pages``."""
        need = -(-last_position // self.page_size)
        return min(self.max_pages, -(-need // 4) * 4)

    def _run_spec_lookahead(self, tables, cur, pos, occ, k: int, cover: int,
                            rng=None, aidx=None):
        """``k`` lookahead rounds (``paged_spec_superstep``) for the rows
        ``occ`` marks; on the card as ``k`` replays of the captured round
        (budget unbounded, no eos: ``live`` stays ``occ``), round ``i``
        under ``split(rng, k)[i]``; ``aidx`` adapts the target's verify.
        Returns (committed [k, slots,
        gamma+1], n [k, slots], new_cur, new_pos), the carry copied out
        of the graph's buffers."""
        if self._spec_graph is None:
            committed, n, new_cur, new_pos, _, _ = paged_spec_superstep(
                self.params, self.draft_params, self.pools, self.d_pools, tables, cur, pos,
                occ, self.config, self.draft_config, self.gamma, k, cover,
                sampling=self.sampling, rng=rng,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                t_lora=self._lora(aidx), reduce=self._reduce,
            )
            return committed, n, new_cur, new_pos
        committed, n, _, new_cur, new_pos, _, _ = self._spec_graph.run(
            tables, cur, torch.where(occ, pos, 0), occ, *self._unbounded, k, cover, aidx,
            keys=prng.split(rng, k) if self.sampling else None,
        )
        return committed, n, new_cur.clone(), new_pos.clone()

    def _run_spec_chained(self, tables, cur, pos, occ, live, budget, eos, k: int,
                          cover: int, rngs=None, aidx=None):
        """``k`` chained-retirement rounds
        (``paged_spec_superstep_chained``); on the card as ``k`` replays
        of the captured round, empty slots pinned to position 0 at entry,
        round ``i`` under ``split(rngs[i], 1)[0]``.  ``aidx`` adapts the
        target's verify.  Returns (committed, n,
        round_live, new_cur, new_pos, new_live, new_budget), the carry
        copied out of the graph's buffers."""
        if self._spec_graph is None:
            out = paged_spec_superstep_chained(
                self.params, self.draft_params, self.pools, self.d_pools, tables, cur, pos,
                occ, live, budget, eos, self.config, self.draft_config, self.gamma, k,
                cover, sampling=self.sampling, rngs=rngs,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                t_lora=self._lora(aidx), reduce=self._reduce,
            )
            return out[:7]
        committed, n, round_live, *carry = self._spec_graph.run(
            tables, cur, torch.where(occ, pos, 0), live & occ, budget, eos, k, cover, aidx,
            keys=prng.split(rngs, 1)[:, 0] if self.sampling else None,
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
        ``PRNGKey(0)``, never the engine's key: the served stream never
        sees the probe.  An injected calibration (``spec_calibration=``) is
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
        key = prng.PRNGKey(0, device=self.device)  # private; never self._next_key()
        aidx = self._aidx_dev(np.zeros(self.slots, np.int32))

        def plain_once(tok):
            if self._graph is None:
                toks, _ = paged_decode_chunk(
                    self.params, self.pools, tables, tok, zeros, occ, key,
                    self.temperature, self.top_k, self.top_p, self.config, self.chunk,
                    self.sampling, lora=self._lora(aidx), reduce=self._reduce,
                )
                return toks[:, -1]
            return self._graph.run(tables, tok, zeros, occ, *self._unbounded,
                                   self.chunk, aidx, keys=chunk_keys)[1].clone()

        chunk_keys = prng.split(key, self.chunk) if self.sampling else None
        rngs = torch.stack([key] * k)

        def spec_once(cur):
            if self.spec_superstep_k > 1:
                return self._run_spec_chained(tables, cur, zeros, occ, occ, zeros32 + 1,
                                              zeros32 - 1, k, cover, rngs, aidx)[3]
            return self._run_spec_lookahead(tables, cur, zeros, occ, k, cover, key,
                                            aidx)[2]

        def timed(once, n: int) -> float:
            tok = zeros
            t0 = time.perf_counter()
            for _ in range(n):
                tok = once(tok)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

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
        per_plain = max(statistics.median(plain_slopes), 1e-9)
        per_spec = max(statistics.median(spec_slopes), 1e-9)
        tokens_plain = float(self.chunk)
        tokens_spec = (1.0 + 0.75 * self.gamma) * k
        spec_wins = tokens_spec / per_spec > tokens_plain / per_plain
        threshold = float(self.slots) if spec_wins else 0.0
        calibration = {
            "plain_dispatch_ms": per_plain * 1000,
            "spec_dispatch_ms": per_spec * 1000,
            "plain_tokens_per_dispatch": tokens_plain,
            "spec_tokens_per_dispatch_assumed": tokens_spec,
            "threshold": threshold,
        }
        if self._mesh is not None:
            calibration = self._agree(calibration)
        self.spec_calibration = calibration
        return float(calibration["threshold"])

    def _agree(self, obj):
        """Under a mesh, the first rank of the model group's ``obj`` on
        every rank: a choice made from the clock (the ``spec="auto"``
        calibration, deadlines) must be one choice, since the ranks run
        the same collectives in lockstep."""
        group = self._mesh.get_group("model")
        out = [obj]
        torch.distributed.broadcast_object_list(
            out, src=torch.distributed.get_global_rank(group, 0), group=group)
        return out[0]

    def _step_spec(self) -> list[Request]:
        """One speculative dispatch of ``spec_lookahead`` rounds: every
        occupied row drafts, verifies and commits its own accepted length
        each round, with its table extended over all k rounds first, so
        the host leaves the loop for k rounds (rows that finish mid-way
        compute dead rounds; admission waits for the dispatch boundary).
        With ``pipelined`` the rounds are read back only after the next
        dispatch goes out, chained on the device's (cur, pos)."""
        with record_function("engine.decode"):
            k = self.spec_lookahead
            u = (self.gamma + 1) * k
            in_flight = set(self._pending_spec[1]) if self._pending_spec else set()
            ub = {slot: int(self._positions[slot]) + (u if slot in in_flight else 0)
                  for slot in self._slot_req}
            for slot, req in self._slot_req.items():
                table = self._extend_evicting(self._seq_id(slot, req), ub[slot] + u)
                self._tables[slot, : len(table)] = table
            cover = self._spec_cover(max(ub.values()) + u)
            rng = self._next_key() if self.sampling else None
            self._maybe_fault("spec_dispatch")
            start = self._phase_start()
            cur = self._dev(self._tokens)
            pos = self._dev(self._positions)
            if self.pipelined and self._spec_chained is not None:
                fresh = self._fresh_mask()
                c_cur, c_pos = self._spec_chained
                cur = torch.where(fresh, cur, c_cur)
                pos = torch.where(fresh, pos, c_pos)
            self._fresh_slots.clear()
            committed, n_acc, new_cur, new_pos = self._run_spec_lookahead(
                self._dev(self._tables), cur, pos, self._dev(self._occupied), k, cover, rng,
                aidx=self._aidx_dev(),
            )
            self.spec_rounds += k
            read = _Readback(committed, n_acc, phase=self._phase_end(start))
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
        with record_function("engine.decode"):
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
            # One engine key per round, in the k=1 spec path's draw order
            # (a k=1 spec step draws a key only when sampling).
            rngs = (torch.stack([self._next_key() for _ in range(k)])
                    if self.sampling else None)
            self._maybe_fault("spec_dispatch")
            start = self._phase_start()
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
                cover, rngs, aidx=self._aidx_dev(),
            )
            self.spec_rounds += k
            self.spec_supersteps_run += 1
            snapshot = dict(self._slot_req)
            prev, self._pending_spec = self._pending_spec, (
                _Readback(committed, n_acc, round_live, phase=self._phase_end(start)),
                snapshot)
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
        fetched = self._host_sync(read.arrays)
        self._phase_read("decode", read.phase)
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
        due_rids = None
        if self._mesh is not None:
            timed = [r for r in (*self.pending, *(p["req"] for p in self._inflight_prefill),
                                 *self._slot_req.values()) if r.t_deadline is not None]
            if not timed:
                return []
            due_rids = self._agree({r.rid for r in timed if now >= r.t_deadline})

        def due(req: Request) -> bool:
            if due_rids is not None:
                return req.rid in due_rids
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

    # ---- fast start (faststart.py) ----------------------------------------

    @property
    def compile_cache_hits(self) -> int:
        """Kernel libraries found built since THIS engine was built (a
        delta over the process-wide faststart counters)."""
        from .faststart import cache_stats

        return cache_stats()["hits"] - self._cc_base["hits"]

    @property
    def compile_cache_misses(self) -> int:
        """Kernel libraries nvcc built since this engine was built — the
        cold-spawn signature."""
        from .faststart import cache_stats

        return cache_stats()["misses"] - self._cc_base["misses"]

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
        closed_now = []
        for slot in sorted(self._slot_req):
            closed_now.append(
                self._finish_terminal(self._release_slot(slot), "failed", error=err))
        for plan in list(self._inflight_prefill):
            req = self._abort_partial(plan)
            req.group = None
            closed_now.append(self._finish_terminal(req, "failed", error=err))
        while self.pending:
            req = self.pending.popleft()
            req.group = None
            closed_now.append(self._finish_terminal(req, "failed", error=err))
        self._finished_buffer.clear()
        self._dissolve_groups()
        if self.prefix is not None:
            self.prefix.clear()
        if self.ledger is not None:
            # The last counter deltas and the close-failed classification
            # land before the observer's final registry push reads them.
            self.ledger.engine_closed(self, closed_now)
        if self._obs is not None:
            self._obs._engine_closed(self, closed_now)
            self._obs.unbind_registry()
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


@torch.inference_mode()
def cli_prompts(requests: int, prompt_len: int, vocab: int) -> list[list[int]]:
    """The CLI's request prompts, the JAX CLI's: ``PRNGKey(7)`` split
    three ways a request, a length in [1, prompt_len] and the tokens by
    ``randint`` (on the CPU: they are host data)."""
    key = prng.PRNGKey(7, device="cpu")
    prompts = []
    for _ in range(requests):
        key, k_prompt, k_len = prng.split(key, 3).unbind(0)
        plen = int(prng.randint(k_len, (), 1, prompt_len + 1))
        prompts.append([int(t) for t in prng.randint(k_prompt, (plen,), 0, vocab)])
    return prompts


def serve_batch(
    params: dict,
    config: ModelConfig,
    prompts: torch.Tensor,
    max_new_tokens: int,
    ctrl: PagePool,
    pools: tuple[torch.Tensor, torch.Tensor],
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rng: torch.Tensor | None = None,
):
    """LOCKSTEP baseline: one admission batch through the paged cache —
    prefill as a single block forward, then per-token decode steps
    (``paged_decode_step``, eager); pages are allocated on demand and
    released when the whole batch retires, also when a step raises.
    ``prompts`` [batch, P] lie on the pools' device; sampling draws token
    ``i`` under ``split(rng, max_new_tokens)[i]``.  Returns (tokens
    [batch, max_new_tokens] int64, pools), the pools updated in place."""
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 requires an rng key")
    device = pools[0].device
    keys = (prng.split(rng.to(device), max_new_tokens) if temperature > 0.0
            else [None] * max_new_tokens)
    prompts = torch.as_tensor(prompts, device=device).long()
    batch, prompt_len = prompts.shape
    total = prompt_len + max_new_tokens
    max_pages = ctrl.pages_needed(total)
    for b in range(batch):
        ctrl.allocate(("serve", b), prompt_len)
    try:
        tables = table_array(
            [ctrl.tables[("serve", b)] for b in range(batch)], max_pages,
            fill=ctrl.trash, device=device,
        )
        lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
        logits, pools = paged_prefill(
            params, pools, tables, prompts, lengths, config
        )
        tok = sample_logits(logits, keys[0], temperature, top_k, top_p)
        out = [tok]
        for step in range(1, max_new_tokens):
            pos = prompt_len + step - 1
            for b in range(batch):
                ctrl.extend(("serve", b), pos + 1)
            tables = table_array(
                [ctrl.tables[("serve", b)] for b in range(batch)], max_pages,
                fill=ctrl.trash, device=device,
            )
            logits, pools = paged_decode_step(
                params, pools, tables, tok, pos, config
            )
            tok = sample_logits(logits, keys[step], temperature, top_k, top_p)
            out.append(tok)
    finally:
        for b in range(batch):
            if ("serve", b) in ctrl.tables:
                ctrl.release(("serve", b))
    return torch.stack(out, dim=1), pools


class _RecorderDriver:
    """Duck-typed fleet-driver shim for the flight recorder: delegates
    the Fleet loop API (submit/cancel/idle/... via __getattr__) and
    polls the recorder after EVERY step — the sustained-SLO-burn
    trigger needs consecutive polls to distinguish a spike from a
    burn, and a quarantine bundle must capture the incident's ring
    state before the bounded rings evict it, neither of which a
    single end-of-run poll can do."""

    def __init__(self, inner, recorder, feed=None):
        self._inner = inner
        self._recorder = recorder
        # Optional SentryFeed (profiler.py): windowed live signals into
        # the regression sentry, polled at the recorder's cadence so a
        # perf_regression fires while the rings still hold the incident.
        self._feed = feed

    def step(self):
        finished = self._inner.step()
        if self._feed is not None:
            self._feed.poll()
        self._recorder.poll()
        return finished

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _run_fleet_cli(
    args, parser, params, config, page_size, bucket, adapters, spec_kw,
    metrics_server, schedule, replica_schedules, device,
) -> int:
    """The ``--fleet N`` serve path: N replicas behind the router, a
    seeded open-loop bursty traffic stream (optionally pushed through
    the HTTP/SSE front end), replica fault injection (per-replica
    targeting via ``SEAM@REPLICA:N``), optional self-healing
    supervision (``--supervise``), and a lifecycle summary.  Every
    engine, respawns and scale-ups included, runs on ``device``;
    replica ``i`` samples under ``PRNGKey(42 + i)`` and every respawn
    under ``PRNGKey(4242)`` (the canary's stream must repeat)."""
    from .faults import ENGINE_SEAMS, FaultInjector, REPLICA_SEAMS
    from .fleet import (
        ROLES,
        Fleet,
        FleetServer,
        TrafficGen,
        drive_open_loop,
    )

    # Disaggregated prefill/decode pools (--roles) + SLO-class weighted
    # fair queuing (--wfq): validated here so a typo fails before any
    # engine builds.
    roles = None
    if args.roles is not None:
        roles = [r.strip() for r in args.roles.split(",")]
        if len(roles) != args.fleet:
            parser.error(
                f"--roles wants one role per replica ({args.fleet}), "
                f"got {len(roles)}: {args.roles!r}"
            )
        bad = [r for r in roles if r not in ROLES]
        if bad:
            parser.error(
                f"--roles values must be from {ROLES}, got {bad}"
            )
    wfq_weights = None
    if args.wfq is not None:
        import math

        wfq_weights = {}
        for part in args.wfq.split(","):
            name, sep, weight = part.partition(":")
            name = name.strip()
            try:
                w = float(weight) if sep else 1.0
            except ValueError:
                parser.error(
                    f"--wfq wants CLASS[:WEIGHT] pairs, got {part!r}"
                )
            if not name or not math.isfinite(w) or w <= 0:
                parser.error(
                    f"--wfq wants a class name with a positive weight, "
                    f"got {part!r}"
                )
            wfq_weights[name] = w
    replica_schedules = dict(replica_schedules or {})
    fleet_schedule = {
        s: n for s, n in schedule.items() if s in REPLICA_SEAMS
    }
    engine_schedule = {
        s: n for s, n in schedule.items() if s in ENGINE_SEAMS
    }
    if set(schedule) - set(fleet_schedule) - set(engine_schedule):
        parser.error(
            f"unknown seams in --inject-fault: "
            f"{sorted(set(schedule) - set(fleet_schedule) - set(engine_schedule))}"
        )
    # The supervisor's resurrection seam and the autoscaler's scale-up
    # spawn seam: consulted by their controllers, not by the fleet's
    # step loop.
    respawn_schedule = {
        s: n for s, n in fleet_schedule.items() if s == "replica_respawn"
    }
    spawn_schedule = {
        s: n for s, n in fleet_schedule.items() if s == "scale_spawn_fail"
    }
    fleet_schedule = {
        s: n for s, n in fleet_schedule.items()
        if s not in ("replica_respawn", "scale_spawn_fail")
    }
    if respawn_schedule and not args.supervise:
        parser.error(
            "--inject-fault replica_respawn:N schedules supervised "
            "resurrection crashes; it needs --supervise"
        )
    if spawn_schedule and not args.autoscale:
        parser.error(
            "--inject-fault scale_spawn_fail:N kills autoscaler "
            "scale-up spawns; it needs --autoscale MIN:MAX"
        )
    # SEAM@REPLICA:N targeting: engine seams only (replica seams are
    # fleet-level, scheduled by crossing), and the target must exist.
    for target, sched in replica_schedules.items():
        if not 0 <= target < args.fleet:
            parser.error(
                f"--inject-fault targets replica {target}, but --fleet "
                f"has replicas 0..{args.fleet - 1}"
            )
        for seam in sched:
            if seam not in ENGINE_SEAMS:
                parser.error(
                    f"--inject-fault {seam}@{target}: only engine seams "
                    f"({', '.join(ENGINE_SEAMS)}) can target a replica; "
                    "replica seams are fleet-level crossings"
                )
    # Back-compat: untargeted engine seams land on replica 0.
    if engine_schedule:
        merged = replica_schedules.setdefault(0, {})
        for seam, hits in engine_schedule.items():
            merged.setdefault(seam, []).extend(hits)
    observers = [None] * args.fleet
    fleet_obs = None
    sup_obs = None
    if (
        args.metrics_port is not None or args.trace_out
        or args.postmortem_dir is not None
    ):
        # Any active sink (a metrics scrape, a trace file OR the flight
        # recorder's postmortem bundles) gets the FULL observer set — a
        # --trace-out --supervise run without --metrics-port must still
        # see supervisor events on the very trace it asked for; only
        # registry BINDING is port-gated.
        from .obs import EngineObserver, FleetObserver
        from .profiler import DeviceTimeTable

        observers = [
            EngineObserver(
                name=str(i), replica=str(i),
                device_table=DeviceTimeTable(),
            )
            for i in range(args.fleet)
        ]
        fleet_obs = FleetObserver()
        if args.supervise:
            from .obs import SupervisorObserver

            sup_obs = SupervisorObserver()
        if args.metrics_port is not None:
            from tpu_device_plugin.metrics import registry

            for obs in observers:
                obs.bind_registry(registry)
            fleet_obs.bind_registry(registry)
            if sup_obs is not None:
                sup_obs.bind_registry(registry)
    fleet_ledger = None
    recorder = None
    if args.ledger:
        from .ledger import ChipTimeLedger, FleetLedger, FlightRecorder

        fleet_ledger = FleetLedger()
        if args.postmortem_dir is not None:
            recorder = FlightRecorder(out_dir=args.postmortem_dir)
    sentry_feed = None
    if recorder is not None:
        # The live regression sentry rides the flight recorder: the
        # committed artifact (the port's own, measured on the card)
        # contributes the RELATIVE noise band, each detector
        # self-baselines from its first live windows, and a confirmed
        # breach fires exactly one perf_regression bundle.
        from .profiler import (
            SentryFeed,
            load_committed_artifact,
            sentry_from_artifact,
        )

        artifact = load_committed_artifact()
        if artifact:
            sentry = sentry_from_artifact(
                artifact, live=True, recorder=recorder
            )
            if sentry.signals:
                sentry_feed = SentryFeed(sentry)
                print(
                    "sentry armed: watching "
                    f"{', '.join(sentry.signals)} at the committed "
                    "artifact's noise band"
                )
    profiler = None
    if args.profile_dir is not None:
        from .profiler import ProfileSession

        profiler = ProfileSession(args.profile_dir)
    engines = []
    for i in range(args.fleet):
        engines.append(ServeEngine(
            params, config, slots=args.slots, page_size=page_size,
            prompt_bucket=bucket, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p,
            rng=prng.PRNGKey(42 + i, device=device),
            pipelined=args.pipelined,
            superstep_k=args.superstep_k,
            prefill_budget=args.prefill_budget,
            prefix_cache=args.prefix_cache, kv_offload=args.kv_offload,
            kv_host_pages=args.kv_host_pages,
            kv_disk_dir=args.kv_disk_dir,
            kv_disk_pages=args.kv_disk_pages, adapters=adapters,
            observer=observers[i],
            ledger=(
                ChipTimeLedger(name=str(i)) if args.ledger else None
            ),
            fault_injector=(
                FaultInjector(replica_schedules[i])
                if replica_schedules.get(i) else None
            ),
            max_retries=args.max_retries,
            retry_backoff_s=args.retry_backoff_s, device=device, **spec_kw,
        ))
        if recorder is not None:
            recorder.attach_engine(str(i), engines[-1])
        if sentry_feed is not None:
            sentry_feed.attach(engines[-1], observers[i])
    fleet = Fleet(
        engines,
        chip_ids=[f"chip-{i}" for i in range(args.fleet)],
        max_pending=args.max_pending, max_failovers=args.max_retries,
        fault_injector=(
            FaultInjector(fleet_schedule) if fleet_schedule else None
        ),
        # A kernel build or graph capture past each replica's exempt
        # first step (decode graphs capture on the first decode) must
        # not read as a hang.
        hang_timeout_s=60.0,
        observer=fleet_obs,
        roles=roles, wfq_weights=wfq_weights,
        ledger=fleet_ledger,
        journal_dir=args.journal_dir, journal_every=args.journal_every,
    )
    if recorder is not None:
        recorder.attach_fleet(fleet)
    if args.journal_dir is not None:
        # BEFORE any traffic (restore is a boot-time operation): a
        # journal left by the previous process resurrects its sessions
        # — interrupted streams continue exactly where they stopped.
        restored = fleet.restore()
        if restored:
            print(
                f"journal restored: {restored} session(s) from "
                f"{args.journal_dir} ({len(fleet.queue)} continuing, "
                f"{fleet.tokens_replayed} tokens replayed)"
            )
    if roles is not None:
        print(f"disaggregated pools: roles={fleet.roles()}" + (
            f", wfq={wfq_weights}" if wfq_weights else ""
        ))
    # Warm every replica (kernel build, graph capture) with one request each, off the clock
    # (two tokens on a disagg fleet, so the warm prompts hand off and
    # warm BOTH pools plus the transfer path itself).
    for i in range(args.fleet):
        fleet.submit([1 + i], 2 if roles is not None else 1,
                     session=f"warm-{i}")
    fleet.run()
    supervisor = None
    respawn_observers: list = []
    if args.supervise:
        from .backoff import Backoff
        from .supervisor import FleetSupervisor

        def respawn_factory(slot):
            # Respawns share the fleet's weights and built kernels
            # (warm restart) under a FIXED rng, so every
            # respawn's canary stream is deterministic — the half-open
            # probe's bit-identity check needs exactly that.
            obs = None
            if fleet_obs is not None and slot is not None:
                # A resurrected replica keeps reporting: its engine gets
                # its own observer (chip-slot-keyed replica label) so
                # the merged trace covers the post-revival timeline too.
                # Probe-calibration scratch engines (slot None) stay
                # unobserved.
                from .obs import EngineObserver

                obs = EngineObserver(
                    name=f"respawn-{slot.chip_id}-{slot.restarts}",
                    replica=f"respawn-{slot.chip_id}",
                )
                if args.metrics_port is not None:
                    from tpu_device_plugin.metrics import registry

                    obs.bind_registry(registry)
                respawn_observers.append(obs)
            led = None
            if args.ledger and slot is not None:
                from .ledger import ChipTimeLedger

                # The resurrected replica keeps its own books; the
                # fleet ledger adopts them when it rejoins (probe
                # tokens classify as probe_warmup pre-join).
                led = ChipTimeLedger(
                    name=f"respawn-{slot.chip_id}-{slot.restarts}"
                )
            eng = ServeEngine(
                params, config, slots=args.slots, page_size=page_size,
                prompt_bucket=bucket, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p,
                rng=prng.PRNGKey(4242, device=device),
                pipelined=args.pipelined,
                superstep_k=args.superstep_k,
                prefill_budget=args.prefill_budget,
                prefix_cache=args.prefix_cache,
                kv_offload=args.kv_offload,
                kv_host_pages=args.kv_host_pages,
                kv_disk_dir=args.kv_disk_dir,
                kv_disk_pages=args.kv_disk_pages, adapters=adapters,
                max_retries=args.max_retries, observer=obs, ledger=led,
                retry_backoff_s=args.retry_backoff_s, device=device,
                **spec_kw,
            )
            if recorder is not None and slot is not None:
                # The black box must watch the REPLACEMENT, not keep
                # reading the dead predecessor's frozen counters — a
                # quarantine on a resurrected replica is exactly what
                # a postmortem is for.
                recorder.attach_engine(
                    f"respawn-{slot.chip_id}-{slot.restarts}", eng
                )
            return eng

        supervisor = FleetSupervisor(
            fleet, respawn_factory,
            backoff=Backoff(
                base_s=args.restart_backoff_s,
                max_s=args.restart_backoff_max_s,
                seed=7,
            ),
            max_restarts=args.max_restarts,
            fault_injector=(
                FaultInjector(respawn_schedule)
                if respawn_schedule else None
            ),
            observer=sup_obs,
        )
        # Sampled engines have no dense greedy canary oracle: calibrate
        # from a scratch respawn now, so the FIRST real resurrection is
        # already held to bit-identity.
        supervisor.calibrate_probe()
        if recorder is not None:
            recorder.attach_supervisor(supervisor)
        print(
            f"supervisor armed: backoff {args.restart_backoff_s}s base "
            f"/ {args.restart_backoff_max_s}s cap, max_restarts="
            f"{args.max_restarts}, capacity-aware admission bound="
            f"{fleet.admission_bound}"
        )
    autoscaler = None
    asc_obs = None
    if args.autoscale is not None:
        from .autoscaler import FleetAutoscaler

        a_min, a_max = args.autoscale
        if args.metrics_port is not None or args.trace_out:
            from .obs import AutoscalerObserver

            asc_obs = AutoscalerObserver()
            if args.metrics_port is not None:
                from tpu_device_plugin.metrics import registry

                asc_obs.bind_registry(registry)

        def scale_factory(slot):
            # Scale-ups share the fleet's weights and built kernels
            # under a FIXED rng — the canary probe's
            # bit-identity check needs a deterministic stream.  A real
            # slot handle (scale-ups; calibration scratch engines pass
            # None) gets its own observer so the new replica's
            # timeline lands on the merged trace/registry exactly like
            # a founder's or a respawn's.
            obs = None
            if slot is not None and (
                args.metrics_port is not None or args.trace_out
            ):
                from .obs import EngineObserver

                obs = EngineObserver(
                    name=f"scaleup-{slot.chip_id}",
                    replica=f"scaleup-{slot.chip_id}",
                )
                if args.metrics_port is not None:
                    from tpu_device_plugin.metrics import registry

                    obs.bind_registry(registry)
                respawn_observers.append(obs)
            led = None
            if args.ledger and slot is not None:
                from .ledger import ChipTimeLedger

                led = ChipTimeLedger(name=f"scaleup-{slot.chip_id}")
            eng = ServeEngine(
                params, config, slots=args.slots, page_size=page_size,
                observer=obs, ledger=led,
                prompt_bucket=bucket, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p,
                rng=prng.PRNGKey(4242, device=device),
                pipelined=args.pipelined,
                superstep_k=args.superstep_k,
                prefill_budget=args.prefill_budget,
                prefix_cache=args.prefix_cache,
                kv_offload=args.kv_offload,
                kv_host_pages=args.kv_host_pages,
                kv_disk_dir=args.kv_disk_dir,
                kv_disk_pages=args.kv_disk_pages, adapters=adapters,
                max_retries=args.max_retries,
                retry_backoff_s=args.retry_backoff_s, device=device,
                **spec_kw,
            )
            if recorder is not None and slot is not None:
                recorder.attach_engine(f"scaleup-{slot.chip_id}", eng)
            return eng

        autoscaler = FleetAutoscaler(
            fleet,
            respawn_factory if args.supervise else scale_factory,
            min_replicas=a_min, max_replicas=a_max,
            supervisor=supervisor,
            # A CLI run lives seconds, not hours: a short signal
            # window lets the loop demonstrate the full up -> clear ->
            # down cycle before the exit summary prints.
            window_s=3.0,
            fault_injector=(
                FaultInjector(spawn_schedule) if spawn_schedule else None
            ),
            observer=asc_obs,
        )
        autoscaler.calibrate_probe()
        if recorder is not None:
            recorder.attach_autoscaler(autoscaler)
        print(
            f"autoscaler armed: replicas in [{a_min}, {a_max}] "
            f"(starting at {args.fleet}), brownout factor "
            f"{autoscaler.brownout_factor:g}, preempt class "
            f"{autoscaler.preempt_class!r}"
        )
    controller = None
    ctrl_obs = None
    if args.control:
        from .control import GoodputController

        if args.metrics_port is not None or args.trace_out:
            from .obs import ControlObserver

            ctrl_obs = ControlObserver()
            if args.metrics_port is not None:
                from tpu_device_plugin.metrics import registry

                ctrl_obs.bind_registry(registry)
        # The controller wraps whatever driver is already stacked
        # (autoscaler > supervisor > fleet): heal and scale land
        # before each control pass reads the ledger.
        controller = GoodputController(
            fleet, autoscaler=autoscaler,
            driver=(autoscaler or supervisor or fleet),
            observer=ctrl_obs,
        )
        print(
            "controller armed: ledger-driven retune/WFQ/waste-budget/"
            "preempt scoring (inert until the ledger accounts "
            f"{controller.min_sample_tokens}+ tokens per poll)"
        )
    # SLO-classed traffic: --slo-mix tags every arrival with a class
    # drawn from the weighted mix; attainment is scored by the fleet's
    # default interactive/bulk targets and summarized at exit.
    class_mix = None
    if args.slo_mix:
        from .fleet import DEFAULT_SLO_CLASSES

        import math

        known = {c.name for c in DEFAULT_SLO_CLASSES}
        class_mix = []
        for part in args.slo_mix.split(","):
            name, _, weight = part.partition(":")
            name = name.strip()
            try:
                w = float(weight) if weight else 1.0
            except ValueError:
                parser.error(
                    f"--slo-mix wants CLASS[:WEIGHT] pairs, got {part!r}"
                )
            if name not in known or not math.isfinite(w) or w <= 0:
                parser.error(
                    f"--slo-mix class must be one of {sorted(known)} "
                    f"with a positive weight, got {part!r}"
                )
            class_mix.append((name, w))
    traffic = TrafficGen(
        seed=7, vocab=config.vocab_size, max_prompt=args.prompt_len,
        max_new=args.max_new_tokens,
        min_new=max(1, args.max_new_tokens // 3),
        **({"class_mix": tuple(class_mix)} if class_mix else {}),
    )
    sched = (
        traffic.schedule_classed(args.requests) if class_mix
        else traffic.schedule(args.requests)
    )
    tokens0 = fleet.generated_tokens
    t0 = time.perf_counter()
    if args.http_port is not None:
        import json
        import threading
        import urllib.request

        server = FleetServer(
            fleet, args.http_port, supervisor=supervisor,
            autoscaler=autoscaler, profiler=profiler,
            controller=controller,
        )
        port = server.start()
        print(f"fleet SSE front end: http://127.0.0.1:{port}/v1/generate")
        if profiler is not None:
            print(
                f"profiler armed: POST http://127.0.0.1:{port}"
                f"/profile?secs=N (dumps -> {args.profile_dir})"
            )
        statuses: dict[str, int] = {}
        statuses_lock = threading.Lock()

        # One client thread per request: reading an SSE stream to
        # completion inline would serialize the open-loop schedule into
        # a closed loop of depth 1 and never exercise the router.
        def sse_client(prompt, new, slo_class=None):
            payload = {"prompt": prompt, "max_new_tokens": new}
            if slo_class is not None:
                payload["slo_class"] = slo_class
            body = json.dumps(payload).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/generate", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req) as resp:
                for line in resp:
                    if line.startswith(b"data: "):
                        ev = json.loads(line[6:])
                        if ev.get("done"):
                            with statuses_lock:
                                statuses[ev["status"]] = (
                                    statuses.get(ev["status"], 0) + 1
                                )

        clients = []
        t_start = time.perf_counter()
        for offset, prompt, new, *rest in sched:
            time.sleep(max(0.0, offset - (time.perf_counter() - t_start)))
            t = threading.Thread(
                target=sse_client,
                args=(prompt, new, rest[0] if rest else None),
                daemon=True,
            )
            t.start()
            clients.append(t)
        for t in clients:
            t.join()
        server.stop()
        print(f"SSE streams closed: statuses={statuses}")
    else:
        driver = fleet
        if autoscaler is not None:
            driver = autoscaler
        elif supervisor is not None:
            driver = supervisor
        if controller is not None:
            driver = controller  # built over the same stacked driver
        if recorder is not None:
            driver = _RecorderDriver(driver, recorder, sentry_feed)
        if profiler is not None:
            # No HTTP operator to trigger captures: deep-profile the
            # whole timed fleet loop (still duration/disk bounded).
            profiler.start()
        drive_open_loop(driver, sched)
        if profiler is not None:
            capture = profiler.stop() or (
                profiler.captures[-1] if profiler.captures else None
            )
            if capture is not None:
                print(
                    f"profile: {capture['bytes']} bytes over "
                    f"{capture['secs']}s -> {capture['dir']}"
                )
    if recorder is not None:
        recorder.poll()
    if supervisor is not None:
        supervisor.wait_healed(timeout_s=30.0)
    if autoscaler is not None:
        # Let the loop scale back down after the stream drains, so the
        # summary line reports the converged fleet (bounded: classed
        # overload can legitimately hold the burn window longer).
        autoscaler.wait_quiescent(timeout_s=20.0)
    elapsed = time.perf_counter() - t0
    generated = fleet.generated_tokens - tokens0
    rate = generated / elapsed if elapsed > 0 and generated else 0.0
    print(
        f"fleet done: {args.requests} requests over "
        f"{args.fleet} replicas, {generated} tokens, "
        f"≈ {rate:.0f} tok/s aggregate "
        f"(states={fleet.states()}, router dispatches="
        f"{fleet.router.dispatches}, affinity hits="
        f"{fleet.router.affinity_hits}, queue rejections="
        f"{fleet.queue_rejections})"
    )
    if fleet.kv_handoffs or fleet.wfq_dispatches:
        handoff_ms = [round(s * 1000, 2) for s in fleet.handoff_s[:8]]
        print(
            f"disagg: handoffs={fleet.kv_handoffs} "
            f"pages_transferred={fleet.handoff_pages} "
            f"handoff_ms={handoff_ms}"
            f"{'…' if len(fleet.handoff_s) > 8 else ''} "
            f"wfq_dispatches={dict(sorted(fleet.wfq_dispatches.items()))}"
        )
    if (
        fleet.replica_crashes or fleet.replica_hangs
        or fleet.failover_requeues or fleet.drain_requeues
    ):
        from collections import Counter

        statuses = Counter(r.status for r in fleet.completed)
        print(
            f"failover: crashes={fleet.replica_crashes} "
            f"hangs={fleet.replica_hangs} "
            f"charged_requeues={fleet.failover_requeues} "
            f"drain_requeues={fleet.drain_requeues} "
            f"statuses={dict(statuses)} recovery_ms="
            f"{[round(s * 1000, 1) for s in fleet.failover_recovery_s]}"
        )
    if supervisor is not None:
        print(
            f"selfheal: restarts={supervisor.restarts_total} "
            f"restart_failures={supervisor.restart_failures} "
            f"crash_loops={supervisor.crash_loops} "
            f"quarantined={supervisor.quarantined} "
            f"slots={supervisor.states()} "
            f"restore_ms={supervisor.restore_ms}"
        )
    if autoscaler is not None:
        print(
            f"autoscale: ups={autoscaler.scale_ups} "
            f"downs={autoscaler.scale_downs} "
            f"spawn_failures={autoscaler.spawn_failures} "
            f"brownouts={autoscaler.brownouts} "
            f"preemptions={autoscaler.preemptions_total} "
            f"ladder={autoscaler.ladder_level} "
            f"replicas={len(fleet.alive)}/{autoscaler.target_replicas} "
            f"[{autoscaler.min_replicas},{autoscaler.max_replicas}] "
            f"recover_ms={autoscaler.recover_ms} "
            f"overprovision_chip_s="
            f"{round(autoscaler.overprovision_chip_s, 3)}"
        )
    if controller is not None:
        gp = controller.goodput_fraction_ewma
        print(
            f"control: retunes={controller.retunes_applied} "
            f"wfq_reweights={controller.wfq_reweights} "
            f"decisions={dict(sorted(controller.decisions.items()))} "
            f"goodput_ewma="
            f"{'n/a' if gp is None else format(gp, '.3f')} "
            f"poll_s={controller.poll_s:.3f}"
        )
    if fleet_ledger is not None:
        if recorder is not None:
            recorder.poll()  # final trigger sweep before the summary
        fsnap = fleet_ledger.snapshot()
        waste = {
            k: v for k, v in sorted(fsnap["waste_tokens"].items()) if v
        }
        print(
            f"ledger: goodput={fsnap['goodput_tokens']} "
            f"waste={sum(fsnap['waste_tokens'].values())} {waste} "
            f"goodput_fraction={fsnap['goodput_fraction']:.3f} "
            f"busy_fraction={fsnap['busy_fraction']:.3f} "
            f"per_class={fsnap['per_class']} "
            f"reconcile_ok={fleet_ledger.reconcile()['ok']}"
        )
        if recorder is not None:
            import os

            print(
                f"postmortem: {len(recorder.dumped)} bundle(s) "
                f"{[os.path.basename(p) for p in recorder.dumped]} "
                f"-> {args.postmortem_dir} "
                f"(validate: python tools/postmortem.py --validate)"
            )
    armed_observers = [
        o for o in list(observers) + respawn_observers if o is not None
    ]
    if any(getattr(o, "_wall_ms", 0.0) > 0 for o in armed_observers):
        from .profiler import device_report

        rep = device_report(armed_observers)
        per_phase = {
            ph: d["device_busy_fraction"]
            for ph, d in rep["phases"].items()
        }
        print(
            f"device: busy_fraction={rep['device_busy_fraction']:.3f} "
            f"host_stall_fraction={rep['host_stall_fraction']:.3f} "
            f"per_phase={per_phase}"
        )
    if sentry_feed is not None:
        st = sentry_feed.sentry.state()
        print(
            f"sentry: armed={st['armed']} fired={st['fired']} "
            f"incidents={[i['signal'] for i in st['incidents']]}"
        )
    attainment = fleet.slo_attainment()
    if any(v is not None for v in attainment.values()):
        burn = fleet.slo_burn_rates()
        print("slo: " + " ".join(
            f"{name}={fleet.slo_attained_counts[name]}"
            f"/{fleet.slo_request_counts[name]} attained "
            f"({ratio * 100:.1f}%, burn_rate={burn[name]:.2f})"
            for name, ratio in sorted(attainment.items())
            if ratio is not None
        ))
    if args.trace_out and fleet_obs is not None:
        from .obs import export_fleet_trace

        control_events = list(
            supervisor.events if supervisor is not None else ()
        )
        if autoscaler is not None:
            # Autoscaler decisions share the supervisor trace lane —
            # one control-plane timeline, sorted so the merged lane
            # reads in wall order.
            control_events = sorted(
                control_events + list(autoscaler.events),
                key=lambda ev: ev.t,
            )
        if controller is not None:
            # Controller actuations (retunes, WFQ re-weights) join the
            # same control-plane lane.
            control_events = sorted(
                control_events + list(controller.events),
                key=lambda ev: ev.t,
            )
        n_events, n_replicas = export_fleet_trace(
            args.trace_out, fleet_obs, list(observers) + respawn_observers,
            supervisor_events=control_events,
        )
        print(
            f"fleet trace: {n_events} events covering {n_replicas} "
            f"replica lanes + router + supervisor "
            f"({len(fleet_obs.spans)} request spans, "
            f"{len(supervisor.events) if supervisor is not None else 0} "
            f"supervisor events) -> {args.trace_out}"
        )
    fleet.close()
    if metrics_server is not None:
        metrics_server.stop()
    return 0


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
    parser.add_argument("--max-pending", type=int, default=None,
                        help="bounded admission: reject (typed QueueFull) "
                        "instead of queueing more than N pending requests")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="per-request deadline in seconds; requests "
                        "still queued or running past it expire")
    parser.add_argument("--max-retries", type=int, default=2,
                        help="replay retries per request after a "
                        "quarantined step before it fails")
    parser.add_argument("--retry-backoff-s", type=float, default=0.0,
                        help="exponential host-side backoff between "
                        "consecutive quarantines (0 = none)")
    parser.add_argument("--inject-fault", action="append", default=None,
                        metavar="SEAM[@REPLICA]:N",
                        help="raise at the named seam's Nth crossing "
                        "(repeatable; engine seams: prefill_dispatch, "
                        "prefill_readback, decode_dispatch, "
                        "decode_readback, spec_dispatch, spec_readback — "
                        "quarantine and replay; with --fleet, replica "
                        "seams replica_crash / replica_hang / replica_slow "
                        "drive router failover, replica_respawn kills "
                        "supervised resurrections (--supervise), "
                        "scale_spawn_fail kills autoscaler scale-up spawns "
                        "(--autoscale), and engine seams land on replica 0 "
                        "unless targeted: SEAM@REPLICA:N, e.g. "
                        "decode_dispatch@1:3)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="expose the observer's Prometheus metrics "
                        "(beside the plugin registry) on this port's "
                        "/metrics; 0 binds an ephemeral port and prints it")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="write the run's chrome://tracing timeline "
                        "(request spans and step records) to PATH at exit; "
                        "enables the observer")
    parser.add_argument("--ledger", action="store_true",
                        help="arm the chip-time ledger (ledger.py): each "
                        "step's wall goes to a phase and each token to "
                        "goodput or a named waste class; streams are the "
                        "same on and off")
    parser.add_argument("--postmortem-dir", default=None, metavar="DIR",
                        help="arm the flight recorder (implies --ledger): "
                        "quarantines, crash loops, canary divergence and "
                        "sustained SLO burn dump a JSON postmortem bundle "
                        "into DIR (tools/postmortem.py --validate)")
    parser.add_argument("--fleet", type=int, default=None, metavar="N",
                        help="serve a fleet of N engine replicas behind the "
                        "least-loaded/affinity router (fleet.py): seeded "
                        "open-loop bursty traffic, replica failover by "
                        "replay")
    parser.add_argument("--http-port", type=int, default=None,
                        help="with --fleet: serve the HTTP/SSE front end on "
                        "this port (0 = ephemeral) and push the request "
                        "stream through it as real SSE clients")
    parser.add_argument("--roles", default=None, metavar="R0,R1,...",
                        help="with --fleet: per-replica roles from "
                        "{prefill,decode,mixed}, one per replica; fresh "
                        "prompts prefill on the prefill pool and hand "
                        "their KV to the decode pool (pair with "
                        "--kv-offload for the page transfer)")
    parser.add_argument("--wfq", default=None, metavar="CLASS:W,...",
                        help="with --fleet: SLO-class weighted fair queuing "
                        "for fresh-prompt dispatch (e.g. "
                        "interactive:3,bulk:1); default FIFO")
    parser.add_argument("--slo-mix", default=None, metavar="CLASS[:WEIGHT],...",
                        help="with --fleet: tag the traffic with SLO classes "
                        "drawn from this weighted mix; per-class attainment "
                        "and burn rates print at exit")
    parser.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                        help="with --fleet: arm the FleetAutoscaler "
                        "(autoscaler.py), resizing the fleet between MIN "
                        "and MAX replicas from its own signals; --fleet N "
                        "is the starting size and must sit in [MIN, MAX]")
    parser.add_argument("--control", action="store_true",
                        help="with --fleet and --ledger: arm the "
                        "GoodputController (control.py), which retunes "
                        "replicas and re-weights WFQ from the ledger")
    parser.add_argument("--supervise", action="store_true",
                        help="with --fleet: arm the FleetSupervisor "
                        "(supervisor.py): dead replicas respawn under "
                        "backoff and rejoin after a bit-identical canary")
    parser.add_argument("--max-restarts", type=int, default=None, metavar="N",
                        help="with --supervise: lifetime resurrection budget "
                        "per chip slot (default: unbounded)")
    parser.add_argument("--restart-backoff-s", type=float, default=0.5,
                        help="with --supervise: base delay of the "
                        "exponential restart backoff")
    parser.add_argument("--restart-backoff-max-s", type=float, default=30.0,
                        help="with --supervise: the restart backoff cap")
    parser.add_argument("--journal-dir", default=None, metavar="DIR",
                        help="with --fleet: checkpoint every session to an "
                        "atomic epoch-stamped journal under DIR, restored "
                        "before traffic on the next start")
    parser.add_argument("--journal-every", type=int, default=None,
                        metavar="STEPS",
                        help="with --journal-dir: journal every STEPS fleet "
                        "steps (default: only on close and on demand)")
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
    parser.add_argument("--profile-dir", default=None, metavar="DIR",
                        help="arm on-demand deep profiling: a bounded "
                        "torch.profiler ProfileSession (profiler.py) writes "
                        "Chrome traces of the card's kernels and every "
                        "thread's operators into DIR/profile-NNN/; a "
                        "single-engine or non-HTTP fleet run captures its "
                        "timed loop; with --fleet and --http-port the capture "
                        "is operator-triggered via POST /profile?secs=N")
    parser.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                        help="the kernel-build cache (faststart.py): each "
                        "CUDA kernel library is looked up in DIR, built "
                        "there by nvcc when missing, and reused by later "
                        "engines and processes; hit/miss counters land on "
                        "--metrics-port as engine_compile_cache_"
                        "{hits,misses}_total; streams are the same on and "
                        "off")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    args = parser.parse_args(argv)
    if args.requests < 1 or args.slots < 1:
        parser.error("--requests and --slots must be >= 1")
    if args.metrics_port is not None and not 0 <= args.metrics_port <= 65535:
        parser.error("--metrics-port must be in [0, 65535] (0 = ephemeral)")
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
    if args.postmortem_dir is not None:
        args.ledger = True  # a bundle without its ledger is half a story
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
    if args.journal_dir is not None and args.fleet is None:
        parser.error("--journal-dir checkpoints fleet sessions; it "
                     "needs --fleet N")
    if args.journal_every is not None and args.journal_dir is None:
        parser.error("--journal-every paces the --journal-dir "
                     "checkpoint cadence")
    if args.journal_every is not None and args.journal_every < 1:
        parser.error("--journal-every must be >= 1 fleet steps")
    if args.restart_backoff_s <= 0:
        parser.error("--restart-backoff-s must be > 0 seconds")
    if args.restart_backoff_max_s < args.restart_backoff_s:
        parser.error("--restart-backoff-max-s must be >= "
                     "--restart-backoff-s (the cap cannot undercut the "
                     "base)")
    if args.max_restarts is not None and args.max_restarts < 0:
        parser.error("--max-restarts must be >= 0 (omit for unbounded)")
    if args.slo_mix and args.fleet is None:
        parser.error("--slo-mix tags fleet traffic; it needs --fleet N")
    if args.autoscale is not None:
        if args.fleet is None:
            parser.error("--autoscale resizes a fleet; it needs "
                         "--fleet N (the starting size)")
        lo, sep, hi = args.autoscale.partition(":")
        if not sep or not lo.isdigit() or not hi.isdigit():
            parser.error("--autoscale wants MIN:MAX with integer "
                         f"bounds, got {args.autoscale!r}")
        args.autoscale = (int(lo), int(hi))
        if args.autoscale[0] < 1 or args.autoscale[1] < args.autoscale[0]:
            parser.error("--autoscale wants 1 <= MIN <= MAX, got "
                         f"{args.autoscale[0]}:{args.autoscale[1]}")
        if not args.autoscale[0] <= args.fleet <= args.autoscale[1]:
            parser.error(f"--fleet {args.fleet} must sit inside "
                         f"--autoscale [{args.autoscale[0]}, "
                         f"{args.autoscale[1]}]")
    if args.control:
        if args.fleet is None:
            parser.error("--control retunes a fleet; it needs --fleet N")
        if not args.ledger:
            parser.error("--control reads the chip-time ledger's "
                         "goodput/waste burn; it needs --ledger")
    schedule: dict[str, list[int]] = {}
    replica_schedules: dict[int, dict[str, list[int]]] = {}
    for spec_arg in args.inject_fault or ():
        seam, _, n = spec_arg.partition(":")
        target = None
        if "@" in seam:
            seam, _, rep_s = seam.partition("@")
            if not rep_s.isdigit():
                parser.error(
                    f"--inject-fault wants SEAM[@REPLICA]:N with an "
                    f"integer replica index, got {spec_arg!r}"
                )
            target = int(rep_s)
        if not n.isdigit() or int(n) < 1:
            parser.error(
                f"--inject-fault wants SEAM[@REPLICA]:N with N >= 1, "
                f"got {spec_arg!r}"
            )
        if target is None:
            schedule.setdefault(seam, []).append(int(n))
        else:
            replica_schedules.setdefault(target, {}).setdefault(
                seam, []
            ).append(int(n))
    if args.fleet is not None and args.fleet < 1:
        parser.error("--fleet must be >= 1 replicas")
    if args.fleet is None:
        if args.http_port is not None:
            parser.error("--http-port needs --fleet (the SSE front end is "
                         "the fleet's)")
        if args.roles is not None:
            parser.error("--roles splits a FLEET into prefill/decode "
                         "pools; it needs --fleet")
        if args.wfq is not None:
            parser.error("--wfq orders the FLEET router's dispatch; it "
                         "needs --fleet")
        if args.supervise:
            parser.error("--supervise needs --fleet (the supervisor heals "
                         "fleet replicas)")
        if replica_schedules:
            parser.error("--inject-fault SEAM@REPLICA:N targets a fleet "
                         "member; it needs --fleet")
    injector = None
    if schedule and args.fleet is None:
        from .faults import ENGINE_SEAMS, REPLICA_SEAMS, FaultInjector

        for seam in schedule:
            if seam in REPLICA_SEAMS:
                parser.error(
                    f"seam {seam!r} is a fleet-level seam; it needs "
                    "--fleet"
                )
            elif seam not in ENGINE_SEAMS:
                parser.error(
                    f"--inject-fault wants SEAM:N with a known SEAM: "
                    f"unknown seam {seam!r} (engine seams: "
                    f"{', '.join(ENGINE_SEAMS)}; replica seams — with "
                    f"--fleet: {', '.join(REPLICA_SEAMS)})"
                )
        try:
            injector = FaultInjector(schedule)
        except ValueError as e:
            parser.error(str(e))
    from . import lease

    lease.hold_claim_leases()  # mixed-strategy lifetime declaration

    device = resolve_device(args.device)
    if args.compile_cache_dir is not None:
        # Process-global, set before any engine builds so every kernel
        # library — founders, respawns, scale-ups — is looked up in (or
        # built into) DIR.
        from .faststart import enable_compile_cache

        print(f"compile cache: {enable_compile_cache(args.compile_cache_dir)}")

    config = ModelConfig(
        d_model=512, n_heads=8, n_layers=4, d_ff=2048, vocab_size=8192,
        max_seq_len=args.prompt_len + args.max_new_tokens,
        n_kv_heads=args.kv_heads,
    )
    params = cast_params(
        init_params(config, prng.PRNGKey(0, device=device)), config.dtype
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
    # Opt-in observability: the observer records spans and step records
    # for --trace-out, and --metrics-port serves its Prometheus bridge on
    # the shared plugin registry.  A fleet builds one a replica.
    observer = None
    metrics_server = None
    if args.fleet is None and (
        args.metrics_port is not None or args.trace_out
        or args.postmortem_dir is not None
    ):
        # The device-time table splits each step's wall into device-busy
        # and host-stall (StepRecord.device_ms, the engine_device_seconds
        # family and the trace's device lane).
        from .obs import EngineObserver
        from .profiler import DeviceTimeTable

        observer = EngineObserver(device_table=DeviceTimeTable())
    if args.metrics_port is not None:
        from tpu_device_plugin.metrics import MetricsServer, registry

        if observer is not None:
            observer.bind_registry(registry)
        metrics_server = MetricsServer(args.metrics_port)
        bound = metrics_server.start()
        print(f"metrics: http://127.0.0.1:{bound}/metrics")
    if args.fleet is not None:
        return _run_fleet_cli(
            args, parser, params, config, page_size, bucket, adapters,
            spec_kw, metrics_server, schedule, replica_schedules, device,
        )
    ledger = None
    recorder = None
    if args.ledger:
        from .ledger import ChipTimeLedger, FlightRecorder

        ledger = ChipTimeLedger()
        if args.postmortem_dir is not None:
            recorder = FlightRecorder(out_dir=args.postmortem_dir)
    engine = ServeEngine(
        params, config, slots=args.slots, page_size=page_size,
        prompt_bucket=bucket, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        rng=prng.PRNGKey(42, device=device),
        pipelined=args.pipelined, superstep_k=args.superstep_k,
        prefill_budget=args.prefill_budget, prefix_cache=args.prefix_cache,
        kv_offload=args.kv_offload, kv_host_pages=args.kv_host_pages,
        kv_disk_dir=args.kv_disk_dir, kv_disk_pages=args.kv_disk_pages,
        max_pending=args.max_pending, fault_injector=injector,
        max_retries=args.max_retries, retry_backoff_s=args.retry_backoff_s,
        adapters=adapters, observer=observer, ledger=ledger, device=device,
        **spec_kw,
    )
    if recorder is not None:
        recorder.attach_engine("0", engine)
    rejected = 0
    for i, prompt in enumerate(cli_prompts(args.requests, args.prompt_len,
                                           config.vocab_size)):
        # Mixed lengths: the stream the engine's slot turnover exists for.
        try:
            engine.submit(prompt, max(1, args.max_new_tokens // (1 + i % 3)),
                          adapter=names[i % len(names)], deadline_s=args.deadline_s)
        except QueueFull:
            rejected += 1

    engine.step()  # warm-up: first launches and kernel build
    profiler = None
    if args.profile_dir is not None:
        # Deep-profile the TIMED loop (warm-up excluded): the capture is
        # duration- and disk-bounded by the session.
        from .profiler import ProfileSession

        profiler = ProfileSession(args.profile_dir)
        profiler.start()
    tokens_before = engine.generated_tokens
    t0 = time.perf_counter()
    while not engine.idle:
        engine.step()
        if recorder is not None:
            recorder.poll()
    elapsed = time.perf_counter() - t0
    if profiler is not None:
        capture = profiler.stop() or (
            profiler.captures[-1] if profiler.captures else None
        )
        if capture is not None:
            print(
                f"profile: {capture['bytes']} bytes over "
                f"{capture['secs']}s -> {capture['dir']}"
            )
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
            f"prefill_tokens={engine.prefill_tokens} "
            f"prefill_padded_tokens={engine.prefill_padded_tokens}"
        )
    if (rejected or engine.steps_quarantined or engine.requests_expired
            or engine.requests_failed or args.kv_offload):
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
            + (f"rejected={rejected} " if rejected else "")
            + f"quarantined_steps={engine.steps_quarantined} "
            f"replays={engine.requests_retried} "
            f"tokens_replayed={engine.tokens_replayed} "
            f"host_sync_ms={round(engine.host_sync_s * 1000, 1)} "
            f"recoveries_ms={[round(t * 1000, 1) for t in engine.fault_recovery_s]}"
        )
    if observer is not None and getattr(observer, "_wall_ms", 0.0) > 0:
        from .profiler import device_report

        rep = device_report([observer])
        print(
            f"device: busy_fraction={rep['device_busy_fraction']:.3f} "
            f"host_stall_fraction={rep['host_stall_fraction']:.3f} "
            f"device_ms={rep['device_ms']} wall_ms={rep['wall_ms']} "
            f"table_entries={len(observer.device_table or ())}"
        )
    if ledger is not None:
        if recorder is not None:
            recorder.poll()  # final trigger sweep before the summary
        snap = ledger.snapshot()
        waste = {k: v for k, v in sorted(snap.waste_tokens.items()) if v}
        print(
            f"ledger: goodput={snap.goodput_tokens} "
            f"waste={sum(snap.waste_tokens.values())} {waste} "
            f"goodput_fraction={snap.goodput_fraction:.3f} "
            f"busy_fraction={snap.busy_fraction:.3f} "
            f"reconcile_ok={ledger.reconcile()['ok']}"
        )
        if recorder is not None:
            import os

            print(
                f"postmortem: {len(recorder.dumped)} bundle(s) "
                f"{[os.path.basename(p) for p in recorder.dumped]} "
                f"-> {args.postmortem_dir} "
                f"(validate: python tools/postmortem.py --validate)"
            )
    if args.trace_out:
        n_events = engine.export_trace(args.trace_out)
        print(
            f"trace: {n_events} events -> {args.trace_out} "
            "(load in chrome://tracing or https://ui.perfetto.dev)"
        )
    if metrics_server is not None:
        metrics_server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
