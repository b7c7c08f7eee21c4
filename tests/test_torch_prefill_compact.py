"""The engine's compact prefill sweep (workloads_torch/serve.py) on the CPU.

Each chunk of a batched prefill sweep runs ``paged_prefill_chunk`` over
only the rows whose uncached span covers it, at the width their spans
need in the chunk (rounded up to a page), not over every slot at the
full prompt bucket.  torch, numpy and the port only, so it runs in the
fast tier.  Three parts:

* engine cases, tiny float32 model, four slots, bucket 8, page 4: the
  batched engine's greedy streams equal the serial engine's (batch 1
  per admission) token for token; ``prefill_dispatches`` and
  ``prefill_sweeps`` are what the [slots, bucket] sweep dispatched (one
  dispatch per chunk some row's uncached span covers); and
  ``prefill_padded_tokens`` is the sum of R x W worked out by hand in
  ``CASES``;
* the golden engine prompts at two and four slots against the JAX
  engine's frozen streams (tests/test_torch_golden.npz);
* ``paged_prefill_chunk`` itself on the same rows as a compact [R, W]
  batch and as the padded [slots, bucket] batch: first-token logits and
  the pages each row writes agree.  tests/test_torch_cuda.py runs the
  same check in bf16 on the card (``compact_against_padded``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_golden import (
    ENGINE_REQUESTS,
    GOLDEN,
    case_key,
    engine_array,
    params_to_torch,
    tiny_config,
)
from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import convert
from workloads_torch.paged import init_page_pools, paged_prefill_chunk
from workloads_torch.quant import quantize_params
from workloads_torch.serve import ServeEngine

CASE = ("f32", None, None)
SLOTS, PAGE, BUCKET = 4, 4, 8
ENGINE_KW = dict(slots=SLOTS, page_size=PAGE, prompt_bucket=BUCKET, chunk=4)
NEW = 6
# name -> (prompt lengths, extra engine options, (dispatches, sweeps,
# padded token rows)) over the whole run.  Chunk ci covers positions
# 8ci..8ci+7; W is the longest remaining span of the chunk's rows,
# rounded up to a page of 4.
CASES = {
    # ci 0: R 1, W 4.
    "one_of_four": ((3,), {}, (1, 1, 4)),
    # ci 0: R 3 (4 page-aligned, 2 and 3 not), W 4.
    "mixed_lengths": ((4, 2, 3), {}, (1, 1, 12)),
    # ci 0: R 2, W 8; ci 1: R 1, W 8; ci 2: R 1 (19 - 16 = 3), W 4.
    "multi_chunk": ((19, 3), {}, (3, 1, 28)),
    # Prompts that end on a chunk's last token: ci 0 R 3 W 8 (8 emits);
    # ci 1 R 1 W 8 (16 emits).
    "chunk_boundary": ((8, 16, 5), {}, (2, 1, 32)),
    # Warm-up sweep of the 12-token prompt: ci 0 R 1 W 8, ci 1 R 1 W 4.
    # Then a hit on its first 8 tokens (11 tokens, start page 2) beside a
    # 5-token miss: ci 0 R 1 (the miss) W 8, ci 1 R 1 (the hit) W 4.
    "prefix_hit": ((12, 11, 5), {"prefix_cache": True}, (4, 2, 24)),
    # A fan-out group of three over a 6-token prompt beside a 3-token
    # prompt: only the group's first member prefills, ci 0: R 2, W 8.
    "fanout": ((6, 3), {}, (1, 1, 16)),
    # The base, tenant-a and tenant-b: ci 0 R 3 W 8; ci 1 R 1 W 4.
    "lora": ((5, 3, 10), {"lora": True}, (2, 1, 28)),
    # One chunk a step: ci 0 R 2 W 8; ci 1 R 1 W 8; ci 2 R 1 W 4.
    "budgeted": ((19, 3), {"prefill_budget": BUCKET}, (3, 3, 28)),
    # An int8 self-draft: its pools take the same compact chunks, which
    # the target's count alone.
    "spec": ((19, 3), {"draft": True}, (3, 1, 28)),
}


@pytest.fixture(scope="module")
def params_golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def params(params_golden):
    return params_to_torch(params_golden, "params_mha", torch.float32)


def prompts(lengths) -> list[list[int]]:
    rng = np.random.default_rng(2024)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lengths]


def make_engine(params, options: dict, batched: bool) -> ServeEngine:
    config = tiny_config(CASE)
    kw = dict(ENGINE_KW, batched_admission=batched)
    if "prefix_cache" in options:
        kw["prefix_cache"] = options["prefix_cache"]
    if "prefill_budget" in options and batched:
        kw["prefill_budget"] = options["prefill_budget"]
    if options.get("lora"):
        from tests.test_torch_lora import ALPHA, numpy_adapters

        kw.update(adapters=convert.adapters_from_jax(numpy_adapters(config), device="cpu"),
                  lora_alpha=ALPHA)
    if options.get("draft"):
        kw.update(draft_params=quantize_params(params), draft_config=config)
    return ServeEngine(params, config, device="cpu", **kw)


def serve_case(engine: ServeEngine, name: str,
               adapters=(None, "tenant-a", "tenant-b")) -> list[list[int]]:
    """Drive ``CASES[name]``'s traffic to idle (the lora case under
    ``adapters``); returns the streams in submission order."""
    lengths = CASES[name][0]
    ps = prompts(lengths)
    rids: list[str] = []
    if name == "prefix_hit":
        # Warm the cache, then a hit on the first bucket beside a miss.
        rids.append(engine.submit(ps[0], NEW))
        engine.run()
        hit = ps[0][:BUCKET] + ps[1][: lengths[1] - BUCKET]
        rids += [engine.submit(hit, NEW), engine.submit(ps[2], NEW)]
    elif name == "fanout":
        rids += engine.submit_fanout(ps[0], NEW, n_samples=3)
        rids.append(engine.submit(ps[1], NEW))
    elif name == "lora":
        for p, adapter in zip(ps, adapters):
            rids.append(engine.submit(p, NEW, adapter=adapter))
    else:
        rids += [engine.submit(p, NEW) for p in ps]
    served = {}
    while not engine.idle:
        for req in engine.step():
            served[req.rid] = req.tokens
    for req in engine.completed:
        served.setdefault(req.rid, req.tokens)
    return [list(served[r]) for r in rids]


@pytest.mark.parametrize("name", list(CASES))
def test_compact_sweep_matches_the_serial_engine(params, name):
    """The batched engine's streams equal the serial engine's; its
    dispatch and sweep counts are the padded sweep's, and its padded
    token rows the hand count of R x W."""
    options, (dispatches, sweeps, padded) = CASES[name][1], CASES[name][2]
    batched = make_engine(params, options, batched=True)
    got = serve_case(batched, name)
    serial = make_engine(params, options, batched=False)
    want = serve_case(serial, name)
    assert got == want
    assert all(len(s) == NEW for s in got)
    assert (batched.prefill_dispatches, batched.prefill_sweeps,
            batched.prefill_padded_tokens) == (dispatches, sweeps, padded)
    assert batched.prefill_tokens <= batched.prefill_padded_tokens
    # The serial path pads each dispatch to the bucket.
    assert serial.prefill_padded_tokens == BUCKET * serial.prefill_dispatches
    assert batched.ctrl.used_pages == (0 if name != "prefix_hit" else
                                       batched.prefix.cached_pages)
    if name == "prefix_hit":
        assert batched.prefix.hits == serial.prefix.hits == BUCKET // PAGE  # pages
    if name == "spec":
        # The draft pools hold what the serial engine's do: same drafts
        # rejected.
        assert batched.spec_rounds > 0
        assert batched.spec_tokens_rejected == serial.spec_tokens_rejected
    if name == "fanout":
        assert got[0] == got[1] == got[2]
    if name == "lora":
        # The adapters change the adapted rows' streams, not the base row's.
        plain = serve_case(make_engine(params, {}, batched=True), name, adapters=(None,) * 3)
        assert plain[0] == got[0] and plain[1:] != got[1:]


@pytest.mark.parametrize("slots", [2, 4])
def test_compact_sweep_streams_match_jax(params_golden, params, slots):
    """The golden engine prompts (3-10 tokens, one or two chunks of 8)
    through the compact sweep at two and four slots: the JAX engine's
    frozen greedy streams token for token."""
    engine = ServeEngine(params, tiny_config(CASE), device="cpu",
                         **dict(ENGINE_KW, slots=slots))
    rids = [engine.submit(params_golden[f"input/engine_prompt{i}"],
                          int(params_golden[f"input/engine_new{i}"]))
            for i in range(ENGINE_REQUESTS)]
    served = engine.run()
    np.testing.assert_array_equal(engine_array([served[r] for r in rids]),
                                  params_golden[f"{case_key(CASE)}/engine_tokens"])
    assert engine.prefill_tokens < engine.prefill_padded_tokens
    assert engine.prefill_padded_tokens < engine.prefill_dispatches * slots * BUCKET


@pytest.mark.parametrize("options", [{}, {"lora": True}], ids=["base", "lora"])
def test_each_chunk_uploads_its_inputs_once(params, options):
    """A sweep makes one host-to-device copy a chunk: tokens, tables,
    lengths, start pages, adapter indices and the emitting rows are
    staged together."""
    engine = make_engine(params, options, batched=True)
    uploads = []
    upload = engine._dev

    def counting(mirror):
        uploads.append(mirror)
        return upload(mirror)

    for p in prompts((19, 3)):
        engine.submit(p, NEW)
    rows = engine._plan_admissions(set())
    engine._dev = counting
    engine._sweep_prefill(rows)
    assert len(uploads) == engine.prefill_dispatches == 3


# ---- paged_prefill_chunk: the compact batch against the padded batch ----

# name -> (chunk index, {slot: (prompt length, start page)}): rows that
# each cover the chunk with their uncached span.
CHUNKS = {
    "first_chunk": (0, {0: (3, 0), 2: (2, 0)}),
    "second_chunk_cached_prefix": (1, {1: (12, 0), 3: (11, 2)}),
    "full_width_one_row_continues": (1, {0: (19, 0), 1: (11, 2), 3: (16, 0)}),
}


def compact_against_padded(params, config, name: str, device) -> dict:
    """Run ``CHUNKS[name]`` through ``paged_prefill_chunk`` twice from the
    same random pools: as the engine's compact [R, W] batch and as the
    [slots, bucket] batch (rows not in the chunk at length 0 with trash
    tables).  Returns the first-token logits of the rows whose prompt
    ends in the chunk and every real page afterwards, both ways."""
    ci, rows = CHUNKS[name]
    bp = BUCKET // PAGE
    max_pages = 6
    n_pages = SLOTS * max_pages
    g = torch.Generator().manual_seed(7)
    pools = init_page_pools(config, n_pages, PAGE, device=device)
    for pool in pools:
        pool.copy_(torch.randn(pool.shape, generator=g).to(pool.dtype))
    trash = n_pages
    tok_rng = np.random.default_rng(11)
    tokens = {s: tok_rng.integers(0, 256, n) for s, (n, _) in rows.items()}
    tables = {s: [s * max_pages + j for j in range(-(-n // PAGE))]
              for s, (n, _) in rows.items()}
    start = ci * BUCKET
    slots = sorted(rows)
    W = min(BUCKET, -(-max(rows[s][0] - start for s in slots) // PAGE) * PAGE)

    def run(batch_slots, width, cover):
        t = np.full((len(batch_slots), cover), trash, np.int64)
        x = np.zeros((len(batch_slots), width), np.int64)
        lengths = np.zeros(len(batch_slots), np.int64)
        row_start = np.zeros(len(batch_slots), np.int64)
        for i, s in enumerate(batch_slots):
            if s not in rows:
                continue
            n, sp = rows[s]
            t[i, : min(cover, len(tables[s]))] = tables[s][:cover]
            span = tokens[s][start : start + min(width, n - start)]
            x[i, : len(span)] = span
            lengths[i], row_start[i] = n, sp
        ps = tuple(p.clone() for p in pools)
        logits, _ = paged_prefill_chunk(
            params, ps, torch.from_numpy(t).to(device), torch.from_numpy(x).to(device),
            torch.from_numpy(lengths).to(device), config, start_page=ci * bp,
            cover_pages=cover, emit=True, row_start=torch.from_numpy(row_start).to(device),
        )
        emitting = [i for i, s in enumerate(batch_slots)
                    if s in rows and rows[s][0] <= start + BUCKET]
        return logits[emitting].float().cpu(), tuple(p[:, :trash].float().cpu() for p in ps)

    compact = run(slots, W, ci * bp + W // PAGE)
    padded = run(list(range(SLOTS)), BUCKET, (ci + 1) * bp)
    # The chunk's columns past each row's cached prefix, up to its end.
    written = [p for s in slots
               for p in tables[s][max(ci * bp, rows[s][1]) : ci * bp + W // PAGE]]
    before = tuple(p[:, written].float().cpu() for p in pools)
    return {"width": W, "compact": compact, "padded": padded, "written": written,
            "before": before}


@pytest.mark.parametrize("name", list(CHUNKS))
def test_prefill_chunk_compact_equals_padded(params, name):
    """float32 on the CPU: the compact batch's first-token logits within
    1e-6 of the padded batch's, and the same pages written."""
    out = compact_against_padded(params, tiny_config(CASE), name, "cpu")
    (lc, pc), (lp, pp) = out["compact"], out["padded"]
    assert lc.shape[0] >= 1
    torch.testing.assert_close(lc, lp, atol=1e-6, rtol=0)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # Every page of the chunk past a row's cached prefix was written.
    for before, after in zip(out["before"], pc):
        changed = (after[:, out["written"]] != before).flatten(2).any(-1)
        assert bool(changed.any(0).all())

