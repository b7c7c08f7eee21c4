"""The JAX package's contracts for the KV-cache hierarchy, ported to the
PyTorch port on the CPU: its tests/test_prefix_cache.py (the flat
index and the engine with it), test_kv_hierarchy.py (the radix tree,
the offload tier, streams across the cache modes and the scheduling
matrix, reclaims and quarantine), test_durable.py (the disk tier and
its page codec), the engine-level cases of test_disagg.py (gathered
spills, the park, the KV handoff), and the fan-out cases of
test_serve.py, test_chunked_prefill.py and test_batched_admission.py.
The router, WFQ and supervisor cases wait for the fleet.

torch, numpy and the port only, so it runs in the fast tier.  Streams
are held against ``generate`` on the same parameters (float32 greedy,
token for token).  The scripted runs against the JAX engine's frozen
counters are in tests/test_torch_kv_hierarchy.py.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import prng
from workloads_torch import durable
from workloads_torch.faults import FaultInjector
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.paged import (
    PagePool,
    PrefixCache,
    RadixKV,
    init_page_pools,
    read_page,
    write_page,
)
from workloads_torch.serve import ServeEngine, main

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, prng.PRNGKey(0, device="cpu"))


def _ref(params, prompt, new, config=CONFIG):
    return generate(params, torch.tensor([prompt]), config, new, device="cpu")[0].tolist()


def _engine(params, config=CONFIG, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, **kw}
    return ServeEngine(params, config, device="cpu", **kw)


def _hygiene(engine):
    assert not engine._occupied.any() and engine._committed_pages == 0
    assert not engine._inflight_prefill and engine.idle
    assert engine.ctrl.used_pages == (engine.prefix.cached_pages if engine.prefix else 0)


def _prompts(seed=5, n=4, plen=17):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, CONFIG.vocab_size, plen)] for _ in range(n)]


def _stream(params, prompts, new, oracle=False, **kw):
    """Serve ``prompts`` twice over (the second pass hits the cache);
    returns (engine, {prompt: tokens})."""
    if not oracle:
        kw.setdefault("prefix_cache", True)
    engine = _engine(params, **kw)
    rid_prompt = {}
    for p in list(prompts) + list(prompts):
        rid_prompt[engine.submit(p, new)] = tuple(p)
    served = engine.run()
    return engine, {rid_prompt[r]: t for r, t in served.items()}


# -- the prefix indexes (test_prefix_cache.py, test_kv_hierarchy.py)


def test_prefix_cache_unit_chain_and_eviction():
    ctrl = PagePool(n_pages=8, page_size=4)
    cache = PrefixCache(ctrl)
    t_a = ctrl.allocate("a", 12)
    tokens_a = list(range(12))
    cache.insert(tokens_a, t_a)
    assert cache.cached_pages == 3
    assert cache.lookup(tokens_a, 3) == t_a
    assert cache.lookup(tokens_a, 2) == t_a[:2]
    assert cache.lookup(tokens_a[:4] + [99, 98, 97, 96], 2) == t_a[:1]
    assert cache.lookup([7] * 8, 2) == []
    ctrl.release("a")
    assert ctrl.used_pages == 3
    assert cache.evict(2) == 2 and ctrl.used_pages == 1
    cache.clear()
    assert ctrl.used_pages == 0 and cache.cached_pages == 0


def test_radix_longest_prefix_shares_partial_overlaps():
    ctrl = PagePool(n_pages=8, page_size=4)
    cache = RadixKV(ctrl)
    a = list(range(12))
    t_a = ctrl.allocate("a", 12)
    cache.insert(a, t_a)
    b = a[:4] + [90, 91, 92, 93, 94, 95, 96, 97]
    ctrl.adopt("b", t_a[:1])
    ctrl.extend("b", 12)
    cache.insert(b, ctrl.tables["b"])
    assert cache.node_count == 5
    assert cache.lookup(a, 3) == t_a
    assert cache.lookup(b, 3) == ctrl.tables["b"]
    assert cache.match_depth(a) == 3 and cache.match_depth(b) == 3
    assert cache.lookup(a[:4] + [7] * 8, 3) == t_a[:1]


def test_radix_salt_partitions_key_spaces_fuzz():
    """A lookup under one salt never returns a page inserted under
    another, under random interleavings with heavy overlap."""
    rng = np.random.default_rng(17)
    ctrl = PagePool(n_pages=64, page_size=4)
    cache = RadixKV(ctrl)
    owner: dict[int, str] = {}
    salts = ["", "lora:1", "lora:2"]
    for i in range(40):
        salt = salts[int(rng.integers(3))]
        toks = [int(t) for t in rng.integers(0, 4, 8)]
        if rng.integers(2) and ctrl.free:
            seq = ("s", i)
            hit = cache.lookup(toks, 2, salt=salt)
            assert all(owner[p] == salt for p in hit)
            if hit:
                ctrl.adopt(seq, hit)
                ctrl.extend(seq, 8)
            else:
                if len(ctrl.free) < 2:
                    continue
                ctrl.allocate(seq, 8)
            cache.insert(toks, ctrl.tables[seq], salt=salt)
            for p in ctrl.tables[seq]:
                owner.setdefault(p, salt)
            ctrl.release(seq)
        else:
            assert all(owner[p] == salt for p in cache.lookup(toks, 2, salt=salt))
    cache.clear()
    assert ctrl.used_pages == 0


def _one_chain(cache_cls=RadixKV, n_pages=8, **kw):
    ctrl = PagePool(n_pages=n_pages, page_size=4)
    cache = cache_cls(ctrl, **kw)
    toks = list(range(12))
    cache.insert(toks, ctrl.allocate("a", 12))
    ctrl.release("a")
    return ctrl, cache, toks


def test_radix_lru_eviction_is_leaf_first_and_walks_up():
    ctrl, cache, toks = _one_chain()
    assert cache.evict(1) == 1
    assert cache.match_depth(toks) == 2 and ctrl.used_pages == 2
    assert cache.evict(2) == 2
    assert cache.match_depth(toks) == 0
    assert ctrl.used_pages == 0 and cache.node_count == 0


def test_radix_never_orphans_suffix_unlike_flat_lru():
    _, flat, toks = _one_chain(PrefixCache)
    flat.evict(1)
    _, radix, _ = _one_chain()
    radix.evict(1)
    assert flat.lookup(toks, 3) == [] and flat.cached_pages == 2
    assert len(radix.lookup(toks, 3, granularity=1)) == 2


def test_radix_evict_refuses_pages_with_live_refcounts():
    ctrl = PagePool(n_pages=8, page_size=4)
    cache = RadixKV(ctrl, host_pages=None)
    toks = list(range(8))
    cache.insert(toks, ctrl.allocate("a", 8))
    spilled = []
    assert cache.evict(2, spill=lambda p: spilled.append(p) or ("b",)) == 0
    assert not spilled and cache.cached_pages == 2
    ctrl.release("a")
    assert cache.evict(2, spill=lambda p: ("b",)) == 2
    assert cache.offloaded_pages == 2 and ctrl.used_pages == 0
    cache.clear()


def test_radix_host_budget_bounds_offloaded_pages():
    ctrl, cache, _ = _one_chain(host_pages=1)
    assert cache.evict(3, spill=lambda p: ("b", p)) == 3
    assert cache.offloaded_pages == 1 and cache.spills == 1
    assert ctrl.used_pages == 0


def test_radix_reload_brings_pages_back_and_insert_reanchors():
    ctrl = PagePool(n_pages=8, page_size=4)
    cache = RadixKV(ctrl, host_pages=None)
    toks = list(range(8))
    cache.insert(toks, ctrl.allocate("a", 8))
    ctrl.release("a")
    cache.evict(2, spill=lambda p: ("blob", p))
    assert cache.offloaded_pages == 2 and ctrl.used_pages == 0
    pages = cache.lookup(toks, 2, reload=lambda blob: ctrl.take_page())
    assert len(pages) == 2 and cache.reloads == 2
    assert cache.offloaded_pages == 0 and ctrl.used_pages == 2
    cache.evict(2, spill=lambda p: ("blob", p))
    cache.insert(toks, ctrl.allocate("b", 8))
    assert cache.offloaded_pages == 0 and cache.cached_pages == 2
    ctrl.release("b")
    cache.clear()
    assert ctrl.used_pages == 0


def test_radix_lookup_locks_matched_pages_against_midwalk_evict():
    ctrl, cache, toks = _one_chain(n_pages=3, host_pages=None)
    cache.evict(2, spill=lambda p: ("blob", p))
    ctrl.allocate("blocker", 8)
    assert not ctrl.free

    def reload(blob):
        cache.evict(1, spill=lambda p: ("blob2", p))
        return ctrl.take_page() if ctrl.free else None

    pages = cache.lookup(toks, 3, reload=reload)
    assert len(pages) == 1 and cache.reloads == 1
    assert ctrl.refcounts.get(pages[0]) == 1 and pages[0] not in ctrl.free
    ctrl.release("blocker")
    cache.clear()
    assert ctrl.used_pages == 0


def test_match_depth_is_readonly():
    ctrl = PagePool(n_pages=8, page_size=4)
    cache = RadixKV(ctrl)
    toks = list(range(8))
    cache.insert(toks, ctrl.allocate("a", 8))
    ctrl.release("a")
    before = (cache.hits, cache.misses, cache._clock)
    assert cache.match_depth(toks) == 2 and cache.match_depth([99] * 8) == 0
    assert (cache.hits, cache.misses, cache._clock) == before


def test_take_page_refcounts_and_exhaustion():
    ctrl = PagePool(n_pages=2, page_size=4)
    a, b = ctrl.take_page(), ctrl.take_page()
    assert ctrl.refcounts[a] == 1 and ctrl.refcounts[b] == 1 and ctrl.used_pages == 2
    with pytest.raises(RuntimeError):
        ctrl.take_page()
    ctrl.release_page(a)
    ctrl.release_page(b)
    assert ctrl.used_pages == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_page_spill_reload_roundtrip_bit_exact(dtype):
    """read_page -> host -> write_page restores the exact bytes."""
    from dataclasses import replace

    pools = init_page_pools(replace(CONFIG, dtype=dtype), 4, 4, "cpu")
    g = torch.Generator().manual_seed(0)
    k = torch.randn(pools[0][:, 1].shape, generator=g).to(dtype)
    v = torch.randn(pools[1][:, 1].shape, generator=g).to(dtype)
    write_page(pools, k, v, 1)
    hk, hv = read_page(pools, 1)
    write_page(pools, hk, hv, 3)
    out_k, out_v = read_page(pools, 3)
    assert torch.equal(out_k, k) and torch.equal(out_v, v)


def test_engine_kv_knob_validation(params):
    for kw, msg in [
        (dict(kv_offload=True), "prefix_cache"),
        (dict(prefix_cache="flat", kv_offload=True), "radix"),
        (dict(prefix_cache=True, kv_host_pages=4), "kv_host_pages"),
        (dict(prefix_cache=True, kv_offload=True, kv_host_pages=0), "kv_host_pages"),
        (dict(prefix_cache="bogus"), "prefix_cache"),
        (dict(prefix_cache=True, kv_disk_dir="x"), "kv_disk_dir"),
        (dict(prefix_cache=True, kv_offload=True, kv_disk_pages=4), "kv_disk_pages"),
    ]:
        with pytest.raises(ValueError, match=msg):
            _engine(params, **kw)


# -- the engine with a prefix cache


def test_second_request_reuses_prefix_tokens_identical(params):
    engine = _engine(params, chunk=4, prefix_cache=True)
    prompt = list(range(1, 20))  # 19 tokens: 4 full pages, bucket 8 -> 2 pages a step
    engine.submit(prompt, 8)
    engine.run()
    assert engine.prefill_tokens == 19
    r2 = engine.submit(prompt, 8)
    assert engine.run()[r2] == _ref(params, prompt, 8)
    assert engine.prefill_tokens - 19 == 3  # 16 tokens served from the cache
    assert engine.prefix.hits >= 4


def test_shared_512_token_prefix_cuts_prefill_compute():
    config = ModelConfig(max_seq_len=640, n_layers=1, dtype=torch.float32)
    p = init_params(config, prng.PRNGKey(0, device="cpu"))
    kw = dict(slots=2, page_size=16, prompt_bucket=64, chunk=16)
    engine = ServeEngine(p, config, device="cpu", prefix_cache=True, **kw)
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(0, config.vocab_size, 512)]
    engine.submit(prefix + [1, 2, 3, 4, 5, 6, 7, 8], 4)
    engine.run()
    assert engine.prefill_tokens == 520
    b = engine.submit(prefix + [11, 12, 13, 14, 15, 16, 17, 18], 4)
    served = engine.run()
    assert engine.prefill_tokens - 520 == 8
    clean = ServeEngine(p, config, device="cpu", **kw)
    b2 = clean.submit(prefix + [11, 12, 13, 14, 15, 16, 17, 18], 4)
    assert served[b] == clean.run()[b2]


def test_eviction_under_pressure_keeps_serving(params):
    """A pool sized for one request serves a stream with the cache on:
    admissions evict index-only pages, evicted prefixes re-prefill."""
    engine = _engine(params, slots=1, chunk=4, prefix_cache=True)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(0, CONFIG.vocab_size, 12)] for _ in range(3)]
    for p in prompts + prompts:
        rid = engine.submit(p, 6)
        assert engine.run()[rid] == _ref(params, p, 6)
    assert engine.ctrl.used_pages == engine.prefix.cached_pages
    engine.prefix.clear()
    assert engine.ctrl.used_pages == 0


def test_radix_streams_match_flat_and_uncached(params):
    prompts = _prompts()
    _, ref = _stream(params, prompts, 6, oracle=True)
    flat_e, flat = _stream(params, prompts, 6, prefix_cache="flat")
    radix_e, radix = _stream(params, prompts, 6, prefix_cache=True)
    assert flat == ref and radix == ref
    assert radix_e.prefix.hits > 0
    assert radix_e.prefill_tokens == flat_e.prefill_tokens


@pytest.mark.parametrize("kw", [dict(batched_admission=False), {}, dict(pipelined=True),
                                dict(prefill_budget=8), dict(superstep_k=2)],
                         ids=["serial", "batched", "pipelined", "budget", "k2"])
def test_offload_streams_bit_identical_across_engine_matrix(params, kw):
    """Streams offload on and off equal the roomy-pool oracle's under a
    pool tight enough to spill and reload."""
    prompts = _prompts()
    _, ref = _stream(params, prompts, 6, oracle=True)
    probe = _engine(params, prefix_cache=True, **kw)
    pool = probe._worst_case_pages(17, 6) + 4
    reloads = 0
    for offload in (False, True):
        engine, got = _stream(params, prompts, 6, n_pages=pool, kv_offload=offload, **kw)
        assert got == ref, offload
        reloads += engine.prefix.reloads if offload else 0
        engine.close()
        assert engine.ctrl.used_pages == 0 and engine.prefix.offloaded_pages == 0
    assert reloads > 0


def test_oversubscribed_conversations_outlive_hbm_pages(params):
    """Multi-turn conversations past the pool's capacity: the offload
    tier keeps every stream equal to a roomy pool's while pages park in
    host RAM."""
    def serve(n_pages=None, kv_offload=False):
        rng = np.random.default_rng(9)
        history = [[int(t) for t in rng.integers(0, CONFIG.vocab_size, 16)] for _ in range(4)]
        e = _engine(params, slots=1, n_pages=n_pages, prefix_cache=True, kv_offload=kv_offload)
        outs, peak = [], 0
        for _ in range(2):
            for ci in range(4):
                rid = e.submit(history[ci], 4)
                toks = e.run()[rid]
                outs.append(list(toks))
                history[ci] = history[ci] + list(toks) + [
                    int(t) for t in rng.integers(0, CONFIG.vocab_size, 8)]
                peak = max(peak, e.prefix.offloaded_pages)
        return e, outs, peak

    ref_engine, ref, _ = serve()
    e, got, peak = serve(n_pages=ref_engine._worst_case_pages(16 + 2 * 12, 4) + 4,
                         kv_offload=True)
    assert got == ref
    assert peak > 0 and e.prefix.reloads > 0
    e.close()
    assert e.ctrl.used_pages == 0 and e.prefix.offloaded_pages == 0


def test_offload_reclaim_on_cancel_and_deadline(params):
    prompts = _prompts(seed=11)
    engine, _ = _stream(params, prompts, 6, n_pages=12, kv_offload=True)
    assert engine.prefix.spills > 0
    r1 = engine.submit(prompts[0], 6)
    r2 = engine.submit(prompts[1], 6, deadline_s=1e-6)
    assert engine.cancel(r1)
    time.sleep(0.01)
    engine.run()
    statuses = {r.rid: r.status for r in engine.completed}
    assert statuses[r1] == "cancelled" and statuses[r2] == "expired"
    assert engine.ctrl.used_pages == engine.prefix.cached_pages
    engine.close()
    assert engine.ctrl.used_pages == 0 and engine.prefix.offloaded_pages == 0


def test_quarantine_flushes_offload_tier_and_replays_bit_identical(params):
    prompts = _prompts(seed=13)
    _, ref = _stream(params, prompts, 6, oracle=True)
    engine, got = _stream(params, prompts, 6, n_pages=12, kv_offload=True, max_retries=2,
                          fault_injector=FaultInjector({"prefill_dispatch": [3]}))
    assert engine.steps_quarantined >= 1 and got == ref
    assert engine.ctrl.used_pages == engine.prefix.cached_pages
    engine.close()
    assert engine.ctrl.used_pages == 0 and engine.prefix.offloaded_pages == 0


def test_disk_tier_streams_and_restart_rehydration(params, tmp_path):
    """Streams with the disk tier under pressure equal the oracle's; a
    flushed prefix rehydrates into a fresh engine from files alone and
    its continuation equals the oracle's."""
    prompts = _prompts(seed=23)
    _, ref = _stream(params, prompts, 6, oracle=True)
    kw = dict(n_pages=12, kv_offload=True, kv_host_pages=1, kv_disk_dir=str(tmp_path))
    engine, got = _stream(params, prompts, 6, **kw)
    assert got == ref
    assert engine.prefix.demotions > 0 and engine.prefix.disk_reloads > 0
    assert engine._kv_disk.write_failures == 0 and engine._kv_disk.read_corrupt == 0
    assert engine.kv_spill_s > 0 and engine.kv_reload_s > 0
    assert engine.flush_kv_to_disk(prompts[0]) == 4
    engine.close()
    fresh = _engine(params, prefix_cache=True, **kw)
    assert fresh.attach_kv_disk(prompts[0]) == 4
    rid = fresh.submit(prompts[0], 6)
    assert fresh.run()[rid] == ref[tuple(prompts[0])]
    assert fresh.prefix.disk_reloads == 4 and fresh.prefill_tokens == 1
    fresh.close()


def test_cli_kv_flags_on_cpu(capsys, tmp_path):
    assert main(["--requests", "6", "--slots", "2", "--prompt-len", "8",
                 "--max-new-tokens", "16", "--temperature", "0", "--device", "cpu",
                 "--kv-offload", "--kv-host-pages", "4", "--kv-disk-dir", str(tmp_path),
                 "--kv-disk-pages", "64"]) == 0
    out = capsys.readouterr().out
    assert "pages in use after drain:" in out and "prefix cache: hits=" in out
    assert "kv_offloads=" in out and "kv_disk_demotions=" in out
    for bad in (["--kv-host-pages", "4"], ["--kv-disk-dir", str(tmp_path)],
                ["--kv-offload", "--kv-disk-pages", "3"], ["--kv-offload", "--kv-host-pages", "0"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", *bad])


# -- the disk tier (test_durable.py)


def _blob(seed=0, dtype=torch.float32, draft=False):
    g = torch.Generator().manual_seed(seed)

    def arr():
        return torch.randn((2, 4, 8), generator=g).to(dtype)
    return ((arr(), arr()), (arr(), arr()) if draft else None)


def _blobs_equal(a, b):
    (amk, amv), ad = a
    (bmk, bmv), bd = b
    if (ad is None) != (bd is None):
        return False
    pairs = [(amk, bmk), (amv, bmv)] + (list(zip(ad, bd)) if ad is not None else [])
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in pairs)


def test_atomic_write_replaces_whole_file_and_cleans_tmp(tmp_path):
    path = str(tmp_path / "artifact.bin")
    durable.atomic_write_bytes(path, b"first generation")
    durable.atomic_write_bytes(path, b"second")
    assert open(path, "rb").read() == b"second"
    assert os.listdir(tmp_path) == ["artifact.bin"]


def test_disk_page_roundtrip_preserves_bfloat16():
    blob = _blob(seed=3, dtype=torch.bfloat16, draft=True)
    out = durable._unpack_blob(durable._pack_blob(blob))
    assert out[0][0].dtype == torch.bfloat16
    assert _blobs_equal(out, blob)


def test_unpack_rejects_damage():
    data = durable._pack_blob(_blob())
    with pytest.raises(ValueError):
        durable._unpack_blob(b"NOTMAGIC" + data[8:])
    flipped = bytearray(data)
    flipped[-1] ^= 0xFF
    with pytest.raises(ValueError):
        durable._unpack_blob(bytes(flipped))
    with pytest.raises(ValueError):
        durable._unpack_blob(data[: len(data) // 2])


def test_disk_tier_put_get_dedup_and_counters(tmp_path):
    tier = durable.KVDiskTier(str(tmp_path))
    blob = _blob(seed=1, draft=True)
    assert tier.put("ab12", blob) and tier.writes == 1
    assert tier.put("ab12", blob) and tier.writes == 1
    assert tier.dedup_hits == 1 and tier.pages == 1
    other = durable.KVDiskTier(str(tmp_path))
    assert other.contains("ab12")
    got = other.get("ab12")
    assert got is not None and _blobs_equal(got, blob) and other.reads == 1
    with pytest.raises(ValueError):
        tier.put("not-hex!", blob)
    with pytest.raises(ValueError):
        durable.KVDiskTier(str(tmp_path), budget_pages=0)


def test_disk_tier_budget_evicts_coldest_by_mtime(tmp_path):
    tier = durable.KVDiskTier(str(tmp_path), budget_pages=2)
    for i, key in enumerate(("aa", "bb", "cc")):
        tier.put(key, _blob(seed=i))
        os.utime(tier._path(key), (i + 1, i + 1))
    assert tier.pages == 2 and tier.evictions == 1
    assert not tier.contains("aa") and tier.contains("bb") and tier.contains("cc")


def test_disk_tier_corrupt_read_quarantines_to_miss(tmp_path):
    tier = durable.KVDiskTier(str(tmp_path))
    blob = _blob(seed=2)
    tier.put("0f", blob)
    with open(tier._path("0f"), "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff\xff")
    assert tier.get("0f") is None
    assert tier.read_corrupt == 1 and not tier.contains("0f")
    assert tier.put("0f", blob) and tier.writes == 2
    assert tier.get("0f") is not None


def test_disk_tier_fault_seams_degrade_not_raise(tmp_path):
    inj = FaultInjector({"kv_disk_write_fail": 1, "kv_disk_read_corrupt": 1})
    tier = durable.KVDiskTier(str(tmp_path), injector=inj)
    blob = _blob(seed=4)
    assert tier.put("e0", blob) is False and tier.write_failures == 1
    assert tier.put("e0", blob) is True
    assert tier.get("e0") is None
    assert tier.read_corrupt == 1 and not tier.contains("e0")


# -- spills and the KV handoff (test_disagg.py, engine level)


def _hand_engine(params, **kw):
    return _engine(params, **{"prompt_bucket": 4, "prefix_cache": True, "kv_offload": True, **kw})


def test_gathered_spill_bit_exact_and_single_gather(params, monkeypatch):
    from workloads_torch import serve as serve_mod

    engine = _hand_engine(params)
    prompt = [3] * 12
    engine.submit(prompt, 2)
    engine.run()
    pages = engine.prefix.lookup(prompt, 3)
    assert len(pages) == 3
    ref = [read_page(engine.pools, p) for p in pages]
    calls = []
    real = serve_mod.read_pages
    monkeypatch.setattr(serve_mod, "read_pages", lambda *a: calls.append(1) or real(*a))
    blobs = engine._spill_pages(pages)
    assert len(calls) == 1
    for (main_, draft), (rk, rv) in zip(blobs, ref):
        assert draft is None and torch.equal(main_[0], rk) and torch.equal(main_[1], rv)
    engine.close()


def test_spill_blobs_own_their_memory(params):
    engine = _hand_engine(params)
    prompt = [8] * 12
    engine.submit(prompt, 2)
    engine.run()
    for (mk, mv), draft in engine._spill_pages(engine.prefix.lookup(prompt, 3)):
        assert mk._base is None and mv._base is None and draft is None
        assert mk.untyped_storage().nbytes() == mk.numel() * mk.element_size()
    engine.close()


def test_park_spill_many_matches_serial_spill(params):
    def parked_state(batched):
        engine = _hand_engine(params)
        prompt = [4] * 16
        engine.submit(prompt, 2)
        engine.run()
        kw = dict(spill_many=engine._spill_pages) if batched else dict(spill=engine._spill_page)
        n = engine.prefix.park(prompt, **kw)
        out = (n, engine.prefix.offloaded_pages)
        rid = engine.submit(prompt, 5)
        toks = engine.run()[rid]
        engine.close()
        return out, toks

    (n_b, off_b), toks_b = parked_state(True)
    (n_s, off_s), toks_s = parked_state(False)
    assert (n_b, off_b) == (n_s, off_s) and n_b == 4
    assert toks_b == toks_s == _ref(params, [4] * 16, 5)


def test_import_kv_refuses_incompatible_tickets(params):
    src = _hand_engine(params, page_size=8, prompt_bucket=8)
    prompt = [6] * 16
    src.submit(prompt, 2)
    src.run()
    blobs = src.export_kv(prompt)
    assert blobs
    dst = _hand_engine(params)
    assert dst.import_kv(prompt, blobs) == 0 and dst.prefix.offloaded_pages == 0
    src4 = _hand_engine(params)
    src4.submit(prompt, 2)
    src4.run()
    blobs4 = src4.export_kv(prompt)
    assert dst.import_kv(prompt, blobs4, adapter="ghost") == 0
    assert dst.prefix.offloaded_pages == 0
    assert dst.import_kv(prompt, blobs4) == len(blobs4)
    for e in (src, dst, src4):
        e.close()


def test_import_kv_takes_a_served_adapters_ticket(params):
    """Beside the ghost refusal above: a ticket for an adapter the engine
    serves grafts under that adapter's salt, and the adapted request on
    the importing engine takes the handed-off pages and its own stream."""
    from workloads_torch.lora import merge_lora
    from workloads_torch.multi_lora import synthetic_adapters

    adapters = synthetic_adapters(CONFIG, 1, rank=2, seed=5, device="cpu")
    src = _hand_engine(params, adapters=adapters)
    prompt = [6] * 16
    src.submit(prompt, 2, adapter="tenant-0")
    src.run()
    blobs = src.export_kv(prompt, adapter="tenant-0")
    assert blobs
    dst = _hand_engine(params, adapters=adapters)
    assert dst.import_kv(prompt, blobs, adapter="ghost") == 0
    assert dst.import_kv(prompt, blobs, adapter="tenant-0") == len(blobs)
    assert dst.prefix.match_depth(prompt) == 0
    assert dst.prefix.match_depth(prompt, salt="lora:1") == len(blobs)
    rid = dst.submit(prompt, 5, adapter="tenant-0")
    merged = merge_lora(params, adapters["tenant-0"], dtype=torch.float32)
    assert dst.run()[rid] == _ref(merged, prompt, 5)
    assert dst.prefix.reloads > 0
    for e in (src, dst):
        e.close()


def test_graft_respects_host_budget(params):
    src = _hand_engine(params)
    prompt = [6] * 16
    src.submit(prompt, 2)
    src.run()
    blobs = src.export_kv(prompt)
    assert len(blobs) == 4
    dst = _hand_engine(params, kv_host_pages=2)
    assert dst.import_kv(prompt, blobs) == 2 and dst.prefix.offloaded_pages == 2
    rid = dst.submit(prompt, 5)
    assert dst.run()[rid] == _ref(params, prompt, 5)
    src.close()
    dst.close()


def test_handoff_continuation_forwards_only_the_tail(params):
    """A decode engine that imports a prefill engine's pages serves the
    prompt with the same stream, forwarding only the tokens past the
    grafted bucket-aligned pages."""
    prompt = list(range(3, 22))  # 19 tokens, 4 full pages
    src = _hand_engine(params, prompt_bucket=8)
    src.submit(prompt, 1)
    src.run()
    dst = _hand_engine(params, prompt_bucket=8)
    assert dst.import_kv(prompt, src.export_kv(prompt)) == 4
    assert src.kv_handoff_pages_out == dst.kv_handoff_pages_in == 4
    rid = dst.submit(prompt, 6)
    assert dst.run()[rid] == _ref(params, prompt, 6)
    assert dst.prefill_tokens == 3 and dst.prefix.reloads == 4
    assert src.export_kv([99] * 8) is None
    assert _engine(params, prefix_cache="flat").export_kv(prompt) is None
    for e in (src, dst):
        e.close()


@pytest.mark.parametrize("kw", [{}, {"pipelined": True}, {"superstep_k": 2, "pipelined": True}],
                         ids=["defaults", "pipelined", "k2-pipelined"])
def test_preempt_parks_prefix_and_resume_is_bit_identical(params, kw):
    """A preempted running request's prompt pages park in host RAM; the
    resume's lookup reloads them and recomputes only the tail, and its
    continuation completes the uninterrupted stream."""
    prompt = list(range(1, 18))  # 17 tokens: 4 full pages
    engine = _engine(params, prefix_cache=True, kv_offload=True, **kw)
    rid = engine.submit(prompt, 20)
    for _ in range(3):
        engine.step()
    got = engine.preempt(rid)
    assert got is not None and 0 < len(got.tokens) < 20
    assert engine.pages_parked == 4 and engine.prefix.offloaded_pages == 4
    assert engine.preempt_recompute_tokens == 1 + len(got.tokens)
    assert engine.retained_pages(rid) == 0.0
    rest = engine.submit(prompt + got.tokens, 20 - len(got.tokens))
    assert got.tokens + engine.run()[rest] == _ref(params, prompt, 20)
    assert engine.prefix.reloads == 4
    _hygiene(engine)


# -- fan-out groups (test_serve.py, test_chunked_prefill.py,
#    test_batched_admission.py)


def test_fanout_shares_prompt_pages_and_matches_greedy(params):
    engine = _engine(params, slots=3, prompt_bucket=12, chunk=4)
    prompt = list(range(2, 12))  # 10 tokens: 2 full shared pages + tail
    rids = engine.submit_fanout(prompt, 6, n_samples=3)
    assert not engine.step()
    assert engine.ctrl.used_pages == 2 + 3 * 2
    tables = [engine.ctrl.tables[engine._seq_id(s, engine._slot_req[s])] for s in range(3)]
    for t in tables[1:]:
        assert t[:2] == tables[0][:2] and t[2] != tables[0][2]
    assert engine.retained_pages(rids[0]) == pytest.approx(2 / 3 + 2)
    served = engine.run()
    want = _ref(params, prompt, 6)
    assert all(served[r] == want for r in rids)
    assert engine.ctrl.used_pages == 0 and engine.prefills_run == 1


def test_fanout_sampling_diverges(params):
    engine = _engine(params, slots=4, chunk=4, temperature=1.0,
                     rng=prng.PRNGKey(9, device="cpu"))
    rids = engine.submit_fanout([1, 2, 3, 4, 5], 8, n_samples=4)
    served = engine.run()
    assert len({tuple(served[r]) for r in rids}) >= 2
    assert engine.ctrl.used_pages == 0


def test_fanout_short_prompt_degrades_to_independent(params):
    engine = _engine(params, page_size=8, prompt_bucket=8, chunk=8)
    rids = engine.submit_fanout([1, 2, 3], 5, n_samples=2)
    served = engine.run()
    assert all(served[r] == _ref(params, [1, 2, 3], 5) for r in rids)
    assert engine.ctrl.used_pages == 0


def test_batched_matches_serial_fanout_groups(params):
    outs, engines = [], []
    for batched in (False, True):
        engine = _engine(params, slots=4, prompt_bucket=12, chunk=4,
                         batched_admission=batched)
        rids = engine.submit_fanout(list(range(2, 12)), 6, n_samples=3)
        rids.append(engine.submit([5, 4, 3, 2], 4))
        served = engine.run()
        outs.append([served[r] for r in rids])
        engines.append(engine)
    assert outs[0] == outs[1]
    assert engines[0].prefills_run == engines[1].prefills_run == 2
    assert engines[1].ctrl.used_pages == 0


def test_budget_fanout_streams_bit_identical(params):
    rng = np.random.default_rng(5)
    long_prompt = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 27)]
    short = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 5)]

    def run(budget):
        engine = _engine(params, slots=3, prefill_budget=budget, pipelined=True)
        rids = engine.submit_fanout(long_prompt, 6, n_samples=3)
        rids.append(engine.submit(short, 5))
        served = engine.run()
        _hygiene(engine)
        return [served[r] for r in rids]

    assert run(None) == run(8)


def test_cancel_mid_prefill_fanout_requeues_siblings_solo(params):
    rng = np.random.default_rng(12)
    long = [int(t) for t in rng.integers(0, CONFIG.vocab_size, 27)]
    engine = _engine(params, slots=3, prefill_budget=8)
    rids = engine.submit_fanout(long, 5, n_samples=2)
    engine.step()
    assert engine._inflight_prefill
    assert engine.cancel(rids[0])
    served = engine.run()
    _hygiene(engine)
    by_rid = {r.rid: r for r in engine.completed}
    assert by_rid[rids[0]].status == "cancelled" and by_rid[rids[1]].status == "ok"
    assert by_rid[rids[1]].retries == 0
    assert served[rids[1]] == _ref(params, long, 5)


def test_fanout_members_refuse_preempt_and_abandon_on_withdraw(params):
    engine = _engine(params, slots=1, chunk=4)
    rids = engine.submit_fanout(list(range(2, 12)), 12, n_samples=3)
    engine.step()
    assert engine.preempt(rids[0]) is None  # a running member
    got = engine.withdraw(rids[2])
    assert got is not None and got.group is None
    served = engine.run()
    assert served[rids[0]] == served[rids[1]] == _ref(params, list(range(2, 12)), 12)
    assert not engine._groups and engine.ctrl.used_pages == 0


def test_fanout_queue_full_is_all_or_nothing(params):
    from workloads_torch import QueueFull

    engine = _engine(params, slots=1, max_pending=2)
    with pytest.raises(QueueFull):
        engine.submit_fanout([1, 2, 3], 4, n_samples=3)
    assert not engine.pending and not engine._groups and engine.queue_rejections == 1
