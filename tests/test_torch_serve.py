"""The port's serving engine (workloads_torch.serve), torch only on the
CPU: greedy output equals the port's generate() for every request,
eos retires early, pages recycle, slot turnover beats lockstep,
long prompts prefill in chunks, back-pressure and QueueFull, requests
that can never be admitted are rejected, close() fails what is in
flight, and the CLI runs with --device cpu."""

import numpy as np
import pytest
import torch

from workloads_torch import prng
from workloads_torch import EngineClosed, InvalidRequest, QueueFull, RequestTooLarge
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.serve import ServeEngine, main

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return init_params(CONFIG, prng.PRNGKey(0, device="cpu"))


def _engine(params, config=CONFIG, **kw):
    kw = {"slots": 2, "page_size": 4, "prompt_bucket": 8, "chunk": 4, **kw}
    return ServeEngine(params, config, device="cpu", **kw)


def _mixed_requests(n, vocab=256, rng_seed=7):
    """A mixed-length stream: prompts 3..10 tokens, generations 2..24."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(3, 11))
        out.append((list(rng.integers(0, vocab, plen)), int(rng.integers(2, 25))))
    return out


def _generate(params, prompt, new, config=CONFIG):
    return generate(params, torch.tensor([prompt]), config, new, device="cpu")[0].tolist()


@pytest.mark.parametrize(
    "config",
    [
        CONFIG,
        ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, attention_window=5,
                    dtype=torch.float32),
    ],
    ids=["mha", "gqa-window"],
)
def test_engine_greedy_matches_generate(config):
    """Every request gets exactly the tokens generate() produces for it
    alone: admission order, slot turnover and chunk overshoot change
    nothing."""
    params = init_params(config, prng.PRNGKey(0, device="cpu"))
    engine = _engine(params, config, prompt_bucket=12)
    requests = _mixed_requests(5)
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    assert set(served) == set(rids)
    for rid, (prompt, new) in zip(rids, requests):
        assert served[rid] == _generate(params, prompt, new, config), rid
    assert engine.ctrl.used_pages == 0
    assert all(r.status == "ok" for r in engine.completed)


def test_engine_eos_retires_early(params):
    engine = _engine(params, slots=1)
    prompt = [1, 2, 3]
    eos = _generate(params, prompt, 20)[2]  # the 3rd token it will emit
    rid = engine.submit(prompt, 20, eos_token=eos)
    served = engine.run()
    assert served[rid][-1] == eos
    assert len(served[rid]) <= 3 + engine.chunk
    assert engine.ctrl.used_pages == 0


def test_pages_recycle_across_streams(params):
    """Three streams through a pool sized for about one: every page comes
    back after each drain."""
    engine = _engine(params, n_pages=12)
    for seed in range(3):
        for p, n in _mixed_requests(3, rng_seed=seed):
            engine.submit(p[:8], min(n, 12))
        engine.run()
        assert engine.ctrl.used_pages == 0
    assert 0 < engine.ctrl.peak_used <= 12


def test_continuous_beats_lockstep_on_mixed_stream(params):
    """A mixed-length stream needs fewer decode steps under slot turnover
    than under lockstep admission batches."""
    requests = [(list(range(3, 8)), n) for n in (2, 24, 2, 24, 2, 24)]
    engine = _engine(params)
    for p, n in requests:
        engine.submit(p, n)
    engine.run()
    lockstep = sum(max(n for _, n in requests[i:i + 2]) - 1 for i in range(0, 6, 2))
    assert engine.chunks_run * engine.chunk < lockstep


def test_chunked_prefill_serves_long_prompts(params):
    """Prompts longer than the prefill bucket admit in page-aligned chunks
    and still emit exactly generate()'s tokens."""
    engine = _engine(params)
    rng = np.random.default_rng(13)
    requests = [(list(rng.integers(0, 256, plen)), int(rng.integers(2, 12)))
                for plen in (9, 23, 37, 8)]
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    for rid, (prompt, new) in zip(rids, requests):
        assert served[rid] == _generate(params, prompt, new), rid
    assert engine.prefill_dispatches >= 5  # the 37-token prompt took 5 chunks
    assert engine.ctrl.used_pages == 0


def test_single_token_requests_finish_at_admission(params):
    engine = _engine(params)
    rids = [engine.submit([4, 5, 6], 1) for _ in range(3)]
    served = engine.run()
    assert [len(served[r]) for r in rids] == [1, 1, 1]
    assert engine.chunks_run == 0 and engine.ctrl.used_pages == 0


def test_engine_backpressure_defers_admission(params):
    """A pool with room for one worst-case request at a time serializes
    admissions instead of failing mid-stream."""
    engine = _engine(params, n_pages=8)
    requests = [(list(range(1, 8)), 20) for _ in range(3)]
    rids = [engine.submit(p, n) for p, n in requests]
    served = engine.run()
    for rid, (prompt, new) in zip(rids, requests):
        assert served[rid] == _generate(params, prompt, new)
    assert engine.ctrl.used_pages == 0 and engine.ctrl.peak_used <= 8


def test_submit_validations(params):
    engine = _engine(params, slots=1)
    engine.submit(list(range(CONFIG.max_seq_len - 1)), 1)  # at the cap
    with pytest.raises(RequestTooLarge, match="prompt length"):
        engine.submit(list(range(CONFIG.max_seq_len)), 1)
    with pytest.raises(RequestTooLarge, match="prompt length"):
        engine.submit([], 4)
    with pytest.raises(RequestTooLarge, match="max_seq_len"):
        engine.submit([1, 2], CONFIG.max_seq_len)
    with pytest.raises(InvalidRequest, match="max_new_tokens"):
        engine.submit([1, 2], 0)
    engine.submit([1, 2], 4, rid="dup")
    with pytest.raises(InvalidRequest, match="already in flight"):
        engine.submit([3, 4], 4, rid="dup")
    with pytest.raises(ValueError, match="slots"):
        _engine(params, slots=0)
    with pytest.raises(ValueError, match="multiple of page_size"):
        _engine(params, prompt_bucket=6)


def test_engine_rejects_never_admittable_request(params):
    engine = _engine(params, slots=1, n_pages=4)
    with pytest.raises(RequestTooLarge, match="never be admitted"):
        engine.submit(list(range(1, 8)), 30)


def test_queue_full_backpressure(params):
    """Bounded admission: past max_pending the engine rejects with
    QueueFull carrying a 'rejected' record, and accepts again after the
    queue drains."""
    engine = _engine(params, max_pending=2)
    engine.submit([1, 2, 3], 4)
    engine.submit([1, 2, 3], 4)
    with pytest.raises(QueueFull) as info:
        engine.submit([1, 2, 3], 4, rid="late")
    assert info.value.request.status == "rejected"
    assert info.value.request.rid == "late"
    assert engine.queue_rejections == 1
    engine.run()
    engine.submit([1, 2, 3], 4)
    assert len(engine.run()) == 1


def test_close_fails_in_flight_and_refuses_work(params):
    engine = _engine(params, slots=1)
    running = engine.submit([1, 2, 3], 20)
    queued = engine.submit([4, 5], 20)
    engine.step()  # admits the first, decodes one chunk
    engine.close()
    engine.close()  # idempotent
    statuses = {r.rid: r.status for r in engine.completed}
    assert statuses == {running: "failed", queued: "failed"}
    assert all("EngineClosed" in r.error for r in engine.completed)
    assert engine.ctrl.used_pages == 0 and engine.idle
    with pytest.raises(EngineClosed):
        engine.submit([1], 2)
    with pytest.raises(EngineClosed):
        engine.step()


def test_sampling_stream_is_seeded(params):
    """Temperature/top-k/top-p serving drains a stream, and one generator
    seed gives one stream."""
    def run(seed):
        engine = _engine(params, temperature=0.8, top_k=20, top_p=0.9,
                         rng=prng.PRNGKey(seed, device="cpu"))
        rids = [engine.submit([1, 2, 3], 6) for _ in range(3)]
        served = engine.run()
        return [served[r] for r in rids]

    first = run(3)
    assert all(len(s) == 6 and all(0 <= t < 256 for t in s) for s in first)
    assert run(3) == first


def test_completed_ring_is_bounded_and_drains(params):
    engine = _engine(params, completed_limit=2)
    for _ in range(3):
        engine.submit([1, 2], 2)
    engine.run()
    assert len(engine.completed) == 2
    assert len(engine.drain_completed()) == 2 and not engine.completed


def test_engine_needs_cuda_unless_told_cpu(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, CONFIG)


def test_cli_entry_on_cpu(capsys):
    assert main([
        "--requests", "3", "--slots", "2", "--prompt-len", "8",
        "--max-new-tokens", "4", "--temperature", "0.8", "--device", "cpu",
    ]) == 0
    assert main([
        "--requests", "2", "--slots", "2", "--prompt-len", "8",
        "--max-new-tokens", "4", "--kv-heads", "4", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out
    assert out.count("pages in use after drain: 0") == 2
    assert "kv_heads=4" in out
