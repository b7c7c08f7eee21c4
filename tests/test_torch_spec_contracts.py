"""The JAX package's speculative-decoding contracts, ported: its
tests/test_speculative.py, test_spec_sampling.py, test_spec_auto.py,
test_spec_lookahead.py and test_spec_superstep.py, as far as they need
no JAX (the LoRA, tensor-parallel, observer and fleet cases wait for
those slices), on the port's CPU route.

torch, numpy and the port only, so it runs in the fast tier.  The dense
reference is the port's own ``generate``, which tests/test_torch_golden.py
holds to the JAX package's.  Beside the contracts: the lossless rejection
rule held distributionally (``_spec_accept``'s marginal is the target's,
with the JAX test's total-variation bound and sample count), the draft
halves of a spill and a reload, the blob check's draft presence and
shape, and every validation of the engine and the CLI.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tests.test_torch_superstep import one_torch_thread  # noqa: F401
from workloads_torch import prng
from workloads_torch.faults import FaultInjector
from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.paged import _spec_accept
from workloads_torch.serve import ServeEngine, main
from workloads_torch.speculative import speculative_generate

CONFIG = ModelConfig(max_seq_len=64, n_layers=2, dtype=torch.float32)
DRAFT_CONFIG = ModelConfig(max_seq_len=64, n_layers=1, d_model=32, n_heads=2, d_ff=64,
                           dtype=torch.float32)
STREAMS = [([3, 1, 4, 1, 5], 17), ([2, 7], 9), ([9] * 11, 13)]


@pytest.fixture(scope="module")
def models():
    return (init_params(CONFIG, prng.PRNGKey(0, device="cpu")),
            init_params(DRAFT_CONFIG, prng.PRNGKey(7, device="cpu")))


def _ref(params, prompt, new, config=CONFIG):
    return [int(t) for t in generate(params, [prompt], config, new, device="cpu")[0]]


def _engine(models, **kw):
    params, draft = models
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("prompt_bucket", 8)
    kw.setdefault("draft_params", draft)
    kw.setdefault("draft_config", DRAFT_CONFIG)
    kw.setdefault("gamma", 3)
    return ServeEngine(params, CONFIG, device="cpu", **kw)


def _serve(models, streams=STREAMS, **kw):
    engine = _engine(models, **kw)
    rids = [engine.submit(p, n) for p, n in streams]
    served = engine.run()
    return [served[rid] for rid in rids], engine


# ---- speculative_generate (test_speculative.py) ---------------------------

def test_matches_target_greedy_exactly(models):
    """A random, often disagreeing draft still reproduces the target's
    greedy output token for token."""
    target, draft = models
    prompt = torch.randint(0, CONFIG.vocab_size, (1, 6), generator=torch.Generator().manual_seed(1))
    want = generate(target, prompt, CONFIG, 20, device="cpu")
    got, rounds = speculative_generate(target, draft, prompt, CONFIG, DRAFT_CONFIG, 20,
                                       gamma=3, device="cpu")
    assert torch.equal(got, want)
    assert 1 <= rounds <= 20


def test_self_draft_accepts_everything(models):
    target, _ = models
    prompt = torch.ones((1, 4), dtype=torch.long)
    max_new, gamma = 17, 3
    want = generate(target, prompt, CONFIG, max_new, device="cpu")
    got, rounds = speculative_generate(target, target, prompt, CONFIG, CONFIG, max_new,
                                       gamma=gamma, device="cpu")
    assert torch.equal(got, want)
    # The prefill commits 1; each round then commits gamma + 1.
    assert rounds == 1 + -(-(max_new - 1) // (gamma + 1))


@pytest.mark.parametrize("gamma", [1, 2, 5])
def test_gamma_sweep_stays_lossless(models, gamma):
    target, draft = models
    prompt = torch.zeros((1, 3), dtype=torch.long)
    want = generate(target, prompt, CONFIG, 12, device="cpu")
    got, _ = speculative_generate(target, draft, prompt, CONFIG, DRAFT_CONFIG, 12,
                                  gamma=gamma, device="cpu")
    assert torch.equal(got, want)


def test_speculative_generate_validation(models):
    target, draft = models
    z = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="batch-1"):
        speculative_generate(target, draft, torch.zeros((2, 4), dtype=torch.long), CONFIG,
                             DRAFT_CONFIG, 4, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(target, draft, z, CONFIG, DRAFT_CONFIG, 4, gamma=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        speculative_generate(target, draft, z, CONFIG, DRAFT_CONFIG, 60, device="cpu")
    small_vocab = ModelConfig(max_seq_len=64, vocab_size=128, dtype=torch.float32)
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(target, init_params(small_vocab, prng.PRNGKey(0, device="cpu")),
                             z, CONFIG, small_vocab, 4, device="cpu")


# ---- the rejection rule (test_spec_sampling.py) ---------------------------

def test_spec_accept_marginal_matches_target_distribution():
    """The committed first token's marginal is exactly p however bad q
    is: 4000 draws on a small vocabulary where q and p disagree, total
    variation inside sampling noise, and every acceptance length seen."""
    vocab, gamma, trials = 5, 2, 4000
    q_dist = torch.tensor([0.70, 0.10, 0.10, 0.05, 0.05])
    p_dist = torch.tensor([0.10, 0.40, 0.20, 0.20, 0.10])
    g = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(q_dist.expand(trials * gamma, vocab), 1, replacement=True,
                               generator=g).reshape(trials, gamma)
    q = q_dist.expand(trials, gamma, vocab)
    p = p_dist.expand(trials, gamma + 1, vocab)
    committed, n = _spec_accept(drafts, q, p, prng.PRNGKey(0, device="cpu"))
    counts = np.bincount(committed[:, 0].numpy(), minlength=vocab) / trials
    assert np.abs(counts - p_dist.numpy()).sum() < 0.06, counts
    assert set(n.tolist()) == {0, 1, 2}


def test_spec_accept_identical_distributions_accept_everything():
    vocab, gamma, batch = 7, 3, 4
    g = torch.Generator().manual_seed(1)
    dist = torch.softmax(torch.randn((batch, vocab), generator=g), dim=-1)
    q = dist[:, None].expand(batch, gamma, vocab)
    p = dist[:, None].expand(batch, gamma + 1, vocab)
    drafts = torch.multinomial(dist, gamma, replacement=True, generator=g)
    committed, n = _spec_accept(drafts, q, p, prng.PRNGKey(1, device="cpu"))
    assert bool((n == gamma).all())
    assert torch.equal(committed[:, :gamma], drafts)


def test_spec_accept_certain_rejection_resamples_from_residual():
    """q on token 0, p on token 1: the draft is always rejected and the
    correction comes from the residual, token 1."""
    vocab, gamma = 4, 1
    q = torch.tensor([1.0, 0.0, 0.0, 0.0])[None, None]
    p = torch.tensor([0.0, 1.0, 0.0, 0.0]).expand(1, gamma + 1, vocab)
    drafts = torch.zeros((1, gamma), dtype=torch.long)
    for seed in range(5):
        committed, n = _spec_accept(drafts, q, p, prng.PRNGKey(seed, device="cpu"))
        assert int(n[0]) == 0 and int(committed[0, 0]) == 1


def test_greedy_spec_tokens_unchanged_by_sampling_support(models):
    params, _ = models
    engine = _engine(models)
    rid = engine.submit([3, 1, 4, 1, 5], 12)
    assert engine.run()[rid] == _ref(params, [3, 1, 4, 1, 5], 12)


def test_sampling_spec_self_draft_accepts_every_round(models):
    """draft == target at temperature 1: p == q at every position, so a
    round commits gamma + 1 tokens."""
    params, _ = models
    gamma, new = 3, 1 + 2 * 4  # the first token and two full rounds
    engine = ServeEngine(params, CONFIG, device="cpu", slots=1, page_size=4, prompt_bucket=8,
                         draft_params=params, draft_config=CONFIG, gamma=gamma,
                         temperature=1.0, rng=prng.PRNGKey(11, device="cpu"))
    rid = engine.submit([5, 2, 9], new)
    assert len(engine.run()[rid]) == new
    assert engine.spec_rounds == 2, engine.spec_rounds


@pytest.mark.parametrize("kw", [dict(temperature=0.9, top_k=40),
                                dict(temperature=0.8, pipelined=True),
                                dict(temperature=0.8, top_k=40, spec_lookahead=2),
                                dict(temperature=0.8, top_p=0.9, spec_superstep_k=3)],
                         ids=["top_k", "pipelined", "lookahead", "superstep"])
def test_sampling_spec_real_draft_structurally_sound(models, kw):
    """A disagreeing draft at temperature > 0: every request gets exactly
    its budget, tokens stay in the vocabulary, the pool drains."""
    engine = _engine(models, rng=prng.PRNGKey(5, device="cpu"), **kw)
    rids = [engine.submit([1 + i, 2, 3], 9 + i) for i in range(3)]
    served = engine.run()
    for i, rid in enumerate(rids):
        assert len(served[rid]) == 9 + i
        assert all(0 <= t < CONFIG.vocab_size for t in served[rid])
    assert engine.ctrl.used_pages == 0


# ---- the paged round, its chained form and its phase probes -------------

def _round_inputs(models):
    from workloads_torch.paged import init_page_pools, paged_prefill_chunk

    params, draft = models
    g = torch.Generator().manual_seed(4)
    lengths = torch.tensor([5, 9, 2], dtype=torch.int32)
    tables = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    prompts = torch.randint(0, CONFIG.vocab_size, (3, 8), generator=g)
    t_pools = init_page_pools(CONFIG, 12, 4, device="cpu")
    d_pools = init_page_pools(DRAFT_CONFIG, 12, 4, device="cpu")
    paged_prefill_chunk(params, t_pools, tables, prompts, lengths, CONFIG, 0, 2, False)
    paged_prefill_chunk(draft, d_pools, tables, prompts, lengths, DRAFT_CONFIG, 0, 2, False)
    cur = torch.randint(0, CONFIG.vocab_size, (3,), generator=g)
    return t_pools, d_pools, tables, cur, lengths.long()


def _clone(pools):
    return tuple(p.clone() for p in pools)


def test_chained_round_equals_the_round_and_parks_rows_at_zero(models):
    from workloads_torch.paged import paged_spec_round, paged_spec_round_chained

    params, draft = models
    t_pools, d_pools, tables, cur, pos = _round_inputs(models)
    c, n, *_ = paged_spec_round(params, draft, _clone(t_pools), _clone(d_pools), tables, cur,
                                pos, CONFIG, DRAFT_CONFIG, 3)
    occ = torch.tensor([True, True, False])
    cc, nc, new_cur, new_pos, *_ = paged_spec_round_chained(
        params, draft, _clone(t_pools), _clone(d_pools), tables, cur, pos, occ, CONFIG,
        DRAFT_CONFIG, 3)
    assert torch.equal(cc[:2], c[:2]) and torch.equal(nc[:2], n[:2])
    assert new_pos.tolist()[:2] == (pos[:2] + n[:2] + 1).tolist() and int(new_pos[2]) == 0
    assert new_cur.tolist()[:2] == [int(c[i, n[i]]) for i in range(2)]
    assert int(new_cur[2]) == int(cur[2])


def test_phase_probes_compose_to_the_fused_round(models):
    """Draft, verify and commit run one after another from the same
    state give the fused greedy round's committed tokens and n."""
    from workloads_torch.paged import (
        paged_spec_draft_phase,
        paged_spec_round,
        paged_spec_verify_phase,
        spec_commit_phase,
    )

    params, draft = models
    t_pools, d_pools, tables, cur, pos = _round_inputs(models)
    want_c, want_n, *_ = paged_spec_round(params, draft, _clone(t_pools), _clone(d_pools),
                                          tables, cur, pos, CONFIG, DRAFT_CONFIG, 3, 4)
    drafts, last, _ = paged_spec_draft_phase(draft, d_pools, tables, cur, pos, DRAFT_CONFIG, 3,
                                             4)
    assert drafts.shape == (3, 3) and last.shape == (3,)
    block = torch.cat([cur[:, None], drafts], dim=1)
    picks, _ = paged_spec_verify_phase(params, t_pools, tables, block, pos, CONFIG, 4)
    committed, n = spec_commit_phase(drafts, picks)
    assert torch.equal(committed, want_c) and torch.equal(n, want_n)


# ---- spec="auto" (test_spec_auto.py) --------------------------------------

def test_mode_switches_when_occupancy_crosses_threshold(models):
    params, _ = models
    engine = _engine(models, slots=3, spec="auto", spec_breakeven=1.5)
    expected = {engine.submit(p, n): (p, n) for p, n in (([5, 6, 7], 24), ([1, 2], 6), ([9], 4))}
    out = engine.run()
    assert engine.plain_mode_steps > 0 and engine.spec_mode_steps > 0
    assert engine.mode_switches >= 1
    for occ, mode in engine.decode_mode_trace:
        assert (mode == "spec") == (occ <= 1.5), (occ, mode)
    for rid, (p, n) in expected.items():
        assert out[rid] == _ref(params, p, n), rid


def test_threshold_extremes_reduce_to_the_pure_engines(models):
    params, _ = models
    prompts = [([1, 2, 3], 8), ([4, 5], 8)]

    def run(breakeven):
        got, engine = _serve(models, prompts, spec="auto", spec_breakeven=breakeven)
        return engine, got

    never, toks_never = run(0.0)
    assert never.spec_mode_steps == 0 and never.spec_rounds == 0
    assert never.plain_mode_steps > 0 and never.chunks_run > 0
    always, toks_always = run(2.0)
    assert always.plain_mode_steps == 0 and always.chunks_run == 0
    assert always.spec_mode_steps > 0 and always.spec_rounds > 0
    assert toks_never == toks_always
    for (p, n), got in zip(prompts, toks_never):
        assert got == _ref(params, p, n)


def test_admissions_straddling_a_switch(models):
    """Fan-out and prefix-cache admissions on both sides of mode switches
    (pipelined, so the boundary drains real work in flight)."""
    params, _ = models
    engine = _engine(models, spec="auto", spec_breakeven=1.0, prefix_cache=True,
                     pipelined=True)
    prefix = list(range(10, 22))
    expected = {engine.submit(prefix + [1], 40): (prefix + [1], 40),
                engine.submit(prefix + [2], 8): (prefix + [2], 8)}
    for rid in engine.submit_fanout([3, 4, 5], 6, n_samples=2):
        expected[rid] = ([3, 4, 5], 6)
    out = engine.run()
    assert set(out) == set(expected)
    assert engine.mode_switches >= 1
    for rid, (p, n) in expected.items():
        assert out[rid] == _ref(params, p, n), rid


def test_lookahead_composes_with_auto(models):
    params, _ = models
    engine = _engine(models, spec="auto", spec_breakeven=1.0, spec_lookahead=2, pipelined=True)
    expected = {engine.submit(p, n): (p, n) for p, n in (([7, 8, 9], 16), ([2, 3], 6))}
    out = engine.run()
    for rid, (p, n) in expected.items():
        assert out[rid] == _ref(params, p, n), rid
    assert engine.spec_mode_steps > 0 and engine.plain_mode_steps > 0


@pytest.mark.parametrize("k", [1, 3])
def test_calibration_path(models, k):
    """No threshold given: the engine calibrates at its first decode step
    (a binary verdict), records the timings under a private key (the
    engine's key is untouched), and serves the reference stream."""
    params, _ = models
    engine = _engine(models, spec="auto", spec_superstep_k=k)
    assert engine.spec_breakeven is None
    rid = engine.submit([1, 2, 3], 6)
    state = engine._rng.clone()
    out = engine.run()
    assert engine.spec_breakeven in (0.0, 2.0)
    assert engine.spec_calibration["threshold"] == engine.spec_breakeven
    assert engine.spec_calibration["plain_dispatch_ms"] > 0
    assert engine.spec_calibration["spec_dispatch_ms"] > 0
    assert torch.equal(engine._rng, state)
    assert out[rid] == _ref(params, [1, 2, 3], 6)
    assert engine.ctrl.used_pages == 0


def test_injected_calibration_is_adopted(models):
    engine = _engine(models, spec="auto", spec_calibration={"threshold": 2.0})
    rid = engine.submit([1, 2, 3], 6)
    engine.run()
    assert engine.spec_breakeven == 2.0 and engine.calibration_reused == 1
    assert engine.spec_calibration == {"threshold": 2.0}
    assert len(engine.completed) == 1 and engine.completed[0].rid == rid


# ---- lookahead (test_spec_lookahead.py) -----------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_lookahead_greedy_matches_dense_reference(models, k):
    params, _ = models
    got, engine = _serve(models, spec_lookahead=k)
    for row, (p, n) in zip(got, STREAMS):
        assert row == _ref(params, p, n), k
    assert engine.ctrl.used_pages == 0


def test_lookahead_fewer_host_syncs_same_rounds(models):
    params, _ = models
    ref = _ref(params, [5, 2, 9], 25)
    steps = {}
    for k in (1, 3):
        engine = _engine(models, slots=1, spec_lookahead=k)
        rid = engine.submit([5, 2, 9], 25)
        n_steps, served = 0, {}
        while not engine.idle:
            for req in engine.step():
                served[req.rid] = req.tokens
            n_steps += 1
        steps[k] = n_steps
        assert served[rid] == ref, k
    assert steps[3] < steps[1], steps


@pytest.mark.parametrize("kw", [dict(spec_lookahead=3), dict(spec_superstep_k=4)],
                         ids=["lookahead", "superstep"])
def test_eos_retires_with_the_exact_stop(models, kw):
    """A request hitting eos mid-dispatch retires with exactly the
    reference's prefix through its eos; later rounds are dead compute."""
    params, _ = models
    prompt, new = [3, 1, 4, 1, 5], 16
    full = _ref(params, prompt, new)
    eos = full[new // 2]
    want = full[: full.index(eos) + 1]
    engine = _engine(models, **kw)
    rid = engine.submit(prompt, new, eos_token=eos)
    assert engine.run()[rid] == want
    assert engine.ctrl.used_pages == 0


def test_lookahead_composes_with_pipelined(models):
    params, _ = models
    streams = [([1, 2, 3], 15), ([6, 5], 11), ([7] * 5, 8)]
    got, engine = _serve(models, streams, spec_lookahead=2, pipelined=True)
    for row, (p, n) in zip(got, streams):
        assert row == _ref(params, p, n)
    assert engine.ctrl.used_pages == 0


# ---- chained spec supersteps (test_spec_superstep.py) ---------------------

@pytest.mark.parametrize("k", [2, 3, 5])
def test_spec_superstep_greedy_matches_dense_reference(models, k):
    params, _ = models
    got, engine = _serve(models, spec_superstep_k=k)
    for row, (p, n) in zip(got, STREAMS):
        assert row == _ref(params, p, n), k
    assert engine.spec_rounds == engine.spec_supersteps_run * k
    assert engine.ctrl.used_pages == 0


@pytest.mark.parametrize("mode_kw", [
    dict(pipelined=True), dict(batched_admission=False), dict(prefill_budget=8),
    dict(prefix_cache=True, kv_offload=True), dict(spec="auto", spec_breakeven=1.0),
], ids=["pipelined", "serial", "budget", "offload", "auto"])
def test_spec_superstep_bit_identical_across_modes(models, mode_kw):
    want, _ = _serve(models, **mode_kw)
    got, engine = _serve(models, spec_superstep_k=3, **mode_kw)
    assert got == want
    engine.close()
    assert engine.ctrl.used_pages == 0


def test_spec_superstep_sampled_bit_identical_to_k1(models):
    """The draws run round by round from one key a round, so sampled
    streams, not only greedy ones, are the same for every k on a stream
    without slot turnover."""
    streams = [([3, 1, 4, 1, 5], 12), ([2, 7], 9)]
    served = {}
    for k in (1, 2, 4):
        served[k], engine = _serve(models, streams, spec_superstep_k=k, temperature=0.8,
                                   top_k=40, rng=prng.PRNGKey(5, device="cpu"))
        assert engine.ctrl.used_pages == 0, k
    assert served[2] == served[1] and served[4] == served[1]


def test_spec_superstep_overdecode_bounded_and_reconciled(models):
    params, _ = models
    k = 4
    got, engine = _serve(models, spec_superstep_k=k)
    for row, (p, n) in zip(got, STREAMS):
        assert row == _ref(params, p, n)
    # Each retiring row wastes less than one superstep's committed capacity.
    assert engine.tokens_overdecoded <= len(STREAMS) * k * (engine.gamma + 1)
    assert engine.ctrl.used_pages == 0


@pytest.mark.parametrize("pipelined", [False, True])
def test_spec_superstep_tight_pool_precommit_never_faults(models, pipelined):
    params, _ = models
    sizer = _engine(models, slots=1, spec_superstep_k=4, pipelined=pipelined)
    new = CONFIG.max_seq_len - 3
    tight = _engine(models, slots=1, spec_superstep_k=4, pipelined=pipelined,
                    n_pages=sizer._worst_case_pages(3, new))
    rid = tight.submit([5, 2, 9], new)
    assert tight.run()[rid] == _ref(params, [5, 2, 9], new)
    assert tight.ctrl.used_pages == 0


def test_spec_superstep_cancel_and_deadline_reclaim(models):
    params, _ = models
    engine = _engine(models, spec_superstep_k=2, pipelined=True)
    r1 = engine.submit([3, 1, 4], 30)
    r2 = engine.submit([2, 7], 30)
    engine.step()
    engine.step()  # a chained spec superstep is in flight
    assert engine._pending_spec is not None
    assert engine.cancel(r1)
    served = engine.run()
    statuses = {r.rid: r.status for r in engine.completed}
    assert statuses[r1] == "cancelled" and statuses[r2] == "ok"
    assert served[r1] == _ref(params, [3, 1, 4], 30)[: len(served[r1])]
    assert served[r2] == _ref(params, [2, 7], 30)
    assert engine.ctrl.used_pages == 0

    engine = _engine(models, slots=1, spec_superstep_k=2)
    rd = engine.submit([1, 2, 3], 40, deadline_s=0.05)
    engine.step()
    time.sleep(0.08)
    engine.run()
    assert {r.rid: r.status for r in engine.completed}[rd] == "expired"
    assert engine.ctrl.used_pages == 0


@pytest.mark.parametrize("seam", ["spec_dispatch", "spec_readback"])
@pytest.mark.parametrize("kw", [dict(spec_superstep_k=2), dict(spec_superstep_k=2, pipelined=True),
                                dict(spec_lookahead=2, pipelined=True), dict()],
                         ids=["superstep", "superstep_piped", "lookahead_piped", "round"])
def test_spec_quarantine_drops_and_replays_bit_identical(models, seam, kw):
    params, _ = models
    engine = _engine(models, fault_injector=FaultInjector({seam: [2]}), max_retries=2, **kw)
    rids = [engine.submit(p, n) for p, n in STREAMS]
    served = engine.run()
    for rid, (p, n) in zip(rids, STREAMS):
        assert served[rid] == _ref(params, p, n), seam
    assert engine.steps_quarantined == 1
    assert engine._pending_spec is None
    assert engine.ctrl.used_pages == 0


def test_spec_superstep_close_reclaims_in_flight(models):
    engine = _engine(models, spec_superstep_k=3, pipelined=True)
    rid = engine.submit([5, 5], 40)
    engine.step()
    engine.step()
    engine.close()
    assert {r.rid: r.status for r in engine.completed}[rid] == "failed"
    assert engine._pending_spec is None and engine.idle
    assert engine.ctrl.used_pages == 0


def test_retune_walks_the_spec_knobs_with_identical_streams(models):
    want, _ = _serve(models)
    engine = _engine(models, spec_superstep_k=3, spec="auto", spec_breakeven=2.0)
    rids = [engine.submit(p, n) for p, n in STREAMS]
    served, walk = {}, [dict(spec_superstep_k=1), dict(spec_breakeven=0.0),
                        dict(spec_breakeven=2.0, spec_superstep_k=2), dict(spec_superstep_k=3)]
    while not engine.idle:
        if walk:
            assert engine.retune(**walk.pop(0))
        for req in engine.step():
            served[req.rid] = req.tokens
    assert [served[r] for r in rids] == want
    assert engine.retunes == 4 and engine.retune(spec_superstep_k=3) == {}
    with pytest.raises(ValueError, match="construction-time ceiling"):
        engine.retune(spec_superstep_k=4)
    with pytest.raises(ValueError, match="spec_breakeven must be >= 0"):
        engine.retune(spec_breakeven=-1.0)
    with pytest.raises(ValueError, match='spec_breakeven retune needs spec="auto"'):
        _engine(models).retune(spec_breakeven=1.0)


# ---- the draft halves of the KV hierarchy ---------------------------------

def test_spill_gathers_both_halves_as_single_spills_do(models):
    """A 4-page gathered spill equals 4 single spills, draft halves
    included, and a reload writes both halves back."""
    engine = _engine(models, prefix_cache=True, kv_offload=True)
    for pools in (engine.pools, engine.d_pools):
        for pool in pools:
            pool.copy_(torch.randn(pool.shape, generator=torch.Generator().manual_seed(3)))
    pages = [3, 0, 7, 5]
    many = engine._spill_pages(pages)
    for page, blob in zip(pages, many):
        one = engine._spill_page(page)
        assert blob[1] is not None and one[1] is not None
        for a, b in zip((*blob[0], *blob[1]), (*one[0], *one[1])):
            assert torch.equal(a, b)
    page = engine._reload_page(many[2])
    for pools, half in ((engine.pools, many[2][0]), (engine.d_pools, many[2][1])):
        assert torch.equal(pools[0][:, page], half[0]) and torch.equal(pools[1][:, page], half[1])


def test_blob_check_wants_the_draft_half_in_presence_and_shape(models):
    params, _ = models
    spec = _engine(models, prefix_cache=True, kv_offload=True)
    plain = ServeEngine(params, CONFIG, device="cpu", slots=2, page_size=4, prompt_bucket=8,
                        prefix_cache=True, kv_offload=True)
    with_draft = spec._spill_page(0)
    without = plain._spill_page(0)
    assert spec._blob_compatible(with_draft) and plain._blob_compatible(without)
    assert not spec._blob_compatible(without)
    assert not plain._blob_compatible(with_draft)
    wrong = (with_draft[0], (with_draft[1][0][:, :1], with_draft[1][1][:, :1]))
    assert not spec._blob_compatible(wrong)
    prompt = list(range(1, 10))
    assert spec.import_kv(prompt, [without]) == 0


def test_handoff_between_spec_engines_serves_the_reference(models):
    params, _ = models
    src = _engine(models, prefix_cache=True, kv_offload=True)
    dst = _engine(models, prefix_cache=True, kv_offload=True)
    prompt = list(range(20, 33))
    src.submit(prompt, 1)
    src.run()
    assert dst.import_kv(prompt, src.export_kv(prompt)) > 0
    rid = dst.submit(prompt, 10)
    assert dst.run()[rid] == _ref(params, prompt, 10)
    assert dst.prefix.reloads > 0


# ---- validations of the engine and the CLI --------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(draft_params="d"), "draft_params and draft_config come together"),
    (dict(draft="small_vocab"), "target and draft must share a vocabulary"),
    (dict(draft="ok", gamma=0), "gamma must be >= 1"),
    (dict(draft="ok", spec_lookahead=0), "spec_lookahead must be >= 1"),
    (dict(draft="ok", spec_superstep_k=0), "spec_superstep_k must be >= 1"),
    (dict(spec_lookahead=2), "spec_lookahead > 1 is a speculative-serving mode"),
    (dict(spec_superstep_k=2), "spec_superstep_k > 1 is a speculative-serving mode"),
    (dict(draft="ok", spec_superstep_k=2, spec_lookahead=2), "supersedes spec_lookahead"),
    (dict(draft="ok", spec="bogus"), 'spec must be "on" or "auto"'),
    (dict(spec="auto"), 'spec="auto" chooses between'),
    (dict(draft="ok", spec_breakeven=2.0), "spec_breakeven is the spec=\"auto\" occupancy"),
    (dict(draft="ok", spec_calibration={"threshold": 1.0}), "spec_calibration injects"),
    (dict(draft="ok", spec="auto", spec_calibration={}), 'must carry the calibrated'),
    (dict(mode_trace_limit=0), "mode_trace_limit must be >= 1"),
])
def test_engine_validations(models, kw, match):
    params, draft = models
    kw = dict(kw)
    which = kw.pop("draft", None)
    if which == "ok":
        kw.update(draft_params=draft, draft_config=DRAFT_CONFIG)
    elif which == "small_vocab":
        small = ModelConfig(max_seq_len=64, vocab_size=128, dtype=torch.float32)
        kw.update(draft_params=init_params(small, prng.PRNGKey(0, device="cpu")),
                  draft_config=small)
    with pytest.raises(ValueError, match=match):
        ServeEngine(params, CONFIG, device="cpu", **kw)


@pytest.mark.parametrize("argv, match", [
    (["--spec-superstep-k", "0"], "--spec-superstep-k must be >= 1"),
    (["--spec-superstep-k", "2"], "needs --spec-int8-draft"),
    (["--spec-int8-draft", "--spec-superstep-k", "2", "--spec-lookahead", "2"],
     "supersedes --spec-lookahead"),
    (["--spec-auto"], "--spec-auto needs --spec-int8-draft"),
    (["--superstep-k", "0"], "--superstep-k must be >= 1"),
    (["--inject-fault", "spec_bogus:1"], "--inject-fault wants SEAM:N"),
])
def test_cli_validations(argv, match, capsys):
    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert match in capsys.readouterr().err


def test_cli_speculation_drains_every_page(capsys):
    """The CLI's speculative run (int8 self-draft, spec="auto" at a
    given threshold; tests above take the calibration path) drains every
    page."""
    assert main(["--device", "cpu", "--requests", "3", "--slots", "2", "--prompt-len", "8",
                 "--max-new-tokens", "8", "--spec-int8-draft", "--spec-auto",
                 "--spec-breakeven", "2"]) == 0
    out = capsys.readouterr().out
    assert "pages in use after drain: 0" in out and "spec=auto" in out
