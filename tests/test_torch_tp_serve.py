"""Tensor-parallel serving (workloads_torch/tp_serve.py and
ServeEngine(mesh=)) on gloo CPU worlds of 2 and 4 ranks: every TP case of
the JAX package (tests/test_tp_serve.py and the mesh cases of
test_batched_admission, test_prefix_cache, test_spec_lookahead,
test_spec_superstep and test_multi_lora, as tests/torch_tp_world.py's
CASES) serves in float32, on every rank, exactly the port's one-device
engine's tokens and the frozen JAX TP engine's
(tests/test_torch_tp_golden.npz, written by
tests/test_torch_parity.py's write_tp_goldens); the tp_serve programs
equal their single-device functions; param_specs equals JAX's; and the
constructors refuse what JAX refuses.  In bf16 one decode step's logits
stay within the bf16 floor.

Both worlds run once, side by side, in a module fixture (about 40 s);
each test reads one scenario's result.  The reduce hook leaves the
one-device engine as it was: its float32 streams equal the ones the
tree gave before the hook (frozen below), and the graphed chunk equals
the eager one bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tests import torch_tp_world as tw

TP_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_tp_golden.npz")
WORLDS = (2, 4)
# One device's float32 decode step against the tensor-parallel one, as a
# share of the largest logit: only the summation order differs.
STEP_F32_RTOL = 1e-4
# A rank's pools against its slice of one device's, float32.
POOL_ATOL = 1e-5
# The TP bf16 step's distance from one device's float32 step, against one
# device's bf16 step's: chip_smoke.TP_BF16_FLOOR_FACTOR.
TP_BF16_FLOOR_FACTOR = 2.0**0.5


def jsonable(obj):
    """Tuples to lists, recursively, as the golden's JSON holds them."""
    return json.loads(json.dumps(obj))


def load_tp_golden() -> dict:
    with np.load(TP_GOLDEN) as f:
        return json.loads(f["tp"].item())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results, {world: {scenario: per-rank results}}, run
    side by side."""
    return tw.run_worlds(tmp_path_factory, WORLDS, tw.world_scenarios, timeout=300)


@pytest.fixture(scope="module")
def one_device():
    """Every case on the port's one-device engine."""
    return {name: tw.run_case(name) for name in tw.CASES}


@pytest.fixture(scope="module")
def golden():
    return load_tp_golden()


CASE_MESHES = [(name, mp) for name, case in tw.CASES.items() for mp in case.meshes]
GREEDY = [(n, mp) for n, mp in CASE_MESHES if not tw.CASES[n].kw.get("temperature")]


@pytest.mark.parametrize("name, mp", GREEDY, ids=[f"{n}-mp{mp}" for n, mp in GREEDY])
def test_tp_engine_matches_one_device(worlds, one_device, name, mp):
    got = tw.result_of(worlds[mp], f"case:{name}")
    want = one_device[name]
    assert got["streams"] == want["streams"]
    assert got["statuses"] == want["statuses"]
    assert got["used_pages"] == want["used_pages"]
    assert got["prefills_run"] == want["prefills_run"]


@pytest.mark.parametrize("name, mp", CASE_MESHES, ids=[f"{n}-mp{mp}" for n, mp in CASE_MESHES])
def test_tp_ranks_serve_in_lockstep(worlds, name, mp):
    """Every rank of the model group serves the same tokens and takes
    the same host decisions (pages, prefills, rounds, sweeps)."""
    results = [tw.result_of(worlds[mp], f"case:{name}", rank) for rank in range(mp)]
    assert all(r == results[0] for r in results[1:])


GOLDEN_CASES = [(n, mp) for n, mp in CASE_MESHES if tw.CASES[n].golden]


@pytest.mark.parametrize("name, mp", GOLDEN_CASES, ids=[f"{n}-mp{mp}" for n, mp in GOLDEN_CASES])
def test_tp_engine_matches_jax_tp_golden(worlds, golden, name, mp):
    got = tw.result_of(worlds[mp], f"case:{name}")
    assert got["streams"] == golden["case"][f"{name}/{mp}"]


def test_fanout_prefills_once(worlds):
    for mp in tw.CASES["fanout"].meshes:
        got = tw.result_of(worlds[mp], "case:fanout")
        assert got["prefills_run"] == 1
        assert len({tuple(s) for s in got["streams"]}) == 1
        assert got["used_pages"] == 0


def test_prefix_hit_skips_the_tp_prefill(worlds):
    for mp in tw.CASES["prefix"].meshes:
        got = tw.result_of(worlds[mp], "case:prefix")
        first, second = got["prefill_tokens"]
        assert second - first < 13
        assert got["streams"][0] == got["streams"][1]


def test_batched_admission_matches_serial_under_the_mesh(worlds):
    for mp in tw.CASES["batched"].meshes:
        serial = tw.result_of(worlds[mp], "case:serial")
        batched = tw.result_of(worlds[mp], "case:batched")
        assert batched["streams"] == serial["streams"]
        assert batched["prefill_sweeps"] > 0


def test_pipelined_matches_unpipelined_under_the_mesh(worlds):
    for mp in tw.CASES["pipelined"].meshes:
        assert (tw.result_of(worlds[mp], "case:pipelined")["streams"]
                == tw.result_of(worlds[mp], "case:unpipelined")["streams"])


@pytest.mark.parametrize("name", [n for n, c in tw.CASES.items()
                                  if c.draft and c.kw.get("spec") != "auto"])
def test_tp_speculation_ran_rounds(worlds, name):
    assert tw.result_of(worlds[2], f"case:{name}")["spec_rounds"] > 0


def test_spec_auto_takes_one_calibration_on_every_rank(worlds):
    """spec="auto" calibrates from the clock: the first rank's verdict
    is every rank's, so each rank decodes in the same mode every step."""
    ranks = [tw.result_of(worlds[2], "case:spec_auto", r) for r in range(2)]
    assert ranks[0]["mode_steps"] == ranks[1]["mode_steps"]
    assert sum(ranks[0]["mode_steps"]) > 0


def test_lookahead_sampling_is_structurally_sound(worlds):
    """TP x sampling x lookahead: budgets exact, tokens in the
    vocabulary, no page kept (the sampled tokens themselves are the
    engine key's; every rank draws the same ones, held by the lockstep
    test)."""
    got = tw.result_of(worlds[2], "case:lookahead_sampling")
    assert [len(s) for s in got["streams"]] == [9, 9, 9]
    assert all(0 <= t < tw.VOCAB for s in got["streams"] for t in s)
    assert got["statuses"] == ["ok"] * 3 and got["used_pages"] == 0


def test_deadline_expires_on_every_rank_alike(worlds):
    got = tw.result_of(worlds[2], "case:deadline")
    assert got["statuses"] == ["expired", "ok"]


@pytest.mark.parametrize("key, match", [
    ("generate_heads", "kv_heads"), ("draft_heads", "kv_heads"),
    ("data_degree", "data degree 1"), ("engine_data_degree", "data degree 1"),
])
def test_four_rank_constructors_refuse_what_jax_refuses(worlds, key, match):
    got = tw.result_of(worlds[4], "validations")[key]
    assert got is not None and got.startswith("ValueError") and match in got


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key, match", [
    ("kv_offload", "kv_offload is not supported under tensor parallelism"),
    ("device", "the mesh's ranks run on cpu"),
    ("default_mesh", "no CUDA device"),
])
def test_mesh_engine_refusals(worlds, world, key, match):
    got = tw.result_of(worlds[world], "validations")[key]
    assert got is not None and match in got


@pytest.mark.parametrize("world", WORLDS)
def test_param_specs_equal_jax(worlds, golden, world):
    got = tw.result_of(worlds[world], "param_specs")
    for name in ("mha", "gqa"):
        assert jsonable(got[name]) == golden["param_specs"][name]
    mp = world
    c = tw._dims("mha")
    d, h, hd, ff = c["d_model"], c["n_heads"], c["head_dim"], c["d_ff"]
    assert got["mha_shapes"] == {"ln1": (d,), "ln2": (d,), "wqkv": (d, 3, h // mp, hd),
                                 "wo": (h // mp, hd, d), "w_up": (d, ff // mp),
                                 "w_down": (ff // mp, d)}
    if world == 2:
        assert got["gqa_shapes"]["wq"] == (d, h // 2, hd)
        assert got["gqa_shapes"]["wkv"] == (d, 2, 1, hd)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_generate_matches_generate_and_jax(worlds, golden, world):
    got = tw.result_of(worlds[world], "generate")
    assert set(got) == {f"{n}{s}" for n, s, _ in tw.GENERATE_MESHES[world]}
    for key, (tp, one) in got.items():
        assert tp == one, key
        assert tp == golden["generate"][key], key


@pytest.mark.parametrize("program", [
    "prefill", "chunk", "superstep", "prefill_chunk", "spec_round", "spec_round_chained",
    "spec_superstep", "spec_superstep_retire",
])
def test_tp_program_matches_its_single_device_function(worlds, program):
    got, want, pool_err = tw.result_of(worlds[2], "programs")[program]
    assert got == want
    assert pool_err <= POOL_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_step_within_the_floor(worlds, world):
    """float32: the TP step within STEP_F32_RTOL of the largest logit.
    bf16: the TP step's max and rms distance from one device's float32
    step within sqrt 2 of one device's bf16 step's (the bf16 floor; a
    rank rounds each partial row-parallel product once more),
    chip_smoke's TP_BF16_FLOOR_FACTOR."""
    got = tw.result_of(worlds[world], "bf16_step")
    assert got["f32_tp"][0] <= STEP_F32_RTOL * got["scale"]
    for tp, floor in zip(got["bf16_tp"], got["floor"]):
        assert tp <= TP_BF16_FLOOR_FACTOR * floor


class _CudaMesh:
    """A mesh whose ranks would run on the card, without one."""

    device_type = "cuda"
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 2)[dim]

    def get_local_rank(self, dim):
        return 0


def test_entry_points_default_to_the_card(monkeypatch):
    """On a CUDA mesh without a card, TP generate and the TP engine
    refuse to run instead of moving to the CPU."""
    from workloads_torch import tp_serve
    from workloads_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tw.port_config("mha")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_serve.make_tp_generate(config, _CudaMesh())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tw.port_params("mha"), config, mesh=_CudaMesh(), **tw._SMALL)


# ---- the reduce hook leaves the one-device engine as it was ---------------

HOOK_MODES = {
    "defaults": ("mha", {}, False, False),
    "superstep_k=2 pipelined": ("mha", dict(superstep_k=2, pipelined=True), False, False),
    "prefill_budget=8": ("mha", dict(prefill_budget=8), False, False),
    "spec gamma=3": ("mha", dict(gamma=3), True, False),
    "spec_superstep_k=2": ("mha", dict(gamma=3, spec_superstep_k=2), True, False),
    "adapters": ("mha", {}, False, True),
    "gqa window": ("gqa_window", {}, False, False),
}
# The streams of HOOK_MODES on the tree before the reduce hook, float32.
PARENT_STREAMS_DIGEST = "ec5348204ee31d636729f88c0c35876be168421c59eacf2074d9839317ca2c36"


def hook_streams() -> dict:
    """HOOK_MODES' streams on the one-device engine (built without a
    mesh, as engines were before the hook), over tw's engine traffic with
    every tenant in turn."""
    from workloads_torch import convert
    from workloads_torch.serve import ServeEngine

    out = {}
    for label, (name, kw, draft, adapters) in HOOK_MODES.items():
        kw = dict(tw._ENGINE, **kw)
        if draft:
            kw.update(draft_params=tw.port_params("draft"), draft_config=tw.port_config("draft"))
        tenants = [None]
        if adapters:
            kw["adapters"] = convert.adapters_from_jax(tw.numpy_adapters(name), device="cpu")
            tenants = [None, "tenant-a", "tenant-b"]
        engine = ServeEngine(tw.port_params(name), tw.port_config(name), device="cpu", **kw)
        script = [("submit", p, n, tenants[i % len(tenants)])
                  for i, (p, n) in enumerate(tw._ENGINE_REQ + tw._PIPE_REQ)] + [("run",)]
        with torch.inference_mode():
            out[label] = tw.drive(engine, script)["streams"]
    return out


def streams_digest(streams: dict) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(streams, sort_keys=True).encode()).hexdigest()


def test_one_device_streams_are_the_ones_before_the_hook():
    assert streams_digest(hook_streams()) == PARENT_STREAMS_DIGEST


def test_identity_hook_changes_no_bit():
    """The cores with an identity ``reduce`` compute what they compute
    without one, bit for bit: logits, tokens and pools of a prefill, a
    decode chunk and a speculative superstep."""
    from workloads_torch import paged

    config, d_config = tw.port_config("mha"), tw.port_config("draft")
    params, d_params = tw.port_params("mha"), tw.port_params("draft")
    tables = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, tw.VOCAB, (2, 8)))
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    occ = torch.ones(2, dtype=torch.bool)
    outs = []
    for reduce in (None, lambda t: t):
        pools = paged.init_page_pools(config, 24, 4, "cpu")
        d_pools = paged.init_page_pools(d_config, 24, 4, "cpu")
        logits, _ = paged.paged_prefill(params, pools, tables, prompts, lengths, config,
                                        reduce=reduce)
        paged.paged_prefill(d_params, d_pools, tables, prompts, lengths, d_config,
                            reduce=reduce)
        tok = logits.argmax(-1)
        toks, _ = paged.paged_decode_chunk(params, pools, tables, tok, lengths.long(), occ,
                                           None, 0.0, 0, 1.0, config, 4, False, reduce=reduce)
        committed, n, _, _, _, _ = paged.paged_spec_superstep(
            params, d_params, pools, d_pools, tables, toks[:, -1], lengths.long() + 4, occ,
            config, d_config, 3, 1, cover_pages=8, reduce=reduce)
        outs.append((logits, toks, committed, n, *pools, *d_pools))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_graphed_chunk_equals_eager_chunk_bit_for_bit():
    """The decode step graph runner (its replay run eagerly, as on the
    CPU rehearsal) against ``paged_decode_chunk``: tokens and pools
    bit-identical."""
    from tests.test_torch_superstep import _EagerReplay
    from workloads_torch import paged
    from workloads_torch.decode_graph import DecodeGraph

    config, params = tw.port_config("mha"), tw.port_params("mha")
    tables = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, tw.VOCAB, (2, 8)))
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    occ = torch.ones(2, dtype=torch.bool)
    results = []
    for graphed in (False, True):
        pools = paged.init_page_pools(config, 24, 4, "cpu")
        with torch.inference_mode():
            logits, _ = paged.paged_prefill(params, pools, tables, prompts, lengths, config)
            tok, pos = logits.argmax(-1), lengths.long()
            if graphed:
                runner = DecodeGraph(params, pools, config, slots=2, max_pages=12, max_steps=4,
                                     temperature=0.0, top_k=0, top_p=1.0,
                                     sampling=False)
                runner.graph = _EagerReplay(runner)
                toks = runner.run(tables, tok, pos, occ,
                                  torch.full((2,), 1 << 30, dtype=torch.int32),
                                  torch.full((2,), -1), 4)[0]
            else:
                toks, _ = paged.paged_decode_chunk(params, pools, tables, tok, pos, occ, None,
                                                   0.0, 0, 1.0, config, 4, False)
        results.append((toks.clone(), *pools))
    for a, b in zip(*results):
        assert torch.equal(a, b)
