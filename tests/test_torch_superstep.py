"""The port's decode superstep (workloads_torch.paged.paged_decode_superstep),
its page ops and its decode-step graph runner, on the CPU.

torch, numpy and the port only, so it runs in the fast tier.  The
superstep is held against the JAX package's ``paged_decode_superstep``,
frozen in tests/test_torch_superstep_golden.npz (``python
tests/test_torch_parity.py --write-goldens`` regenerates it from the JAX
package; tests/test_torch_parity.py runs the same comparison live).  The
inputs, from a numpy seed, are page pools of bf16-representable values, a
table per row and four rows: one that emits its eos early, one whose
budget runs out, one parked, and one that emits its eos in the second
chunk (so only ``k = 2`` retires it).  Each row's eos is taken by the
writer from the reference's own stream without eos.

Tolerances: the tokens and the carry (tok, pos, live, budget) exactly in
both dtypes.  The k/v the superstep wrote into each row's pages (every
slot from the row's start to its final position): in float32 within the
golden file's atol = rtol = 1e-4 (the two frameworks sum the projections
in different orders: readings 4.8e-8 to 3.3e-7 of the largest value, not
0); in bfloat16 within 2^-6 of the largest value, the golden file's
limit for the paged decode step (``decode_logits``): XLA and PyTorch sum
the step's rmsnorm mean in different orders, so one ulp can flip a bf16
rounding of a k/v a later step writes (ROADMAP Queue C, known floors).
Readings: 0 in the GQA cases, 4.6e-4 to 3.6e-3 in the MHA cases, over
the 2^-10 the file keeps for bit-identical comparisons.  ``python -m
tests.test_torch_superstep`` prints the readings.  A control that
ignores eos and budget must fail.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.test_torch_golden import (
    BF16_PALLAS_ROUTE,
    DTYPES,
    F32_TOL,
    GOLDEN,
    case_key,
    params_to_torch,
    tiny_config,
)
from workloads_torch import paged as tpaged
from workloads_torch.decode_graph import DecodeGraph
from workloads_torch.ops import paged_attention as tpa

SUPERSTEP_GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "test_torch_superstep_golden.npz"
)

SS_CASES = [("f32", None, None), ("f32", 2, 5), ("bf16", None, None), ("bf16", 2, 5)]
SS_CASE_IDS = [case_key(c) for c in SS_CASES]
SS_KS = (1, 2)
SS_CHUNK, SS_PAGE_SIZE, SS_PAGES, SS_MAX_PAGES = 3, 4, 16, 5
# Four rows: eos early, budget runs out, parked, eos in the second chunk.
SS_START = (5, 3, 0, 7)
SS_LIVE = (True, True, False, True)
SS_BUDGET = (20, 2, 0, 20)
SS_EOS_STEP = {0: 1, 3: 4}  # row -> the step whose token becomes its eos


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run thousands of tiny ops; beside the XLA thread pool
    that tests/conftest.py's jax import starts, torch's intra-op threads
    make each op about ten times slower.  One thread for the module, then
    the count as it was."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_values(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (so both dtypes start
    from the same numbers)."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()


def superstep_inputs() -> dict:
    """Pools for both layouts (4 and 2 kv heads), tables and first tokens,
    from a numpy seed."""
    rng = np.random.default_rng(4321)
    inp = {}
    for kv in (4, 2):
        shape = (2, SS_PAGES + 1, kv, SS_PAGE_SIZE, 16)
        inp[f"pool_k{kv}"] = bf16_values(rng.standard_normal(shape))
        inp[f"pool_v{kv}"] = bf16_values(rng.standard_normal(shape))
    perm = rng.permutation(SS_PAGES)
    tables = np.full((4, SS_MAX_PAGES), SS_PAGES, np.int32)  # trash-filled
    live_rows = [r for r in range(4) if SS_LIVE[r]]
    for i, r in enumerate(live_rows):
        tables[r] = perm[i * SS_MAX_PAGES:(i + 1) * SS_MAX_PAGES]
    inp["tables"] = tables
    inp["tokens"] = rng.integers(0, 256, 4)
    return inp


def written_slots(pools, tables: np.ndarray, final_pos) -> tuple[np.ndarray, np.ndarray]:
    """The k and v at every slot a live row's steps wrote: positions from
    its start to its final (frozen) position, as [n, L, Hkv, hd]."""
    idx = [(int(tables[r, p // SS_PAGE_SIZE]), p % SS_PAGE_SIZE)
           for r in range(4) if SS_LIVE[r]
           for p in range(SS_START[r], int(final_pos[r]) + 1)]
    pages = [i for i, _ in idx]
    slots = [s for _, s in idx]
    return tuple(
        pool[:, pages, :, slots].float().numpy() for pool in pools
    )


def port_superstep(case, params: dict, inp: dict, eos, k: int, final_pos=None) -> dict:
    """The port's superstep from the stored state.  ``final_pos`` picks
    the written slots to return (the reference's final positions; the
    port's own by default)."""
    config = tiny_config(case)
    kv = config.kv_heads
    pools = tuple(torch.tensor(inp[f"pool_{n}{kv}"], dtype=config.dtype)
                  for n in ("k", "v"))
    ptrs = [p.data_ptr() for p in pools]
    tables = torch.from_numpy(inp["tables"])
    toks, tok, pos, live, budget, out = tpaged.paged_decode_superstep(
        params, pools, tables, torch.from_numpy(inp["tokens"]),
        torch.tensor(SS_START), torch.tensor(SS_LIVE),
        torch.tensor(SS_BUDGET, dtype=torch.int32),
        torch.as_tensor(np.asarray(eos), dtype=torch.int32), None, 0.0, 0, 1.0,
        config, SS_CHUNK, k, False,
    )
    assert out is pools and [p.data_ptr() for p in pools] == ptrs
    wk, wv = written_slots(pools, inp["tables"], pos if final_pos is None else final_pos)
    return {"tokens": toks.numpy(), "tok": tok.numpy(), "pos": pos.numpy(),
            "live": live.numpy(), "budget": budget.numpy(),
            "written_k": wk, "written_v": wv}


CARRY_KEYS = ("tokens", "tok", "pos", "live", "budget")


def superstep_mismatches(case, got: dict, want: dict) -> dict:
    """Every comparison over its limit: carry keys that differ, and the
    written slots' error (max abs in float32, share of max in bf16)."""
    out = {key: "differs" for key in CARRY_KEYS
           if not np.array_equal(got[key], want[key])}
    for key in ("written_k", "written_v"):
        if got[key].shape != want[key].shape:
            out[key] = "shape"
            continue
        err = np.abs(got[key] - want[key])
        if case[0] == "f32":
            if not (err <= F32_TOL + F32_TOL * np.abs(want[key])).all():
                out[key] = float(err.max())
        elif err.max() / np.abs(want[key]).max() > BF16_PALLAS_ROUTE:
            out[key] = float(err.max() / np.abs(want[key]).max())
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        params = {k: f[k] for k in f.files if k.startswith("params_")}
    with np.load(SUPERSTEP_GOLDEN) as f:
        return params | {k: f[k] for k in f.files}


def _case_params(golden, case):
    layout = "gqa" if case[1] else "mha"
    return params_to_torch(golden, f"params_{layout}", DTYPES[case[0]])


def _stored_inputs(golden) -> dict:
    return {k[len("superstep/input/"):]: v for k, v in golden.items()
            if k.startswith("superstep/input/")}


def _want(golden, case, k) -> dict:
    prefix = f"superstep/{case_key(case)}/k{k}/"
    return {key[len(prefix):]: v for key, v in golden.items() if key.startswith(prefix)}


def test_superstep_inputs_match_their_seed(golden):
    inp = superstep_inputs()
    stored = _stored_inputs(golden)
    assert set(stored) == set(inp)
    for key in inp:
        np.testing.assert_array_equal(stored[key], inp[key], err_msg=key)


@pytest.mark.parametrize("k", SS_KS)
@pytest.mark.parametrize("case", SS_CASES, ids=SS_CASE_IDS)
def test_superstep_matches_jax_goldens(golden, case, k):
    """Tokens, carry and written k/v of k chained chunks against the JAX
    package's paged_decode_superstep."""
    want = _want(golden, case, k)
    eos = golden[f"superstep/{case_key(case)}/eos"]
    got = port_superstep(case, _case_params(golden, case), superstep_inputs(), eos, k,
                         final_pos=want["pos"])
    assert not superstep_mismatches(case, got, want), superstep_mismatches(case, got, want)
    # The rows the inputs are built for: row 0 retired on its eos, row 1
    # on its budget, row 2 stayed parked where it was.
    assert not want["live"][0] and not want["live"][1] and not want["live"][2]
    assert want["budget"][1] == 0 and want["pos"][2] == SS_START[2]
    assert want["tokens"][0, SS_EOS_STEP[0]] == eos[0]


@pytest.mark.parametrize("case", SS_CASES, ids=SS_CASE_IDS)
def test_superstep_control_without_eos_or_budget_fails(golden, case):
    """A superstep that ignores eos and budget (every row runs to the
    end) misses the goldens: the limits see retirement."""
    want = _want(golden, case, 2)
    inp = superstep_inputs()
    config = tiny_config(case)
    pools = tuple(torch.tensor(inp[f"pool_{n}{config.kv_heads}"], dtype=config.dtype)
                  for n in ("k", "v"))
    toks, tok, pos, live, budget, _ = tpaged.paged_decode_superstep(
        _case_params(golden, case), pools, torch.from_numpy(inp["tables"]),
        torch.from_numpy(inp["tokens"]), torch.tensor(SS_START), torch.tensor(SS_LIVE),
        torch.full((4,), 99, dtype=torch.int32), torch.full((4,), -1, dtype=torch.int32),
        None, 0.0, 0, 1.0, config, SS_CHUNK, 2, False,
    )
    wk, wv = written_slots(pools, inp["tables"], want["pos"])
    got = {"tokens": toks.numpy(), "tok": tok.numpy(), "pos": pos.numpy(),
           "live": live.numpy(), "budget": budget.numpy(), "written_k": wk, "written_v": wv}
    assert {"tokens", "pos", "live", "budget"} <= set(superstep_mismatches(case, got, want))


def test_superstep_k_chunks_equal_chained_chunk_calls(golden):
    """Without retirement, a superstep of k chunks emits exactly what k
    paged_decode_chunk calls emit from the same state, and writes the
    same pools."""
    case = ("f32", 2, 5)
    config = tiny_config(case)
    params = _case_params(golden, case)
    inp = superstep_inputs()
    pools = [tuple(torch.from_numpy(inp[f"pool_{n}2"]).clone() for n in ("k", "v"))
             for _ in range(2)]
    tables = torch.from_numpy(inp["tables"])
    live = torch.tensor(SS_LIVE)
    tok0, pos0 = torch.from_numpy(inp["tokens"]), torch.tensor(SS_START)
    toks, tok, pos, _, _, _ = tpaged.paged_decode_superstep(
        params, pools[0], tables, tok0, pos0, live, torch.full((4,), 99, dtype=torch.int32),
        torch.full((4,), -1, dtype=torch.int32), None, 0.0, 0, 1.0, config, SS_CHUNK, 2, False,
    )
    chunks, t, p = [], tok0, pos0
    for _ in range(2):
        c, _ = tpaged.paged_decode_chunk(params, pools[1], tables, t, p, live, None, 0.0, 0,
                                         1.0, config, SS_CHUNK, False)
        chunks.append(c)
        t = torch.where(live, c[:, -1], t)
        p = torch.where(live, p + SS_CHUNK, p)
    assert torch.equal(toks, torch.cat(chunks, dim=1))
    assert torch.equal(tok[live], t[live]) and torch.equal(pos, p)
    for a, b in zip(pools[0], pools[1]):
        assert torch.equal(a[:, :SS_PAGES], b[:, :SS_PAGES])


def test_superstep_golden_fixture_stays_small():
    assert os.path.getsize(SUPERSTEP_GOLDEN) < 1 << 20


# ---- page ops -------------------------------------------------------------


def _pools(dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    shape = (2, 9, 2, 4, 16)
    return (torch.randn(shape, generator=g).to(dtype), torch.randn(shape, generator=g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_page_ops_round_trip_bit_exactly_in_place(dtype):
    pools = _pools(dtype)
    ptrs = [p.data_ptr() for p in pools]
    before = [p.clone() for p in pools]
    k3, v3 = tpaged.read_page(pools, 3)
    assert k3.shape == (2, 2, 4, 16) and torch.equal(k3, pools[0][:, 3])
    assert tpaged.write_page(pools, k3, v3, 6) is pools
    assert torch.equal(pools[0][:, 6], before[0][:, 3])
    assert torch.equal(pools[1][:, 6], before[1][:, 3])
    # What read_page returned is a copy: a later pool write leaves it.
    pools[0][:, 3] = 0
    assert torch.equal(k3, before[0][:, 3])
    assert tpaged.copy_page(pools, torch.tensor(6), 3) is pools
    assert torch.equal(pools[0][:, 3], before[0][:, 3])
    untouched = [i for i in range(9) if i not in (3, 6)]
    for p, b in zip(pools, before):
        assert torch.equal(p[:, untouched], b[:, untouched])
    assert [p.data_ptr() for p in pools] == ptrs


def test_read_pages_columns_equal_read_page():
    pools = _pools(torch.bfloat16)
    srcs = [5, 0, 8, 5]
    ks, vs = tpaged.read_pages(pools, srcs)
    assert ks.shape == (2, 4, 2, 4, 16)
    for i, src in enumerate(srcs):
        k, v = tpaged.read_page(pools, src)
        assert torch.equal(ks[:, i], k) and torch.equal(vs[:, i], v)
    # A gathered page written back lands bit for bit.
    tpaged.write_page(pools, ks[:, 2], vs[:, 2], 1)
    assert torch.equal(pools[0][:, 1], pools[0][:, 8])
    assert torch.equal(pools[1][:, 1], pools[1][:, 8])


# ---- the decode-step graph runner, with a replay that does not launch ---------


class _EagerReplay:
    """Stands in for a captured CUDA graph: a replay runs the runner's
    step eagerly on CPU tensors, as the graph would on the card, and
    launches no kernel (the plain paged attention runs on CPU tensors)."""

    def __init__(self, runner):
        self.runner, self.replays = runner, 0

    def replay(self):
        self.replays += 1
        self.runner._step()


def _runner(golden, max_steps=6):
    case = ("f32", 2, 5)
    config = tiny_config(case)
    inp = superstep_inputs()
    pools = tuple(torch.from_numpy(inp[f"pool_{n}2"]).clone() for n in ("k", "v"))
    runner = DecodeGraph(
        _case_params(golden, case), pools, config, slots=4, max_pages=SS_MAX_PAGES,
        max_steps=max_steps, temperature=0.0, top_k=0, top_p=1.0,
        sampling=False,
    )
    return runner, inp, config


def test_graph_runner_counts_kernel_launches_per_replay(golden):
    """K1's count under a graph: every replay adds what one captured step
    launched (here 2, one per layer), and nothing else moves it."""
    runner, inp, _ = _runner(golden)
    runner.graph = fake = _EagerReplay(runner)
    runner.k1_per_step = 2
    before = tpa.paged_attention.launches
    args = (torch.from_numpy(inp["tables"]), torch.from_numpy(inp["tokens"]),
            torch.tensor(SS_START), torch.tensor(SS_LIVE),
            torch.tensor(SS_BUDGET, dtype=torch.int32), torch.full((4,), -1))
    runner.run(*args, 5)
    assert fake.replays == 5
    assert tpa.paged_attention.launches - before == 10
    runner.run(*args, 1)
    assert tpa.paged_attention.launches - before == 12
    with pytest.raises(ValueError, match="steps"):
        runner.run(*args, 7)
    assert tpa.paged_attention.launches - before == 12


def test_graph_runner_step_equals_the_eager_superstep(golden):
    """The runner's buffers (inputs copied in, the step's carry written
    back, the step's tokens into ``out`` column by column) compute what
    paged_decode_superstep computes, replay by replay."""
    runner, inp, config = _runner(golden)
    runner.graph = _EagerReplay(runner)
    eos = golden[f"superstep/{case_key(('f32', 2, 5))}/eos"]
    state = (torch.from_numpy(inp["tables"]), torch.from_numpy(inp["tokens"]),
             torch.tensor(SS_START), torch.tensor(SS_LIVE),
             torch.tensor(SS_BUDGET, dtype=torch.int32), torch.as_tensor(eos))
    ptrs = [p.data_ptr() for p in runner.pools]
    toks, tok, pos, live, budget = runner.run(*state, 2 * SS_CHUNK)
    want = port_superstep(("f32", 2, 5), runner.params, inp, eos, 2)
    assert np.array_equal(toks.numpy(), want["tokens"])
    for key, t in (("tok", tok), ("pos", pos), ("live", live), ("budget", budget)):
        assert np.array_equal(t.numpy(), want[key]), key
    got_k, got_v = written_slots(runner.pools, inp["tables"], want["pos"])
    assert np.array_equal(got_k, want["written_k"]) and np.array_equal(got_v, want["written_v"])
    assert [p.data_ptr() for p in runner.pools] == ptrs


def print_readings() -> None:
    """Each case's written k/v error against the JAX package's, the
    port's own bf16 and float32 runs side by side."""
    with np.load(GOLDEN) as f:
        golden = {k: f[k] for k in f.files if k.startswith("params_")}
    with np.load(SUPERSTEP_GOLDEN) as f:
        golden |= {k: f[k] for k in f.files}
    inp = superstep_inputs()
    for case in SS_CASES:
        eos = golden[f"superstep/{case_key(case)}/eos"]
        for k in SS_KS:
            want = _want(golden, case, k)
            got = port_superstep(case, _case_params(golden, case), inp, eos, k,
                                 final_pos=want["pos"])
            shares = [np.abs(got[key] - want[key]).max() / np.abs(want[key]).max()
                      for key in ("written_k", "written_v")]
            print(f"{case_key(case):14s} k={k} carry "
                  f"{'equal' if all(np.array_equal(got[x], want[x]) for x in CARRY_KEYS) else 'DIFFERS'}"
                  f"  written k/v share of max {shares[0]:.3e} {shares[1]:.3e}")


if __name__ == "__main__":
    print_readings()
