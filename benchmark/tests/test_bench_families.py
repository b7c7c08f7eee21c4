"""Block families: the ``dense`` family pinned to the readings the
harness gave before families existed, and a family that the dense one
cannot describe, with its cells, a counter a cell names and a reader,
added by new files alone."""

import hashlib
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import spec, weights
from benchmark.reference import model as ref

from .tiny import ROOT_FILES, TINY_CONFIG

ROOT = spec.ROOT
DENSE = spec.HERE / "families" / "dense.py"
POSITIONS = (0, 511, 1535, 2047)

# The harness's work counts before families existed (``work.py`` at the
# parent commit), at the configurations' published sizes: K1 at
# ``POSITIONS``; one token's forward at each of them with its logits; a
# 512-token prompt, and positions 512-2,047 with their logits; a
# training step of 8 x 2,048 predicted positions; K2-K4 for that step
# with the forward run once and twice; the launches a step.
PINNED = {
    "pythia-6.9b": {
        "k1": [(524288, 1048576), (268435456, 268959744), (805306368, 805830656),
               (1073741824, 1074266112)],
        "token": [13298565120, 13566476288, 14103347200, 14371782656],
        "spans": (6665923461120, 21456985522176),
        "train": 680026466942976,
        "flash": [[(8800387989504, 17246978048), (13200581984256, 21609054208),
                   (17600775979008, 25904021504)],
                  [(17600775979008, 34493956096), (13200581984256, 21609054208),
                   (17600775979008, 25904021504)]],
        "launches": (32, 128),
        # k1_roofline, flash_roofline, mfu.train, mfu.decode on the runs of
        # ``_reader_runs``.
        "readers": (0.11461114541577824, 3.823474938564206, 6.741078004549813,
                    0.038111994957654195),
    },
    "pythia-1.4b": {
        "k1": [(196608, 393216), (100663296, 100859904), (301989888, 302186496),
               (402653184, 402849792)],
        "token": [2622160896, 2722627584, 2923954176, 3024617472],
        "spans": (1262770716672, 4414035197952),
        "train": 138775225171968,
        "flash": [[(3300145496064, 6467616768), (4950218244096, 8103395328),
                   (6600290992128, 9714008064)],
                  [(6600290992128, 12935233536), (4950218244096, 8103395328),
                   (6600290992128, 9714008064)]],
        "launches": (24, 96),
        "readers": (0.05730557270788913, 1.9117374692821032, 1.3756738354444775,
                    0.007500018695247725),
    },
}

# SHA-256 over (path, bytes) of every leaf of ``make_params(TINY_CONFIG,
# 2**31 + 5)`` before families existed: float32 and bfloat16, MHA and GQA.
PINNED_WEIGHTS = {
    ("float32", None): "9a996b655063e886d5899dc9205f97643f7542246b8abcb5149f65fe772d011f",
    ("float32", 2): "595886ddedf8e1eae4bec6e7374334c6380f31b2f4790452905d7245900dbd07",
    ("bfloat16", None): "4a9db67dfc1a27258d1cd26bc89b09f108851debe4706a489173dba8b53374c6",
    ("bfloat16", 2): "27a63a148ec993ce07f239a28b2579b690b7c9f70aee89ed16d1b3846f9c3f7c",
}


def _config(name: str) -> dict:
    return spec.load_json(ROOT / "benchmark" / "configs" / f"{name}.json")


def test_the_benchmark_cells_are_dense():
    for w in spec.benchmark()["workloads"]:
        cell = spec.Cell(w["name"])
        assert "family" not in cell.config
        assert cell.family.__file__ == str(DENSE)
        assert spec.family(cell.config).__file__ == str(DENSE)


@pytest.mark.parametrize("name", PINNED)
def test_the_dense_work_counts_are_the_parents(name):
    cfg, pin = _config(name), PINNED[name]
    fam = spec.family(cfg)
    assert [fam.k1_work(cfg, p) for p in POSITIONS] == pin["k1"]
    assert [fam.span_flops(cfg, p, p + 1, True) for p in POSITIONS] == pin["token"]
    assert (fam.span_flops(cfg, 0, 512, False), fam.span_flops(cfg, 512, 2048, True)) \
        == pin["spans"]
    assert fam.train_step_flops(cfg, 8, 2048) == pin["train"]
    assert [fam.flash_work(cfg, 8, 2048, f) for f in (1, 2)] == pin["flash"]
    assert (fam.k1_launches_per_step(cfg), fam.flash_launches_per_step(cfg, 2)) \
        == pin["launches"]


class _Trace:
    """A profiled slice's trace that holds ``seconds`` of the named
    kernels over ``records`` launch records."""

    def __init__(self, seconds, records):
        self.seconds, self.records = seconds, records

    def kernel_s(self, *names):
        return self.seconds, self.records


def _reader_runs(cfg):
    asks = [types.SimpleNamespace(t_admit=1.0, prompt=[0] * 300, seen=700),
            types.SimpleNamespace(t_admit=2.0, prompt=[0] * 128, seen=1),
            types.SimpleNamespace(t_admit=None, prompt=[0] * 50, seen=0),
            types.SimpleNamespace(t_admit=99.0, prompt=[0] * 50, seen=0)]
    return {
        "k1_roofline": {"cfg": cfg, "slice": {"trace": _Trace(0.25, 100),
                                              "decode_positions": list(POSITIONS),
                                              "decode_steps": 7}},
        "flash_roofline": {"cfg": cfg, "batch": 8, "seq": 2048,
                           "settings": {"trainer": {"remat_layers": True}},
                           "slice": {"trace": _Trace(0.5, 50), "steps": 1}},
        "mfu.train": {"cfg": cfg, "batch": 8, "seq": 2048, "steps": 5, "window_s": 51.0},
        "mfu.decode": {"cfg": cfg, "asks": asks, "t0": 0.0, "window_s": 51.0,
                       "stepping_s": 40.0},
    }


@pytest.mark.parametrize("name", PINNED)
def test_the_readers_read_the_parents_counts(name):
    runs = _reader_runs(_config(name))
    read = tuple(spec.load_module(spec.HERE / "metrics" / f"{m}.py").read(run)
                 for m, run in runs.items())
    assert read == PINNED[name]["readers"]


@pytest.mark.parametrize("dtype, kv_heads", PINNED_WEIGHTS)
def test_the_dense_weights_are_the_parents(dtype, kv_heads):
    cfg = {**TINY_CONFIG, "num_key_value_heads": kv_heads}
    fam = spec.family(cfg)
    h = hashlib.sha256()
    for path, t in fam.leaf_items(fam.make_params(cfg, 2**31 + 5, getattr(torch, dtype), "cpu")):
        h.update(path.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS[(dtype, kv_heads)]


def test_the_dense_reference_is_the_reference():
    cfg = dict(TINY_CONFIG)
    fam = spec.family(cfg)
    params = weights.make_params(cfg, 31, torch.float32, "cpu")
    prompt, served = [5, 3, 9, 1], [7, 7, 2]
    assert torch.equal(fam.served_logits(params, prompt, served, cfg, "cpu"),
                       ref.served_logits(params, prompt, served, cfg, "cpu"))
    batch = weights.token_ids(31, "b", 2 * 17, cfg["vocab_size"], "cpu").view(2, 17)
    leaves = [t.requires_grad_(True) for _, t in weights.leaf_items(params)]
    loss, grads = fam.loss_and_grads(params, batch, cfg, leaves, False, [1])
    loss_ref, grads_ref = ref.loss_and_grads(params, batch, cfg, leaves, False, [1])
    assert loss == loss_ref
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_ref))


def test_an_unknown_family_names_its_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"families/mamba\.py"):
        spec.family({**TINY_CONFIG, "family": "mamba"})
    for name in ROOT_FILES:
        src = ROOT / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, tmp_path / name)
    path = tmp_path / "benchmark" / "configs" / "pythia-1.4b.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "family": "mamba"}))
    with pytest.raises(FileNotFoundError, match=r"families/mamba\.py"):
        spec.Cell("pythia-1.4b.train", root=tmp_path)


# ---- a family in new files alone ----------------------------------------

# Serving with the port's int8 weight-only leaves (``{"q8", "scale"}``, one
# scale per output channel), quantised by the family's own plain code
# from the dense weights and dequantised in its reference.
TOY_INT8 = '''"""int8 weight-only serving of the dense block."""

import torch

from benchmark import spec

dense = spec.family({})
port_config = dense.port_config
span_flops = dense.span_flops
k1_work = dense.k1_work
k1_launches_per_step = dense.k1_launches_per_step

# Each product weight with the axes its product contracts.
CONTRACTED = {"wqkv": (0,), "wq": (0,), "wkv": (0,), "wo": (0, 1), "w_up": (0,),
              "w_down": (0,)}


def quantise(w, axes):
    amax = w.float().abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return {"q8": torch.round(w.float() / scale).clamp(-127, 127).to(torch.int8),
            "scale": scale}


def dequantise(leaf):
    return leaf["q8"].float() * leaf["scale"]


def make_params(cfg, seed, dtype, device):
    params = dense.make_params(cfg, seed, dtype, device)
    params["unembed"] = quantise(params["unembed"], (0,))
    for layer in params["layers"]:
        for name, axes in CONTRACTED.items():
            if name in layer:
                layer[name] = quantise(layer[name], axes)
    return params


def served_logits(params, prompt, served, cfg, device, fp8=False):
    if not isinstance(params["unembed"], dict):
        raise TypeError("the weights the port served are not this family's int8 tree")

    def plain(t):
        return dequantise(t) if isinstance(t, dict) else t

    tree = {"embed": params["embed"], "unembed": plain(params["unembed"]),
            "layers": [{k: plain(v) for k, v in layer.items()} for layer in params["layers"]]}
    return dense.served_logits(tree, prompt, served, cfg, device, fp8)


def weight_bytes(cfg):
    """Bytes of the int8 product weights and their scales."""
    params = make_params(cfg, 0, torch.float32, "cpu")
    leaves = [params["unembed"]] + [v for layer in params["layers"] for v in layer.values()
                                    if isinstance(v, dict)]
    return sum(t.numel() * t.element_size() for leaf in leaves for t in leaf.values())
'''

# Training through the port's top-1 GShard expert layer (``moe.py``), with
# a plain top-1, capacity-dropping reference.
TOY_MOE = '''"""The dense block with its MLP swapped for top-1 experts."""

import dataclasses
import math

import torch
import torch.nn.functional as F

from benchmark import spec, weights
from benchmark.reference import model as ref

dense = spec.family({})
flash_work = dense.flash_work
flash_launches_per_step = dense.flash_launches_per_step


def port_config(cfg, dtype, **extra):
    from workloads_torch.model import ModelConfig

    @dataclasses.dataclass(frozen=True)
    class MoEModelConfig(ModelConfig):
        n_experts: int = 1
        capacity_factor: float = 1.0
        aux_loss_weight: float = 0.0

    base = dense.port_config(cfg, dtype, **extra)
    return MoEModelConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                          n_experts=cfg["num_experts"],
                          capacity_factor=cfg["capacity_factor"],
                          aux_loss_weight=cfg["aux_loss_weight"])


def port_train_step(config, optimizer):
    from workloads_torch.moe import MoEConfig, make_moe_train_step

    moe = MoEConfig(config.n_experts, config.capacity_factor, config.aux_loss_weight)
    return make_moe_train_step(config, moe, None, optimizer)


def make_params(cfg, seed, dtype, device):
    params = dense.make_params(cfg, seed, dtype, device)
    d, ff, e = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_experts"]
    g = weights.generator(seed, "experts", device)

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02, generator=g)

    for layer in params["layers"]:
        del layer["w_up"], layer["w_down"]
        layer["moe"] = {"router": draw(d, e), "w_up": draw(e, d, ff), "w_down": draw(e, ff, d)}
    return params


def leaf_items(params):
    yield "embed", params["embed"]
    yield "unembed", params["unembed"]
    for i, layer in enumerate(params["layers"]):
        for name in sorted(layer):
            if isinstance(layer[name], dict):
                for sub in sorted(layer[name]):
                    yield f"layers.{i}.{name}.{sub}", layer[name][sub]
            else:
                yield f"layers.{i}.{name}", layer[name]


def train_step_flops(cfg, batch, seq):
    """The dense count (one expert's MLP a token) and the router."""
    router = 2 * batch * seq * cfg["num_hidden_layers"] * cfg["hidden_size"] * cfg["num_experts"]
    return dense.train_step_flops(cfg, batch, seq) + 3 * router


def attention(x, layer, cfg, fp8):
    batch, seq, d = x.shape
    heads = cfg["num_attention_heads"]
    hd = d // heads
    h = ref.rmsnorm(x, layer["ln1"].float())
    qkv = ref.matmul(h, layer["wqkv"].float().reshape(d, -1), fp8).reshape(batch, seq, 3, heads, hd)
    positions = torch.arange(seq, device=x.device)
    q, k = (ref.rope(qkv[:, :, i], positions, 10000.0).transpose(1, 2) for i in (0, 1))
    v = qkv[:, :, 2].transpose(1, 2)
    scores = ref.matmul(q, k.transpose(-1, -2), fp8) / math.sqrt(hd)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = ref.matmul(probs, v, fp8).transpose(1, 2).reshape(batch, seq, d)
    return x + ref.matmul(out, layer["wo"].float().reshape(d, d), fp8)


def experts(h, p, cfg, fp8):
    """Each token to its most probable expert, scaled by that probability;
    an expert takes the first ``capacity`` tokens of a row routed to it
    and the rest pass it by.  (y, the load-balancing loss)."""
    batch, seq, d = h.shape
    n = cfg["num_experts"]
    capacity = max(1, math.ceil(seq * cfg["capacity_factor"] / n))
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    gate, chosen = probs.max(dim=-1)
    flat, y = h.reshape(batch * seq, d), torch.zeros(batch * seq, d, device=h.device)
    for r in range(batch):
        for e in range(n):
            rows = r * seq + (chosen[r] == e).nonzero()[:capacity, 0]
            up = ref.gelu_tanh(ref.matmul(flat[rows], p["w_up"][e].float(), fp8))
            out = ref.matmul(up, p["w_down"][e].float(), fp8) * gate.reshape(-1)[rows, None]
            y = y.index_add(0, rows, out)
    share = F.one_hot(chosen, n).float().mean(dim=(0, 1))
    aux = cfg["aux_loss_weight"] * n * (share * probs.mean(dim=(0, 1))).sum()
    return y.reshape(batch, seq, d), aux


def loss_and_grads(params, batch, cfg, leaves, fp8=False, rows=None):
    """The whole batch at once: the load-balancing loss is over all of it."""
    tokens = batch if rows is None else batch[rows]
    x = params["embed"].float()[tokens[:, :-1]]
    aux = 0.0
    for layer in params["layers"]:
        x = attention(x, layer, cfg, fp8)
        y, a = experts(ref.rmsnorm(x, layer["ln2"].float()), layer["moe"], cfg, fp8)
        x, aux = x + y, aux + a
    logits = ref.unembed(params, x, fp8)
    loss = F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten()) + aux
    return float(loss.detach()), list(torch.autograd.grad(loss, leaves))
'''

# Weight bytes the int8 prefill dispatches streamed a token row: a reader
# that asks the configuration's family, and reads a counter its cell names.
TOY_READER = '''from benchmark import spec

META = {"unit": "bytes", "better": "lower", "source": "program_counter",
        "layer": "Engine (serve.py)", "moves": "output_tokens_per_s"}


def read(run):
    c = run["counters"]
    if not c.get("prefill_padded_tokens"):
        return None
    fam = spec.family(run["cfg"])
    return fam.weight_bytes(run["cfg"]) * c["prefill_dispatches"] / c["prefill_padded_tokens"]
'''

# Runs each cell named on the command line with the trace off and on,
# from the checkout in the working directory; the port from the repository.
RUNNER = '''import json, sys
sys.path[:0] = [".", sys.argv[1]]
import torch
torch.set_num_threads(1)
from benchmark import spec
from benchmark.tests.tiny import run_tiny
out = {}
for name in sys.argv[2:]:
    cell = spec.Cell(name)
    out[name] = {"family": cell.family.__file__, "runs": []}
    for trace in (0, 1):
        rc, res, err = run_tiny(cell, trace=trace)
        out[name]["runs"].append([rc, res, err[-3000:]])
# mfu.train of a step of 2 x 32 a second, and the same by each family's count
from benchmark import work
cell = spec.Cell("toy-moe.toy_train")
run = {"cfg": cell.config, "batch": 2, "seq": 32, "steps": 1, "window_s": 1.0}
out["mfu.train"] = [cell.metric_reader("mfu.train")(run)] + [
    100.0 * fam.train_step_flops(cell.config, 2, 32) / work.PEAK_BF16_FLOPS
    for fam in (cell.family, spec.family({}))]
print(json.dumps(out))
'''


def _add_toy_families(root):
    """The new files and ``BENCHMARK.json``'s new entries of two toy
    families' cells, under the checkout ``root``."""
    d = root / "benchmark"
    (d / "families" / "toy_int8.py").write_text(TOY_INT8)
    (d / "families" / "toy_moe.py").write_text(TOY_MOE)
    (d / "metrics" / "toy.int8_bytes_per_row.py").write_text(TOY_READER)
    (d / "configs" / "toy-int8.json").write_text(json.dumps({**TINY_CONFIG,
                                                             "family": "toy_int8"}))
    (d / "configs" / "toy-moe.json").write_text(json.dumps({
        **TINY_CONFIG, "family": "toy_moe", "num_experts": 4, "capacity_factor": 1.0,
        "aux_loss_weight": 0.01}))
    (d / "traffic" / "toy_chat.json").write_text(json.dumps({
        "kind": "closed_loop", "clients": 3, "pool": 8192, "greedy": True,
        "prompt_len": {"law": "log_uniform", "lo": 4, "hi": 40},
        "new_tokens": {"law": "log_uniform", "lo": 4, "hi": 16}}))
    (d / "traffic" / "toy_train.json").write_text(json.dumps({
        "kind": "train_batches", "batch": 2, "seq_len": 33}))
    (d / "cells" / "toy-int8.toy_chat.json").write_text(json.dumps({
        "engine": {"slots": 4, "page_size": 8, "chunk": 4, "prompt_bucket": 16,
                   "pipelined": True},
        "counters": ["prefill_padded_tokens"], "profile_steps": 2,
        "check": {"sample": 3, "limits": {"max_gap": 1e-3}}}))
    (d / "cells" / "toy-moe.toy_train.json").write_text(json.dumps({
        "trainer": {"attention_impl": "native", "remat_layers": False},
        "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.01},
        "profile_steps": 1,
        "check": {"steps": 3,
                  "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("toy-int8", "toy-moe"):
        bench["configs"].append({"name": name, "source": "https://example.org/toy",
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
    bench["workloads"] += [
        {"name": "toy-int8.toy_chat", "config": "toy-int8", "traffic": "toy_chat", "chips": 1,
         "why": "a test"},
        {"name": "toy-moe.toy_train", "config": "toy-moe", "traffic": "toy_train", "chips": 1,
         "why": "a test"}]
    joins = {"output_tokens_per_s": "toy-int8.toy_chat", "mfu.decode": "toy-int8.toy_chat",
             "engine.prefill_fill": "toy-int8.toy_chat",
             "train_tokens_per_s": "toy-moe.toy_train", "mfu.train": "toy-moe.toy_train"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in joins:
            m["workloads"].append(joins[m["name"]])
    bench["per_layer"].append({"name": "toy.int8_bytes_per_row", "unit": "bytes",
                               "better": "lower", "source": "program_counter",
                               "layer": "Engine (serve.py)", "moves": "output_tokens_per_s",
                               "workloads": ["toy-int8.toy_chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_family_needs_new_files_only(tmp_path):
    """Two families the dense one cannot describe, int8 serving and top-1
    expert training, each with its configuration, mix and cell, a counter
    the serving cell names and a reader that asks the family: the harness
    of a checkout that holds them runs both cells to ``correct`` with the
    trace off and on, the readers that count work through the family
    among its metrics, and no file that was there changes."""
    for name in ROOT_FILES:
        src = ROOT / name
        (shutil.copytree(src, tmp_path / name, ignore=shutil.ignore_patterns("__pycache__"))
         if src.is_dir() else shutil.copy(src, tmp_path / name))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    _add_toy_families(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT), "toy-int8.toy_chat", "toy-moe.toy_train"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"toy-int8.toy_chat": ({"output_tokens_per_s", "setup_s"},
                                  {"mfu.decode", "engine.prefill_fill",
                                   "toy.int8_bytes_per_row"}),
            "toy-moe.toy_train": ({"train_tokens_per_s", "setup_s"}, {"mfu.train"})}
    for name, (e2e, per_layer) in want.items():
        family = name.split(".")[0].replace("-", "_")
        assert out[name]["family"] == str(tmp_path / "benchmark" / "families" / f"{family}.py")
        for trace, (rc, res, err) in enumerate(out[name]["runs"]):
            assert rc == 0, err
            assert res["correct"] is True, (name, trace, res["checks"])
            assert set(res["metrics"]) == (per_layer if trace else e2e), (name, trace)
            assert all(m["value"] > 0 for m in res["metrics"].values())
    fill = out["toy-int8.toy_chat"]["runs"][1][1]["metrics"]["engine.prefill_fill"]["value"]
    assert 0 < fill <= 100
    # The reader counts by the configuration's family, which counts the router.
    read, by_family, by_dense = out["mfu.train"]
    assert read == by_family != by_dense
    assert all(p.read_bytes() == b for p, b in before.items())
    assert not (ROOT / "benchmark" / "families" / "toy_int8.py").exists()
