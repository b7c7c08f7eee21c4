"""The ``mellum2`` family and its cell: the work counts at the published
sizes as literal numbers, a tiny Mellum2 cell through ``run.main`` on the
CPU to ``correct`` with the trace off and on, the expert layer's two
readers on synthetic runs, and every file the benchmark held before the
family came, byte for byte."""

import hashlib
import types

import pytest

from benchmark import spec

from .tiny import run_tiny, tiny_cell

ROOT = spec.ROOT
CELL = "mellum2-12b-a2.5b.generate_2k"
POSITIONS = (0, 1023, 1024, 3071)
CFG = spec.load_json(ROOT / "benchmark" / "configs" / "mellum2-12b-a2.5b.json")

# Counted by hand from the published sizes (d 2,304, 32 q and 4 kv heads
# of 128, 28 layers of which 7 full and 21 with a window of 1,024, 64
# experts of width 896 at top-8, vocabulary 98,304).
K1 = [(458752, 516096), (469762048, 59179008), (469876736, 59193344),
      (704643072, 88539136)]
TOKEN = [4425318400, 4894621696, 4894736384, 5129502720]  # one token with its logits
SPANS = (4307952861184, 10264820842496)  # a 1,024-token prompt; 1,024-3,071 with logits
PARAMS = 12149913600
ACTIVE_LAYER = 70926336
EXPERT = (12386304, 12386304)  # 2 x 3 x 2,304 x 896 operations; 3 x 2,304 x 896 x 2 bytes

# The tiny stand-in: every mechanism of the block, at a size the CPU holds.
TINY = {"num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 32, "hidden_size": 64, "num_experts": 8, "num_experts_per_tok": 2,
        "moe_intermediate_size": 32, "sliding_window": 8, "max_seq_len": 96,
        "layer_types": ["sliding_attention"] * 3 + ["full_attention"]}

# SHA-256 of every file under benchmark/ before the family came.
BEFORE = {
    "benchmark/__init__.py": "3886e216fcad6c035c8feebf2c80ce517a6007d6ff2abb7ad2bd529c0588d591",
    "benchmark/calibrate.py": "85112d55c6cbafe587562bcd5aabbe1763d74c1f3974320e9eb07395eb90d780",
    "benchmark/cells/pythia-1.4b.train.json": "6f3f760031cfb422c905f428e041b9b2e3e14195e3e7b99bab6098bcf160a72b",
    "benchmark/cells/pythia-6.9b.generate.json": "16eaccb27acaca0eb014cdfee003be0599b6bb03b965991217084bc5d3852a16",
    "benchmark/configs/pythia-1.4b.json": "d9a8afc487d45b3c069837a60ae1d7077758d3d76a3add649c49973968e6d0bc",
    "benchmark/configs/pythia-6.9b.json": "2bc843bc3b4fc8f171b1b98933beb3f589fec64c9e0e914578fb4c99a0e479ad",
    "benchmark/draws.py": "ba17f272f338f231a52db52bebf84745927d474fef16a7636d02bc5db0242af0",
    "benchmark/families/dense.py": "a7ac495d0bd2513400c80ed92b7b5357fa06c465235d1efe52381011fb591079",
    "benchmark/metrics/decode_step_ms.py": "69c3928127f335971191c59fce7803ef43c5e7247ce5b9a4de95f98d61ca8208",
    "benchmark/metrics/device_idle.decode.py": "3123bbc1767102df68c07d00e9ccb2b3937899fb103e70a22a4765efcce71650",
    "benchmark/metrics/device_idle.engine.py": "a13552acef5fb91eb8eea6ab89f1aafa00d7aece2ec397a7fdd591b59d5eb1f9",
    "benchmark/metrics/device_idle.optimizer.py": "62f534d2d7b9190f1644b4dd3787cd335fbe07974e336a3beb31b519e3036203",
    "benchmark/metrics/device_idle.train.py": "ea5ab4d1229a94c2a9d2033292e222285fc2433033828920502dc92b7b747107",
    "benchmark/metrics/engine.decode_rows.py": "7992c7852f54e3e15f99e708c4e7d87bc5721242fb3fcc1cab12a2c6d333b689",
    "benchmark/metrics/engine.prefill_fill.py": "3e4d84946e6efbc018435dc0c1a91e301c92ccb654c9fb9533683941a24acc50",
    "benchmark/metrics/flash_roofline.py": "e09924cff2975a115b1fe8761a356a77e5bf91caa31a9aeb3609c12e9f48527c",
    "benchmark/metrics/k1_roofline.py": "8a39d8b3d10bc6ec4059495331a6e12033c01eb4d8310d0919eff96844e4bdc4",
    "benchmark/metrics/mfu.decode.py": "b17e16b43b45a169b48346d91dcab914b0875cbe21afe9e925c112aac0529959",
    "benchmark/metrics/mfu.train.py": "89b97daa12b81801e0dd92aab4fcdb8ac866c7dd85cc8d3efeb6609793131c95",
    "benchmark/metrics/output_tokens_per_s.py": "32773a855c747175c016fd8caa43957e6c5ba023bd6f55919539572cb2aee807",
    "benchmark/metrics/setup_s.py": "3d8e831192e9c87c9d740343ab297af2ce55b8f3742ff0fd10777e7bb3d6a11e",
    "benchmark/metrics/tpot_p95_ms.py": "f2dc7028d41536eed2485f09ac80f9edb01dfabd0c2476d2b8684de761f3b99e",
    "benchmark/metrics/train_tokens_per_s.py": "f44969641a41967005f5bcec5856e1623daf4ddcaeee637f6d9c0b1b0ea06a28",
    "benchmark/phases.py": "a774accff9ec43f25e34daa18ef5ae4c69bd19f4b1f1ea213a413bb698d58a08",
    "benchmark/reference/__init__.py": "984eb1aee0544ecde153d68a2531ba67fc7ac4693b243bbc03fae30ef2faefb1",
    "benchmark/reference/model.py": "276a244dc46901e137f7a0684844b5046cc0dfd8479a5a4581ab5b726174bc14",
    "benchmark/run.py": "0b16144799d716afd72b27ba2ece25efde0e7a9006939f226017beff2fcfa5cc",
    "benchmark/serving.py": "dbe3d88cab50ca5ec495b415f8e5b88623a7fdc79c5642aa02740a0b9e9c1238",
    "benchmark/spec.py": "f9bbc4fa4d5a910de50937a7bdd3bcca5960c0acdd161a27f6ad5f8fa3b98055",
    "benchmark/tests/__init__.py": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "benchmark/tests/conftest.py": "bf07e2e4bc56af8000dfe5daed63aa7bb9427c272ff5c1fc75c073b33dec80a8",
    "benchmark/tests/test_bench_card.py": "0536d2fea5d399c0ce2285a819d9a367a6295a3a3cbeed157cf5ed1ebd37eddf",
    "benchmark/tests/test_bench_families.py": "32e6f9f078cb80f984c915d2293c65fac0bfc0bc8f51739382fdbe4bffe1d10a",
    "benchmark/tests/test_bench_phases.py": "2e1f8a73ae8ba9d0bc36fb55dabe667d13f24f5b5349d528c0b32b1bc3a93166",
    "benchmark/tests/test_bench_reference.py": "9678b7af0b792fb2ff6355e73afc4d677f6f6725f62c76b4c9c565502bf512b2",
    "benchmark/tests/test_bench_run.py": "aef188d71cacace88eb9d30ca588f6925d2d7bc5d3b7a6b598a565066470cc45",
    "benchmark/tests/test_bench_spec.py": "f46d8c4c230ca5cf27e2c002e3722150e455171d48827c894f0225d2564ae62c",
    "benchmark/tests/test_bench_work.py": "257f1a941b9ac0f0b17ba3216b392c0f5b57e21f5b59aaff794fd6e930992bb8",
    "benchmark/tests/tiny.py": "a4170ca7bf8e30bb13febc96d9128a054941cdca1b14e733cf9e4fdba37d6f73",
    "benchmark/trace.py": "a0e1afe9ba7882d0eca510c86f6c1cebeba7fd9b1c72d876059897c0d7b82fbe",
    "benchmark/traffic/closed_loop.py": "669ffb63227a1659d13021a5bb815ce33f045976a10db9e2dc9c121e747d0a8a",
    "benchmark/traffic/generate.json": "8b9e24a7ea866c5f520d9ed6a462595a6a50a51faada23a2a08fe885ba40a2ce",
    "benchmark/traffic/open_loop.py": "c203201e33845f2e88cb70e398cd202ba00bfa6584089a032606b862a028ba0e",
    "benchmark/traffic/train.json": "e9486d97a0bdbe74c2d905590725cc8657a67ea776180fedfff0208e5fc2f16e",
    "benchmark/traffic/train_batches.py": "1afa96dbdb5222c2e13768e47bc4f6595f475484eca920009c36203f19f52433",
    "benchmark/training.py": "0b8d19b392dd3f1db8d4460a7a25bff5b3ebc5e754b0d1c2c2010872afc95fe8",
    "benchmark/weights.py": "64ef208339ac528cfd850ac8d0698c9fb317143793756c32a2a8da03d40d2639",
    "benchmark/work.py": "ad776a7b38e5a582acd1f962113926efbd8022e52759539cd362456199cbd95f",
}


def test_the_work_counts_at_the_published_sizes():
    fam = spec.family(CFG)
    assert fam.__file__ == str(spec.HERE / "families" / "mellum2.py")
    assert [fam.k1_work(CFG, p) for p in POSITIONS] == K1
    assert [fam.span_flops(CFG, p, p + 1, True) for p in POSITIONS] == TOKEN
    assert (fam.span_flops(CFG, 0, 1024, False), fam.span_flops(CFG, 1024, 3072, True)) \
        == SPANS
    assert fam.param_count(CFG) == PARAMS == CFG["params"]
    assert fam.active_layer_params(CFG) == ACTIVE_LAYER
    assert fam.expert_work(CFG) == EXPERT
    assert fam.k1_launches_per_step(CFG) == 28
    assert fam.windows(CFG) == [1024, 1024, 1024, None] * 7


def test_the_family_serves_only():
    fam = spec.family(CFG)
    for fn in (fam.port_train_step, fam.loss_and_grads, fam.train_step_flops,
               fam.flash_work, fam.flash_launches_per_step):
        with pytest.raises(NotImplementedError, match="no Mellum2 training cell"):
            fn(CFG)


def _tiny():
    cell = tiny_cell(CELL)
    cell.config = {**cell.config, **TINY}
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_mellum2_run_is_correct_and_reports_its_metrics(trace):
    cell = _tiny()
    rc, res, err = run_tiny(cell, trace=trace)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in cell.metrics(bool(trace))}
    # The CPU has no device trace: those readers find nothing and stay out.
    device_only = {m["name"] for m in cell.bench["per_layer"] if m["source"] == "device_trace"}
    assert set(res["metrics"]) == want - device_only
    if trace:
        assert {"moe.rows_per_expert", "moe_roofline"} <= want
        rows = res["metrics"]["moe.rows_per_expert"]["value"]
        # 4 slots at top-2 over 8 experts: at most 8 rows a call, in 2-8 experts.
        assert 1.0 <= rows <= 4.0
    for m in res["metrics"].values():
        assert m["value"] > 0


class _Slice:
    def __init__(self, device):
        self.device = device


def _roofline_run(device, reads, positions=64, steps=64, chunks=1, chunk=64):
    return {"cfg": CFG, "chunk": chunk,
            "counters": {"moe_decode_expert_reads": reads, "chunks_run": chunks},
            "slice": {"trace": _Slice(device), "decode_positions": [100] * positions,
                      "decode_steps": steps}}


def test_the_expert_roofline_counts_decode_kernels_only():
    """Prefill's grouped products launch no K1 and stay out; a decode
    layer's two after its K1 count.  One step of 28 layers, 64 rows, every
    expert read: 64 x 28 x 8 rows' operations and 28 x 64 experts' bytes
    over the decode records' time."""
    reader = spec.load_module(spec.HERE / "metrics" / "moe_roofline.py")
    gemm, prep = (f"kernel<{m}>" for m in reader.META["kernels"])
    product = [(0.0, 5.0, prep), (5.0, 200.0, gemm)]  # 200 us a product

    def at(t, ops):
        return [(t + a, t + b, n) for a, b, n in ops]

    device, t = [], 0.0
    for _ in range(56):  # a prefill sweep's products before any decode
        device += at(t, product)
        t += 200.0
    for _ in range(28):
        device += at(t, [(0.0, 10.0, "paged_decode_kernel"), (10.0, 20.0, "elementwise")])
        device += at(t + 20.0, product) + at(t + 220.0, product)
        t += 420.0
    for _ in range(56):  # and one after
        device += at(t, product)
        t += 200.0
    seconds, records = reader.decode_kernel_s(device)
    assert records == 4 * 28 and seconds == pytest.approx(56 * 200e-6)
    share = reader.read(_roofline_run(device, reads=64 * 28, steps=1, chunk=1))
    nbytes = 28 * 64 * EXPERT[1]
    assert share == pytest.approx(100.0 * nbytes / 3.35e12 / (56 * 200e-6))
    assert 0 < share <= 100


def test_the_expert_readers_read_nothing_without_their_counters():
    rows = spec.load_module(spec.HERE / "metrics" / "moe.rows_per_expert.py")
    roof = spec.load_module(spec.HERE / "metrics" / "moe_roofline.py")
    assert rows.read({"counters": {"chunks_run": 3}}) is None
    assert rows.read({"counters": {"moe_decode_assignments": 0,
                                   "moe_decode_expert_reads": 0}}) is None
    assert rows.read({"counters": {"moe_decode_assignments": 150,
                                   "moe_decode_expert_reads": 20}}) == 7.5
    assert roof.read({"counters": {"chunks_run": 3}, "slice": None}) is None
    assert roof.read(_roofline_run([(0.0, 1.0, "paged_decode_kernel")], reads=5)) is None


@pytest.mark.parametrize("path", sorted(BEFORE))
def test_the_files_before_the_family_are_unchanged(path):
    data = (ROOT / path).read_bytes()
    assert hashlib.sha256(data).hexdigest() == BEFORE[path]
