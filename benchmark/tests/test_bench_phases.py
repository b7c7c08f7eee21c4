"""The readers of idle time by the program's phase spans
(``device_idle.engine``, ``device_idle.optimizer``) on synthetic slices:
which gaps each rule counts, and nothing read where there is nothing to
read."""

import pytest

from benchmark import spec, trace

ENGINE = spec.load_module(spec.HERE / "metrics" / "device_idle.engine.py").read
OPTIMIZER = spec.load_module(spec.HERE / "metrics" / "device_idle.optimizer.py").read
IDLE = spec.load_module(spec.HERE / "metrics" / "device_idle.decode.py").read


def make_slice(tmp_path, device, host, wall_us=1000.0):
    """A read slice with these (start us, end us, name) device operations
    and host events."""
    sl = trace.Slice(str(tmp_path), cuda=False)
    sl.device = sorted(device)
    sl.host = list(host)
    sl.wall_s = wall_us * 1e-6
    return {"slice": {"trace": sl}}


# Device operations with three gaps: 100-200, 300-400 and 500-700 us.
OPS = [(0.0, 100.0, "k"), (200.0, 300.0, "k"), (400.0, 500.0, "k"), (700.0, 1000.0, "k")]


def test_a_gap_under_engine_decode_counts(tmp_path):
    host = [(50.0, 750.0, "engine.step"), (120.0, 190.0, "engine.decode")]
    run = make_slice(tmp_path, OPS, host)
    # Every gap's middle (150, 350, 600) lies inside engine.step; none
    # inside engine.sync: 100 + 100 + 200 us of 1,000.
    assert ENGINE(run) == pytest.approx(40.0)
    assert ENGINE(run) <= IDLE(run)


def test_a_gap_under_engine_sync_or_outside_the_step_does_not(tmp_path):
    host = [
        (50.0, 450.0, "engine.step"),
        (120.0, 190.0, "engine.decode"),
        (320.0, 390.0, "engine.sync"),   # the host waits: 300-400 is out
        (460.0, 800.0, "bench.track"),   # after the step: 500-700 is out
    ]
    run = make_slice(tmp_path, OPS, host)
    assert ENGINE(run) == pytest.approx(10.0)


def test_a_gap_under_the_optimizer_counts_and_under_loss_grad_does_not(tmp_path):
    host = [
        (0.0, 1000.0, "bench.train_step"),
        (0.0, 320.0, "train.loss_grad"),
        (330.0, 900.0, "train.optimizer"),
    ]
    run = make_slice(tmp_path, OPS, host)
    # 100-200 lies under train.loss_grad; 300-400 has its middle (350) and
    # 500-700 its middle (600) under train.optimizer.
    assert OPTIMIZER(run) == pytest.approx(30.0)
    assert OPTIMIZER(run) <= IDLE(run)


def test_overlapping_spans_of_one_name_cover_their_union(tmp_path):
    host = [(50.0, 700.0, "engine.step"), (60.0, 120.0, "engine.step")]
    assert ENGINE(make_slice(tmp_path, OPS, host)) == pytest.approx(40.0)


@pytest.mark.parametrize("reader", [ENGINE, OPTIMIZER])
def test_nothing_is_read_without_device_records_or_spans(tmp_path, reader):
    host = [(0.0, 1000.0, "engine.step"), (0.0, 1000.0, "train.optimizer")]
    assert reader(make_slice(tmp_path, [], host)) is None
    # The program before its phase spans: a device trace, no span to read.
    assert reader(make_slice(tmp_path, OPS, [(0.0, 1000.0, "bench.step")])) is None
    assert reader({"slice": None}) is None
    assert reader({}) is None


def test_the_engines_spans_reach_the_slices_host_events(tmp_path):
    """A tiny engine stepped inside a CPU slice: its ``record_function``
    spans are among the host events the readers search."""
    import torch

    from workloads_torch import prng
    from workloads_torch.model import ModelConfig, init_params
    from workloads_torch.serve import ServeEngine

    config = ModelConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                         max_seq_len=64, dtype=torch.float32)
    engine = ServeEngine(init_params(config, prng.PRNGKey(0, device="cpu")), config,
                         slots=2, page_size=4, prompt_bucket=12, chunk=4,
                         pipelined=True, device="cpu")
    engine.submit(list(range(1, 10)), 6)
    with trace.Slice(str(tmp_path), cuda=False) as sl:
        engine.step()
        engine.step()
    sl.read()
    names = {name for _, _, name in sl.host}
    assert {"engine.step", "engine.admit", "engine.prefill", "engine.decode",
            "engine.sync"} <= names
