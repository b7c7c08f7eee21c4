"""On the card: a small model through each traffic kind with the trace
on, so the device-trace readers find the kernels they name.  Run on the
chip with ``python -m pytest benchmark/tests/test_bench_card.py``; here
they skip."""

import pytest

from .tiny import run_tiny, tiny_cell

# Head size 128, as the CUDA kernels take it.
CARD = {"hidden_size": 256, "num_attention_heads": 2, "num_hidden_layers": 2,
        "intermediate_size": 512, "vocab_size": 512, "max_position_embeddings": 96,
        "dtype": "bfloat16"}


def _card_cell(name):
    cell = tiny_cell(name)
    cell.config = {**cell.config, **CARD}
    return cell


@pytest.mark.gpu
@pytest.mark.parametrize("name, roofline", [("pythia-6.9b.generate", "k1_roofline"),
                                            ("pythia-1.4b.train", "flash_roofline")])
def test_traced_run_on_the_card_reads_its_kernels(name, roofline, cuda_card):
    cell = _card_cell(name)
    rc, res, err = run_tiny(cell, trace=1, device="cuda")
    assert rc == 0, err[-3000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["metrics"][roofline]["value"] <= 105
    assert res["breakdown"]["device_ops"]
