"""The whole step's share of the bf16 peak while decoding: model FLOPs of
the prompt and output tokens the window processed over the summed wall
time of the step() calls that dispatched work."""

from benchmark import work
from benchmark.serving import decode_flops

META = {"unit": "%", "better": "higher", "source": "host_clock",
        "layer": "Whole step (serve.py, paged.py)", "moves": "output_tokens_per_s"}


def read(run):
    if run["stepping_s"] <= 0:
        return None
    flops = decode_flops(run["cfg"], run["asks"], run["t0"] + run["window_s"])
    return 100.0 * flops / run["stepping_s"] / work.PEAK_BF16_FLOPS
