"""The training step's share of the bf16 peak: model FLOPs of a step
(3 x the forward's products, unembed included, and its causal attention,
the window counted, recompute not counted) x steps over the window, as
the configuration's block family counts them."""

from benchmark import spec, work

META = {"unit": "%", "better": "higher", "source": "host_clock",
        "layer": "Trainer (train.py)", "moves": "train_tokens_per_s"}


def read(run):
    if not run["steps"]:
        return None
    cfg = run["cfg"]
    flops = spec.family(cfg).train_step_flops(cfg, run["batch"], run["seq"]) * run["steps"]
    return 100.0 * flops / run["window_s"] / work.PEAK_BF16_FLOPS
