"""The flash kernels' (K2-K4) share of their roofline in the profiled
slice: per kernel, the larger of the operations its causal pairs need
over the bf16 peak and its bytes (each input read and each output written
once) over the bandwidth, summed over the slice's steps, over the device
time of the three kernels.  With recomputed layers the forward runs
twice a step.  A trace that drops kernel records is scaled by the
launches the steps make.  The work and the launches are the
configuration's block family's."""

from benchmark import spec, work

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "Kernels (ops/paged_attention.py, ops/attention.py)",
        "moves": "train_tokens_per_s",
        "kernels": ["flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"]}


def read(run):
    sl = run.get("slice")
    if not sl:
        return None
    cfg = run["cfg"]
    seconds, records = sl["trace"].kernel_s(*META["kernels"])
    if records == 0:
        return None
    forwards = 2 if run["settings"]["trainer"]["remat_layers"] else 1
    fam = spec.family(cfg)
    expected = sl["steps"] * fam.flash_launches_per_step(cfg, forwards)
    seconds *= max(1.0, expected / records)
    work_ = fam.flash_work(cfg, run["batch"], run["seq"], forwards)
    bound = sum(work.bound_s(f, n) for f, n in work_) * sl["steps"]
    return work.roofline_share(bound, seconds)
