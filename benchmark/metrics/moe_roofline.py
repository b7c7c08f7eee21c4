"""The decode step's expert products' share of their roofline in the
profiled slice: the least time the work of the slice's decoded tokens
needs, over the device time of the grouped-product kernels that the
decode graph's replays ran (each ``torch._grouped_mm`` launches a
kernel that lays out its groups' problems, then the grouped GEMM: both
count).

Work: each decoded token's ``num_experts_per_tok`` routed rows in every
layer, at the family's operations a row (``expert_work``); bytes, each
expert a layer call reads, its three bf16 matrices once, at the
window's mean reads a call (``moe_decode_expert_reads`` over the
window's decode steps times the layers) for every decode step of the
slice.  The same kernels run in prefill, which launches no K1: a record
counts only as one of the first ``PER_LAYER`` marked records after a K1
record (``paged_decode``), that is inside a decode step's layer, so no
prefill time enters.  A trace that drops records is scaled by the
records the slice's decode steps launch.  The cell names the expert
counters among its ``counters``; without them, or without a decoded
token, it reads nothing."""

from benchmark import spec, work

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "Expert layer (moe.py)", "moves": "output_tokens_per_s",
        "kernels": ["GroupProblemShape", "prepare_grouped_gemm_data"]}
K1 = "paged_decode"
PER_LAYER = 4  # the gate-up and the down product, each with its layout kernel


def decode_kernel_s(device: list) -> tuple[float, int]:
    """(seconds, records) of the marked kernels inside decode steps:
    each K1 record opens a layer, whose first ``PER_LAYER`` marked
    records count."""
    seconds, records, since = 0.0, 0, None
    for start, end, name in device:
        if K1 in name:
            since = 0
        elif since is not None and since < PER_LAYER and any(m in name for m in META["kernels"]):
            seconds += end - start
            records += 1
            since += 1
    return seconds * 1e-6, records


def read(run):
    sl = run.get("slice")
    c = run["counters"]
    reads = c.get("moe_decode_expert_reads")
    if not sl or not sl["decode_positions"] or not reads or not c.get("chunks_run"):
        return None
    cfg = run["cfg"]
    seconds, records = decode_kernel_s(sl["trace"].device)
    if records == 0:
        return None
    layers = cfg["num_hidden_layers"]
    seconds *= max(1.0, PER_LAYER * layers * sl["decode_steps"] / records)
    row_flops, expert_bytes = spec.family(cfg).expert_work(cfg)
    reads_per_call = reads / (c["chunks_run"] * run["chunk"] * layers)
    flops = row_flops * len(sl["decode_positions"]) * layers * cfg["num_experts_per_tok"]
    nbytes = expert_bytes * reads_per_call * sl["decode_steps"] * layers
    return work.roofline_share(work.bound_s(flops, nbytes), seconds)
