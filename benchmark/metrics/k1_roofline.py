"""K1's share of its roofline in the profiled slice: the least time the
bytes (and operations) its decoded tokens need could take, each token
reading its row's live K and V once a layer with q and the output once,
over the device time of paged_decode_kernel.  The work counts the tokens
that the slice's chunks emitted, read from the requests, so steps a row
runs past its end are time without work; a trace that drops kernel
records is scaled by the launches those chunks make (one a layer a
step)."""

from benchmark import work

META = {"unit": "%", "better": "higher", "source": "device_trace",
        "layer": "Kernels (ops/paged_attention.py, ops/attention.py)",
        "moves": "output_tokens_per_s", "kernels": ["paged_decode"]}


def read(run):
    sl = run.get("slice")
    if not sl or not sl["decode_positions"]:
        return None
    cfg = run["cfg"]
    seconds, records = sl["trace"].kernel_s(*META["kernels"])
    if records == 0:
        return None
    expected = cfg["num_hidden_layers"] * sl["decode_steps"]
    seconds *= max(1.0, expected / records)
    nbytes = sum(work.k1_bytes(cfg, p) for p in sl["decode_positions"])
    flops = sum(work.k1_flops(cfg, p) for p in sl["decode_positions"])
    return work.roofline_share(work.bound_s(flops, nbytes), seconds)
