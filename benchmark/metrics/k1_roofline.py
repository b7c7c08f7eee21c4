"""K1's share of its roofline in the profiled slice: the least time the
bytes (and operations) its decoded tokens need could take, each token
reading its row's live K and V once a layer with q and the output once,
over the device time of paged_decode_kernel.  The work counts the tokens
that the slice's chunks emitted, read from the requests, so steps a row
runs past its end are time without work; a trace that drops kernel
records is scaled by the launches those chunks make.  The bytes,
operations and launches are the configuration's block family's."""

from benchmark import spec, work

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
    fam = spec.family(cfg)
    expected = fam.k1_launches_per_step(cfg) * sl["decode_steps"]
    seconds *= max(1.0, expected / records)
    counts = [fam.k1_work(cfg, p) for p in sl["decode_positions"]]
    flops = sum(f for f, _ in counts)
    nbytes = sum(b for _, b in counts)
    return work.roofline_share(work.bound_s(flops, nbytes), seconds)
