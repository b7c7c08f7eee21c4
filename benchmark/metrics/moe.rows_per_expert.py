"""Rows each expert's weight read served while decoding: the routed
(token, expert) rows of live rows over the experts read, both summed
over the window's decode steps and every expert layer
(ServeEngine.moe_decode_assignments / moe_decode_expert_reads).  The
cell names both among its ``counters``; a run that did not record them,
or read no expert, reads nothing."""

META = {"unit": "rows", "better": "higher", "source": "program_counter",
        "layer": "Expert layer (moe.py)", "moves": "output_tokens_per_s"}


def read(run):
    c = run["counters"]
    reads = c.get("moe_decode_expert_reads")
    if not reads or c.get("moe_decode_assignments") is None:
        return None
    return c["moe_decode_assignments"] / reads
