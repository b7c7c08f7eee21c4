"""The window's wall time over the decode steps the engine dispatched
(ServeEngine.chunks_run x chunk)."""

META = {"unit": "ms", "better": "lower", "source": "program_counter",
        "layer": "Paged model step (paged.py, decode_graph.py)",
        "moves": "output_tokens_per_s"}


def read(run):
    steps = run["counters"]["chunks_run"] * run["chunk"]
    return 1e3 * run["window_s"] / steps if steps else None
