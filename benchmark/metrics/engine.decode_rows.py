"""Useful rows a decode step: tokens the engine generated in the window
(less each admission's first token, which prefill makes) over the decode
steps it dispatched (chunks x chunk); from ServeEngine's counters."""

META = {"unit": "rows", "better": "higher", "source": "program_counter",
        "layer": "Engine (serve.py)", "moves": "output_tokens_per_s"}


def read(run):
    c = run["counters"]
    steps = c["chunks_run"] * run["chunk"]
    if steps == 0:
        return None
    return (c["generated_tokens"] - c["requests_admitted"]) / steps
