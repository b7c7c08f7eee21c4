"""The prefill dispatches' fill: prompt tokens the engine forwarded in
the window over the token rows its target prefill dispatches ran,
padding included (ServeEngine.prefill_tokens / prefill_padded_tokens).
The cell names ``prefill_padded_tokens`` among its ``counters``; a run
that did not record it, or whose window dispatched no prefill, reads
nothing."""

META = {"unit": "%", "better": "higher", "source": "program_counter",
        "layer": "Engine (serve.py)", "moves": "output_tokens_per_s"}


def read(run):
    c = run["counters"]
    padded = c.get("prefill_padded_tokens")
    if not padded:
        return None
    return 100.0 * c["prefill_tokens"] / padded
