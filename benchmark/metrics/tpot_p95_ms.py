"""p95 over requests of (last token - first token) / (tokens - 1), for
every request with two tokens or more in the window; one still running
at the end counts over the tokens it emitted."""

from benchmark.serving import p95, tpots_ms

META = {"unit": "ms", "better": "lower", "source": "host_clock", "layer": None}


def read(run):
    return p95(tpots_ms(run))
