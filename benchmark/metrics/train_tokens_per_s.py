"""Token positions trained by the window's steps over the window's
seconds; each step ends in a synchronise."""

META = {"unit": "tokens/s", "better": "higher", "source": "host_clock", "layer": None}


def read(run):
    return run["tokens"] / run["window_s"]
