"""Output tokens of every request seen by the window's end, over the
window's seconds."""

META = {"unit": "tokens/s", "better": "higher", "source": "host_clock", "layer": None}


def read(run):
    return sum(a.seen for a in run["asks"]) / run["window_s"]
