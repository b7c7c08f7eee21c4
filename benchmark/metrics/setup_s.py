"""Set-up seconds: process start to the first timed work (weights, the
system under test, warm-up, and on a first run the kernels' builds)."""

META = {"unit": "s", "better": "lower", "source": "host_clock", "layer": None}


def read(run):
    return run["setup_s"]
