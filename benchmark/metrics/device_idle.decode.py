"""The device's idle share in the profiled slice: 1 - the union of its
operations' intervals over the slice's wall time."""

META = {"unit": "%", "better": "lower", "source": "device_trace", "layer": "Device",
        "moves": "output_tokens_per_s"}


def read(run):
    sl = run.get("slice")
    if not sl or sl["trace"].wall_s <= 0 or not sl["trace"].device:
        return None
    return 100.0 * (1.0 - sl["trace"].busy_s() / sl["trace"].wall_s)
