"""Idle time while the engine's own host code ran: the idle gaps of the
profiled slice whose middle lies inside an ``engine.step`` span and
outside every ``engine.sync`` span (there the host waits on the device),
over the slice's wall.  A program that records no ``engine.step`` span
reads nothing."""

from benchmark import phases

META = {"unit": "%", "better": "lower", "source": "device_trace",
        "layer": "Engine (serve.py)", "moves": "output_tokens_per_s"}


def read(run):
    sl = run.get("slice")
    if not sl:
        return None
    return phases.idle_share(sl["trace"], "engine.step", outside=("engine.sync",))
