"""Idle time while the train step's optimizer ran: the idle gaps of the
profiled slice whose middle lies inside a ``train.optimizer`` span (the
AdamW update, launched leaf by leaf), over the slice's wall.  A program
that records no ``train.optimizer`` span reads nothing."""

from benchmark import phases

META = {"unit": "%", "better": "lower", "source": "device_trace",
        "layer": "Trainer (train.py)", "moves": "train_tokens_per_s"}


def read(run):
    sl = run.get("slice")
    if not sl:
        return None
    return phases.idle_share(sl["trace"], "train.optimizer")
