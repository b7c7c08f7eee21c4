"""Training traffic: one data-parallel rank's micro-batches, each step a
fresh batch of ``batch`` rows of ``seq_len`` token ids uniform over the
vocabulary, drawn on the device from the seed and the step number, so no
two rows of a run are alike and the reference can draw them again."""

from __future__ import annotations

import torch

from benchmark import weights

RUNNER = "train"


def batch(mix: dict, seed: int, step: int, vocab: int, device) -> torch.Tensor:
    rows, seq = int(mix["batch"]), int(mix["seq_len"])
    return weights.token_ids(seed, f"batch:{step}", rows * seq, vocab, device).view(rows, seq)
