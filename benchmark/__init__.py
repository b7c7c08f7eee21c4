"""The benchmark of the PyTorch and CUDA port (``workloads_torch``).

One command runs one cell once, from the root of a checkout:

    python3 benchmark/run.py --workload pythia-6.9b.generate --seed 7 \\
        --seconds 51 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics; everything else is found by name under this folder:

- ``configs/<config>.json``: a model configuration's sizes and source;
- ``families/<family>.py``: the block family a configuration names by
  its ``"family"`` key (``dense`` without one): the port's config and
  train step, the weights, the plain reference and the work counts of
  that block;
- ``cells/<cell>.json``: a cell's engine or trainer settings, the engine
  counters it records beside the fixed ones, and the limits of its
  correctness check;
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the
  generator of its ``kind`` (``traffic/<kind>.py``);
- ``metrics/<metric>.py``: the reader of one metric;
- ``reference/``: the plain float32 model, loss and AdamW that decide
  ``correct``; it imports nothing of the port.

Nothing here imports ``jax`` or the JAX package ``workloads``; the port
is imported only by ``serving.py``, ``training.py`` and the families,
inside a run.
"""
