"""The plain reference that decides ``correct``: the port's block in
float32 with TF32 off, written from its equations in plain ``torch`` and
frozen here.  It imports nothing of ``workloads_torch``, ``workloads`` or
``jax``, and takes only the inputs the benchmark made (weights, prompts,
batches); it works out again whatever the program derived from them.

The block (``model.py``) departs from GPT-NeoX, the architecture of the
Pythia configurations, in six places, each as the port runs it:

1. a sequential residual, ``x + attn(norm(x))`` then ``x + mlp(norm(x))``,
   where GPT-NeoX adds both branches to the same ``x`` (parallel);
2. rotary embedding over the whole head, where GPT-NeoX rotates 25% of it;
3. RMSNorm without bias (eps 1e-6) where GPT-NeoX has LayerNorm with a
   bias (eps 1e-5);
4. no biases on the q/k/v, output and MLP products;
5. the tanh approximation of GELU where GPT-NeoX uses erf;
6. no final norm before the unembed.

None changes a product's shape or its FLOPs beyond the norms and biases.

``model.py`` has a lower-precision mode (``fp8=True``): the operands of
every product, and of the two gradient products behind it, rounded to
float8 e4m3 with a per-tensor scale.  It is the control that the
comparison has to fail (``calibrate.py``); the benchmark's runs never use
it.
"""
