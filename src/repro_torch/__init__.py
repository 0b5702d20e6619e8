"""PyTorch + CUDA port of the MEC reproduction (``repro``), for NVIDIA
Hopper.  The module layout mirrors ``repro``: ``core`` (conv2d front-end
and reference algorithms), ``kernels`` (hand-written CUDA kernels with
their plain versions), ``launch.costmodel``, ``models.layers``,
``optim.adamw``, ``examples.train_cnn``, ``plan`` (the ConvPlan planner,
plan cache and calibration), ``bench.harness`` and ``convert`` (JAX
parameters to torch).  Imports torch and numpy only,
never jax or ``repro``."""
