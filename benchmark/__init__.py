"""The benchmark of garage_tpu_torch: ``python3 benchmark/run.py``.

It measures the PyTorch and CUDA port only; no module under this folder
imports JAX or the JAX package, and ``reference/`` imports nothing of
the port.  See README.md here for the layout and its rules.
"""
