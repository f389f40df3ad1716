"""garage_tpu_torch — the PyTorch/CUDA port of garage_tpu.

The port is a package of its own beside ``garage_tpu`` (the JAX
reference, which it never imports) and mirrors its module layout.  It
grows one slice at a time.  It holds the block codec (``ops/``):
BLAKE2s-256 integrity hashing and Reed-Solomon GF(2^8) parity as CUDA
kernels for Hopper (``csrc/``), the ``CudaCodec`` that drives them, the
``HybridCodec`` production stack and the ``CodecFeeder`` that batches
requests in front of it; and one block store node above it: ``utils/``
(config, CRDTs, persistence, background workers), ``db/``, ``net/``,
``rpc/`` (``System``, layout, ring), ``table/replication`` and
``block/`` (``BlockManager``, scrub, resync, parity sidecars).

Entry points run on the GPU.  ``make_codec("cuda", device="cpu", ...)``
is the only way onto the CPU, where each kernel's plain PyTorch version
runs; it exists for the tests.
"""

__version__ = "0.9.5"
