"""garage_tpu_torch — the PyTorch/CUDA port of garage_tpu.

The port is a package of its own beside ``garage_tpu`` (the JAX
reference, which it never imports) and mirrors its module layout.  It
grows one slice at a time.  It holds the block codec (``ops/``):
BLAKE2s-256 integrity hashing and Reed-Solomon GF(2^8) parity as CUDA
kernels for Hopper (``csrc/``), the ``CudaCodec`` that drives them, the
``HybridCodec`` production stack and the ``CodecFeeder`` that batches
requests in front of it; the block store node above it: ``utils/``
(config, CRDTs, persistence, background workers, the incident flight
recorder), ``db/``, ``net/``, ``rpc/`` (``System``, layout, ring) and
``block/`` (``BlockManager``, scrub, resync, parity sidecars, the
layout-change mover and the full-node-loss rebuild); and the metadata
plane and node object: the CRDT table engine (``table/``: schema, data,
Merkle trees, anti-entropy sync, tombstone GC, insert queue), the data
model (``model/``: buckets, keys, S3 objects, versions, block refs,
multipart uploads, lifecycle, K2V, the parity index and the distributed
parity repair) and ``model.Garage``, which wires one node, plus the
API front door's admission gate (``api/admission.py``).  The HTTP APIs
and the daemon are not ported yet.

Entry points run on the GPU: ``Garage(config)`` and
``make_codec("cuda" | "hybrid", ...)`` build the codec on the card and
raise without one.  ``device="cpu"`` is the only way onto the CPU,
where each kernel's plain PyTorch version runs; it exists for the tests.
"""

__version__ = "0.9.5"
