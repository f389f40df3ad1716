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
parity repair) and ``model.Garage``, which wires one node; and the
daemon: the HTTP front doors (``api/``: SigV4, the S3 API, K2V, the
admin REST API and ``/metrics``, the admission gate), the website
server (``web/``), the admin RPC handler (``admin/``), ``server.py``
and the CLI (``python -m garage_tpu_torch -c garage.toml server``); the
host layers beside them: the ``native`` log-structured metadata engine
(``db/native_adapter.py`` over ``native/logdb.cpp``), Consul and
Kubernetes peer discovery (``rpc/discovery.py``), the K2V client
(``k2v_client.py``) and the drill rig (``testing/``: fault injection,
the in-process SimCluster, the gateway-pool client and the trace
replayer).

Entry points run on the GPU: ``Garage(config)``, ``Server(config)``,
``SimCluster``, ``FaultInjector.revive``, the ``server`` command and
``make_codec("cuda" | "hybrid", ...)`` build the codec on the card and
raise without one.  ``device="cpu"`` is the
only way onto the CPU, where each kernel's plain PyTorch version runs;
it exists for the tests.  A config with ``codec.backend = "cpu"`` asks
for the native C++ floor and builds no device codec.
"""

__version__ = "0.9.5"

# what this build ships, surfaced by `--version` and node stats
FEATURES = [
    "k2v", "lmdb-equivalent-logdb", "sqlite", "consul-discovery",
    "kubernetes-discovery", "metrics", "telemetry-otlp",
    "codec-cpu", "codec-cuda", "codec-hybrid", "repair-tree",
]
