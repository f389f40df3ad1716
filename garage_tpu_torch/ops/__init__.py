"""ops — the BlockCodec device-op layer of the port.

The block layer's integrity hashing and Reed-Solomon erasure coding run
as batch operations behind the ``BlockCodec`` interface (ops/codec.py),
bit-identical to the reference package's codecs:

  - cpu backend (cpu_codec.py): hashlib + GF(2^8) through the native
    C++ kernels (native.py) or numpy — the correctness baseline;
  - cuda backend (cuda_codec.py): BLAKE2s-256 and the GF(2^8) matrix
    apply as CUDA kernels;
  - hybrid backend (hybrid_codec.py): the CPU floor plus a CudaCodec fed
    through the DeviceTransport (transport.py, pinned double-buffered
    staging) and the DevicePool (device_pool.py) — the configured
    default of the daemon (`codec.backend`).
"""

from __future__ import annotations

from .codec import BlockCodec, CodecParams


def make_codec(backend: str = "cuda", metrics=None, tracer=None,
               device="cuda", devices=None, **kw) -> BlockCodec:
    """Codec factory.  ``backend="cuda"`` builds a CudaCodec and
    ``"hybrid"`` a HybridCodec whose device side is a CudaCodec, both on
    `device`: "cuda" (the default) needs a GPU and raises without one;
    "cpu" runs the kernels' plain versions (the tests' path).  With
    ``shard_mesh=n > 1`` the CudaCodec splits every batch over n devices:
    the first n of `devices` when given, else the first n GPUs (raising
    when there are fewer) or n times "cpu".  ``"cpu"`` builds the CPU
    codec, which has no device."""
    if backend == "cpu":
        from .cpu_codec import CpuCodec
        return CpuCodec(CodecParams(**kw), metrics=metrics, tracer=tracer)
    if backend == "cuda":
        from .cuda_codec import CudaCodec
        return CudaCodec(CodecParams(**kw), device=device, devices=devices,
                         metrics=metrics, tracer=tracer)
    if backend == "hybrid":
        from .hybrid_codec import HybridCodec
        return HybridCodec(CodecParams(**kw), device=device, devices=devices,
                           metrics=metrics, tracer=tracer)
    raise ValueError(f"unknown codec backend {backend!r}")
