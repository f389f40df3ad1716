"""The flagship scrub step and its multi-device run.

Counterpart of ``__graft_entry__.py``: the batched scrub step (BLAKE2s
verify of every block and RS(k, m) parity of its shards) that replaces
the reference's sequential per-block CPU loop.

  entry(device)                → (the one-device scrub step, example
                                  tensors on `device`)
  dryrun_multichip(n, devices) → the step split over n devices (batch
                                  slices, the corrupt counts summed on the
                                  first), then CudaCodec with
                                  ``shard_mesh = n`` through its fused
                                  scrub, checked against the GF oracle.

The reference's XLA flags, subprocess re-exec and alarm exist to get a
virtual CPU mesh out of JAX and have no counterpart here: a device list
may name "cpu" n times, or one card n times.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import gf256
from .ops.sharded import gf_bitmatmul, sharded_fns, to_host, verify_kernel


def _example_batch(bsz: int, nbytes: int, k: int, m: int, seed: int = 0):
    """(data (bsz, nbytes) uint8, lengths (bsz,) int32, expected (bsz, 8)
    uint32 digests, shards (bsz, k, nbytes // k) uint8, w_enc (8k, 8m)
    int8), as numpy arrays: the reference's example batch."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (bsz, nbytes), dtype=np.uint8)
    lengths = np.full((bsz,), nbytes, dtype=np.int32)
    expected = np.stack([
        np.frombuffer(hashlib.blake2s(data[i].tobytes(),
                                      digest_size=32).digest(), dtype="<u4")
        for i in range(bsz)]).astype(np.uint32)
    shards = data.reshape(bsz, k, nbytes // k)
    w_enc = np.asarray(
        gf256.bitmatrix_of_gf_matrix(gf256.rs_parity_matrix(k, m)),
        dtype=np.int8)
    return data, lengths, expected, shards, w_enc


def _as_device(args, device) -> tuple:
    """The example batch as tensors on `device` (digest words as int32)."""
    data, lengths, expected, shards, w_enc = args
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (data, lengths, expected.view(np.int32), shards,
                           w_enc))


def _scrub_step(data_u8, lengths, expected, shards, w_enc):
    """One scrub step on one device: batch-verify every block's BLAKE2s
    hash and compute its RS(k, m) parity shards → (digests, ok,
    n_corrupt, parity)."""
    digests, ok, n_corrupt = verify_kernel(data_u8, lengths, expected)
    parity = gf_bitmatmul(shards, w_enc)
    return digests, ok, n_corrupt, parity


def entry(device="cuda"):
    """(fn, example_args): the one-device step and its arguments, 8
    blocks of 512 bytes at RS(8, 4), as tensors on `device`."""
    args = _example_batch(bsz=8, nbytes=512, k=8, m=4)
    return _scrub_step, _as_device(args, device)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """Run the scrub step split over `n_devices` devices (`devices`, or
    the first n GPUs) on small shapes, then the production path on the
    same devices: CudaCodec at RS(4, 2) with ``shard_mesh = n``, its
    fused scrub as the node's ScrubWorker drives it, against the GF
    oracle.  Raises AssertionError on a wrong result."""
    from .ops.codec import CodecParams
    from .ops.cuda_codec import CudaCodec
    from .utils.data import Hash

    if devices is None:
        count = torch.cuda.device_count()
        if count < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {count}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devs = [torch.device(d) for d in devices][:n_devices]
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")

    # the batch divides over the devices; tiny shapes otherwise
    bsz = max(8, n_devices)
    bsz += (-bsz) % n_devices
    data, lengths, expected, shards, w_enc = _example_batch(
        bsz=bsz, nbytes=256, k=8, m=4)
    fns = sharded_fns(devs)
    _digests, ok, n_corrupt = fns["verify"](data, lengths, expected)
    parity = to_host(fns["rs_encode"](shards, w_enc))
    assert bool(to_host(ok).all()), "verify failed on clean batch"
    assert int(n_corrupt) == 0
    assert parity.shape == (bsz, 4, 256 // 8)

    # the production path on the same devices: CudaCodec with
    # shard_mesh, through the fused scrub the ScrubWorker drives
    codec = CudaCodec(
        CodecParams(rs_data=4, rs_parity=2, shard_mesh=n_devices,
                    batch_blocks=max(8, n_devices)),
        device=devs[0], devices=devs)
    assert len(codec.shards) == n_devices, "shard_mesh did not split"
    rng = np.random.default_rng(1)
    nblk = max(8, n_devices)
    nblk += (-nblk) % 4  # whole codewords, for the codec AND the oracle
    blocks = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
              for _ in range(nblk)]
    hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]
    ok2, parity2 = codec.scrub_encode_batch(blocks, hashes,
                                            fetch_parity=True)
    assert bool(np.all(ok2)), "split codec verify failed"
    grouped = np.stack([np.frombuffer(b, dtype=np.uint8)
                        for b in blocks]).reshape(-1, 4, 512)
    expect = gf256.gf_matmul_blocks(gf256.rs_parity_matrix(4, 2), grouped)
    assert np.array_equal(parity2, expect), \
        "split codec parity differs from the GF oracle"


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
