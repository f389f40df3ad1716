"""Batched BLAKE2s-256: the port (garage_tpu_torch) against the reference.

The same inputs, made with numpy from a seed, go through the reference's
Pallas kernel (interpret mode on the CPU) or its XLA scan, through the
port's plain PyTorch version, and through hashlib.  All of it is integer
work: the tolerance is exact equality.  The CUDA kernel itself runs only
on a GPU: tests/test_torch_cuda.py, and chip_smoke.py at full size.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garage_tpu.ops import tpu_blake2s as ref_b2s
from garage_tpu.ops.pallas_blake2s import blake2s_batch_pallas
from garage_tpu_torch.ops import blake2s as port_b2s
from garage_tpu_torch.ops import cuda_blake2s

SIZES = [0, 1, 63, 64, 65, 128, 1000, 4096, 16_001]


def _batch(rng, lengths, total):
    arr = np.zeros((len(lengths), total), np.uint8)
    for i, n in enumerate(lengths):
        arr[i, :n] = rng.integers(0, 256, (n,), np.uint8)
    return arr, np.asarray(lengths, np.int32)


def _plain(arr, lengths):
    out = port_b2s.blake2s_batch_plain(torch.from_numpy(arr),
                                       torch.from_numpy(lengths))
    return out.numpy().view(np.uint32)


def _hashlib(arr, lengths):
    return [hashlib.blake2s(arr[i, :n].tobytes(), digest_size=32).digest()
            for i, n in enumerate(lengths)]


def test_constants_match_reference():
    assert np.array_equal(port_b2s.IV, ref_b2s.IV)
    assert np.array_equal(port_b2s.SIGMA, ref_b2s.SIGMA)
    assert np.array_equal(port_b2s.H0, ref_b2s.H0)
    assert port_b2s._G_IDX == ref_b2s._G_IDX


def test_reference_sizes_match_hashlib_and_xla_scan():
    rng = np.random.default_rng(0)
    arr, lengths = _batch(rng, SIZES, 16_064)
    got = _plain(arr, lengths)
    for g, w, n in zip(got, _hashlib(arr, lengths), SIZES):
        assert g.astype("<u4").tobytes() == w, n
    want = np.asarray(ref_b2s.blake2s_batch(jnp.asarray(arr),
                                            jnp.asarray(lengths)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nchunks", [1, 3, 8])
def test_plain_matches_pallas_kernel(nchunks):
    """128 lanes (the Pallas kernel's lane tile) of random lengths."""
    rng = np.random.default_rng(100 + nchunks)
    total = nchunks * 64
    lengths = rng.integers(0, total + 1, 128).tolist()
    arr, lengths = _batch(rng, lengths, total)
    want = np.asarray(blake2s_batch_pallas(
        jnp.asarray(arr), jnp.asarray(lengths), interpret=True))
    got = _plain(arr, lengths)
    assert np.array_equal(got, want)
    assert [g.astype("<u4").tobytes() for g in got] == _hashlib(arr, lengths)


@pytest.mark.parametrize("bsz", [1, 7, 131])
def test_odd_batch_sizes(bsz):
    """No lane-tile rule: any B hashes, bit-identical to the XLA scan."""
    rng = np.random.default_rng(bsz)
    lengths = rng.integers(0, 5 * 64 + 1, bsz).tolist()
    arr, lengths = _batch(rng, lengths, 5 * 64)
    got = _plain(arr, lengths)
    want = np.asarray(ref_b2s.blake2s_batch(jnp.asarray(arr),
                                            jnp.asarray(lengths)))
    assert np.array_equal(got, want)


def test_length_past_row_matches_reference_scan():
    """A length beyond the row hashes the row without finalising, exactly
    as the reference scan does (the kernel never reads past the row)."""
    rng = np.random.default_rng(5)
    arr, _ = _batch(rng, [128, 128, 40], 128)
    lengths = np.array([1000, 129, 40], np.int32)
    want = np.asarray(ref_b2s.blake2s_batch(jnp.asarray(arr),
                                            jnp.asarray(lengths)))
    assert np.array_equal(_plain(arr, lengths), want)


def test_bytes_to_words_and_digests_to_bytes():
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, (3, 64), np.uint8)
    got = port_b2s.bytes_to_words(torch.from_numpy(arr)).numpy()
    want = np.asarray(ref_b2s.bytes_to_words(jnp.asarray(arr)))
    assert np.array_equal(got.view(np.uint32), want)
    h = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    assert port_b2s.digests_to_bytes(h.view(np.int32)) == \
        ref_b2s.digests_to_bytes(h)
    with pytest.raises(ValueError):
        port_b2s.bytes_to_words(torch.zeros(6, dtype=torch.uint8))


def test_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(11)
    arr, lengths = _batch(rng, [0, 65, 200], 256)
    before = cuda_blake2s.launches
    got = cuda_blake2s.blake2s_batch(torch.from_numpy(arr),
                                     torch.from_numpy(lengths))
    assert np.array_equal(got.numpy().view(np.uint32), _plain(arr, lengths))
    assert cuda_blake2s.launches == before  # no kernel ran
    meta = torch.empty((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_blake2s.blake2s_batch(meta, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_chain_probe_needs_a_cuda_device(device):
    """The dependent-latency probe measures the card; it has no plain
    version to fall back to."""
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_blake2s.g_chain_cycles(device)
