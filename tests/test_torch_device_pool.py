"""The port's DevicePool under its DeviceTransport against the reference's.

The same seeded blocks are scrubbed through the reference (transport +
pool over its ``SyntheticLinkCodec``) and through the port (transport +
pool over the port's ``SyntheticLinkCodec`` and over
``CudaCodec(device="cpu")``, whose pool API composes resident lanes from
torch page tensors).  Carried over: cold-then-warm hit/miss accounting
(hit + miss = bytes scrubbed, a warm pass stages nothing), ragged-tail
readback, a corrupt lane never adopted, invalidate → miss.  New: an
adopted page owns its storage (a page is not a view that keeps the whole
batch alive).  Integer work: exact equality; counts, never rates.
"""

import hashlib

import numpy as np
import pytest

from garage_tpu.ops.codec import CodecParams as RefParams
from garage_tpu.ops.cpu_codec import CpuCodec as RefCpu
from garage_tpu.ops.device_pool import DevicePool as RefPool
from garage_tpu.ops.transport import DeviceTransport as RefTransport
from garage_tpu.ops.transport import TransportItem as RefItem
from garage_tpu.testing.synthetic_device import SyntheticLinkCodec as RefSynth
from garage_tpu.utils.data import Hash as RefHash
from garage_tpu_torch.ops.codec import CodecParams
from garage_tpu_torch.ops.cpu_codec import CpuCodec
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.ops.device_pool import DevicePool
from garage_tpu_torch.ops.transport import DeviceTransport, TransportItem
from garage_tpu_torch.testing.synthetic_device import SyntheticLinkCodec
from garage_tpu_torch.utils.data import Hash
from garage_tpu_torch.utils.metrics import MetricsRegistry

DEVICES = ("synthetic", "cuda_cpu")
RAGGED = (4096, 1000, 4096, 256, 2048, 77, 3000, 1025)


def _blocks(n=8, seed=0, sizes=RAGGED):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (sizes[i % len(sizes)],),
                        dtype=np.uint8).tobytes() for i in range(n)]
    return out, [hashlib.blake2s(b, digest_size=32).digest() for b in out]


def _port(kind, page_bytes=1024, metrics=None):
    p = CodecParams(rs_data=4, rs_parity=2, block_size=4096)
    dev = (SyntheticLinkCodec(p, link_gibs=100.0, compute_real=True)
           if kind == "synthetic" else CudaCodec(p, device="cpu"))
    pool = DevicePool(dev, pool_bytes=64 << 20, page_bytes=page_bytes,
                      metrics=metrics)
    tr = DeviceTransport(dev, p, fallback=CpuCodec(p), metrics=metrics,
                         pool=pool)
    return tr, pool


def _ref(page_bytes=1024):
    p = RefParams(rs_data=4, rs_parity=2, block_size=4096)
    dev = RefSynth(p, link_gibs=100.0, compute_real=True)
    pool = RefPool(dev, pool_bytes=64 << 20, page_bytes=page_bytes)
    return RefTransport(dev, p, fallback=RefCpu(p), pool=pool), pool


def _scrub(tr, blocks, digests, port=True):
    item, hcls = (TransportItem, Hash) if port else (RefItem, RefHash)
    it = item("scrub", (blocks, [hcls(d) for d in digests]), len(blocks),
              sum(map(len, blocks)))
    tr.submit_items("scrub", [it])
    return it.future.result(timeout=60)


def _same(a, b):
    assert np.array_equal(a[0], b[0])
    assert a[1].shape == b[1].shape and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("kind", DEVICES)
def test_hit_miss_accounting_cold_then_warm_matches_reference(kind):
    reg = MetricsRegistry()
    tr, pool = _port(kind, metrics=reg)
    ref, rpool = _ref()
    blocks, digests = _blocks(9)
    total = sum(map(len, blocks))
    for _ in range(2):
        _same(_scrub(tr, blocks, digests), _scrub(ref, blocks, digests, False))
        if _ == 0:
            cold_staged = tr.staged_bytes
            assert cold_staged == total
            assert pool.stats()["miss_bytes"] == total
    st = pool.stats()
    assert st["hit_bytes"] == total and st["miss_bytes"] == total
    assert st["hit_bytes"] + st["miss_bytes"] == 2 * total
    assert tr.staged_bytes == cold_staged        # warm pass staged nothing
    for key in ("hit_bytes", "miss_bytes", "resident_blocks",
                "resident_bytes", "adopted"):
        assert st[key] == rpool.stats()[key], key
    body = reg.render()
    assert "pool_hit_bytes_total" in body and "pool_miss_bytes_total" in body
    tr.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_ragged_tail_readback_bit_identical(kind):
    tr, pool = _port(kind, page_bytes=1024)
    blocks, digests = _blocks(8)
    _scrub(tr, blocks, digests)
    for b, d in zip(blocks, digests):
        assert pool.read(d) == b, len(b)
    assert pool.resident_bytes == sum(pool.bytes_for(len(b)) for b in blocks)
    tr.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_partial_residency_after_invalidate_matches_reference(kind):
    """Invalidated blocks miss on the next pass and the rest hit; the
    mixed batch (compact miss upload + composed resident lanes) gives the
    reference's result, and a post-invalidate read is None."""
    tr, pool = _port(kind)
    ref, _rpool = _ref()
    blocks, digests = _blocks(8)
    _scrub(tr, blocks, digests)
    dropped = [2, 5]
    for i in dropped:
        assert pool.invalidate(digests[i], reason="delete")
        assert pool.read(digests[i]) is None
        assert not pool.invalidate(digests[i], reason="overwrite")
    before = pool.stats()
    digests_bad = list(digests)
    digests_bad[6] = bytes(32)
    _same(_scrub(tr, blocks, digests_bad),
          _scrub(ref, blocks, digests_bad, False))
    st = pool.stats()
    # the corrupt expectation of lane 6 is a key the pool never held
    miss = sum(len(blocks[i]) for i in dropped + [6])
    assert st["miss_bytes"] - before["miss_bytes"] == miss
    assert st["hit_bytes"] - before["hit_bytes"] == sum(map(len, blocks)) - miss
    assert st["invalidated"] == 2 and st["resident_blocks"] == 8
    tr.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_corrupt_lane_never_adopted(kind):
    tr, pool = _port(kind)
    blocks, digests = _blocks(4)
    bad = list(blocks)
    bad[2] = b"\x00" + bad[2][1:]
    ok, _par = _scrub(tr, bad, digests)
    assert ok.tolist() == [True, True, False, True]
    assert pool.read(digests[2]) is None
    assert pool.stats()["resident_blocks"] == 3
    tr.shutdown()


@pytest.mark.parametrize("page", [1024, 4096])
def test_adopted_page_owns_its_storage(page):
    """CudaCodec.pool_adopt hands the pool pages with their own storage
    of exactly one page: the batch they were cut from can be freed."""
    p = CodecParams(rs_data=4, rs_parity=2)
    codec = CudaCodec(p, device="cpu")
    blocks, digests = _blocks(8)
    arr, lengths, expected = codec._pad_group(blocks, [Hash(d) for d in digests])
    out, full = codec.scrub_encode_submit_resident(
        arr, list(range(arr.shape[0])), lengths, expected, [])
    ok, _par = codec.scrub_collect(out, True)
    assert ok[:8].all()
    batch_bytes = full.untyped_storage().nbytes()
    assert batch_bytes == full.numel()
    for lane, b in enumerate(blocks):
        pages = codec.pool_adopt(full, lane, len(b), page)
        assert len(pages) == max(1, -(-len(b) // page))
        for pg in pages:
            assert pg.untyped_storage().nbytes() == page < batch_bytes
            assert pg.untyped_storage().data_ptr() != \
                full.untyped_storage().data_ptr()
        assert codec.pool_read(pages, len(b)) == b
    pages0 = codec.pool_adopt(full, 0, len(blocks[0]), page)
    full.zero_()        # the batch's memory is reused: pages keep their bytes
    assert codec.pool_read(pages0, len(blocks[0])) == blocks[0]
