"""The port's DeviceTransport against the reference's, on the CPU.

The same seeded blocks go through the reference (``DeviceTransport`` over
its ``SyntheticLinkCodec``, with its ``CpuCodec`` as the oracle) and
through the port's ``DeviceTransport`` over two device codecs: the
port's ``SyntheticLinkCodec`` and ``CudaCodec(device="cpu")`` (the
kernels' plain versions).  Ok vectors, parity, digests and decodes must
be exactly equal (integer work).  Carried over from the reference's
tests: double-buffer bit-identity under concurrent producers, at most
one host copy per block, the staging-bound clamp's reassembly,
foreground before background, a dead device absorbed on the CPU with
zero errors and counted.  New: a staging slot is never rewritten before
its batch is collected (what makes the pinned, asynchronous H2D copy
safe), staging is pinned only when the device codec asks for it, and on
a CUDA card a failed batch fails its callers instead.
Counts and bits only, never rates.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from garage_tpu.ops.codec import CodecParams as RefParams
from garage_tpu.ops.cpu_codec import CpuCodec as RefCpu
from garage_tpu.ops.transport import DeviceTransport as RefTransport
from garage_tpu.ops.transport import TransportItem as RefItem
from garage_tpu.testing.synthetic_device import SyntheticLinkCodec as RefSynth
from garage_tpu.utils.data import Hash as RefHash
from garage_tpu_torch.ops.codec import CodecParams
from garage_tpu_torch.ops.cpu_codec import CpuCodec
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.ops.transport import (DeviceTransport, TransportClosed,
                                            TransportItem)
from garage_tpu_torch.testing.synthetic_device import SyntheticLinkCodec
from garage_tpu_torch.utils.data import Hash
from garage_tpu_torch.utils.metrics import MetricsRegistry

DEVICES = ("synthetic", "cuda_cpu")
SIZES = (4096, 1000, 4096, 256, 4096, 77, 0, 65)


def _params(cls=CodecParams, k=4, m=2, **kw):
    kw.setdefault("block_size", 4096)
    return cls(rs_data=k, rs_parity=m, **kw)


def _blocks(n, seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (sizes[i % len(sizes)],),
                        dtype=np.uint8).tobytes() for i in range(n)]
    return out, [hashlib.blake2s(b, digest_size=32).digest() for b in out]


def _device(kind, p, link=100.0):
    if kind == "synthetic":
        return SyntheticLinkCodec(p, link_gibs=link, compute_real=True)
    return CudaCodec(p, device="cpu")


def _port(kind, link=100.0, **kw):
    p = _params(**kw)
    dev = _device(kind, p, link)
    return DeviceTransport(dev, p, fallback=CpuCodec(p)), dev


def _ref(**kw):
    p = _params(RefParams, **kw)
    dev = RefSynth(p, link_gibs=100.0, compute_real=True)
    return RefTransport(dev, p, fallback=RefCpu(p))


def _run(tr, item_cls, hash_cls, kind, blocks, digests, **kw):
    """Submit one item of `kind` and return its result."""
    if kind == "scrub":
        payload = (blocks, [hash_cls(d) for d in digests])
    else:
        payload = blocks
    it = item_cls(kind, payload, len(blocks), sum(map(len, blocks)), **kw)
    tr.submit_items(kind, [it])
    return it.future.result(timeout=60)


def _same(a, b):
    """Exact equality of two transport results of one kind."""
    if isinstance(a, list):
        assert [bytes(x) for x in a] == [bytes(x) for x in b]
    elif isinstance(a, tuple):
        assert np.array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            assert a[1].shape == b[1].shape and np.array_equal(a[1], b[1])
    else:
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("kind", DEVICES)
def test_double_buffer_bit_identity_under_concurrent_producers(kind):
    """Six threads submit hash, scrub (with a corrupt lane) and encode
    concurrently through the port's 2-slot staging; every result equals
    the reference transport's on the same inputs."""
    tr, _dev = _port(kind)
    ref = _ref()
    errs = []

    def producer(seed):
        try:
            blocks, digests = _blocks(9, seed=seed)
            digests[seed % 9] = bytes(32)
            for k in ("hash", "scrub", "encode"):
                got = _run(tr, TransportItem, Hash, k, blocks, digests)
                want = _run(ref, RefItem, RefHash, k, blocks, digests)
                _same(got, want)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs, errs
    assert tr.dispatches > 0 and tr.fallbacks == 0
    tr.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_decode_matches_reference(kind):
    tr, _dev = _port(kind)
    ref = _ref()
    cpu = CpuCodec(_params())
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 4, 1001), dtype=np.uint8)
    full = np.concatenate([data, cpu.rs_encode(data)], axis=1)
    present = [0, 1, 4, 5]
    surv = np.ascontiguousarray(full[:, present])
    outs = []
    for t, cls in ((tr, TransportItem), (ref, RefItem)):
        it = cls("decode", (surv, present, [2, 3]), 3, int(surv.nbytes))
        t.submit_items("decode", [it])
        outs.append(it.future.result(timeout=30))
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], data[:, 2:4])
    tr.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_copy_counter_at_most_one_copy_per_block(kind):
    reg = MetricsRegistry()
    p = _params()
    tr = DeviceTransport(_device(kind, p), p, fallback=CpuCodec(p),
                         metrics=reg)
    blocks, digests = _blocks(16)
    for _ in range(3):
        ok, _par = _run(tr, TransportItem, Hash, "scrub", blocks, digests)
        assert ok.all()
    assert tr.staged_blocks == 48
    assert tr.copies_per_block() <= 1.0, tr.stats()
    assert 'transport_staged_bytes_total{copies="1"}' in reg.render()
    tr.shutdown()


@pytest.mark.parametrize("kind", DEVICES)
def test_staging_clamp_reassembles_like_reference(kind):
    """A scrub batch larger than the staging budget is cut at codeword
    boundaries, never stages more than the budget at once, and
    reassembles to the reference's unsplit result."""
    tr, _dev = _port(kind)
    tr.chunk_bytes = 16 << 10
    tr.budget_bytes = 32 << 10
    ref = _ref()
    blocks, digests = _blocks(4 * 16, sizes=(4096, 4000, 3000, 4096))
    digests[17] = bytes(32)
    got = _run(tr, TransportItem, Hash, "scrub", blocks, digests)
    want = _run(ref, RefItem, RefHash, "scrub", blocks, digests)
    _same(got, want)
    assert not got[0][17] and got[0].sum() == 63
    assert tr.chunks_split > 0
    assert tr.max_staged_bytes_seen <= tr.budget_bytes, tr.stats()
    assert any(e["kind"] == "transport_chunk" for e in tr.obs.events_list())
    tr.shutdown()
    ref.shutdown()


def test_foreground_beats_background_at_equal_arrival():
    """With the worker held inside the submit of a blocker batch, a
    background batch queued before a foreground one is dispatched after
    it."""
    p = _params()
    dev = SyntheticLinkCodec(p, link_gibs=0.05, compute_real=True)
    order = []
    orig = dev.scrub_encode_submit
    entered, release = threading.Event(), threading.Event()

    def spy(arr, lengths, expected):
        order.append(int(np.count_nonzero(lengths)))
        if len(order) == 1:     # hold the only slot until both are queued
            entered.set()
            release.wait(60)
        return orig(arr, lengths, expected)

    dev.scrub_encode_submit = spy
    tr = DeviceTransport(dev, p, fallback=CpuCodec(p))
    tr.slots, tr._slot_bufs, tr._slot_free = 1, [None], [0]
    tr._slot_tensors = [None]
    sizes = (4096,)
    bl, h = _blocks(4, sizes=sizes)
    blocker = TransportItem("scrub", (bl, [Hash(x) for x in h]), 4,
                            sum(map(len, bl)))
    tr.submit_items("scrub", [blocker])
    assert entered.wait(60)
    items = {}
    for cls, n in (("bg", 8), ("fg", 12)):
        b, hh = _blocks(n, seed=n, sizes=sizes)
        items[cls] = TransportItem("scrub", (b, [Hash(x) for x in hh]), n,
                                   sum(map(len, b)), cls=cls)
        tr.submit_items("scrub", [items[cls]])
    release.set()
    items["fg"].future.result(timeout=60)
    items["bg"].future.result(timeout=60)
    assert order == [4, 12, 8], order
    tr.shutdown()


class _DeadScrub(CudaCodec):
    def scrub_encode_submit(self, *a):
        raise RuntimeError("device gone")


def test_dead_device_absorbed_with_zero_errors_and_counted():
    """Every scrub against a device that fails at submit resolves with
    the reference CPU codec's result; each absorbed batch is counted in
    `fallbacks` and a `transport_fallback` event, and after the failure
    limit the transport closes (`transport_down`)."""
    p = _params()
    dev = _DeadScrub(p, device="cpu")
    tr = DeviceTransport(dev, p, fallback=CpuCodec(p))
    blocks, digests = _blocks(8)
    digests[2] = bytes(32)
    want = RefCpu(_params(RefParams)).scrub_encode_batch(
        blocks, [RefHash(d) for d in digests], True)
    served = 0
    for i in range(4):
        try:
            got = _run(tr, TransportItem, Hash, "scrub", blocks, digests)
        except TransportClosed:
            assert i == 3
            break
        _same(got, want)
        served += 1
    assert served == 3 and tr.fallbacks == 3
    assert not tr.alive
    kinds = [e["kind"] for e in tr.obs.events_list()]
    assert kinds.count("transport_fallback") == 3
    assert kinds.count("transport_error") == 3
    assert kinds.count("transport_down") == 1
    assert tr.stats()["fallbacks"] == 3
    tr.shutdown()


def test_card_failure_fails_the_batch_and_never_latches():
    """On a CUDA card (here a CPU-built CudaCodec whose device attribute
    says cuda; its staging stays unpinned and nothing touches CUDA) a
    failed submit fails the batch's callers with the device's error: no
    CPU recomputation, no `transport_fallback`, and no down latch however
    many batches fail."""
    p = _params()
    dev = _DeadScrub(p, device="cpu")
    dev.device = torch.device("cuda")
    tr = DeviceTransport(dev, p, fallback=CpuCodec(p))
    assert tr.on_card and not tr.pinned
    blocks, digests = _blocks(8)
    for _ in range(5):
        with pytest.raises(RuntimeError, match="device gone"):
            _run(tr, TransportItem, Hash, "scrub", blocks, digests)
    assert tr.alive and tr.fallbacks == 0
    assert tr.stats()["device_errors"] == 5
    kinds = [e["kind"] for e in tr.obs.events_list()]
    assert kinds.count("transport_error") == 5
    assert "transport_fallback" not in kinds and "transport_down" not in kinds
    assert tr.obs.bytes_total.get("cpu", 0) == 0
    tr.shutdown()


class _SlotWatch(SyntheticLinkCodec):
    """Records each submitted staging buffer with a snapshot of its bytes
    and, at collect, checks the buffer still holds them: a transport that
    rewrote a slot before its batch was collected fails here (an
    asynchronous H2D copy from that slot would have read the new bytes)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.watch = []
        self.rewritten = 0
        self.ids = set()

    def scrub_encode_submit(self, arr, lengths, expected):
        self.ids.add(arr.__array_interface__["data"][0])
        handle = super().scrub_encode_submit(arr, lengths, expected)
        self.watch.append((handle, arr, arr.copy()))
        return handle

    def scrub_collect(self, out, fetch_parity):
        for h, arr, snap in self.watch:
            if h is out:
                if not np.array_equal(arr, snap):
                    self.rewritten += 1
        self.watch = [w for w in self.watch if w[0] is not out]
        return super().scrub_collect(out, fetch_parity)


def test_slot_not_rewritten_before_its_batch_is_collected():
    """Twelve scrub batches through two slots over a slow link, so both
    slots are in flight and reused many times: no slot's bytes change
    between its submit and its collect, and both slots were used."""
    p = _params()
    dev = _SlotWatch(p, link_gibs=0.002, compute_real=True)
    tr = DeviceTransport(dev, p, fallback=CpuCodec(p))
    items = []
    for s in range(12):
        blocks, digests = _blocks(8, seed=s, sizes=(4096,))
        it = TransportItem("scrub", (blocks, [Hash(d) for d in digests]),
                           8, sum(map(len, blocks)), cls="bg")
        tr.submit_items("scrub", [it])
        items.append((it, blocks, digests))
    cpu = CpuCodec(p)
    for it, blocks, digests in items:
        ok, par = it.future.result(timeout=60)
        want = cpu.scrub_encode_batch(blocks, [Hash(d) for d in digests])
        assert ok.all() and np.array_equal(par, want[1])
    assert dev.rewritten == 0
    assert len(dev.ids) == 2 and tr.max_staged_bytes_seen > 0
    assert tr.stats()["inflight"] == 0
    tr.shutdown()


def test_staging_is_pinned_only_for_a_cuda_device():
    """The device codec decides whether slots are page-locked: a CudaCodec
    on the CPU device and the synthetic link stage into plain numpy
    memory (pinning needs a GPU), and a CUDA CudaCodec asks for pinning
    by its device argument alone."""
    p = _params()
    for dev in (CudaCodec(p, device="cpu"),
                SyntheticLinkCodec(p, link_gibs=1.0, compute_real=True)):
        tr = DeviceTransport(dev, p, fallback=CpuCodec(p))
        assert not tr.pinned and not tr.stats()["pinned"]
        blocks, digests = _blocks(4)
        _run(tr, TransportItem, Hash, "hash", blocks, digests)
        assert tr._slot_tensors == [None, None]
        tr.shutdown()
    assert CudaCodec(p, device="cpu").pin_memory is False
