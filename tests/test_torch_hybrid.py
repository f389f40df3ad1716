"""The port's HybridCodec and CodecFeeder against the reference, on the CPU.

The same seeded blocks go through the reference (``make_codec("cpu")``
behind its CodecFeeder, and its ``HybridCodec`` over its
``SyntheticLinkCodec``) and through the port's ``HybridCodec`` over
``CudaCodec(device="cpu")`` — the production stack (feeder → transport →
pool → device codec) with the kernels' plain versions — and over the
port's ``SyntheticLinkCodec``.  Ok vectors, parity, digests and decodes
must be exactly equal.  Also: the stealing engine (scrub_many) with
batch cuts, the feeder's pool-resident route and prefetch hint, a dead
device absorbed with zero errors and counted, the gate probe through the
transport and without it, and the device rule (the hybrid builds its
device on the card and raises without one).  Bits and counts, never
rates: the reference's own hybrid timing tests are load-sensitive.
"""

import asyncio
import hashlib
import time

import numpy as np
import pytest
import torch

from garage_tpu.ops import make_codec as ref_make_codec
from garage_tpu.ops.codec import CodecParams as RefParams
from garage_tpu.ops.feeder import CodecFeeder as RefFeeder
from garage_tpu.ops.hybrid_codec import HybridCodec as RefHybrid
from garage_tpu.testing.synthetic_device import SyntheticLinkCodec as RefSynth
from garage_tpu.utils.data import Hash as RefHash
from garage_tpu_torch.ops import make_codec
from garage_tpu_torch.ops.codec import CodecParams
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.ops.feeder import CodecFeeder
from garage_tpu_torch.ops.hybrid_codec import HybridCodec
from garage_tpu_torch.testing.synthetic_device import SyntheticLinkCodec
from garage_tpu_torch.utils.data import Hash

K, M = 8, 4
# the gate threshold sits far below any rate a loaded CPU host gives, so
# whether the gate opens never depends on the host's speed
KW = dict(rs_data=K, rs_parity=M, block_size=4096, hybrid_group_blocks=8,
          device_batch_blocks=32, pool_page_kib=1, hybrid_min_link_gibs=1e-6)


def _blocks(n, seed=0, sizes=(4096, 3000, 4096, 1, 0, 4096, 2049, 64)):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (sizes[i % len(sizes)],),
                        dtype=np.uint8).tobytes() for i in range(n)]
    return out, [hashlib.blake2s(b, digest_size=32).digest() for b in out]


def _corrupt(blocks, idx):
    out = list(blocks)
    for i in idx:
        buf = bytearray(out[i] or b"\0")
        buf[len(buf) // 2] ^= 0x5A
        out[i] = bytes(buf)
    return out


def _hybrid(device="cpu"):
    return make_codec("hybrid", device=device, **KW)


async def _drive(feeder, scrubs, put_blocks, enc_groups, decodes):
    scrub = await asyncio.gather(*[feeder.scrub_async(b, h) for b, h in scrubs])
    hashed = await asyncio.gather(*[feeder.hash_async([b], peers=len(put_blocks))
                                    for b in put_blocks])
    enc = await asyncio.gather(*[asyncio.wrap_future(
        feeder.submit_encode(g, peers=len(enc_groups))) for g in enc_groups])
    dec = await asyncio.gather(*[feeder.decode_async(s, p, r)
                                 for s, p, r in decodes])
    return scrub, hashed, enc, dec


def test_production_stack_through_the_feeder_matches_reference():
    """Scrub passes (planted corruption, cold then warm through the
    pool), concurrent PUT hashes, write-time encodes and degraded decodes
    through the port's feeder → transport → pool → CudaCodec(cpu), against
    the reference CPU codec behind its feeder: bit-identical, every scrub
    byte on the device side after the gate probe, no fallback, at most one
    host copy per block, hit + miss = scrubbed bytes."""
    blocks, digests = _blocks(2 * K + 3, seed=1)
    # the corrupt batch holds other blocks: the pool serves a resident
    # hash from its verified page, so corrupt bytes under a resident hash
    # would never be read (the store invalidates on rewrite)
    other, other_digests = _blocks(2 * K + 3, seed=5)
    scrubbed = _corrupt(other, [2, 11])
    put_blocks, _ = _blocks(6, seed=2)
    enc_groups = [_blocks(K, seed=3 + i, sizes=(700,))[0] for i in range(3)]
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (3, K, 512), dtype=np.uint8)
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]
    results = []
    hy = _hybrid()
    ref = ref_make_codec("cpu", rs_data=K, rs_parity=M)
    for codec, feeder_cls, hcls in ((ref, RefFeeder, RefHash),
                                    (hy, CodecFeeder, Hash)):
        full = np.concatenate([data, codec.rs_encode(data)], axis=1)
        decodes = [(full[c:c + 1, present], present, [2, 5]) for c in range(3)]
        hashes = [hcls(d) for d in digests]
        other_hashes = [hcls(d) for d in other_digests]
        feeder = feeder_cls(codec)
        try:
            results.append([asyncio.run(_drive(
                feeder, [(scrubbed, other_hashes), (blocks, hashes)], put_blocks,
                enc_groups, decodes)) for _ in range(2)])
        finally:
            feeder.shutdown()
    for (r_scrub, r_hash, r_enc, r_dec), (p_scrub, p_hash, p_enc, p_dec) in \
            zip(*results):
        for (rok, rpar), (pok, ppar) in zip(r_scrub, p_scrub):
            assert np.array_equal(rok, pok) and np.array_equal(rpar, ppar)
        assert [bytes(h[0]) for h in p_hash] == [bytes(h[0]) for h in r_hash]
        for a, b in zip(p_enc, r_enc):
            assert np.array_equal(a, b)
        for a, b in zip(p_dec, r_dec):
            assert np.array_equal(a, b)
    assert not results[1][0][0][0][0][2] and results[1][0][0][1][0].all()
    tr = hy.transport
    st = tr.stats()
    assert tr.alive and st["fallbacks"] == 0 and st["dispatches"] > 0
    assert st["copies_per_block"] <= 1.0
    pool = hy.pool.stats()
    scrub_bytes = 2 * sum(map(len, blocks + scrubbed))
    assert pool["hit_bytes"] + pool["miss_bytes"] == scrub_bytes
    assert pool["hit_bytes"] > 0
    kinds = {e["kind"] for e in hy.obs.events_list()}
    assert not kinds & {"transport_error", "transport_fallback",
                        "transport_down"}
    assert "transport_probe" in kinds
    hy.close()


@pytest.mark.parametrize("device", ["cuda_cpu", "synthetic"])
def test_scrub_many_matches_reference_hybrid(device):
    """The stealing engine over batch cuts (unaligned batch sizes,
    corrupt lanes): the port's hybrid over either device equals the
    reference hybrid over its synthetic link, and every byte is counted
    on exactly one side."""
    p = CodecParams(**KW)
    dev = (CudaCodec(p, device="cpu") if device == "cuda_cpu" else
           SyntheticLinkCodec(p, link_gibs=100.0, compute_real=True))
    hy = HybridCodec(p, device_codec=dev)
    rp = RefParams(**KW)
    ref = RefHybrid(rp, device_codec=RefSynth(rp, link_gibs=100.0,
                                              compute_real=True))
    batches = []
    for i, n in enumerate((13, 40, 8, 27)):
        b, d = _blocks(n, seed=10 + i)
        batches.append((_corrupt(b, [n // 2]), d))
    got = hy.scrub_many([(b, [Hash(x) for x in d]) for b, d in batches],
                        fetch_parity=True)
    want = ref.scrub_many([(b, [RefHash(x) for x in d]) for b, d in batches],
                          fetch_parity=True)
    for (pok, ppar), (rok, rpar) in zip(got, want):
        assert np.array_equal(pok, rok) and not pok.all()
        assert ppar.shape == rpar.shape and np.array_equal(ppar, rpar)
    cpu_b, dev_b = hy.pop_stats()
    assert cpu_b + dev_b == sum(len(x) for b, _ in batches for x in b)
    b, d = batches[1]
    ok, par = hy.scrub_encode_batch(b, [Hash(x) for x in d])
    rok, rpar = ref.scrub_encode_batch(b, [RefHash(x) for x in d])
    assert np.array_equal(ok, rok) and np.array_equal(par, rpar)
    assert np.array_equal(hy.batch_verify(b, [Hash(x) for x in d]),
                          ref.batch_verify(b, [RefHash(x) for x in d]))
    hy.close()
    ref.close()


def test_feeder_pool_resident_route_and_prefetch():
    """prefetch_scrub stages a range into the pool ahead of need (its own
    byte family); a later background scrub batch the pool covers routes
    to the device as `pool_resident` and stages nothing."""
    hy = _hybrid()
    feeder = CodecFeeder(hy)
    # distinct contents: one pool entry per block
    blocks, digests = _blocks(2 * K, seed=4, sizes=(4096, 3000, 1, 2049, 64))
    hashes = [Hash(d) for d in digests]
    try:
        assert feeder.prefetch_scrub(blocks, hashes) == sum(map(len, blocks))
        deadline = time.monotonic() + 30
        while (hy.pool.stats()["resident_blocks"] < len(blocks)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        st = hy.pool.stats()
        assert st["prefetch_bytes"] == sum(map(len, blocks))
        assert st["resident_blocks"] == len(blocks)
        assert feeder.prefetch_scrub(blocks, hashes) == 0   # all resident
        staged = hy.transport.staged_bytes
        ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
        cpu = make_codec("cpu", rs_data=K, rs_parity=M)
        want = cpu.scrub_encode_batch(blocks, hashes)
        assert np.array_equal(ok, want[0]) and np.array_equal(par, want[1])
        assert hy.transport.staged_bytes == staged
        assert hy.pool.stats()["hit_bytes"] == sum(map(len, blocks))
        routes = [e for e in hy.obs.events_list() if e["kind"] == "feeder_route"]
        assert any(e["reason"] == "pool_resident" for e in routes)
    finally:
        feeder.shutdown()
        hy.close()


class _DeadScrub(CudaCodec):
    def scrub_encode_submit(self, *a):
        raise RuntimeError("device gone")


def test_dead_device_absorbed_with_zero_errors_and_counted():
    """Scrub batches whose device submit fails resolve with the CPU
    result through the feeder, each absorbed batch counted; after the
    failure limit the transport is down and the feeder routes to the
    CPU floor."""
    p = CodecParams(**dict(KW, pool_mib=0))
    hy = HybridCodec(p, device_codec=_DeadScrub(p, device="cpu"))
    cpu = make_codec("cpu", rs_data=K, rs_parity=M)
    feeder = CodecFeeder(hy)
    try:
        for seed in range(5):
            blocks, digests = _blocks(K, seed=seed)
            hashes = [Hash(d) for d in digests]
            ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
            want = cpu.scrub_encode_batch(blocks, hashes)
            assert np.array_equal(ok, want[0]) and np.array_equal(par, want[1])
    finally:
        feeder.shutdown()
    assert hy.transport.fallbacks == 3 and not hy.transport.alive
    assert hy.ragged_side() == "cpu"
    kinds = [e["kind"] for e in hy.obs.events_list()]
    assert kinds.count("transport_fallback") == 3
    assert kinds.count("transport_down") == 1
    hy.close()


class _CardScrub(_DeadScrub):
    """A CPU-built CudaCodec presented as one on a CUDA card: its device
    attribute is what selects the card's failure rule, its staging stays
    unpinned, and nothing these tests run on it touches CUDA.  The link
    probe is a hook (healthy) unless `probe_fails`."""

    def __init__(self, p, probe_fails=False, warm_fails=False):
        super().__init__(p, device="cpu")
        self.device = torch.device("cuda")
        self.probe_fails, self.warm_fails = probe_fails, warm_fails

    def probe_link(self, nbytes):
        if self.probe_fails:
            raise RuntimeError("link gone")
        return float("inf")

    def warm_scrub(self, nblocks, nbytes):
        if self.warm_fails:
            raise RuntimeError("nvcc failed")


def test_card_failure_reaches_the_callers():
    """On a card nothing absorbs a device failure on the CPU: feeder
    scrubs whose device submit fails raise the device's error, the
    transport counts them and stays up (no down latch), and no byte runs
    on the CPU; the hybrid engine's own pass raises it too."""
    p = CodecParams(**dict(KW, pool_mib=0))
    hy = HybridCodec(p, device_codec=_CardScrub(p))
    assert hy.transport.on_card and not hy.transport.pinned
    feeder = CodecFeeder(hy)
    try:
        for seed in range(5):
            blocks, digests = _blocks(K, seed=seed)
            with pytest.raises(RuntimeError, match="device gone"):
                asyncio.run(feeder.scrub_async(blocks,
                                               [Hash(d) for d in digests]))
    finally:
        feeder.shutdown()
    st = hy.transport.stats()
    assert st["fallbacks"] == 0 and st["device_errors"] == 5
    assert hy.transport.alive and hy.ragged_side() == "tpu"
    kinds = [e["kind"] for e in hy.obs.events_list()]
    assert kinds.count("transport_error") == 5
    assert "transport_fallback" not in kinds and "transport_down" not in kinds
    assert hy.obs.bytes_total.get("cpu", 0) == 0
    blocks, digests = _blocks(4 * K, seed=8)
    with pytest.raises(RuntimeError, match="device gone"):
        hy.scrub_encode_batch(blocks, [Hash(d) for d in digests])
    assert "feeder_error" in [e["kind"] for e in hy.obs.events_list()]
    hy.close()


@pytest.mark.parametrize("card", [True, False])
def test_probe_and_warm_failures_raise_only_on_the_card(card):
    """A failing link probe or kernel warm-up raises on a card; off the
    card (the CPU device) it is logged and the gate stays shut, as in the
    reference."""
    p = CodecParams(**dict(KW, pool_mib=0))
    dev = _CardScrub(p, probe_fails=True, warm_fails=True)
    if not card:
        dev.device = torch.device("cpu")
    hy = HybridCodec(p, device_codec=dev)
    if card:
        with pytest.raises(RuntimeError, match="link gone"):
            hy.refresh_gate()
        with pytest.raises(RuntimeError, match="nvcc failed"):
            hy.warm(4096)
    else:
        hy.refresh_gate()
        hy.warm(4096)
        assert hy.ragged_side() == "cpu"
    hy.close()


def test_gate_probe_with_and_without_transport():
    """The gate probe runs through the transport's pinned-or-not staging
    path when one is armed, and through CudaCodec.probe_submit/collect
    when not; both give a finite rate that opens the gate."""
    hy = _hybrid()
    assert hy._probe_link() > 0 and hy.ragged_side() == "tpu"
    assert hy.probe_stages() and "stage_copy" in hy.probe_stages()
    hy.close()
    legacy = make_codec("hybrid", device="cpu", transport=False, **KW)
    assert legacy.transport is None
    rate = legacy._probe_link()
    assert 0 < rate < float("inf") and legacy.ragged_side() == "tpu"


def test_device_rule_and_cpu_floor(monkeypatch):
    """make_codec("hybrid") builds its device on the card and raises
    without one (no silent CPU-only hybrid); build_device=False is the
    pure CPU floor, bit-identical to the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make_codec("hybrid", rs_data=K, rs_parity=M)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        HybridCodec(CodecParams(**KW))
    floor = HybridCodec(CodecParams(**KW), build_device=False)
    assert floor.tpu is None and floor.transport is None
    assert floor.ragged_side() == "cpu"
    ref = RefHybrid(RefParams(**KW), build_device=False)
    blocks, digests = _blocks(21, seed=9)
    blocks = _corrupt(blocks, [4])
    ok, par = floor.scrub_encode_batch(blocks, [Hash(d) for d in digests])
    rok, rpar = ref.scrub_encode_batch(blocks, [RefHash(d) for d in digests])
    assert np.array_equal(ok, rok) and np.array_equal(par, rpar)
    assert [e["reason"] for e in floor.obs.events_list()
            if e["kind"] == "gate"] == ["no-device"]


def test_staging_clamp_matches_reference():
    kw = dict(KW, device_batch_blocks=1024, max_device_staging_mib=1,
              block_size=1 << 16)
    hy = make_codec("hybrid", device="cpu", **kw)
    ref = RefHybrid(RefParams(**kw), build_device=False)
    assert hy.device_batch_blocks == ref.device_batch_blocks < 1024
    assert any(e["kind"] == "staging_clamp" for e in hy.obs.events_list())
    hy.close()
