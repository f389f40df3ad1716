"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here carries the `cuda` marker and skips without a GPU.  The
file imports neither jax nor garage_tpu, so it also runs on a GPU machine
that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The plain versions are held against the JAX reference by the CPU tests
(test_torch_blake2s.py, test_torch_gf.py, test_torch_codec.py); here the
kernels are held against the plain versions, hashlib and the port's numpy
GF(2^8) oracle.  Integer work: the tolerance is exact equality.
"""

import hashlib

import numpy as np
import pytest
import torch

from garage_tpu_torch.ops import cuda_blake2s, cuda_codec, cuda_gf, gf256
from garage_tpu_torch.ops import make_codec
from garage_tpu_torch.ops.blake2s import blake2s_batch_plain
from garage_tpu_torch.utils.data import Hash

pytestmark = pytest.mark.cuda

SIZES = [0, 1, 63, 64, 65, 128, 1000, 4096, 16_001]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _digest(b):
    return hashlib.blake2s(b, digest_size=32).digest()


def test_blake2s_kernel_matches_plain(gpu):
    rng = np.random.default_rng(12)
    lengths = SIZES + rng.integers(0, 16_384, 131 - len(SIZES)).tolist()
    arr = np.zeros((len(lengths), 16_384), np.uint8)
    for i, n in enumerate(lengths):
        arr[i, :n] = rng.integers(0, 256, (n,), np.uint8)
    da = torch.from_numpy(arr).to(gpu)
    dl = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = cuda_blake2s.launches
    got = cuda_blake2s.blake2s_batch(da, dl)
    torch.cuda.synchronize()
    assert cuda_blake2s.launches == before + 1
    assert torch.equal(got, blake2s_batch_plain(da, dl))
    digests = got.cpu().numpy().view(np.uint32)
    for i, n in enumerate(lengths):
        assert digests[i].astype("<u4").tobytes() == _digest(arr[i, :n])
    with pytest.raises(ValueError):
        cuda_blake2s.blake2s_batch(da[:, :100], dl)      # not contiguous
    with pytest.raises(ValueError):
        cuda_blake2s.blake2s_batch(da, dl.to(torch.int64))


def test_chain_probe_measures_a_dependent_chain(gpu):
    """The probe's cycles per G: 12 dependent instructions, each at least
    one cycle and well under 20; it is not counted as a K1 launch."""
    before = cuda_blake2s.launches
    cycles = cuda_blake2s.g_chain_cycles(gpu)
    assert 12 <= cycles <= 240
    assert cuda_blake2s.launches == before


@pytest.mark.parametrize("s4", [300, 2500])
def test_gf_kernel_matches_plain_both_regimes(gpu, s4):
    rng = np.random.default_rng(s4)
    dec = gf256.rs_decode_matrix(8, 4, [0, 1, 3, 4, 6, 7, 8, 9])
    for mat in (gf256.rs_parity_matrix(4, 2), gf256.rs_parity_matrix(8, 4),
                dec, np.ascontiguousarray(dec[[2, 5]])):
        x = rng.integers(0, 2**32, (37, mat.shape[1], s4), dtype=np.uint32)
        dx = torch.from_numpy(x.view(np.int32)).to(gpu)
        K = cuda_gf.consts_from_numpy(mat, gpu)
        before = cuda_gf.launches
        got = cuda_gf.gf_apply(dx, K)
        torch.cuda.synchronize()
        assert cuda_gf.launches == before + 1
        assert torch.equal(got, cuda_gf.gf_apply_plain(dx, K))
        assert np.array_equal(got.cpu().numpy().view(np.uint32),
                              cuda_gf.reference_apply(mat, x))


@pytest.mark.parametrize("s4", [300, 301, 2500, 2501])
@pytest.mark.parametrize("kr", list(cuda_gf.INSTANTIATIONS)
                         + [(6, 3), (10, 5), (2, 1)])
def test_gf_bodies_match_plain(gpu, kr, s4):
    """Every instantiated (k, r) and a few others, both regimes, odd S4
    (the guarded tail): the body the wrapper picks and the runtime-(k, r)
    body, each against the plain version and the numpy oracle."""
    k, r = kr
    rng = np.random.default_rng(1000 * k + 10 * r + s4)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    x = rng.integers(0, 2**32, (9, k, s4), dtype=np.uint32)
    dx = torch.from_numpy(x.view(np.int32)).to(gpu)
    K = cuda_gf.consts_from_numpy(mat, gpu)
    plain = cuda_gf.gf_apply_plain(dx, K)
    want = cuda_gf.reference_apply(mat, x)
    for runtime in (False, True):
        body = cuda_gf.instantiation(k, r, runtime)
        before = cuda_gf.launches_by.get(body, 0)
        got = cuda_gf.gf_apply(dx, K, runtime=runtime)
        torch.cuda.synchronize()
        assert cuda_gf.launches_by[body] == before + 1
        assert torch.equal(got, plain), body
        assert np.array_equal(got.cpu().numpy().view(np.uint32), want), body
    with pytest.raises(ValueError, match="aligned"):
        cuda_gf.gf_apply(torch.zeros(1 + 9 * k * s4, dtype=torch.int32,
                                     device=gpu)[1:].view(9, k, s4), K)


def test_fused_scrub_matches_cpu_codec(gpu):
    codec = make_codec("cuda", rs_data=4, rs_parity=2, device=gpu)
    plain = make_codec("cuda", rs_data=4, rs_parity=2, device="cpu")
    rng = np.random.default_rng(14)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (3000, 1, 0, 2047, 3000, 64, 65)]
    hashes = [Hash(_digest(b)) for b in blocks]
    hashes[5] = Hash(bytes(32))
    before = cuda_codec.fused_launches
    ok, par = codec.scrub_encode_batch(blocks, hashes)
    assert cuda_codec.fused_launches == before + 1
    want_ok, want_par = plain.scrub_encode_batch(blocks, hashes)
    assert ok.tolist() == want_ok.tolist() == [True] * 5 + [False, True]
    assert np.array_equal(par, want_par)


# --- slice 2: T1, pinned staging, the pool API ---------------------------


@pytest.mark.parametrize("tile", [128, 4096, 8192, 16384])
def test_gf_tune_variants_match_plain(gpu, tile):
    """Every variant at every tile the kernel takes, at both (k, r) it is
    built for, against the plain version and the numpy oracle."""
    from garage_tpu_torch.tools import gf_tune as T

    assert tile in T.KERNEL_TILES
    rng = np.random.default_rng(tile)
    for k, r in T.SHAPES:
        mat = gf256.rs_parity_matrix(k, r)
        u32 = rng.integers(0, 2**32, (4, k, 4096), dtype=np.uint32)
        x = torch.from_numpy(T.fold(u32).view(np.int32)).to(gpu)
        c = torch.from_numpy(T.mask_consts(mat).view(np.int32)).to(gpu)
        want = cuda_gf.reference_apply(mat, u32)
        for variant in T.VARIANTS:
            plain = T.gf_tune_plain(x, c, variant)
            before = T.launches
            got = T.gf_tune(x, c, variant, tile)
            torch.cuda.synchronize()
            assert T.launches == before + 1
            assert torch.equal(got, plain), (k, r, variant)
            assert np.array_equal(
                T.unfold(got.cpu().numpy().view("<u4"), 4), want)
    with pytest.raises(ValueError):
        T.gf_tune(x, c, "acc", 96)


def test_gf_tune_refused_launches_raise(gpu):
    """A misaligned x and a (k, r) the kernel is not built for raise,
    count no launch, and leave the next launch right."""
    from garage_tpu_torch.tools import gf_tune as T

    mat = gf256.rs_parity_matrix(8, 4)
    u32 = np.random.default_rng(5).integers(0, 2**32, (4, 8, 4096),
                                             dtype=np.uint32)
    x = torch.from_numpy(T.fold(u32).view(np.int32)).to(gpu)
    c = torch.from_numpy(T.mask_consts(mat).view(np.int32)).to(gpu)
    n = x.shape[1] - 128
    before = T.launches
    with pytest.raises(ValueError, match="aligned"):
        T.gf_tune(x.view(-1)[1:1 + 8 * n].view(8, n), c, "acc", 128)
    with pytest.raises(ValueError, match=r"\(k, r\)"):
        T.gf_tune(x, c[:1], "acc", 128)
    assert T.launches == before
    assert torch.equal(T.gf_tune(x, c, "acc", 4096),
                       T.gf_tune_plain(x, c, "acc"))


def _scrub_inputs(codec, seed=21, sizes=(3000, 1, 0, 2047, 3000, 64, 65, 4096)):
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    hashes = [Hash(_digest(b)) for b in blocks]
    hashes[4] = Hash(bytes(32))
    return blocks, hashes, codec._pad_group(blocks, hashes)


def test_pinned_slot_path_matches_pageable(gpu):
    """The transport's pinned staging (page-locked slots, asynchronous
    H2D) gives the same ok vectors and parity as pageable numpy input and
    as the CPU device, through the transport and directly."""
    from garage_tpu_torch.ops.cpu_codec import CpuCodec
    from garage_tpu_torch.ops.transport import DeviceTransport, TransportItem

    codec = make_codec("cuda", rs_data=4, rs_parity=2, device=gpu)
    plain = make_codec("cuda", rs_data=4, rs_parity=2, device="cpu")
    blocks, hashes, (arr, lengths, expected) = _scrub_inputs(codec)
    pinned = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = arr
    a = codec.scrub_collect(codec.scrub_encode_submit(pinned, lengths,
                                                      expected), True)
    b = codec.scrub_collect(codec.scrub_encode_submit(arr, lengths,
                                                      expected), True)
    c = plain.scrub_collect(plain.scrub_encode_submit(arr, lengths,
                                                      expected), True)
    for x in (b, c):
        assert np.array_equal(a[0], x[0]) and np.array_equal(a[1], x[1])
    want = plain.scrub_encode_batch(blocks, hashes)
    tr = DeviceTransport(codec, codec.params,
                         fallback=CpuCodec(codec.params))
    assert tr.pinned
    items = []
    for _ in range(6):
        it = TransportItem("scrub", (blocks, hashes), len(blocks),
                           sum(map(len, blocks)))
        items.append(it)
        tr.submit_items("scrub", [it])
    for it in items:
        ok, par = it.future.result(timeout=60)
        assert np.array_equal(ok, want[0]) and np.array_equal(par, want[1])
    assert tr.stats()["fallbacks"] == 0
    assert tr._slot_tensors[0].is_pinned()
    tr.shutdown()


def test_resident_submit_matches_plain_submit(gpu):
    """scrub_encode_submit_resident over a batch whose lanes come partly
    from pool pages (adopted from an earlier batch) and partly from a
    compact miss upload gives scrub_encode_submit's results on the same
    lanes; adopted pages own their storage."""
    codec = make_codec("cuda", rs_data=4, rs_parity=2, device=gpu)
    _blocks, _hashes, (arr, lengths, expected) = _scrub_inputs(codec)
    want = codec.scrub_collect(codec.scrub_encode_submit(arr, lengths,
                                                         expected), True)
    cols = arr.shape[1]
    for page in (cols // 2, 1000):      # whole pages per row, and not
        lanes = list(range(arr.shape[0]))
        miss = [r for r in lanes if r % 3 == 0]
        out, full = codec.scrub_encode_submit_resident(
            arr[miss], miss, lengths, expected, [])
        got0 = codec.scrub_collect(out, True)
        assert np.array_equal(full.cpu().numpy()[miss], arr[miss])
        # adopt every lane of a full upload, then compose from the pages
        out, full = codec.scrub_encode_submit_resident(
            arr, lanes, lengths, expected, [])
        codec.scrub_collect(out, True)
        resident = []
        for r in lanes:
            if r in miss:
                continue
            pages = codec.pool_adopt(full, r, int(lengths[r]), page)
            assert all(p.untyped_storage().nbytes() == page for p in pages)
            assert codec.pool_read(pages, int(lengths[r])) == \
                arr[r, :lengths[r]].tobytes()
            resident.append((r, pages, int(lengths[r])))
        del full
        out, full = codec.scrub_encode_submit_resident(
            arr[miss], miss, lengths, expected, resident)
        got = codec.scrub_collect(out, True)
        assert np.array_equal(full.cpu().numpy(), arr)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert not got0[0][[r for r in lanes if r not in miss and lengths[r]]].all()


def test_hybrid_on_the_card_cold_then_warm(gpu):
    """make_codec("hybrid") on the card behind the feeder: a cold scrub
    misses the pool, a warm one is all hits and stages nothing, results
    bit-identical to the CPU codec throughout."""
    import asyncio

    from garage_tpu_torch.ops.feeder import CodecFeeder

    hy = make_codec("hybrid", rs_data=4, rs_parity=2, device=gpu,
                    block_size=4096, pool_page_kib=1)
    cpu = make_codec("cpu", rs_data=4, rs_parity=2)
    assert hy.transport.pinned and hy.pool is not None
    feeder = CodecFeeder(hy)
    blocks, hashes, _ = _scrub_inputs(hy.tpu)
    want = cpu.scrub_encode_batch(blocks, hashes)
    try:
        for _ in range(3):
            ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
            assert np.array_equal(ok, want[0]) and np.array_equal(par, want[1])
        staged = hy.transport.staged_bytes
        hit = hy.pool.stats()["hit_bytes"]
        ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
        assert np.array_equal(par, want[1])
        # lane 4's expected digest is wrong: it never verifies, so it is
        # never adopted and is the one lane staged again
        assert hy.transport.staged_bytes == staged + len(blocks[4])
        st = hy.pool.stats()
        assert st["hit_bytes"] - hit == sum(map(len, blocks)) - len(blocks[4])
        assert st["hit_bytes"] + st["miss_bytes"] == 4 * sum(map(len, blocks))
        assert hy.transport.stats()["fallbacks"] == 0
    finally:
        feeder.shutdown()
        hy.close()


def test_store_node_scrub_on_the_card(gpu, tmp_path):
    """One block store node whose Config says backend = "cuda": its
    BlockManager builds the codec on the card, and a ScrubWorker pass
    finds a planted corruption with no scrub byte on the CPU."""
    import asyncio
    import os

    from garage_tpu_torch.block import BlockManager, ScrubWorker
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.db import open_db
    from garage_tpu_torch.rpc.replication_mode import parse_replication_mode
    from garage_tpu_torch.rpc.system import System
    from garage_tpu_torch.table import TableShardedReplication
    from garage_tpu_torch.utils.config import config_from_dict

    async def run():
        cfg = config_from_dict({
            "metadata_dir": str(tmp_path / "meta"),
            "data_dir": str(tmp_path / "data"), "replication_mode": "1",
            "rpc_secret": "cuda-test", "codec": {"backend": "cuda"}})
        s = System(cfg)
        mode = parse_replication_mode("1")
        m = BlockManager(cfg, open_db("memory"), s, TableShardedReplication(
            s, mode.replication_factor, 1, mode.write_quorum))
        assert m.codec.device.type == "cuda"
        rng = np.random.default_rng(15)
        blocks = [rng.bytes(int(n)) for n in rng.integers(1, 300_000, 24)]
        hashes = [Hash(_digest(b)) for b in blocks]
        for h, b in zip(hashes, blocks):
            await m.write_block(h, DataBlock.plain(b))
        path = m.find_block(hashes[7])[0]
        with open(path, "r+b") as f:
            f.seek(len(blocks[7]) // 2)
            f.write(bytes([blocks[7][len(blocks[7]) // 2] ^ 1]))
        before = dict(m.codec.obs.bytes_total)
        w = ScrubWorker(m)
        w.set_tranquility(0)
        w.send_command("start")
        while (await w.work()).name in ("BUSY", "THROTTLED"):
            pass
        after = m.codec.obs.bytes_total
        m.feeder.shutdown()
        await s.netapp.shutdown()
        assert w.state.corruptions == 1
        assert not m.is_block_present(hashes[7])
        assert os.path.exists(path + ".corrupted")
        assert after["cpu"] == before.get("cpu", 0)
        assert after["tpu"] - before.get("tpu", 0) == sum(map(len, blocks))

    asyncio.run(run())


def _split_pair(gpu, kind="cuda", **kw):
    """(unsplit, split over [gpu] * 4) codecs of one kind at RS(4, 2)."""
    one = make_codec(kind, rs_data=4, rs_parity=2, device=gpu, **kw)
    split = make_codec(kind, rs_data=4, rs_parity=2, device=gpu,
                       shard_mesh=4, devices=[gpu] * 4, **kw)
    return one, split


def test_split_codec_matches_unsplit(gpu):
    """CudaCodec split 4 ways over one card: the fused scrub (one launch
    per shard, the summed corrupt count), hashes, verifies, encodes,
    reconstructs and a pinned submit equal the unsplit codec's."""
    one, split = _split_pair(gpu)
    assert split.shards == [gpu] * 4 and split.info()["shards"] == \
        [str(gpu)] * 4
    blocks, hashes, _ = _scrub_inputs(one)
    arr, lengths, expected = split._pad_group(blocks, hashes)
    assert arr.shape[0] % 16 == 0
    before = cuda_codec.fused_launches
    out = split.scrub_encode_submit(arr, lengths, expected)
    got = split.scrub_collect(out, True)
    assert cuda_codec.fused_launches == before + 4 and int(out.bad) == 1
    pinned = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = arr
    got_pinned = split.scrub_collect(
        split.scrub_encode_submit(pinned, lengths, expected), True)
    want = one.scrub_collect(one.scrub_encode_submit(arr, lengths, expected),
                             True)
    for a in (got, got_pinned):
        assert np.array_equal(a[0], want[0]) and np.array_equal(a[1], want[1])
    for a, b in zip(split.scrub_encode_batch(blocks, hashes),
                    one.scrub_encode_batch(blocks, hashes)):
        assert np.array_equal(a, b)
    assert split.batch_hash(blocks) == one.batch_hash(blocks)
    assert np.array_equal(split.batch_verify(blocks, hashes),
                          one.batch_verify(blocks, hashes))
    rng = np.random.default_rng(33)
    data = rng.integers(0, 256, (5, 4, 1000), dtype=np.uint8)
    parity = split.rs_encode(data)
    assert np.array_equal(parity, one.rs_encode(data))
    full = np.concatenate([data, parity], axis=1)
    present = [0, 2, 3, 5]
    assert np.array_equal(split.rs_reconstruct(full[:, present], present),
                          data)
    assert np.array_equal(
        split.decode_collect(split.decode_submit(full[:, present], present,
                                                 [1])), data[:, [1]])


def test_split_resident_submit_moves_pages_between_shards(gpu):
    """Pages adopted from one split batch, composed into the lanes of
    another shard (the batch shifted by one codeword), give the plain
    submit's results."""
    one, split = _split_pair(gpu)
    blocks, hashes, (arr, lengths, expected) = _scrub_inputs(one)
    arr, lengths, expected = split._pad_group(blocks, hashes)
    lanes = list(range(arr.shape[0]))
    out, parts = split.scrub_encode_submit_resident(arr, lanes, lengths,
                                                    expected, [])
    split.scrub_collect(out, True)
    assert isinstance(parts, list) and len(parts) == 4
    pages = {r: split.pool_adopt(parts, r, int(lengths[r]), 1000)
             for r in lanes if lengths[r]}
    shift = 4   # one codeword: lane r's page serves lane r + 4
    arr2 = np.roll(arr, shift, axis=0)
    len2, exp2 = np.roll(lengths, shift), np.roll(expected, shift, axis=0)
    resident = [(r + shift, pg, int(lengths[r])) for r, pg in pages.items()
                if r + shift < arr.shape[0]]
    miss = [r for r in lanes if r not in {x[0] for x in resident}]
    out, _ = split.scrub_encode_submit_resident(arr2[miss], miss, len2, exp2,
                                                resident)
    got = split.scrub_collect(out, True)
    want = one.scrub_collect(one.scrub_encode_submit(arr2, len2, exp2), True)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_gf_bitmatmul_and_sharded_fns_on_the_card(gpu):
    """gf_bitmatmul on the card (torch._int_mm) equals its plain version
    on random GF(2) matrices, below and above _int_mm's 17-row minimum;
    sharded_fns over [gpu] * 4 equals the oracle and the codec."""
    from garage_tpu_torch.ops import sharded

    rng = np.random.default_rng(44)
    for k, r, s in ((8, 4, 77), (4, 2, 3), (3, 1, 1000)):
        x = torch.from_numpy(rng.integers(0, 256, (3, k, s), dtype=np.uint8))
        w = torch.from_numpy(rng.integers(0, 2, (k * 8, r * 8),
                                          dtype=np.int8))
        before = sharded.launches
        got = sharded.gf_bitmatmul(x.to(gpu), w.to(gpu))
        assert sharded.launches == before + 1
        assert torch.equal(got.cpu(), sharded.gf_bitmatmul_plain(x, w))
    fns = sharded.sharded_fns([gpu] * 4)
    data = rng.integers(0, 256, (16, 256), dtype=np.uint8)
    lengths = np.full(16, 256, np.int32)
    expected = np.stack([np.frombuffer(_digest(d.tobytes()), "<u4")
                         for d in data]).astype(np.uint32)
    expected[5] ^= 1
    h, ok, bad = fns["verify"](data, lengths, expected)
    assert int(bad) == 1 and sharded.to_host(ok).tolist() == \
        [i != 5 for i in range(16)]
    pm = gf256.rs_parity_matrix(4, 2)
    w = np.asarray(gf256.bitmatrix_of_gf_matrix(pm), dtype=np.int8)
    shards = rng.integers(0, 256, (16, 4, 512), dtype=np.uint8)
    assert np.array_equal(sharded.to_host(fns["rs_encode"](shards, w)),
                          gf256.gf_matmul_blocks(pm, shards))


def test_split_hybrid_on_the_card_cold_then_warm(gpu):
    """make_codec("hybrid", shard_mesh=4) on one card behind the feeder:
    results equal the CPU codec's cold and warm, and the warm pass
    stages only the lane that never verifies."""
    import asyncio

    from garage_tpu_torch.ops.feeder import CodecFeeder

    _one, hy = _split_pair(gpu, "hybrid", block_size=4096, pool_page_kib=1)
    cpu = make_codec("cpu", rs_data=4, rs_parity=2)
    assert hy.tpu.shards == [gpu] * 4 and hy.transport.pinned
    feeder = CodecFeeder(hy)
    blocks, hashes, _ = _scrub_inputs(hy.tpu)
    want = cpu.scrub_encode_batch(blocks, hashes)
    try:
        for _ in range(2):
            ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
            assert np.array_equal(ok, want[0]) and np.array_equal(par, want[1])
        staged = hy.transport.staged_bytes
        ok, par = asyncio.run(feeder.scrub_async(blocks, hashes))
        assert np.array_equal(par, want[1])
        assert hy.transport.staged_bytes == staged + len(blocks[4])
        assert hy.transport.stats()["fallbacks"] == 0
    finally:
        feeder.shutdown()
        _one.close()
        hy.close()
