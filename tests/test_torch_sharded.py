"""The port's multi-device split against the reference's mesh, on the CPU.

The same seeded numpy inputs go through the reference (``sharded_fns``
and ``TpuCodec(shard_mesh=8)`` over the conftest's 8-device virtual CPU
mesh, ``gf_bitmatmul``, ``__graft_entry__._scrub_step``) and through the
port (``sharded_fns(["cpu"] * 8)``, ``CudaCodec(shard_mesh=8,
device="cpu")``, ``gf_bitmatmul``'s plain version, ``entry``): digests,
ok vectors, corrupt counts, parity and staged shapes must be equal.  The
work is integer, so the tolerance is exact equality.  Also: a split
HybridCodec through a warm pool pass against the unsplit one and the
CPU codec, and the daemon-level scrub of a port ``Garage`` with
``[codec] shard_mesh = 8``, the counterpart of
``test_sharded_codec.py::test_daemon_scrub_end_to_end_on_sharded_codec``
(its reference half is that test).
"""

import asyncio
import hashlib
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as ref_entry
from garage_tpu.ops import gf256 as ref_gf256
from garage_tpu.ops import tpu_codec as ref_tpu
from garage_tpu.ops.codec import CodecParams as RefParams
from garage_tpu.utils.data import Hash as RefHash
from garage_tpu_torch import entry as port_entry
from garage_tpu_torch.ops import gf256, make_codec, sharded
from garage_tpu_torch.ops.codec import CodecParams
from garage_tpu_torch.ops.cuda_codec import CudaCodec
from garage_tpu_torch.ops.feeder import CodecFeeder
from garage_tpu_torch.utils.data import Hash

N = 8
CPUS = ["cpu"] * N


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < N:
        pytest.skip("needs the conftest's 8-device virtual CPU mesh")
    return Mesh(np.array(devs[:N]), ("data",))


def _digest(b):
    return hashlib.blake2s(b, digest_size=32).digest()


def _blocks(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def _verify_batch(bsz, nbytes, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (bsz, nbytes), dtype=np.uint8)
    lengths = np.full((bsz,), nbytes, dtype=np.int32)
    expected = np.stack([np.frombuffer(_digest(data[i].tobytes()), "<u4")
                         for i in range(bsz)]).astype(np.uint32)
    return data, lengths, expected


def test_sharded_fns_match_reference(mesh):
    """verify (one planted corruption: digests, ok, the summed count on
    devices[0]) and rs_encode over 8 CPU devices equal the reference's
    mesh-sharded jits; a batch the device count does not divide is
    refused, as the reference's jit refuses it."""
    data, lengths, expected = _verify_batch(16, 256, seed=0)
    expected[3] ^= 1
    ref = ref_tpu.sharded_fns(mesh)
    port = sharded.sharded_fns(CPUS)
    rh, rok, rbad = ref["verify"](data, lengths, expected)
    ph, pok, pbad = port["verify"](data, lengths, expected)
    assert len(ph) == len(pok) == N
    assert np.array_equal(sharded.to_host(ph).view(np.uint32), np.asarray(rh))
    assert np.array_equal(sharded.to_host(pok), np.asarray(rok))
    assert int(pbad) == int(rbad) == 1 and pbad.device == torch.device("cpu")

    k, m = 4, 2
    shards = np.random.default_rng(1).integers(0, 256, (16, k, 128),
                                               dtype=np.uint8)
    pm = gf256.rs_parity_matrix(k, m)
    w = np.asarray(gf256.bitmatrix_of_gf_matrix(pm), dtype=np.int8)
    got = sharded.to_host(port["rs_encode"](shards, w))
    assert np.array_equal(got, np.asarray(ref["rs_encode"](shards, w)))
    assert np.array_equal(got, gf256.gf_matmul_blocks(pm, shards))
    with pytest.raises(ValueError, match="does not divide"):
        port["verify"](data[:12], lengths[:12], expected[:12])


@pytest.mark.parametrize("k,r", [(8, 4), (4, 2), (3, 1)])
def test_gf_bitmatmul_matches_reference(k, r):
    """gf_bitmatmul (and its bit packing) on a random GF(2) matrix, not
    only the bit-matrix of a GF(2^8) one, at an odd S; and on the CPU
    gf_bitmatmul is its plain version."""
    rng = np.random.default_rng(10 * k + r)
    shards = rng.integers(0, 256, (3, k, 77), dtype=np.uint8)
    w = rng.integers(0, 2, (k * 8, r * 8), dtype=np.int8)
    want = np.asarray(ref_tpu.gf_bitmatmul(shards, w))
    st, wt = torch.from_numpy(shards), torch.from_numpy(w)
    got = sharded.gf_bitmatmul_plain(st, wt)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, r, 77)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(sharded.gf_bitmatmul(st, wt), got)
    assert np.array_equal(got.numpy(), gf256.rs_encode_bits_numpy(shards, w))
    x = torch.from_numpy(shards[0])
    assert np.array_equal(sharded.unpack_bits(x).numpy(),
                          np.asarray(ref_tpu.unpack_bits(shards[0])))
    assert torch.equal(sharded.pack_bits(sharded.unpack_bits(x)), x)


@pytest.fixture(scope="module")
def split_pair(mesh):
    """(reference TpuCodec over the mesh, port CudaCodec split 8 ways on
    the CPU), RS(8, 4)."""
    ref = ref_tpu.TpuCodec(RefParams(rs_data=8, rs_parity=4, shard_mesh=N),
                           devices=list(mesh.devices.flat))
    port = CudaCodec(CodecParams(rs_data=8, rs_parity=4, shard_mesh=N),
                     device="cpu")
    assert ref.mesh is not None and ref.mesh.size == N
    assert port.shards == [torch.device("cpu")] * N
    return ref, port


def test_split_shapes_match_reference(split_pair):
    """_lane_align, _batch_size, staging_geometry and _pad_group give the
    reference's mesh shapes."""
    ref, port = split_pair
    assert port._lane_align() == ref._lane_align() == 8 * N
    for n in (1, 5, 8, 9, 17, 64, 100, 1000):
        assert port._batch_size(n) == ref._batch_size(n)
        for kind in ("scrub", "encode", "hash", "decode"):
            for maxlen in (1, 700, 4096):
                assert port.staging_geometry(n, maxlen, kind) == \
                    ref.staging_geometry(n, maxlen, kind)
    blocks = _blocks([100, 7, 300, 0, 64], seed=3)
    hashes = [_digest(b) for b in blocks]
    pa = port._pad_group(blocks, [Hash(h) for h in hashes])
    ra = ref._pad_group(blocks, [RefHash(h) for h in hashes])
    for a, b in zip(pa, ra):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_split_codec_matches_reference(split_pair):
    """batch_hash, batch_verify, rs_encode on 5 codewords (5 % 8 != 0),
    rs_reconstruct and scrub_encode_batch of the split port codec equal
    the reference's mesh codec and the unsplit port codec."""
    ref, port = split_pair
    one = CudaCodec(CodecParams(rs_data=8, rs_parity=4), device="cpu")
    blocks = [bytes([i]) * (100 + i) for i in range(5)]
    want = [_digest(b) for b in blocks]
    for c in (port, one):
        assert [bytes(h) for h in c.batch_hash(blocks)] == want
    assert [bytes(h) for h in ref.batch_hash(blocks)] == want
    bad = [Hash(h) for h in want]
    bad[2] = Hash(bytes(32))
    ok = port.batch_verify(blocks, bad)
    assert ok.tolist() == [True, True, False, True, True]
    assert np.array_equal(ok, ref.batch_verify(
        blocks, [RefHash(bytes(h)) for h in bad]))

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 8, 64), dtype=np.uint8)
    parity = port.rs_encode(data)
    assert parity.shape == (5, 4, 64)
    assert np.array_equal(parity, ref.rs_encode(data))
    assert np.array_equal(parity, one.rs_encode(data))
    full = np.concatenate([data, parity], axis=1)
    present = [0, 1, 3, 4, 6, 7, 8, 9, 10, 11]
    for rows in (None, [2, 5]):
        got = port.rs_reconstruct(full[:, present], present, rows)
        assert np.array_equal(got, ref.rs_reconstruct(full[:, present],
                                                      present, rows))
        assert np.array_equal(got, one.rs_reconstruct(full[:, present],
                                                      present, rows))
    assert np.array_equal(port.rs_reconstruct(full[:, present], present),
                          data)

    blocks = _blocks([700, 512, 1, 0, 333, 640] * 4 + [64], seed=4)
    hashes = [_digest(b) for b in blocks]
    scrubbed = list(blocks)
    for i in (1, 8, 24):
        scrubbed[i] = bytes([scrubbed[i][0] ^ 1]) + scrubbed[i][1:]
    got = port.scrub_encode_batch(scrubbed, [Hash(h) for h in hashes])
    exp = ref.scrub_encode_batch(scrubbed, [RefHash(h) for h in hashes])
    unsplit = one.scrub_encode_batch(scrubbed, [Hash(h) for h in hashes])
    for a in (exp, unsplit):
        assert np.array_equal(got[0], a[0]) and np.array_equal(got[1], a[1])
    assert (~got[0]).sum() == 3
    # the summed corrupt count and one fused launch per shard
    arr, lengths, expected = port._pad_group(scrubbed,
                                             [Hash(h) for h in hashes])
    out = port.scrub_encode_submit(arr, lengths, expected)
    assert int(out.bad) == 3 and len(out.ok) == len(out.events) == N


def test_split_codec_from_config(monkeypatch):
    """[codec] shard_mesh reaches the codec: the port's Config builds a
    CudaCodec split 8 ways on the CPU device, as the reference's builds
    its 8-device mesh, and `codec info` lists the shards; on the card it
    raises when the host has fewer GPUs (the reference runs unsplit)."""
    from garage_tpu.utils.config import config_from_dict as ref_config
    from garage_tpu_torch.utils.config import config_from_dict

    raw = {"codec": {"backend": "cuda", "shard_mesh": 8}}
    codec = config_from_dict(raw).codec.make(1, device="cpu")
    assert isinstance(codec, CudaCodec) and len(codec.shards) == 8
    assert codec.info()["shards"] == ["cpu"] * 8
    ref = ref_config({"codec": {"backend": "tpu", "shard_mesh": 8}})
    assert ref.codec.make(1).mesh.size == 8
    hy = config_from_dict({"codec": {"backend": "hybrid", "shard_mesh": 4}}
                          ).codec.make(1, device="cpu")
    assert hy.tpu.shards == [torch.device("cpu")] * 4
    assert hy.info()["shards"] == ["cpu"] * 4
    hy.close()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"shard_mesh=8 .*device_count"):
        config_from_dict(raw).codec.make(1)


def _pooled_hybrid(split):
    return make_codec("hybrid", device="cpu", rs_data=4, rs_parity=2,
                      block_size=1024, hybrid_group_blocks=4,
                      device_batch_blocks=16, pool_page_kib=1,
                      hybrid_min_link_gibs=1e-6,
                      shard_mesh=4 if split else 1)


def test_split_hybrid_matches_unsplit_and_cpu():
    """A split HybridCodec (4 shards) behind the feeder: a cold scrub
    pass with planted corruption and a warm one served from the pool,
    PUT hashes, encodes and degraded decodes equal the unsplit hybrid's
    and the CPU codec's; the warm pass stages no scrub lane but the two
    corrupt ones (a lane that fails its hash is never adopted)."""
    sizes = (1024, 700, 1024, 1, 0, 1024, 513, 64)
    blocks = _blocks([sizes[i % 8] for i in range(19)], seed=1)
    hashes = [_digest(b) for b in blocks]
    other = _blocks([sizes[i % 8] for i in range(19)], seed=5)
    other_hashes = [_digest(b) for b in other]
    scrubbed = list(other)
    for i in (2, 11):
        scrubbed[i] = bytes([scrubbed[i][0] ^ 0x5A]) + scrubbed[i][1:]
    put_blocks = _blocks([333] * 6, seed=2)
    data = np.random.default_rng(7).integers(0, 256, (3, 4, 256),
                                             dtype=np.uint8)
    present = [0, 2, 3, 5]
    results, misses = [], []
    codecs = [make_codec("cpu", rs_data=4, rs_parity=2),
              _pooled_hybrid(False), _pooled_hybrid(True)]
    for codec in codecs:
        full = np.concatenate([data, codec.rs_encode(data)], axis=1)
        feeder = CodecFeeder(codec)

        async def drive():
            scrub = await asyncio.gather(
                feeder.scrub_async(scrubbed, [Hash(h) for h in other_hashes]),
                feeder.scrub_async(blocks, [Hash(h) for h in hashes]))
            hashed = await asyncio.gather(*[feeder.hash_async([b], peers=6)
                                            for b in put_blocks])
            enc = await asyncio.wrap_future(feeder.submit_encode(
                [data[0, i].tobytes() for i in range(4)], peers=1))
            dec = await asyncio.gather(*[
                feeder.decode_async(full[c:c + 1, present], present, [1])
                for c in range(3)])
            return scrub, [bytes(h[0]) for h in hashed], enc, dec

        try:
            runs = []
            for _ in range(2):
                pool = getattr(codec, "pool", None)
                before = pool.stats()["miss_bytes"] if pool else 0
                runs.append(asyncio.run(drive()))
                misses.append(pool.stats()["miss_bytes"] - before
                              if pool else 0)
            results.append(runs)
        finally:
            feeder.shutdown()
    cpu_runs, one_runs, split_runs = results
    for runs in (one_runs, split_runs):
        for (rs, rh, re, rd), (ps, ph, pe, pd) in zip(cpu_runs, runs):
            for (rok, rpar), (pok, ppar) in zip(rs, ps):
                assert np.array_equal(rok, pok) and np.array_equal(rpar, ppar)
            assert ph == rh
            assert np.array_equal(pe, re)
            for a, b in zip(pd, rd):
                assert np.array_equal(a, b)
    assert (~split_runs[0][0][0][0]).sum() == 2
    split = codecs[2]
    assert split.tpu.shards == [torch.device("cpu")] * 4
    st, pool = split.transport.stats(), split.pool.stats()
    assert split.transport.alive and st["fallbacks"] == 0
    assert pool["hit_bytes"] > 0
    assert pool["hit_bytes"] + pool["miss_bytes"] == \
        2 * sum(map(len, blocks + scrubbed))
    assert misses[5] == misses[3] == len(scrubbed[2]) + len(scrubbed[11])
    assert misses[4] == misses[2] == sum(map(len, blocks + scrubbed))
    kinds = {e["kind"] for e in split.obs.events_list()}
    assert not kinds & {"transport_error", "transport_fallback",
                        "transport_down"}
    for c in codecs[1:]:
        c.close()


async def test_daemon_scrub_on_split_codec(tmp_path):
    """A port Garage configured with backend "cuda" and shard_mesh = 8
    on the CPU device: `codec info` lists the 8 shards, its ScrubWorker
    finds exactly the 3 planted
    corruptions, the sidecar parity the split pass wrote equals the CPU
    codec's RS encode, and a lost block is rebuilt bit-exact from it."""
    from garage_tpu_torch.admin.handler import AdminRpcHandler
    from garage_tpu_torch.block.block import DataBlock
    from garage_tpu_torch.block.repair import ScrubWorker
    from garage_tpu_torch.model import Garage
    from garage_tpu_torch.ops.cpu_codec import CpuCodec
    from garage_tpu_torch.rpc.layout import ClusterLayout, NodeRole
    from garage_tpu_torch.utils.config import config_from_dict
    from garage_tpu_torch.utils.data import blake2s_sum

    g = Garage(config_from_dict({
        "metadata_dir": str(tmp_path / "meta"),
        "data_dir": str(tmp_path / "data"),
        "replication_mode": "none",
        "rpc_bind_addr": "127.0.0.1:0",
        "rpc_secret": "shard-scrub",
        "db_engine": "memory",
        "bootstrap_peers": [],
        "codec": {
            "backend": "cuda", "shard_mesh": 8,
            "rs_data": 4, "rs_parity": 2,
            "store_parity": True, "batch_blocks": 16,
        },
    }), device="cpu")
    try:
        await g.system.netapp.listen("127.0.0.1:0")
        lay = g.system.layout
        lay.stage_role(bytes(g.system.id), NodeRole("dc1", 1000))
        lay.apply_staged_changes()
        g.system.layout = ClusterLayout.decode(lay.encode())
        g.system._rebuild_ring()
        codec = g.block_manager.codec
        assert isinstance(codec, CudaCodec) and len(codec.shards) == 8
        info = await AdminRpcHandler(g, register_endpoint=False
                                     )._cmd_codec_info({})
        assert info["shards"] == ["cpu"] * 8

        # ~1 KiB blocks: the plain BLAKE2s hashes each dispatch's
        # longest block whole
        rng = np.random.default_rng(11)
        datas = [rng.integers(0, 256, 700 + 13 * i, dtype=np.uint8).tobytes()
                 for i in range(24)]
        hashes = [blake2s_sum(d) for d in datas]
        for h, d in zip(hashes, datas):
            await g.block_manager.write_block(h, DataBlock.plain(d))
        for h in hashes[:3]:
            path, _ = g.block_manager.find_block(h)
            with open(path, "r+b") as f:
                f.seek(16)
                f.write(b"\xde\xad\xbe\xef")

        scrub = ScrubWorker(g.block_manager)
        scrub.send_command("start")
        while (await scrub.work()).name in ("BUSY", "THROTTLED"):
            pass
        assert scrub.state.corruptions == 3
        assert g.block_manager.resync.queue_len() >= 3

        store = g.block_manager.parity_store
        assert store is not None and store.stats()["indexed_blocks"] > 0
        victim = None
        for h in hashes[3:]:
            if not store.coverage(h):
                continue
            man = store._load_manifest(h)
            sibs = [Hash(x) for x in man["hashes"] if bytes(x) != bytes(h)]
            if all(store._read_verified_member(s) is not None for s in sibs):
                victim = h
                break
        assert victim is not None, "no cleanly reconstructable victim"
        man = store._load_manifest(victim)
        want = datas[hashes.index(victim)]
        members = []
        for mh in man["hashes"]:
            raw = datas[[bytes(x) for x in hashes].index(bytes(mh))]
            pad = np.zeros(man["maxlen"], dtype=np.uint8)
            pad[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            members.append(pad)
        while len(members) < man["k"]:
            members.append(np.zeros(man["maxlen"], dtype=np.uint8))
        expect = CpuCodec(CodecParams(rs_data=4, rs_parity=2)).rs_encode(
            np.stack(members)[None])[0]
        got = np.stack([np.frombuffer(s, dtype=np.uint8)
                        for s in man["parity"]])
        assert np.array_equal(got, expect)
        path, _ = g.block_manager.find_block(victim)
        os.remove(path)
        rec = await asyncio.to_thread(store.try_reconstruct, victim)
        assert rec == want
    finally:
        await g.shutdown()


def test_entry_step_matches_reference():
    """entry(device="cpu")'s step equals __graft_entry__._scrub_step on
    the same arguments, and dryrun_multichip runs over 8 CPU devices."""
    fn, args = port_entry.entry(device="cpu")
    _f, ref_args = ref_entry.entry()
    for a, b in zip(args, ref_args):
        assert np.array_equal(a.numpy().view(b.dtype), b)
    want = jax.jit(ref_entry._scrub_step)(*ref_args)
    got = fn(*args)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) == 0
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert np.array_equal(got[3].numpy(), ref_gf256.gf_matmul_blocks(
        ref_gf256.rs_parity_matrix(8, 4), ref_args[3]))
    port_entry.dryrun_multichip(N, devices=CPUS)
