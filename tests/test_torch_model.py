"""The port's model layer (garage_tpu_torch.model) against the reference
package's: CRDT merges of objects, versions, buckets, keys and
permissions (same inputs → same encoded bytes, decodable by the other
package), the object → version → block_ref → rc hook chain, index
counters, the lifecycle expiry and K2V causality tokens on 3-node
loopback clusters of `Garage` nodes; and the erasure-coded storage
class on 5-node clusters of the port's `Garage(config, device="cpu")`
with `codec.backend = "cuda"`, so the CUDA kernels' plain versions run:
write-time distributed parity equal to the reference's on the same
blocks and ring, a degraded GET decoded bit-exact, and a two-node loss
healed exactly once per recoverable block.

The plain BLAKE2s costs ~4 ms per 64-byte chunk of a dispatch's longest
block on the CPU, so the erasure-coded tests use blocks of 0.3-0.7 KiB.
"""

import asyncio
import importlib
import os
import shutil
import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.asyncio

SEED = 20261020


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")

    model = m("model")
    return types.SimpleNamespace(
        name=name, Garage=model.Garage, model=model,
        Bucket=model.Bucket, BucketParams=model.BucketParams,
        Key=model.Key, KeyParams=model.KeyParams,
        BucketKeyPerm=model.BucketKeyPerm, obj=m("model.s3.object_table"),
        ver=m("model.s3.version_table"), bref=m("model.s3.block_ref_table"),
        k2v=m("model.k2v.causality"), lifecycle=m("model.s3.lifecycle_worker"),
        crdt=m("utils.crdt"), data=m("utils.data"), layout=m("rpc.layout"),
        schema=m("table.schema"), parity=m("block.parity"),
        persister=m("utils.persister"),
        config_from_dict=m("utils.config").config_from_dict)


REF, PORT = _pkg("garage_tpu"), _pkg("garage_tpu_torch")


def _rng(salt: int):
    return np.random.default_rng([SEED, salt])


def complete_version(P, uuid, ts, data: bytes):
    h = P.obj.ObjectVersionHeaders.new()
    meta = P.obj.ObjectVersionMeta.new(h, len(data), "etag")
    return P.obj.ObjectVersion(uuid, ts, [
        "complete", P.obj.ObjectVersionData.inline(meta, data)])


# --- CRDT merges: same inputs, same bytes ---------------------------------


def _merge_both_ways(make):
    """(a ⊔ b, b ⊔ a, a ⊔ a) encoded, from fresh copies each time."""
    out = []
    for x, y in ((0, 1), (1, 0), (0, 0)):
        a, b = make(x), make(y)
        a.merge(b)
        out.append(a.encode())
    return out


def crdt_object(P):
    rng = _rng(1)
    bid, key = rng.bytes(32), "some/key"
    uu = [rng.bytes(32) for _ in range(5)]
    hdr = P.obj.ObjectVersionHeaders.new("text/plain", {"x-amz-meta-a": "1"})
    sides = [
        [complete_version(P, uu[0], 100, b"a"),
         P.obj.ObjectVersion.uploading(uu[1], 300, False, hdr),
         P.obj.ObjectVersion(uu[2], 150, ["complete",
                                          P.obj.ObjectVersionData.delete_marker()])],
        [complete_version(P, uu[3], 200, b"bb"),
         P.obj.ObjectVersion(uu[1], 300, ["aborted"]),
         P.obj.ObjectVersion.uploading(uu[4], 400, True, hdr)],
    ]
    return _merge_both_ways(
        lambda i: P.obj.Object(bid, key, [P.obj.ObjectVersion.unpack(
            v.pack()) for v in sides[i]]))


def crdt_version(P):
    rng = _rng(2)
    u, bid = rng.bytes(32), rng.bytes(32)
    blocks = [(int(p), int(o), rng.bytes(32), int(n)) for p, o, n in
              zip(rng.integers(1, 3, 6), rng.integers(0, 1 << 20, 6),
                  rng.integers(1, 1 << 20, 6))]

    def make(i):
        v = P.ver.Version.new(u, bid, "k")
        for b in blocks[i::2]:
            v.add_block(*b)
        return v

    out = _merge_both_ways(make)
    # a deletion absorbs concurrent adds, in either order
    d = P.ver.Version.new(u, bid, "k", deleted=True)
    d.merge(make(0))
    a = make(1)
    a.merge(P.ver.Version.new(u, bid, "k", deleted=True))
    return out + [d.encode(), a.encode()]


def crdt_bucket(P):
    rng = _rng(3)
    bid = rng.bytes(32)
    Lww, LwwMap, Deletable = P.crdt.Lww, P.crdt.LwwMap, P.crdt.Deletable
    keys = [f"GK{rng.bytes(12).hex()}" for _ in range(3)]

    def params(i):
        perms = {k: Lww(P.BucketKeyPerm(bool(i), True, i == 0,
                                        timestamp=10 + j + i),
                        ts=20 + j * 3 + i)
                 for j, k in enumerate(keys[i:])}
        return P.BucketParams(
            creation_date=1000 + i,
            authorized_keys=LwwMap(perms),
            aliases=LwwMap({f"b{i}": Lww(bool(i), ts=5 + i)}),
            website_config=Lww({"index": f"i{i}.html"}, ts=7 - i),
            lifecycle_config=Lww([{"enabled": True, "expiration_days": i + 1}],
                                 ts=9 + i))

    def make(i):
        return P.Bucket(bid, Deletable.present(params(i)))

    out = _merge_both_ways(make)
    gone = P.Bucket(bid, Deletable.delete())
    gone.merge(make(0))
    return out + [gone.encode()]


def crdt_key(P):
    rng = _rng(4)
    Lww, LwwMap, Deletable = P.crdt.Lww, P.crdt.LwwMap, P.crdt.Deletable
    key_id, secret = f"GK{rng.bytes(12).hex()}", rng.bytes(32).hex()
    bids = [rng.bytes(32) for _ in range(3)]

    def make(i):
        kp = P.KeyParams(
            secret, name=Lww(f"name{i}", ts=50 - i),
            allow_create_bucket=Lww(bool(i), ts=3 + i),
            authorized_buckets=LwwMap({
                b: Lww(P.BucketKeyPerm(True, bool(i), False,
                                       timestamp=30 + j), ts=31 + j + i)
                for j, b in enumerate(bids[i:])}),
            local_aliases=LwwMap({f"al{i}": Lww(bids[i], ts=8)}))
        return P.Key(key_id, Deletable.present(kp))

    out = _merge_both_ways(make)
    gone = P.Key(key_id, Deletable.delete())
    gone.merge(make(1))
    return out + [gone.encode()]


def crdt_permission(P):
    perms = [P.BucketKeyPerm(True, False, False, timestamp=10),
             P.BucketKeyPerm(False, True, False, timestamp=20),
             P.BucketKeyPerm(True, False, True, timestamp=20)]
    out = []
    for order in ((0, 1, 2), (2, 1, 0), (1, 2, 0)):
        acc = P.BucketKeyPerm.unpack(perms[order[0]].pack())
        for i in order[1:]:
            acc.merge(perms[i])
        out.append(acc.pack())
    return out


@pytest.mark.parametrize("case", [crdt_object, crdt_version, crdt_bucket,
                                  crdt_key, crdt_permission],
                         ids=lambda f: f.__name__)
def test_crdt_merge_same_bytes_as_reference(case):
    ref, port = case(REF), case(PORT)
    assert ref == port
    # merges commute: a ⊔ b == b ⊔ a
    assert ref[0] == ref[1]


@pytest.mark.parametrize("cls_name", ["Object", "Version", "Bucket", "Key"])
def test_model_entries_decode_in_the_other_package(cls_name):
    cases = {"Object": crdt_object, "Version": crdt_version,
             "Bucket": crdt_bucket, "Key": crdt_key}
    owner = {"Object": "obj", "Version": "ver"}
    for src, dst in ((REF, PORT), (PORT, REF)):
        mod = getattr(dst, owner[cls_name]) if cls_name in owner else dst
        cls = getattr(mod, cls_name)
        for raw in cases[cls_name](src):
            assert cls.decode(raw).encode() == raw


# --- K2V causality tokens --------------------------------------------------


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_k2v_causal_context_round_trips(src, dst):
    rng = _rng(5)
    for n in (0, 1, 3, 8):
        vc = {int(a): int(b) for a, b in zip(
            rng.integers(0, 1 << 63, n, dtype=np.uint64),
            rng.integers(0, 1 << 63, n, dtype=np.uint64))}
        tok = src.k2v.CausalContext(dict(vc)).serialize()
        back = dst.k2v.CausalContext.parse(tok)
        assert back.vector_clock == vc and back.serialize() == tok
        nid = rng.bytes(32)
        assert src.k2v.node_id64(nid) == dst.k2v.node_id64(nid)
    a = dst.k2v.CausalContext({1: 5, 2: 7})
    assert a.is_newer_than(dst.k2v.CausalContext.parse(
        src.k2v.CausalContext({1: 5, 2: 6}).serialize()))
    for bad in ("AAAA", "A" * 23):
        with pytest.raises(ValueError):
            dst.k2v.CausalContext.parse(bad)
        with pytest.raises(ValueError):
            src.k2v.CausalContext.parse(bad)


# --- 3-node Garage clusters (codec on the CPU floor) -----------------------


async def make_garage_cluster(P, root, n=3, mode="3"):
    garages = []
    for i in range(n):
        cfg = P.config_from_dict({
            "metadata_dir": str(root / P.name / f"n{i}" / "meta"),
            "data_dir": str(root / P.name / f"n{i}" / "data"),
            "replication_mode": mode, "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "model-test", "db_engine": "memory",
            "bootstrap_peers": [], "codec": {"backend": "cpu"}})
        g = P.Garage(cfg)
        await g.system.netapp.listen("127.0.0.1:0")
        garages.append(g)
    ports = [g.system.netapp._server.sockets[0].getsockname()[1]
             for g in garages]
    for i, a in enumerate(garages):
        for j in range(i + 1, len(garages)):
            await a.system.netapp.connect(f"127.0.0.1:{ports[j]}",
                                          expected_id=garages[j].system.id)
        a.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
    lay = garages[0].system.layout
    for g in garages:
        lay.stage_role(bytes(g.system.id), P.layout.NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in garages:
        g.system.layout = P.layout.ClusterLayout.decode(enc)
        g.system._rebuild_ring()
    return garages


async def shutdown(garages):
    for g in garages:
        await g.shutdown()


def table_rows(table) -> list:
    return sorted((bytes(k), bytes(v))
                  for k, v in table.data.store.items(None, None))


async def _poll(cond, tries=200, dt=0.05):
    for _ in range(tries):
        if cond():
            return True
        await asyncio.sleep(dt)
    return cond()


async def test_hook_chain_and_counters_equal_reference(tmp_path):
    """version → block_ref → rc on every node, the object counter, then an
    overwrite that tombstones the version and drops the refs: the same
    rows and counts in both packages."""
    rng = _rng(6)
    bid, vu, vu2 = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    blocks = [rng.bytes(32) for _ in range(3)]
    out = {}
    for P in (REF, PORT):
        garages = await make_garage_cluster(P, tmp_path)
        for g in garages:
            g.spawn_workers()
        g = garages[0]
        ver = P.ver.Version.new(vu, bid, "obj1")
        for i, bh in enumerate(blocks):
            ver.add_block(0, i * 1000, bh, 1000)
        await g.version_table.insert(ver)
        await g.object_table.insert(P.obj.Object(bid, "obj1", [
            complete_version(P, vu, 100, b"inline")]))
        await g.object_table.insert(P.obj.Object(bid, "up", [
            P.obj.ObjectVersion.uploading(
                rng.bytes(32), 120, False,
                P.obj.ObjectVersionHeaders.new())]))
        H = P.data.Hash

        def rcs():
            return [[x.block_manager.rc.get(H(b)).is_needed() for b in blocks]
                    for x in garages]

        assert await _poll(lambda: all(all(r) for r in rcs()))
        totals = await g.object_counter.get_totals(bid)
        refs = [table_rows(x.block_ref_table) for x in garages]
        # overwrite: the merge prunes vu, the hook tombstones its version
        await g.object_table.insert(P.obj.Object(bid, "obj1", [
            complete_version(P, vu2, 200, b"")]))
        assert await _poll(lambda: not any(any(r) for r in rcs()))
        await asyncio.sleep(0.2)
        out[P.name] = (totals, refs,
                       [table_rows(x.version_table) for x in garages],
                       await g.object_counter.get_totals(bid))
        await shutdown(garages)
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    totals = out["garage_tpu_torch"][0]
    assert (totals["objects"], totals["unfinished_uploads"]) == (1, 1)


async def test_lifecycle_expiry_equal_reference(tmp_path):
    """tests/test_lifecycle.py:55 in both packages: an object older than
    the rule's days expires behind a delete marker, a fresh one stays,
    and the completion date persists."""
    out = {}
    for P in (REF, PORT):
        garages = await make_garage_cluster(P, tmp_path)
        g = garages[0]
        bucket = await g.helper().create_bucket("lcbkt")
        bucket.params().lifecycle_config.update(
            [{"enabled": True, "prefix": "", "expiration_days": 2}])
        await g.bucket_table.insert(bucket)
        now = P.crdt.now_msec()
        await g.object_table.insert(P.obj.Object(bucket.id, "old.txt", [
            complete_version(P, P.data.gen_uuid(), now - 5 * 86_400_000,
                             b"x" * 10)]))
        await g.object_table.insert(P.obj.Object(bucket.id, "fresh.txt", [
            complete_version(P, P.data.gen_uuid(), now, b"y" * 10)]))
        pers = P.persister.Persister(str(tmp_path / P.name / "lw"), "state",
                                     P.lifecycle.LifecycleWorkerPersisted)
        w = P.lifecycle.LifecycleWorker(g, pers)
        assert w.date == P.lifecycle.today()
        while (await w.work()).name in ("BUSY", "THROTTLED"):
            pass
        old = await g.object_table.get(bucket.id, "old.txt")
        fresh = await g.object_table.get(bucket.id, "fresh.txt")
        w2 = P.lifecycle.LifecycleWorker(g, P.persister.Persister(
            str(tmp_path / P.name / "lw"), "state",
            P.lifecycle.LifecycleWorkerPersisted))
        out[P.name] = (w.objects_expired, old.last_data_version() is None,
                       fresh.last_data_version() is not None, w2.date,
                       w2.last_completed == P.lifecycle.today())
        await shutdown(garages)
    assert out["garage_tpu"] == out["garage_tpu_torch"] == (
        1, True, True, None, True)


# --- the erasure-coded storage class on the port's Garage ------------------


def ec_blocks(n: int, salt: int):
    rng = _rng(salt)
    return [rng.bytes(int(rng.integers(300, 700))) for _ in range(n)]


async def make_ec_cluster(P, root, n=5, rs=(4, 2), keys_from=None,
                          codec=None, flush_after=0.2):
    """tests/test_model.py make_ec_cluster for package P: meta "3", data
    "none", RS(k, m) write-time distributed parity.  The port's nodes are
    `Garage(config, device="cpu")` with the cuda backend; `keys_from`
    copies another cluster's node keys, so both share one ring."""
    garages = []
    for i in range(n):
        meta = root / P.name / f"n{i}" / "meta"
        if keys_from is not None:
            os.makedirs(meta, exist_ok=True)
            src = keys_from / f"n{i}" / "meta"
            for f in os.listdir(src):
                if f.startswith("node_key"):
                    shutil.copy(src / f, meta / f)
        cfg = P.config_from_dict({
            "metadata_dir": str(meta),
            "data_dir": str(root / P.name / f"n{i}" / "data"),
            "replication_mode": "3", "data_replication_mode": "none",
            "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "ec-test",
            "db_engine": "memory", "bootstrap_peers": [],
            "codec": {"backend": "cpu" if P is REF else "cuda",
                      "rs_data": rs[0], "rs_parity": rs[1],
                      "store_parity": True, "parity_on_write": True,
                      "parity_distribute": True, **(codec or {})}})
        garages.append(P.Garage(cfg) if P is REF
                       else P.Garage(cfg, device="cpu"))
    for g in garages:
        await g.system.netapp.listen("127.0.0.1:0")
        g.block_manager.ec_accumulator.flush_after = flush_after
    ports = [g.system.netapp._server.sockets[0].getsockname()[1]
             for g in garages]
    for i, a in enumerate(garages):
        for j, b in enumerate(garages):
            if i < j:
                await a.system.netapp.connect(f"127.0.0.1:{ports[j]}",
                                              expected_id=b.system.id)
            if i != j:
                a.system.peering.add_peer(f"127.0.0.1:{ports[j]}",
                                          b.system.id)
        a.config.rpc_public_addr = f"127.0.0.1:{ports[i]}"
        a.system.peering.start()
    lay = garages[0].system.layout
    for g in garages:
        lay.stage_role(bytes(g.system.id), P.layout.NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for g in garages:
        g.system.layout = P.layout.ClusterLayout.decode(enc)
        g.system._rebuild_ring()
        g.spawn_workers()
    return garages


async def live_rows(g, h):
    ents = await g.parity_index_table.get_range(bytes(h), None)
    return [e for e in ents if not e.is_tombstone()]


def test_garage_codec_is_the_ports_cuda_codec_on_request(tmp_path):
    from garage_tpu_torch.ops.cuda_codec import CudaCodec

    g = PORT.Garage(PORT.config_from_dict({
        "metadata_dir": str(tmp_path / "meta"),
        "data_dir": str(tmp_path / "data"), "replication_mode": "1",
        "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "x",
        "bootstrap_peers": [], "db_engine": "memory",
        "codec": {"backend": "cuda", "parity_distribute": True}}),
        device="cpu")
    codec = g.block_manager.codec
    assert isinstance(codec, CudaCodec) and str(codec.device) == "cpu"
    assert g.block_manager.feeder.codec is codec
    assert g.block_manager.ec_accumulator.codec is codec
    g.block_manager.feeder.shutdown()
    g.db.close()


@pytest.mark.parametrize("backend", ["cuda", "hybrid"])
def test_garage_raises_without_a_gpu(tmp_path, backend):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: Garage(config) builds on it")
    cfg = PORT.config_from_dict({
        "metadata_dir": str(tmp_path / "meta"),
        "data_dir": str(tmp_path / "data"), "replication_mode": "1",
        "rpc_bind_addr": "127.0.0.1:0", "rpc_secret": "x",
        "bootstrap_peers": [], "db_engine": "sqlite",
        "codec": {"backend": backend}})
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.Garage(cfg)
    # the same config on request runs the kernels' plain versions
    g = PORT.Garage(cfg, device="cpu")
    assert str(g.block_manager.codec.device) == "cpu"
    g.block_manager.feeder.shutdown()
    g.db.close()


async def test_distributed_parity_equals_reference(tmp_path):
    """The same 12 blocks written through node 0 of a reference cluster
    and of a port cluster on the same ring (shared node keys): the same
    codewords (members, lengths, parity placement) in the parity index,
    and parity shards equal byte for byte — and equal to the reference
    CPU codec's encode of each codeword's members."""
    from garage_tpu.ops import make_codec as ref_make_codec

    datas = ec_blocks(12, 7)
    out, digests = {}, {}
    for P in (REF, PORT):
        garages = await make_ec_cluster(
            P, tmp_path, keys_from=(tmp_path / REF.name) if P is PORT
            else None, flush_after=60.0)
        digests[P.name] = garages[0].system.ring.digest()
        g0 = garages[0].block_manager
        hs = [P.data.blake2s_sum(d) for d in datas]
        for h, d in zip(hs, datas):
            await g0.rpc_put_block(h, d)
        await g0.ec_accumulator.drain()
        cw = {}
        for h in hs:
            rows = await live_rows(garages[0], h)
            assert len(rows) == 1, "a block without exactly one codeword"
            e = rows[0]
            blobs = [await g0.rpc_get_block(P.data.Hash(bytes(ph)))
                     for ph in e.parity_hashes]
            cw[bytes(h)] = (int(e.member_index), int(e.k), int(e.m),
                            [bytes(x) for x in e.members], list(e.lengths),
                            [bytes(x) for x in e.parity_hashes], blobs)
        out[P.name] = (cw, g0.ec_accumulator.codewords_encoded)
        await shutdown(garages)
    assert digests["garage_tpu"] == digests["garage_tpu_torch"]
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    ref_codec = ref_make_codec("cpu", rs_data=4, rs_parity=2)
    by_hash = {bytes(REF.data.blake2s_sum(d)): d for d in datas}
    for _mi, _k, m, members, _lens, _ph, blobs in out["garage_tpu_torch"][0].values():
        want = ref_codec.rs_encode_blocks([by_hash[x] for x in members])[0]
        got = [PORT.parity.unpack_parity_shard(b) for b in blobs]
        assert [bytes(w) for w in want] == got and len(got) == m


class _DecodeTally:
    """Counts the codewords a node's feeder hands its codec to decode."""

    def __init__(self, codec):
        self.codewords = 0
        inner = codec.rs_reconstruct_ragged

        def counted(items):
            self.codewords += sum(int(it[0].shape[0]) for it in items)
            return inner(items)
        codec.rs_reconstruct_ragged = counted


@pytest.mark.parametrize("ppr", [True, False], ids=["ppr", "whole-shard"])
async def test_degraded_get_decodes_bit_exact(tmp_path, ppr):
    """tests/test_model.py:1370 on the port: the sole copy of a covered
    block vanishes, resync is stubbed out, the GET decodes it from the
    distributed parity and the reader writes the copy back.  With
    whole-shard repair the decode runs through the reader's feeder on
    the GF kernel's plain version."""
    datas = ec_blocks(12, 8)
    garages = await make_ec_cluster(PORT, tmp_path,
                                    codec={"repair_ppr": ppr})
    try:
        g0 = garages[0].block_manager
        hs = [PORT.data.blake2s_sum(d) for d in datas]
        for h, d in zip(hs, datas):
            await g0.rpc_put_block(h, d)
        covered = None
        for _ in range(400):
            for h in hs:
                if await live_rows(garages[0], h):
                    covered = h
                    break
            if covered is not None:
                break
            await asyncio.sleep(0.05)
        assert covered is not None, "no block gained parity coverage"
        for g in garages:
            g.block_resync.put_to_resync = lambda *a, **k: None
        holder = None
        for g in garages:
            found = g.block_manager.find_block(covered)
            if found is not None:
                holder = g
                os.remove(found[0])
        assert holder is not None
        tally = _DecodeTally(g0.codec)
        # a copy for storage (resync's fetch) does not decode: resync's
        # own ladder sweeps live peers for a copy first
        with pytest.raises(Exception, match="could not stream"):
            await g0.rpc_get_raw_block(covered, for_storage=True)
        assert tally.codewords == 0
        got = await g0.rpc_get_block(covered)
        assert got == datas[hs.index(covered)]
        assert await _poll(lambda: holder.block_manager.is_block_present(
            covered), tries=600)
        blk = await holder.block_manager.read_block(covered)
        assert blk.decompressed() == datas[hs.index(covered)]
        assert g0.heal_counts.get("writeback", 0) >= 1
        assert all(g.block_manager.heal_counts.get("resync_fetch", 0) == 0
                   for g in garages)
        if not ppr:
            assert tally.codewords == 1
        assert all(g.block_manager.geometry_cpu_decodes == 0 for g in garages)
    finally:
        for g in garages:
            await g.shutdown()


async def test_two_node_loss_heals_each_recoverable_block_once(tmp_path):
    """tests/test_model.py:674 on the port, whole-shard repair: two nodes
    die; every block of theirs whose codeword keeps >= k live pieces
    (implicit zero shards counted) is rebuilt on its new primary,
    bit-exact, decoded exactly once across the survivors; a block that
    only moved between two live nodes is copied, not decoded."""
    datas = ec_blocks(12, 9)
    garages = await make_ec_cluster(PORT, tmp_path,
                                    codec={"repair_ppr": False})
    g0 = garages[0].block_manager
    H = PORT.data.Hash
    hs = [PORT.data.blake2s_sum(d) for d in datas]
    bid, vu = _rng(10).bytes(32), _rng(11).bytes(32)
    ver = PORT.ver.Version.new(vu, bid, "ec-obj")
    for off, (h, d) in enumerate(zip(hs, datas)):
        await g0.rpc_put_block(h, d)
        ver.add_block(0, off, bytes(h), len(d))
    await garages[0].version_table.insert(ver)
    await g0.ec_accumulator.drain()
    entries = {}
    for h in hs:
        entries[bytes(h)] = await live_rows(garages[0], h)
        assert entries[bytes(h)], "write-time parity never distributed"

    def node_of(x):
        return bytes(g0.replication.write_nodes(H(bytes(x)))[0])

    ids = [bytes(g.system.id) for g in garages]
    # the pair other than node 0 that loses the most recoverable blocks
    best = None
    for a in range(1, 5):
        for b in range(a + 1, 5):
            dead = {ids[a], ids[b]}
            lost = [h for h in hs if node_of(h) in dead]
            rec = [h for h in lost if any(
                sum(node_of(x) not in dead for x in e.members)
                + e.k - len(e.members)
                + sum(node_of(x) not in dead for x in e.parity_hashes)
                >= e.k for e in entries[bytes(h)])]
            if best is None or len(rec) > len(best[2]):
                best = ((a, b), lost, rec)
    (a, b), lost, predicted = best
    assert predicted, "no recoverable block on any pair"
    for g in garages:
        g.block_manager.blocks_reconstructed = 0
    for i in (a, b):
        await garages[i].shutdown()
    survivors = [g for i, g in enumerate(garages) if i not in (a, b)]
    slay = survivors[0].system.layout
    slay.stage_role(ids[a], None)
    slay.stage_role(ids[b], None)
    slay.apply_staged_changes()
    senc = slay.encode()
    for g in survivors:
        g.system.layout = PORT.layout.ClusterLayout.decode(senc)
        g.system._rebuild_ring()
    by_id = {bytes(g.system.id): g for g in survivors}

    def primary(h):
        return by_id[bytes(survivors[0].block_manager.replication
                           .write_nodes(h)[0])]

    try:
        assert await _poll(lambda: all(
            primary(h).block_manager.is_block_present(h) for h in predicted),
            tries=1200), "a recoverable block was not rebuilt"
        assert await _poll(lambda: all(
            g.rebuild_scheduler.idle() for g in survivors), tries=600)
        await asyncio.sleep(0.5)
        for h in predicted:
            blk = await primary(h).block_manager.read_block(h)
            assert blk.decompressed() == datas[hs.index(h)]
        pset = {bytes(h) for h in predicted}
        assert not [h for h in lost if bytes(h) not in pset and any(
            g.block_manager.is_block_present(h) for g in survivors)]
        assert sum(g.block_manager.blocks_reconstructed
                   for g in survivors) == len(predicted)
        assert all(g.block_manager.geometry_cpu_decodes == 0
                   for g in survivors)
        # a parity shard a survivor holds is marked as one, however it
        # got there (a copy swept from its old holder included), so it
        # never joins a codeword of its own
        parity = {bytes(x) for rows in entries.values() for e in rows
                  for x in e.parity_hashes}
        for g in survivors:
            for x in parity:
                if g.block_manager.is_block_present(H(x)):
                    assert g.block_manager.is_parity_block(H(x))
    finally:
        for g in survivors:
            await g.shutdown()
