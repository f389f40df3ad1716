"""The port's table engine (garage_tpu_torch.table) against the reference
package's: the same seeded rows through both on 3-node loopback clusters
— quorum insert/get, read repair, get_range with filters, Merkle trees,
anti-entropy sync, the three-phase tombstone GC, full-copy replication,
the insert queue across a restart — with every stored row, every Merkle
node and every root compared byte for byte across the packages.  Entry
encodings decode in the other package, and a sqlite database written by
one is read by the other.

Every entry carries an explicit timestamp, so encodings are a pure
function of the seeded inputs.
"""

import asyncio
import importlib
import types

import numpy as np
import pytest

pytestmark = pytest.mark.asyncio

SEED = 20261019


def _kv_types(P):
    """The test entry and schema over package P's table engine."""
    Entry, TableSchema = P.schema.Entry, P.schema.TableSchema
    Lww, DeletedFilter = P.crdt.Lww, P.schema.DeletedFilter

    class KVEntry(Entry):
        VERSION_MARKER = b"T01kv"

        def __init__(self, pk, sk, value, ts=None, deleted=False):
            self.pk, self.sk = pk, sk
            self.value = Lww(value, ts=ts)
            self.deleted = deleted

        @property
        def partition_key(self):
            return self.pk

        @property
        def sort_key(self):
            return self.sk

        def is_tombstone(self):
            return self.deleted

        def merge(self, other):
            if other.value.ts > self.value.ts:
                self.value = Lww(other.value.value, ts=other.value.ts)
                self.deleted = other.deleted
            elif other.value.ts == self.value.ts:
                self.value.merge(other.value)
                self.deleted = self.deleted or other.deleted

        def fields(self):
            return [self.pk, self.sk, self.value.pack(), self.deleted]

        @classmethod
        def from_fields(cls, b):
            e = cls(b[0], b[1], None, deleted=bool(b[3]))
            e.value = Lww.unpack(b[2])
            return e

    class KVSchema(TableSchema):
        TABLE_NAME = "testkv"
        ENTRY = KVEntry

        def __init__(self):
            self.updated_calls = []

        def updated(self, tx, old, new):
            self.updated_calls.append((old, new))

        def matches_filter(self, entry, filter):
            if filter is None:
                return True
            return DeletedFilter.matches(filter, entry.is_tombstone())

    return KVEntry, KVSchema


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")

    P = types.SimpleNamespace(
        name=name, System=m("rpc.system").System, layout=m("rpc.layout"),
        config_from_dict=m("utils.config").config_from_dict,
        open_db=m("db").open_db, table=m("table"), schema=m("table.schema"),
        merkle=m("table.merkle"), crdt=m("utils.crdt"), data=m("utils.data"),
        rm=m("rpc.replication_mode"))
    P.KVEntry, P.KVSchema = _kv_types(P)
    return P


REF, PORT = _pkg("garage_tpu"), _pkg("garage_tpu_torch")


def seeded_rows(n: int, salt: int, parts=("alpha", "beta", "gamma")):
    """n (pk, sk, value, ts) rows: values of several msgpack types."""
    rng = np.random.default_rng([SEED, salt])
    out = []
    for i in range(n):
        kind = i % 4
        v = (int(rng.integers(0, 1 << 40)) if kind == 0
             else rng.bytes(int(rng.integers(1, 40))).hex() if kind == 1
             else {"n": int(rng.integers(0, 99)), "s": f"v{i}"} if kind == 2
             else [int(x) for x in rng.integers(0, 255, 3)])
        out.append((parts[i % len(parts)], f"k{i:03d}", v,
                    1_000 + int(rng.integers(0, 1 << 20))))
    return out


async def make_cluster(P, root, n=3, mode="3"):
    """n Systems of package P meshed on loopback with an applied
    equal-capacity layout."""
    systems = []
    for i in range(n):
        s = P.System(P.config_from_dict({
            "metadata_dir": str(root / P.name / f"n{i}" / "meta"),
            "data_dir": str(root / P.name / f"n{i}" / "data"),
            "replication_mode": mode, "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "table-test", "bootstrap_peers": [],
            "codec": {"backend": "cpu"}}))
        await s.netapp.listen("127.0.0.1:0")
        systems.append(s)
    ports = [s.netapp._server.sockets[0].getsockname()[1] for s in systems]
    for i, a in enumerate(systems):
        for j in range(i + 1, len(systems)):
            await a.netapp.connect(f"127.0.0.1:{ports[j]}",
                                   expected_id=systems[j].id)
    lay = systems[0].layout
    for s in systems:
        lay.stage_role(bytes(s.id), P.layout.NodeRole("dc1", 1000))
    lay.apply_staged_changes()
    enc = lay.encode()
    for s in systems:
        s.layout = P.layout.ClusterLayout.decode(enc)
        s._rebuild_ring()
        assert s.ring.ready
    return systems


def make_table(P, system, mode="3", db=None):
    m = P.rm.parse_replication_mode(mode)
    repl = P.table.TableShardedReplication(
        system, m.replication_factor, m.read_quorum, m.write_quorum)
    return P.table.Table(system, P.KVSchema(), repl, db or P.open_db("memory"))


async def shutdown(systems):
    for s in systems:
        await s.netapp.shutdown()


def stored(table) -> dict:
    """Every row of a table's local store, key → encoded bytes."""
    return {bytes(k): bytes(v) for k, v in table.data.store.items(None, None)}


def merkle_nodes(table) -> dict:
    return {bytes(k): bytes(v)
            for k, v in table.data.merkle_tree.items(None, None)}


async def drain_merkle(P, tables):
    for t in tables:
        w = P.merkle.MerkleWorker(t.merkle)
        while (await w.work()).name == "BUSY":
            pass


# --- encodings ----------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_entry_encodings_decode_in_the_other_package(src, dst):
    for pk, sk, v, ts in seeded_rows(24, 1):
        for deleted in (False, True):
            raw = src.KVEntry(pk, sk, v, ts=ts, deleted=deleted).encode()
            back = dst.KVEntry.decode(raw)
            assert back.encode() == raw
            assert (back.partition_key, back.sort_key, back.value.value,
                    back.value.ts, back.is_tombstone()) == (
                        pk, sk, v, ts, deleted)
    # the stored key and the partition hash are the reference's
    for pk, sk, _v, _ts in seeded_rows(8, 2):
        assert bytes(src.schema.tree_key(pk, sk)) == bytes(
            dst.schema.tree_key(pk, sk))
        assert bytes(src.schema.hash_partition_key(pk)) == bytes(
            dst.schema.hash_partition_key(pk))


# --- quorum operations ----------------------------------------------------


async def _insert_rows(P, root, rows):
    systems = await make_cluster(P, root)
    tables = [make_table(P, s) for s in systems]
    for pk, sk, v, ts in rows:
        await tables[0].insert(P.KVEntry(pk, sk, v, ts=ts))
    got = [await tables[1].get(pk, sk) for pk, sk, _v, _ts in rows]
    await asyncio.sleep(0.2)  # the third replica's background write
    return systems, tables, got


async def test_quorum_insert_get_rows_equal_across_packages(tmp_path):
    rows = seeded_rows(30, 3)
    out = {}
    for P in (REF, PORT):
        systems, tables, got = await _insert_rows(P, tmp_path, rows)
        assert [(g.value.value, g.value.ts) for g in got] == [
            (v, ts) for _pk, _sk, v, ts in rows]
        # every node stores every row (replication 3 of 3 nodes), and the
        # updated() hook ran where it was stored
        per_node = [stored(t) for t in tables]
        assert all(len(s) == len(rows) for s in per_node)
        assert all(t.schema.updated_calls for t in tables)
        out[P.name] = per_node
        await shutdown(systems)
    for a, b in zip(out["garage_tpu"], out["garage_tpu_torch"]):
        assert a == b


async def test_crdt_merge_convergence_equal(tmp_path):
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [make_table(P, s) for s in systems]
        await tables[0].insert(P.KVEntry("p", "k", "old", ts=1000))
        await tables[1].insert(P.KVEntry("p", "k", "new", ts=2000))
        await tables[2].insert(P.KVEntry("p", "k2", "x", ts=5, deleted=True))
        await asyncio.sleep(0.1)
        out[P.name] = [stored(t) for t in tables]
        for t in tables:
            assert t.data.decode_entry(
                t.data.read_entry("p", "k")).value.value == "new"
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]


async def test_read_repair_on_divergence_equal(tmp_path):
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [make_table(P, s) for s in systems]
        e_old = P.KVEntry("p", "k", "stale", ts=1000)
        e_new = P.KVEntry("p", "k", "fresh", ts=2000)
        tables[2].data.update_entry(e_old.encode())
        tables[0].data.update_entry(e_new.encode())
        tables[1].data.update_entry(e_new.encode())
        got = await tables[2].get("p", "k")
        assert got.value.value == "fresh"
        await asyncio.sleep(0.2)  # read repair pushes the merged row
        out[P.name] = [stored(t) for t in tables]
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    assert len({tuple(sorted(s.items())) for s in out["garage_tpu"]}) == 1


async def test_get_range_filters_equal(tmp_path):
    rows = [("part", f"k{i:02d}", i, 100 + i) for i in range(12)]
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [make_table(P, s) for s in systems]
        for pk, sk, v, ts in rows:
            await tables[0].insert(P.KVEntry(pk, sk, v, ts=ts))
        await tables[0].insert(P.KVEntry("part", "k03", None, ts=10_000,
                                         deleted=True))
        DF = P.schema.DeletedFilter
        res = []
        for kw in ({"limit": 5}, {"start_sort_key": "k05", "limit": 100},
                   {"filter": DF.NOT_DELETED, "limit": 100},
                   {"filter": DF.ANY, "limit": 100},
                   {"filter": DF.DELETED, "limit": 100}):
            ents = await tables[1].get_range("part", **kw)
            res.append([e.encode() for e in ents])
        out[P.name] = res
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    keys = [[PORT.KVEntry.decode(b).sort_key for b in r]
            for r in out["garage_tpu_torch"]]
    assert keys[0] == [f"k{i:02d}" for i in range(5)]
    assert keys[1] == [f"k{i:02d}" for i in range(5, 12)]
    assert "k03" not in keys[2] and "k03" in keys[3] and keys[4] == ["k03"]


# --- Merkle ---------------------------------------------------------------


async def test_merkle_trees_bit_identical(tmp_path):
    """The same seeded items, inserted in different orders, give the same
    Merkle nodes and partition roots in both packages."""
    rows = seeded_rows(60, 4, parts=tuple(f"p{i}" for i in range(9)))
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path, n=1, mode="1")
        t1 = make_table(P, systems[0], mode="1")
        t2 = make_table(P, systems[0], mode="1")
        for pk, sk, v, ts in rows:
            t1.data.update_entry(P.KVEntry(pk, sk, v, ts=ts).encode())
        for pk, sk, v, ts in reversed(rows):
            t2.data.update_entry(P.KVEntry(pk, sk, v, ts=ts).encode())
        assert t1.data.merkle_todo_len() == len(rows)
        await drain_merkle(P, [t1, t2])
        assert merkle_nodes(t1) == merkle_nodes(t2)
        parts = sorted({t1.replication.partition_of(
            P.schema.hash_partition_key(pk)) for pk, *_ in rows})
        roots = [bytes(t1.merkle.partition_root_hash(p)) for p in parts]
        assert all(r != bytes(P.merkle.EMPTY_HASH) for r in roots)
        leaves = sum(len(t1.merkle.collect_leaves(p, b"")) for p in parts)
        assert leaves == len(rows)
        # deleting every item walks each root back to empty
        for pk, sk, _v, _ts in rows:
            k = t2.data.tree_key(pk, sk)
            t2.data.delete_if_equal(k, t2.data.store.get(k))
        await drain_merkle(P, [t2])
        assert all(bytes(t2.merkle.partition_root_hash(p)) ==
                   bytes(P.merkle.EMPTY_HASH) for p in parts)
        out[P.name] = (merkle_nodes(t1), roots)
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]


async def test_sync_converges_replicas_equal(tmp_path):
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [make_table(P, s) for s in systems]
        syncers = [P.table.TableSyncer(s, t.data, t.merkle)
                   for s, t in zip(systems, tables)]
        for i in range(20):  # on node 0 only
            tables[0].data.update_entry(
                P.KVEntry("p", f"s{i}", i, ts=100 + i).encode())
        await drain_merkle(P, tables)
        ph = P.data.blake2sum(b"p")
        part = tables[0].replication.partition_of(ph)
        await syncers[0].sync_partition(part, ph)
        await drain_merkle(P, tables)
        roots = {bytes(t.merkle.partition_root_hash(part)) for t in tables}
        assert len(roots) == 1
        out[P.name] = ([stored(t) for t in tables], roots)
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]


# --- GC, full copy, insert queue -------------------------------------------


async def test_gc_three_phase_tombstone_collection_equal(tmp_path):
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [make_table(P, s) for s in systems]
        gcs = [P.table.TableGc(s, t.data) for s, t in zip(systems, tables)]
        for g in gcs:
            g.gc_delay_ms = 0
        ph = P.data.blake2sum(b"p")
        leader = tables[0].replication.write_nodes(ph)[0]
        lt = next(t for t, s in zip(tables, systems) if s.id == leader)
        lg = next(g for g, s in zip(gcs, systems) if s.id == leader)
        await lt.insert(P.KVEntry("p", "doomed", "x", ts=1000))
        await lt.insert(P.KVEntry("p", "kept", "y", ts=1000))
        await asyncio.sleep(0.1)
        await lt.insert(P.KVEntry("p", "doomed", None, ts=2000, deleted=True))
        await asyncio.sleep(0.1)
        assert lg.data.gc_todo_len() == 1
        assert await lg.gc_loop_iter()
        for t in tables:
            assert t.data.read_entry("p", "doomed") is None
        assert lg.data.gc_todo_len() == 0
        out[P.name] = [stored(t) for t in tables]
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]
    assert all(len(s) == 1 for s in out["garage_tpu_torch"])


async def test_fullcopy_replication_local_read_equal(tmp_path):
    out = {}
    for P in (REF, PORT):
        systems = await make_cluster(P, tmp_path)
        tables = [P.table.Table(s, P.KVSchema(),
                                P.table.TableFullReplication(s, max_faults=0),
                                P.open_db("memory")) for s in systems]
        await tables[0].insert(P.KVEntry("buckets", "b1", {"cfg": 1}, ts=7))
        await asyncio.sleep(0.1)
        for t in tables:
            got = await t.get("buckets", "b1")
            assert got.value.value == {"cfg": 1}
        out[P.name] = [stored(t) for t in tables]
        await shutdown(systems)
    assert out["garage_tpu"] == out["garage_tpu_torch"]


async def test_insert_queue_survives_restart_port(tmp_path):
    """Hook-deferred inserts of the port's Garage are durable: the
    object-overwrite cascade queued in the insert queue survives a crash
    before the InsertQueueWorker ran, and drains after the restart into
    the rc decrement — the same queue the reference's run holds."""
    queued = {}
    for P in (REF, PORT):
        model = importlib.import_module(f"{P.name}.model")
        obj_mod = importlib.import_module(f"{P.name}.model.s3.object_table")
        ver_mod = importlib.import_module(f"{P.name}.model.s3.version_table")

        def mk():
            return P.config_from_dict({
                "metadata_dir": str(tmp_path / P.name / "meta"),
                "data_dir": str(tmp_path / P.name / "data"),
                "replication_mode": "none", "rpc_bind_addr": "127.0.0.1:0",
                "rpc_secret": "q", "db_engine": "sqlite",
                "bootstrap_peers": [], "codec": {"backend": "cpu"}})

        def complete_version(uuid, ts, data):
            h = obj_mod.ObjectVersionHeaders.new()
            meta = obj_mod.ObjectVersionMeta.new(h, len(data), "etag")
            return obj_mod.ObjectVersion(uuid, ts, [
                "complete", obj_mod.ObjectVersionData.inline(meta, data)])

        g = model.Garage(mk())
        await g.system.netapp.listen("127.0.0.1:0")
        lay = g.system.layout
        lay.stage_role(bytes(g.system.id), P.layout.NodeRole("dc1", 1000))
        lay.apply_staged_changes()
        g.system.layout = P.layout.ClusterLayout.decode(lay.encode())
        g.system._rebuild_ring()
        g.system.save_layout()
        bid, vu = b"\x11" * 32, b"\x22" * 32
        ver = ver_mod.Version.new(vu, bid, "qk")
        ver.add_block(0, 0, b"\xaa" * 32, 100)
        await g.version_table.insert(ver)
        await g.object_table.insert(obj_mod.Object(bid, "qk", [
            complete_version(vu, 100, b"live")]))
        await g.object_table.insert(obj_mod.Object(bid, "qk", [
            complete_version(b"\x33" * 32, 200, b"newer")]))
        queue = {t.schema.TABLE_NAME: len(t.data.insert_queue)
                 for t in g.tables if len(t.data.insert_queue)}
        assert queue, "expected hook-deferred inserts in the queue"
        await g.shutdown()

        g2 = model.Garage(mk())
        await g2.system.netapp.listen("127.0.0.1:0")
        g2.system._rebuild_ring()
        assert {t.schema.TABLE_NAME: len(t.data.insert_queue)
                for t in g2.tables if len(t.data.insert_queue)} == queue
        g2.spawn_workers()
        for _ in range(100):
            if sum(len(t.data.insert_queue) for t in g2.tables) == 0:
                break
            await asyncio.sleep(0.05)
        assert sum(len(t.data.insert_queue) for t in g2.tables) == 0
        rc = g2.block_manager.rc.get(
            importlib.import_module(f"{P.name}.utils.data").Hash(b"\xaa" * 32))
        assert not rc.is_needed()
        queued[P.name] = queue
        await g2.shutdown()
    assert queued["garage_tpu"] == queued["garage_tpu_torch"]


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
async def test_sqlite_table_read_by_the_other_package(tmp_path, src, dst):
    """Rows and Merkle nodes one package writes to a sqlite database are
    the other package's: same tree names, same keys, same bytes."""
    rows = seeded_rows(40, 5, parts=tuple(f"q{i}" for i in range(5)))
    path = str(tmp_path / "t.sqlite")
    systems = await make_cluster(src, tmp_path, n=1, mode="1")
    db = src.open_db("sqlite", path=path)
    t = make_table(src, systems[0], mode="1", db=db)
    for pk, sk, v, ts in rows:
        t.data.update_entry(src.KVEntry(pk, sk, v, ts=ts).encode())
    await drain_merkle(src, [t])
    want_rows, want_nodes = stored(t), merkle_nodes(t)
    db.close()
    await shutdown(systems)

    systems = await make_cluster(dst, tmp_path / "dst", n=1, mode="1")
    db = dst.open_db("sqlite", path=path)
    t2 = make_table(dst, systems[0], mode="1", db=db)
    assert stored(t2) == want_rows and merkle_nodes(t2) == want_nodes
    for pk, sk, v, ts in rows:
        e = t2.data.decode_entry(t2.data.read_entry(pk, sk))
        assert (e.value.value, e.value.ts) == (v, ts)
    db.close()
    await shutdown(systems)
