"""The port's fleet rebuild (garage_tpu_torch.block.rebuild) and chain
repair (block/repair_plan.py) against the reference package's, on the
fakes of tests/test_repair_plan.py and tests/test_rebuild.py:

  - chain repair: every lost row of a codeword from one k-piece fetch
    set, equal to a per-row serial decode and to the reference planner's
    output, the whole-shard decode running on the port's feeder over
    `CudaCodec(device="cpu")` (the GF kernel's plain version);
  - the scheduler heals every lost block exactly once, dedupes resync
    through `owns`, parks failures with source "rebuild", re-arms on a
    late ref, and resumes from a checkpoint — including one the
    reference's scheduler wrote (the checkpoint format is the
    reference's); the worker writes its checkpoints off the event loop;
  - a row that merely moved (a live node still holds it) is left to
    resync's copy, not decoded.
"""

import asyncio
import importlib
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_rebuild import FakeBlockStore, FakeResync  # noqa: E402
from test_repair_plan import (  # noqa: E402
    FakeManager,
    StubPlanner,
    make_codeword,
)

pytestmark = pytest.mark.asyncio

SEED = 20261021


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")

    return types.SimpleNamespace(
        name=name, rebuild=m("block.rebuild"), plan=m("block.repair_plan"),
        resync=m("block.resync"), db=m("db"), data=m("utils.data"),
        error=m("utils.error"), gf256=m("ops.gf256"),
        persister=m("utils.persister"))


REF, PORT = _pkg("garage_tpu"), _pkg("garage_tpu_torch")


# --- chain repair -----------------------------------------------------------


class PortStubPlanner(PORT.plan.RepairPlanner):
    """tests/test_repair_plan.py StubPlanner over the port's planner: the
    network replaced by a shard dictionary."""

    def __init__(self, mgr, shards, **kw):
        super().__init__(mgr, **kw)
        self.shards = shards
        self.behavior = {}
        self.fetch_log = []

    async def _maybe(self, piece):
        b = self.behavior.get(piece.hash)
        if b == "stall":
            await asyncio.sleep(30)
        if b == "fail":
            raise PORT.error.GarageError("injected piece failure")

    async def _fetch_whole(self, piece):
        self.fetch_log.append(("whole", piece.index))
        await self._maybe(piece)
        sh = self.shards[piece.hash]
        return sh, PORT.plan.RAW, len(sh)

    async def _fetch_ppr(self, piece, coeff, want):
        self.fetch_log.append(("ppr", piece.index, coeff))
        await self._maybe(piece)
        body = PORT.gf256.gf_scale_bytes(coeff, self.shards[piece.hash], want)
        return body, int(coeff), len(body)


class PortFakeManager(FakeManager):
    """The reference fake with the port's codec on the CPU behind a
    feeder, so whole-shard decodes run the GF kernel's plain version."""

    def __init__(self, k, m, **kw):
        from garage_tpu_torch.ops import make_codec
        from garage_tpu_torch.ops.feeder import CodecFeeder

        super().__init__(**kw)
        self.codec = make_codec("cuda", device="cpu", rs_data=k,
                                rs_parity=m)
        self.feeder = CodecFeeder(self.codec)
        self.geometry_cpu_decodes = 0
        self.decoded = 0
        inner = self.codec.rs_reconstruct_ragged

        def counted(items):
            self.decoded += sum(int(it[0].shape[0]) for it in items)
            return inner(items)
        self.codec.rs_reconstruct_ragged = counted


@pytest.mark.parametrize("use_ppr", [True, False], ids=["ppr", "shard"])
async def test_chain_repair_two_lost_rows_share_one_fetch_set(use_ppr):
    ent, shards, datas = make_codeword(k=2, m=2, sizes=(640, 480))
    out = {}
    for P in (REF, PORT):
        mgr = FakeManager() if P is REF else PortFakeManager(2, 2)
        cls = StubPlanner if P is REF else PortStubPlanner
        pl = cls(mgr, shards, use_ppr=use_ppr, use_tree=False)
        got = await pl.reconstruct_group(ent, [0, 1])
        assert got[0] == datas[0] and got[1] == datas[1]
        assert len(pl.fetch_log) == ent.k, pl.fetch_log
        assert mgr.counters["repaired"] == len(datas[0]) + len(datas[1])
        out[P.name] = (got, sorted(pl.fetch_log), mgr.counters)
        if P is PORT:
            # whole-shard mode: both rows from ONE feeder decode
            assert mgr.decoded == (0 if use_ppr else 1)
            assert mgr.geometry_cpu_decodes == 0
            mgr.feeder.shutdown()
    assert out["garage_tpu"] == out["garage_tpu_torch"]


@pytest.mark.parametrize("m_prime", [1, 2])
async def test_chain_outputs_match_serial_decode_and_reference(m_prime):
    targets = list(range(m_prime))
    ent, shards, datas = make_codeword(k=3, m=2, sizes=(900, 700, 500),
                                       seed=23)
    cands = [i for i in range(5) if i not in targets]
    piece_hash = {i: (ent.members[i] if i < 3
                      else ent.parity_hashes[i - 3]) for i in range(5)}
    spare = len(cands) - ent.k
    for use_ppr in (True, False):
        for fail in [None] + cands[:spare + 2]:
            res = {}
            for P in (REF, PORT):
                mgr = FakeManager() if P is REF else PortFakeManager(3, 2)
                cls = StubPlanner if P is REF else PortStubPlanner
                pl = cls(mgr, shards, use_ppr=use_ppr, use_tree=False,
                         hedge_delay=5.0)
                if fail is not None:
                    pl.behavior[piece_hash[fail]] = "fail"
                group = await pl.reconstruct_group(ent, targets)
                serial = []
                for t in targets:
                    smgr = FakeManager() if P is REF else PortFakeManager(3, 2)
                    s = cls(smgr, shards, use_ppr=use_ppr, use_tree=False,
                            hedge_delay=5.0)
                    if fail is not None:
                        s.behavior[piece_hash[fail]] = "fail"
                    for u in targets:
                        if u != t:
                            s.behavior[ent.members[u]] = "fail"
                    serial.append(await s.reconstruct(
                        P.data.Hash(ent.members[t]), ent))
                    if P is PORT:
                        smgr.feeder.shutdown()
                res[P.name] = ([group[t] for t in targets], serial)
                if P is PORT:
                    mgr.feeder.shutdown()
            assert res["garage_tpu"] == res["garage_tpu_torch"]
            recoverable = fail is None or spare >= 1
            group_rows, serial = res["garage_tpu_torch"]
            for t, g, s in zip(targets, group_rows, serial):
                assert (g == s == datas[t]) if recoverable else (
                    g is None and s is None)


# --- the scheduler ----------------------------------------------------------


class PortBlockStore(FakeBlockStore):
    """tests/test_rebuild.py FakeBlockStore with what the port's
    scheduler asks of a node: the layout's other nodes and their
    need_block answer ("present" for the rows in `held`)."""

    def __init__(self, keys, held=()):
        super().__init__(keys)
        held = {bytes(h) for h in held}
        others = [b"\x02" * 32, b"\x03" * 32]
        self.probes = []

        class _Layout:
            def all_nodes(self):
                return [bytes(self_id)] + others

        class _Rpc:
            async def call(rpc, endpoint, node, msg, **kw):
                self.probes.append((bytes(node), bytes(msg["h"])))
                return {"needed": False, "present": bytes(msg["h"]) in held}

        self_id = self.system.id
        self.system.layout = _Layout()
        self.system.rpc = _Rpc()
        self.endpoint = None
        self.block_rpc_timeout = 1.0


def fixture(P, tmp_path, n_blocks=20, partition=0x42, uncovered=(),
            held=(), name="rebuild_sched"):
    """tests/test_rebuild.py sched_fixture for package P, on seeded keys
    and data, so both packages walk the same rows."""
    rng = np.random.default_rng([SEED, partition])
    keys, datas = [], {}
    for i in range(n_blocks):
        hb = bytes([partition, i]) + rng.bytes(30)
        keys.append(hb)
        datas[hb] = rng.bytes(100 + i)
    mgr = (FakeBlockStore(keys) if P is REF
           else PortBlockStore(keys, held=[keys[i] for i in held]))
    resync = FakeResync()

    class _Ent:
        def __init__(self, hb):
            self.k, self.m = 1, 1
            self.member_index = 0
            self.members = [hb]
            self.lengths = [len(datas[hb])]
            self.parity_hashes = []

    async def lookup(h):
        if bytes(h) in {keys[i] for i in uncovered}:
            return []
        return [_Ent(bytes(h))]

    async def decode(h, ent):
        return datas[bytes(h)]

    def make(rate=1e9):
        s = P.rebuild.RebuildScheduler(
            mgr, resync, rate_mib_s=rate,
            persister=P.persister.Persister(str(tmp_path), name,
                                            P.rebuild.RebuildCheckpoint),
            governor=None, lookup=lookup, decode_fallback=decode)
        resync.rebuild = s
        return s

    return mgr, resync, keys, datas, make


def _checkpoint_bytes(tmp_path, name="rebuild_sched"):
    with open(os.path.join(str(tmp_path), name), "rb") as f:
        return f.read()


async def test_scheduler_heals_every_lost_block_once_like_reference(tmp_path):
    out = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        mgr, resync, keys, datas, make = fixture(P, d)
        s = make()
        s.node_lost([0x42], b"ring-a")
        while s._pending:
            await s.work()
        assert sorted(mgr.writes) == sorted(keys)
        assert len(mgr.writes) == len(set(mgr.writes)), "a block healed twice"
        assert mgr.heals == ["rebuild"] * len(keys)
        assert s.partitions_done == s.partitions_total == 1
        assert s.blocks_healed == len(keys) and s.paced_sleeps > 0
        assert s.bytes_healed == sum(len(x) for x in datas.values())
        assert not s.owns(keys[0])
        out[P.name] = (mgr.writes, mgr.heals, s.blocks_healed,
                       s.codewords_rebuilt, _checkpoint_bytes(d))
    assert out["garage_tpu"] == out["garage_tpu_torch"]


async def test_worker_checkpoints_are_written_off_the_event_loop(tmp_path):
    """The port's repair (ROADMAP Queue 3): the worker's checkpoint writes
    (two fsyncs each) run in a thread, so a slow disk never stalls the
    loop that every in-process node shares; the file is the reference's
    either way."""
    import threading

    mgr, resync, keys, datas, make = fixture(PORT, tmp_path)
    s = make()
    writers = []
    save = s.persister.save

    def traced(chk):
        writers.append(threading.get_ident())
        save(chk)

    s.persister.save = traced
    loop_thread = threading.get_ident()
    s.node_lost([0x42], b"ring-a")
    while s._pending:
        await s.work()
    assert writers[0] == loop_thread        # the layout change's own write
    assert len(writers) >= 2
    assert all(t != loop_thread for t in writers[1:])
    chk = s.persister.load()
    assert not chk.active and chk.partitions_done == 1


async def test_scheduler_owns_dedupes_resync(tmp_path):
    mgr, resync, keys, datas, make = fixture(PORT, tmp_path)
    s = make()
    s.node_lost([0x42], b"ring-a")
    ordered = sorted(keys)
    assert s.owns(ordered[0]) and s.owns(ordered[-1])
    assert not s.owns(b"\x43" + ordered[0][1:])
    await s.work()
    assert not s.owns(ordered[0]) and s.owns(ordered[-1])
    assert ordered[0] in mgr.writes

    class _M:
        class system:
            metrics = None

    rsm = PORT.resync.BlockResyncManager(_M(), PORT.db.open_db("memory"))
    rsm.rebuild = s
    rsm.put_to_resync(PORT.data.Hash(ordered[-1]), 0.0, source="layout_sweep")
    assert rsm.queue_len() == 1
    await rsm.resync_iter()
    assert rsm.queue_len() == 0 and rsm.rebuild_skips == 1
    assert await rsm.rebalance_hash(PORT.data.Hash(ordered[-1])) == 0
    assert rsm.rebuild_skips == 2


@pytest.mark.parametrize("first", [REF, PORT], ids=["ref-first", "port-first"])
async def test_checkpoint_resumes_across_packages(tmp_path, first):
    """One batch by a scheduler of one package, a crash, then a scheduler
    of the other package resumes from the same checkpoint file: the
    rebuild completes with every block healed exactly once."""
    second = PORT if first is REF else REF
    rng = np.random.default_rng([SEED, 7])
    keys = [bytes([0x42, i]) + rng.bytes(30) for i in range(20)]
    datas = {k: rng.bytes(100 + i) for i, k in enumerate(keys)}
    writes = []
    schedulers = []
    for P in (first, second):
        mgr = FakeBlockStore(keys) if P is REF else PortBlockStore(keys)
        mgr.present.update(writes)
        resync = FakeResync()

        class _Ent:
            def __init__(self, hb):
                self.k = self.m = 1
                self.member_index = 0
                self.members = [hb]
                self.lengths = [len(datas[hb])]
                self.parity_hashes = []

        async def lookup(h):
            return [_Ent(bytes(h))]

        async def decode(h, ent):
            return datas[bytes(h)]

        s = P.rebuild.RebuildScheduler(
            mgr, resync, rate_mib_s=1e9,
            persister=P.persister.Persister(str(tmp_path), "rebuild_sched",
                                            P.rebuild.RebuildCheckpoint),
            lookup=lookup, decode_fallback=decode)
        resync.rebuild = s
        schedulers.append((s, mgr))
        if P is first:
            s.node_lost([0x42, 0x99], b"ring-a")
            await s.work()  # one batch, then the coordinator "crashes"
            s._checkpoint(force=True)
            assert 0 < len(mgr.writes) < len(keys)
        else:
            assert s.maybe_resume(b"ring-a")
            assert s.partitions_total == 2
            while s._pending:
                await s.work()
            assert s.partitions_done == 2
        writes.extend(mgr.writes)
    assert sorted(writes) == sorted(keys)
    assert len(writes) == len(set(writes)), "resume re-healed a block"


async def test_scheduler_parks_failures_with_rebuild_source(tmp_path):
    out = {}
    for P in (REF, PORT):
        d = tmp_path / P.name
        d.mkdir()
        mgr, resync, keys, datas, make = fixture(P, d, uncovered=(0, 5))
        s = make()
        s.node_lost([0x42], b"ring-a")
        while s._pending:
            await s.work()
        uncovered = {keys[0], keys[5]}
        assert {hb for hb, _ in resync.parked} == uncovered
        assert all(src == "rebuild" for _, src in resync.parked)
        assert sorted(mgr.writes) == sorted(set(keys) - uncovered)
        assert not any(s.owns(hb) for hb, _ in resync.parked)
        out[P.name] = (sorted(resync.parked), sorted(mgr.writes))
    assert out["garage_tpu"] == out["garage_tpu_torch"]


async def test_late_ref_rearms_and_rewalks(tmp_path):
    mgr, resync, keys, datas, make = fixture(PORT, tmp_path)
    s = make()
    s.node_lost([0x42], b"ring-a")
    await s.work()  # one batch: the cursor is inside the partition
    behind = bytes([0x42]) + b"\x00" * 31  # sorts before every key
    datas[behind] = b"b" * 77
    mgr.rc.tree.keys = sorted(mgr.rc.tree.keys + [behind])
    assert bytes(behind) <= s._cursor
    assert s.note_ref(PORT.data.Hash(behind))
    while s._pending:
        await s.work()
    assert behind in mgr.writes and s.idle() and s.rearms == 1
    late = bytes([0x42]) + b"\xfe" + b"\x11" * 30
    datas[late] = b"l" * 321
    mgr.rc.tree.keys = sorted(mgr.rc.tree.keys + [late])
    assert s.note_ref(PORT.data.Hash(late)) and not s.idle()
    while s._pending:
        await s.work()
    assert late in mgr.writes and s.rearms == 2
    assert len(mgr.writes) == len(set(mgr.writes))
    assert not s.note_ref(PORT.data.Hash(b"\x43" + b"\x00" * 31))
    s._rearm_until = 0.0
    assert not s.note_ref(PORT.data.Hash(late))


async def test_moved_rows_are_left_to_resync_not_decoded(tmp_path):
    """Rows a live node still holds (they moved between two survivors)
    are parked for resync's copy; only rows no node holds are decoded."""
    mgr, resync, keys, datas, make = fixture(PORT, tmp_path,
                                             held=(1, 4, 9))
    s = make()
    s.node_lost([0x42], b"ring-a")
    while s._pending:
        await s.work()
    moved = {keys[1], keys[4], keys[9]}
    assert {hb for hb, _ in resync.parked} == moved
    assert all(src == "rebuild" for _, src in resync.parked)
    assert sorted(mgr.writes) == sorted(set(keys) - moved)
    assert s.moved_rows == len(moved)
    assert s.blocks_healed == mgr.blocks_reconstructed == len(keys) - 3
    # the probe asked the layout's other nodes, never this one
    assert {n for n, _ in mgr.probes} == {b"\x02" * 32, b"\x03" * 32}
