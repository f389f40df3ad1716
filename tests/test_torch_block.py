"""The port's block store node (garage_tpu_torch: System, BlockManager,
ScrubWorker, resync, ParityStore) against the reference package's on the
same seeded blocks and corruptions, on loopback clusters.

The port's nodes run the CUDA codec's plain PyTorch versions
(``make_codec("cuda" | "hybrid", device="cpu")``), the reference's its
CPU codec.  Only bits and counts are compared, never timings: the hybrid
codec's split between its CPU floor and its device side depends on
timing.  The plain BLAKE2s costs ~4 ms per 64-byte chunk on the CPU and
each scrub dispatch hashes its longest block whole, so the blocks here
are 0.2-2.5 KiB.
"""

import asyncio
import importlib
import os
import types

import numpy as np
import pytest

from garage_tpu.utils.data import blake2s_sum

pytestmark = pytest.mark.asyncio

SEED = 20261018


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")

    return types.SimpleNamespace(
        name=name, System=m("rpc.system").System, layout=m("rpc.layout"),
        config_from_dict=m("utils.config").config_from_dict,
        open_db=m("db").open_db,
        Repl=m("table").TableShardedReplication,
        BlockManager=m("block").BlockManager,
        BlockResyncManager=m("block").BlockResyncManager,
        ResyncPersistedConfig=m("block.resync").ResyncPersistedConfig,
        ResyncWorker=m("block.resync").ResyncWorker,
        ScrubWorker=m("block.repair").ScrubWorker,
        ScrubWorkerState=m("block.repair").ScrubWorkerState,
        ParityStore=m("block.parity").ParityStore,
        DataBlock=m("block.block").DataBlock,
        Persister=m("utils.persister").Persister,
        Hash=m("utils.data").Hash, make_codec=m("ops").make_codec)


REF, PORT = _pkg("garage_tpu"), _pkg("garage_tpu_torch")


def _codec(P, kind: str, k: int = 8, m: int = 4, **params):
    """A codec factory: the reference runs its CPU codec; the port its
    cuda or hybrid codec on the kernels' plain versions, or its CPU one."""
    kw = {"rs_data": k, "rs_parity": m, **params}
    if P is REF or kind == "cpu":
        return lambda: P.make_codec("cpu", **kw)
    return lambda: P.make_codec(kind, device="cpu", **kw)


async def make_nodes(P, root, codecs, mode="3", engine="memory"):
    """len(codecs) Systems of package P meshed on loopback with an
    applied layout, each with a BlockManager over its codec and a resync
    manager with a persisted config, as the daemon wires them."""
    systems = []
    for i in range(len(codecs)):
        cfg = P.config_from_dict({
            "metadata_dir": str(root / f"n{i}" / "meta"),
            "data_dir": str(root / f"n{i}" / "data"),
            "replication_mode": mode, "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "block-test", "bootstrap_peers": [],
            "db_engine": engine, "codec": {"backend": "cpu"}})
        s = P.System(cfg)
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
    nodes = []
    for s, make in zip(systems, codecs):
        s.layout = P.layout.ClusterLayout.decode(enc)
        s._rebuild_ring()
        cfg, rm = s.config, s.replication_mode
        db = P.open_db(engine, path=(os.path.join(cfg.metadata_dir, "db.sqlite")
                                     if engine == "sqlite" else None))
        mgr = P.BlockManager(cfg, db, s, P.Repl(
            s, rm.replication_factor, 1, rm.write_quorum), codec=make())
        mgr.resync = P.BlockResyncManager(mgr, db, persister=P.Persister(
            cfg.metadata_dir, "resync_cfg", P.ResyncPersistedConfig))
        nodes.append(mgr)
    return nodes


async def close_nodes(nodes):
    for m in nodes:
        if m.feeder is not None:
            m.feeder.shutdown()
        close = getattr(m.codec, "close", None)
        if close is not None:
            close()
        await m.system.netapp.shutdown()
        m.db.close()


def _blocks(n: int, lo: int, hi: int, salt: int):
    """n seeded blocks of lo..hi bytes; every fourth a repeated pattern
    that compression_level 1 stores compressed."""
    rng = np.random.default_rng([SEED, salt])
    out = []
    for i in range(n):
        size = int(rng.integers(lo, hi))
        out.append((rng.bytes(64) * (size // 64 + 1))[:size] if i % 4 == 3
                   else rng.bytes(size))
    return out


def _flip(path: str, off: int) -> None:
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


async def _scrub_pass(worker):
    worker.send_command("start")
    while (await worker.work()).name in ("BUSY", "THROTTLED"):
        pass
    return worker.state.corruptions


async def _drain_resync(P, mgr):
    w = P.ResyncWorker(mgr.resync)
    for _ in range(500):
        if not mgr.resync.queue_len():
            return
        if (await w.work()).name == "IDLE":
            await asyncio.sleep(0.01)
    raise AssertionError(f"resync queue stuck at {mgr.resync.queue_len()}")


# --- scrub, quarantine, resync ---------------------------------------------

async def _scrub_resync_run(P, root, kinds):
    blocks = _blocks(8, 800, 2000, 1)
    nodes = await make_nodes(P, root, [_codec(P, k) for k in kinds])
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await nodes[0].rpc_put_block(h, b)
    for _ in range(200):
        if all(m.is_block_present(h) for m in nodes for h in hashes):
            break
        await asyncio.sleep(0.02)
    for m in nodes:
        m.db.transaction(lambda tx, m=m: [m.rc.block_incref(tx, h)
                                          for h in hashes])
    # seeded corruptions, in plain (uncompressed) copies
    rng = np.random.default_rng([SEED, 2])
    planted = {0: [0, 5], 1: [1, 2, 6]}
    paths = {}
    for ni, idx in planted.items():
        for i in idx:
            path, compressed = nodes[ni].find_block(hashes[i])
            assert not compressed
            paths[ni, i] = path
            _flip(path, int(rng.integers(0, len(blocks[i]))))
    out = {"first": {}, "quarantined": {}, "queued": {}, "second": {}}
    for ni in planted:
        w = P.ScrubWorker(nodes[ni])
        w.set_tranquility(0)
        out["first"][ni] = await _scrub_pass(w)
        out["quarantined"][ni] = sorted(
            i for i in range(len(blocks))
            if os.path.exists(f"{paths.get((ni, i), '-')}.corrupted")
            and not nodes[ni].is_block_present(hashes[i]))
        out["queued"][ni] = nodes[ni].resync.queue_len()
        await _drain_resync(P, nodes[ni])
        for i in planted[ni]:
            got = await nodes[ni].read_block(hashes[i])
            assert got.decompressed() == blocks[i]
        out["second"][ni] = await _scrub_pass(w)
    await close_nodes(nodes)
    return out


async def test_scrub_quarantine_resync_matches_reference(tmp_path):
    ref = await _scrub_resync_run(REF, tmp_path / "ref", ["cpu"] * 3)
    port = await _scrub_resync_run(PORT, tmp_path / "port",
                                   ["cuda", "hybrid", "cpu"])
    assert port == ref
    assert ref["first"] == {0: 2, 1: 3} and ref["second"] == {0: 0, 1: 0}
    assert ref["quarantined"] == {0: [0, 5], 1: [1, 2, 6]}


# --- parity sidecars and local reconstruction --------------------------------

async def _sidecar_run(P, root, k, m):
    blocks = _blocks(2 * k, 300, 1200, 3 + k)
    (node,) = await make_nodes(P, root, [_codec(P, "cuda", k, m)], mode="1")
    node.blocks_reconstructed = 0
    node.parity_store = P.ParityStore(node, P.open_db("memory"), node.codec)
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await node.write_block(h, P.DataBlock.from_buffer(b, 1))
    w = P.ScrubWorker(node)
    w.set_tranquility(0)
    first = await _scrub_pass(w)
    files = {}
    for base in node.parity_store.all_dirs:
        for dirpath, _d, names in os.walk(base):
            for name in names:
                with open(os.path.join(dirpath, name), "rb") as f:
                    files[os.path.relpath(os.path.join(dirpath, name),
                                          base)] = f.read()
    victim = 2
    path, compressed = node.find_block(hashes[victim])
    assert not compressed
    _flip(path, len(blocks[victim]) // 3)
    second = await _scrub_pass(w)
    rebuilt = (await node.read_block(hashes[victim])).decompressed()
    out = {"first": first, "second": second, "files": files,
           "indexed": node.parity_store.stats()["indexed_blocks"],
           "reconstructed": node.blocks_reconstructed,
           "queued": node.resync.queue_len(), "rebuilt": rebuilt,
           "want": blocks[victim]}
    await close_nodes([node])
    return out


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4)])
async def test_sidecar_parity_matches_reference(tmp_path, k, m):
    ref = await _sidecar_run(REF, tmp_path / "ref", k, m)
    port = await _sidecar_run(PORT, tmp_path / "port", k, m)
    assert port == ref
    assert len(ref["files"]) == 2 and ref["indexed"] == 2 * k
    assert (ref["first"], ref["second"], ref["reconstructed"],
            ref["queued"]) == (0, 1, 1, 0)
    assert ref["rebuilt"] == ref["want"]


async def test_rotted_block_found_on_a_warm_pool_pass(tmp_path):
    """A block whose device-pool page is resident from the last pass and
    whose file rots since: the next pass must hash the file, not the
    page.  The port's hybrid codec arms a pool; the reference's CPU codec
    has none and reads the file."""
    runs = {}
    for P, kind in ((REF, "cpu"), (PORT, "hybrid")):
        blocks = _blocks(6, 300, 900, 5)
        (node,) = await make_nodes(P, tmp_path / P.name, [_codec(P, kind)],
                                   mode="1")
        hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
        for h, b in zip(hashes, blocks):
            await node.write_block(h, P.DataBlock.plain(b))
        w = P.ScrubWorker(node)
        w.set_tranquility(0)
        first = await _scrub_pass(w)
        pool = getattr(node.codec, "pool", None)
        resident = (pool.stats()["resident_blocks"] if pool is not None
                    else None)
        _flip(node.find_block(hashes[4])[0], 7)
        second = await _scrub_pass(w)
        runs[P.name] = (first, second, node.is_block_present(hashes[4]))
        if P is PORT:
            assert resident == len(blocks)  # the pass left every page warm
        await close_nodes([node])
    assert runs["garage_tpu_torch"] == runs["garage_tpu"] == (0, 1, False)


# --- scrub windows: successive prefixes in one dispatch ----------------------

def _dispatches(node) -> int:
    return node.feeder.stats()["dispatches"]


async def _window_run(P, root, batch_blocks):
    blocks = _blocks(40, 300, 900, 7)
    nodes = await make_nodes(P, root, [
        _codec(P, kind, batch_blocks=batch_blocks)
        for kind in ("hybrid", "cuda", "cpu")])
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await nodes[0].rpc_put_block(h, b)
    for _ in range(200):
        if all(m.is_block_present(h) for m in nodes for h in hashes):
            break
        await asyncio.sleep(0.02)
    for m in nodes:
        m.db.transaction(lambda tx, m=m: [m.rc.block_incref(tx, h)
                                          for h in hashes])
    node = nodes[0]
    path, compressed = node.find_block(hashes[5])
    assert not compressed
    _flip(path, len(blocks[5]) // 2)
    w = P.ScrubWorker(node)
    w.set_tranquility(0)
    d0 = _dispatches(node)
    first = await _scrub_pass(w)
    d1 = _dispatches(node)
    quarantined = sorted(i for i, h in enumerate(hashes)
                         if not node.is_block_present(h))
    await _drain_resync(P, node)
    second = await _scrub_pass(w)
    d2 = _dispatches(node)
    data = str(root / "n0" / "data")
    files = sorted(os.path.relpath(os.path.join(d, n), data)
                   for d, _s, names in os.walk(data) for n in names)
    healed = [(await node.read_block(h)).decompressed() == b
              for h, b in zip(hashes, blocks)]
    await close_nodes(nodes)
    out = {"first": first, "quarantined": quarantined, "second": second,
           "files": files, "healed": healed}
    return out, (d1 - d0, d2 - d1), len({bytes(h)[:2] for h in hashes})


@pytest.mark.parametrize("batch_blocks", [8, 64])
async def test_scrub_windows_span_prefixes(tmp_path, batch_blocks):
    """40 blocks over about as many prefixes: the port's scrub sends a
    window of at least ``batch_blocks`` blocks per dispatch, never split
    inside a prefix, and finds, sets aside and heals what the
    reference's one-prefix batches do."""
    ref, _d, _n = await _window_run(REF, tmp_path / "ref", batch_blocks)
    port, per_pass, prefixes = await _window_run(
        PORT, tmp_path / "port", batch_blocks)
    assert port == ref
    assert (ref["first"], ref["quarantined"], ref["second"]) == (1, [5], 0)
    assert all(ref["healed"])
    assert prefixes >= 3 * 8
    if batch_blocks >= 40:
        assert per_pass == (1, 1)
    else:
        assert all(1 < d <= -(-40 // batch_blocks) + 1 for d in per_pass)


async def _emptied_run(P, root):
    blocks = _blocks(12, 200, 400, 8)
    (node,) = await make_nodes(P, root, [_codec(P, "cuda", batch_blocks=4)],
                               mode="1")
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await node.write_block(h, P.DataBlock.plain(b))
    # the files of all blocks after the first window go, their prefix
    # dirs stay: the second window lists prefixes and no block
    for h in sorted(hashes, key=bytes)[4:]:
        os.remove(node.find_block(h)[0])
    w = P.ScrubWorker(node)
    w.set_tranquility(0)
    found = await _scrub_pass(w)
    out = (found, w.iterator is None, w.state.time_last_complete > 0)
    await close_nodes([node])
    return out


async def test_scrub_windows_over_emptied_prefix_dirs(tmp_path):
    """A window can end the pass holding prefix dirs and no block."""
    ref = await _emptied_run(REF, tmp_path / "ref")
    port = await _emptied_run(PORT, tmp_path / "port")
    assert port == ref == (0, True, True)


async def _shifted_row_run(P, root, k, m):
    blocks = _blocks(20, 300, 900, 9)
    (node,) = await make_nodes(P, root, [_codec(P, "cuda", k, m,
                                                batch_blocks=8)], mode="1")
    node.blocks_reconstructed = 0
    node.parity_store = P.ParityStore(node, P.open_db("memory"), node.codec)
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await node.write_block(h, P.DataBlock.from_buffer(b, 1))
    assert len({bytes(h)[:2] for h in hashes}) == len(hashes)
    # one block per prefix: a one-prefix batch holds the carry and one
    # block, so a plain block that does not complete its row sits in
    # the batch's trailing partial row
    order = sorted(range(len(blocks)), key=lambda i: bytes(hashes[i]))
    victim = next(i for pos, i in enumerate(order)
                  if 0 < pos < len(order) - k and pos % k != k - 1
                  and not node.find_block(hashes[i])[1])
    w = P.ScrubWorker(node)
    w.set_tranquility(0)
    encodes = []
    if P is PORT:
        encode = w._encode

        async def counted(bs):
            encodes.append(len(bs))
            return await encode(bs)
        w._encode = counted
    first = await _scrub_pass(w)
    _flip(node.find_block(hashes[victim])[0], len(blocks[victim]) // 3)
    second = await _scrub_pass(w)
    files = {}
    for base in node.parity_store.all_dirs:
        for dirpath, _d, names in os.walk(base):
            for name in names:
                with open(os.path.join(dirpath, name), "rb") as f:
                    files[os.path.relpath(os.path.join(dirpath, name),
                                          base)] = f.read()
    out = {"first": first, "second": second, "files": files,
           "index": sorted(node.parity_store.index.items(None, None)),
           "reconstructed": node.blocks_reconstructed,
           "rebuilt": (await node.read_block(hashes[victim])).decompressed()
           == blocks[victim]}
    await close_nodes([node])
    return out, encodes


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2)])
async def test_sidecars_after_a_block_fails_in_a_trailing_row(tmp_path, k, m):
    """A block that fails where a one-prefix batch would have held it in
    its trailing partial row drops out of the parity carry, and every
    later codeword shifts against the window's rows: the port computes
    those rows' parity again, and its sidecars and parity index equal
    the reference's byte for byte."""
    ref, _e = await _shifted_row_run(REF, tmp_path / "ref", k, m)
    port, encodes = await _shifted_row_run(PORT, tmp_path / "port", k, m)
    assert port == ref
    assert (ref["first"], ref["second"], ref["reconstructed"],
            ref["rebuilt"]) == (0, 1, 1, True)
    assert encodes and all(n % k == 0 for n in encodes)


# --- scrub checkpoint and resume ---------------------------------------------

async def _checkpoint_run(P, root):
    blocks = _blocks(12, 100, 300, 6)
    (node,) = await make_nodes(P, root, [_codec(P, "cuda")], mode="1")
    for b in blocks:
        await node.write_block(P.Hash(bytes(blake2s_sum(b))),
                               P.DataBlock.plain(b))
    pers = P.Persister(str(root / "meta"), "scrub_info", P.ScrubWorkerState)
    w = P.ScrubWorker(node, persister=pers)
    w.send_command("start")
    await w.work()
    w._checkpoint(force=True)
    mid = (w.state.position, w.state.running, w.iterator.position)
    w._drop_read_ahead()
    w2 = P.ScrubWorker(node, persister=pers)
    resumed = (w2.state.running, w2.iterator.position)
    while (await w2.work()).name in ("BUSY", "THROTTLED"):
        pass
    w3 = P.ScrubWorker(node, persister=pers)
    end = (w2.state.running, w2.state.corruptions,
           w3.state.running, w3.iterator is None,
           w3.state.time_last_complete > 0)
    await close_nodes([node])
    return mid, resumed, end


async def test_scrub_checkpoint_resume_matches_reference(tmp_path):
    ref = await _checkpoint_run(REF, tmp_path / "ref")
    port = await _checkpoint_run(PORT, tmp_path / "port")
    # block hashes are content hashes: the same blocks give the same
    # prefixes, so the same positions
    assert port == ref
    (pos, running, it_pos), (r2, pos2), _ = ref
    assert running and pos > 0 and it_pos >= pos and r2 and pos2 == pos


# --- a node's on-disk state, carried across the two packages -----------------

async def _write_node(P, root, blocks):
    (node,) = await make_nodes(P, root, [_codec(P, "cuda")], mode="1",
                               engine="sqlite")
    node.parity_store = P.ParityStore(node, node.db, node.codec)
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    for h, b in zip(hashes, blocks):
        await node.write_block(h, P.DataBlock.from_buffer(b, 1))
    node.db.transaction(lambda tx: [node.rc.block_incref(tx, h)
                                    for h in hashes])
    node.db.transaction(lambda tx: node.rc.block_incref(tx, hashes[0]))
    node.resync.set_n_workers(2)
    w = P.ScrubWorker(node, persister=P.Persister(
        node.config.metadata_dir, "scrub_info", P.ScrubWorkerState))
    w.set_tranquility(0)
    await _scrub_pass(w)
    state = {
        "id": bytes(node.system.id),
        "layout": node.data_layout.encode(),
        "rc": [node.rc.tree.get(bytes(h)) for h in hashes],
        "scrub": w.state.fields(),
        "parity_index": sorted(node.parity_store.index.items(None, None)),
        "compressed": [node.find_block(h)[1] for h in hashes],
    }
    await close_nodes([node])
    return state


async def _read_node(P, root, blocks):
    (node,) = await make_nodes(P, root, [_codec(P, "cuda")], mode="1",
                               engine="sqlite")
    node.parity_store = P.ParityStore(node, node.db, node.codec)
    hashes = [P.Hash(bytes(blake2s_sum(b))) for b in blocks]
    w = P.ScrubWorker(node, persister=P.Persister(
        node.config.metadata_dir, "scrub_info", P.ScrubWorkerState))
    state = {
        "id": bytes(node.system.id),
        "layout": node.data_layout.encode(),
        "rc": [node.rc.tree.get(bytes(h)) for h in hashes],
        "scrub": w.state.fields(),
        "parity_index": sorted(node.parity_store.index.items(None, None)),
        "compressed": [node.find_block(h)[1] for h in hashes],
    }
    got = [(await node.read_block(h)).decompressed() for h in hashes]
    assert got == blocks
    assert node.resync.n_workers == 2
    # a lost block comes back from the other package's sidecar
    os.remove(node.find_block(hashes[1])[0])
    assert node.parity_store.try_reconstruct(hashes[1]) == blocks[1]
    await close_nodes([node])
    return state


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
async def test_node_state_carried_across(tmp_path, writer, reader):
    blocks = _blocks(8, 300, 900, 7)
    wrote = await _write_node(writer, tmp_path, blocks)
    read = await _read_node(reader, tmp_path, blocks)
    assert read == wrote
    assert any(wrote["compressed"]) and len(wrote["parity_index"]) == 8
