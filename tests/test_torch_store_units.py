"""The block store node's host modules in the port (garage_tpu_torch:
utils/, db/, rpc/, block/) against the reference package (garage_tpu) on
the same numpy-seeded inputs.  Every comparison is exact: these modules
move bytes and make placement decisions, so the port must write the
same bytes and make the same decisions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import garage_tpu.block.block as r_block
import garage_tpu.block.layout as r_dlayout
import garage_tpu.block.repair as r_repair
import garage_tpu.block.resync as r_resync
import garage_tpu.db as r_db
import garage_tpu.rpc.layout as r_layout
import garage_tpu.rpc.ring as r_ring
import garage_tpu.utils.config as r_config
import garage_tpu.utils.crdt as r_crdt
import garage_tpu.utils.error as r_error
import garage_tpu.utils.migrate as r_migrate
import garage_tpu.utils.persister as r_persister
import garage_tpu_torch.block.block as p_block
import garage_tpu_torch.block.layout as p_dlayout
import garage_tpu_torch.block.repair as p_repair
import garage_tpu_torch.block.resync as p_resync
import garage_tpu_torch.db as p_db
import garage_tpu_torch.rpc.layout as p_layout
import garage_tpu_torch.rpc.ring as p_ring
import garage_tpu_torch.utils.config as p_config
import garage_tpu_torch.utils.crdt as p_crdt
import garage_tpu_torch.utils.error as p_error
import garage_tpu_torch.utils.migrate as p_migrate
import garage_tpu_torch.utils.persister as p_persister
from garage_tpu.utils.data import blake2s_sum

SEED = 20261017


def _rng(*salt):
    return np.random.default_rng([SEED, *salt])


# --- DataBlock ---------------------------------------------------------------

def _block_input(kind: str) -> bytes:
    rng = _rng(1, len(kind))
    if kind == "random":
        return rng.bytes(40_000)
    if kind == "compressible":
        return rng.bytes(512) * 80 + rng.bytes(37)
    if kind == "short":
        return rng.bytes(3)
    return b""


@pytest.mark.parametrize("kind", ["random", "compressible", "short", "empty"])
def test_datablock_matches_reference(kind):
    data = _block_input(kind)
    h = blake2s_sum(data)
    ref = r_block.DataBlock.from_buffer(data, 1)
    port = p_block.DataBlock.from_buffer(data, 1)
    assert (port.inner, port.compressed) == (ref.inner, ref.compressed)
    assert port.header().pack() == ref.header().pack()
    assert port.decompressed() == ref.decompressed() == data
    ref.verify(h)
    port.verify(h)
    if not data:
        return
    bad = bytearray(port.inner)
    bad[len(bad) // 2] ^= 0x5A
    with pytest.raises(r_error.CorruptData):
        r_block.DataBlock(bytes(bad), ref.compressed).verify(h)
    with pytest.raises(p_error.CorruptData):
        p_block.DataBlock(bytes(bad), port.compressed).verify(h)


# --- DataLayout (multi-drive partition assignment) ---------------------------

@pytest.mark.parametrize("ndirs", [1, 2, 4])
def test_data_layout_matches_reference(tmp_path, ndirs):
    rng = _rng(2, ndirs)
    caps = [int(c) for c in rng.integers(1, 1000, ndirs)]
    dirs = [{"path": str(tmp_path / f"d{i}"), "capacity": c}
            for i, c in enumerate(caps)]
    ref = r_dlayout.DataLayout.initialize(dirs)
    port = p_dlayout.DataLayout.initialize(dirs)
    assert port.encode() == ref.encode()
    assert port.part_prim == ref.part_prim
    moved = [{**d, "capacity": int(c)}
             for d, c in zip(dirs, rng.integers(1, 1000, ndirs))]
    moved.append({"path": str(tmp_path / "new"), "capacity": 500})
    ref2, port2 = ref.update(moved), port.update(moved)
    assert port2.encode() == ref2.encode()
    assert (port2.part_prim, port2.part_sec) == (ref2.part_prim, ref2.part_sec)
    assert p_dlayout.DataLayout.decode(ref2.encode()).encode() == ref2.encode()


# --- ClusterLayout and Ring --------------------------------------------------

def _layouts(monkeypatch, nnodes: int):
    """The same staged roles (2 zones, seeded ids and capacities) applied
    by both packages under one fixed clock (the LWW timestamps are part
    of the encoding)."""
    clock = [1_700_000_000_000]

    def now():
        clock[0] += 1
        return clock[0]

    rng = _rng(3, nnodes)
    ids = [rng.bytes(32) for _ in range(nnodes)]
    caps = [int(c) for c in rng.integers(100, 2000, nnodes)]
    out = []
    for crdt, layout in ((r_crdt, r_layout), (p_crdt, p_layout)):
        clock[0] = 1_700_000_000_000
        monkeypatch.setattr(crdt, "now_msec", now)
        lay = layout.ClusterLayout(replication_factor=3)
        for i, (nid, cap) in enumerate(zip(ids, caps)):
            lay.stage_role(nid, layout.NodeRole(f"dc{i % 2}", cap))
        msgs = lay.apply_staged_changes()
        out.append((lay, msgs))
    return out


@pytest.mark.parametrize("nnodes", [3, 5])
def test_cluster_layout_matches_reference(monkeypatch, nnodes):
    (ref, ref_msgs), (port, port_msgs) = _layouts(monkeypatch, nnodes)
    assert port.encode() == ref.encode()
    assert port_msgs == ref_msgs
    assert port.ring_assignment_data == ref.ring_assignment_data
    assert (p_layout.ClusterLayout.decode(ref.encode()).encode()
            == ref.encode())


@pytest.mark.parametrize("nnodes", [3, 5])
def test_ring_matches_reference(monkeypatch, nnodes):
    (ref, _), (port, _) = _layouts(monkeypatch, nnodes)
    r, p = r_ring.Ring(ref), p_ring.Ring(port)
    assert r.ready and p.ready
    for part in range(p_ring.N_PARTITIONS):
        assert ([bytes(x) for x in p.partition_nodes(part)]
                == [bytes(x) for x in r.partition_nodes(part)])


# --- migrate.pack and Persister files ----------------------------------------

def _persisted(mods, which: str):
    repair, resync, dlayout = mods
    if which == "scrub":
        return repair.ScrubWorkerState(position=4242, running=True,
                                       tranquility=0, corruptions=3,
                                       time_next_run=17, time_last_start=5)
    if which == "resync":
        return resync.ResyncPersistedConfig(n_workers=3, tranquility=7)
    return dlayout.DataLayout.initialize(
        [{"path": "/data/a", "capacity": 300},
         {"path": "/data/b", "capacity": 100}])


@pytest.mark.parametrize("which", ["scrub", "resync", "data_layout"])
def test_persister_files_match_reference(tmp_path, which):
    ref = _persisted((r_repair, r_resync, r_dlayout), which)
    port = _persisted((p_repair, p_resync, p_dlayout), which)
    assert p_migrate.pack(port.fields()) == r_migrate.pack(ref.fields())
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    r_persister.Persister(str(tmp_path / "r"), which, type(ref)).save(ref)
    p_persister.Persister(str(tmp_path / "p"), which, type(port)).save(port)
    raw = (tmp_path / "r" / which).read_bytes()
    assert (tmp_path / "p" / which).read_bytes() == raw
    # each package loads the other's file
    back = p_persister.Persister(str(tmp_path / "r"), which,
                                 type(port)).load()
    assert back.encode() == port.encode()
    back = r_persister.Persister(str(tmp_path / "p"), which,
                                 type(ref)).load()
    assert back.encode() == ref.encode()


# --- db adapters -------------------------------------------------------------

def _db_ops(n: int = 200):
    rng = _rng(4)
    keys = [rng.bytes(int(k)) for k in rng.integers(1, 12, 60)]
    ops = []
    for _ in range(n):
        r = rng.random()
        k = keys[int(rng.integers(0, len(keys)))]
        t = "a" if rng.random() < 0.7 else "b"
        if r < 0.6:
            ops.append(("insert", t, k, rng.bytes(int(rng.integers(0, 40)))))
        elif r < 0.85:
            ops.append(("remove", t, k, None))
        else:
            ops.append(("tx", t, k, rng.bytes(8)))
    return ops


def _run_db(db, ops):
    trees = {"a": db.open_tree("a"), "b": db.open_tree("b")}
    got = []
    for op, t, k, v in ops:
        tree = trees[t]
        if op == "insert":
            got.append(tree.insert(k, v))
        elif op == "remove":
            got.append(tree.remove(k))
        else:
            # one transaction: read, write twice, keep the second
            def fn(tx, tree=tree, k=k, v=v):
                old = tx.get(tree, k)
                tx.insert(tree, k, v)
                tx.insert(tree, k + b"\x00", (old or b"") + v)
                return old
            got.append(db.transaction(fn))
    state = {name: list(tree.items(None, None)) for name, tree in trees.items()}
    state["a_rev"] = list(trees["a"].items_rev(None, None))
    return [None if g is None else bytes(g) for g in got], state, \
        {n: len(tr) for n, tr in trees.items()}


@pytest.mark.parametrize("engine", ["memory", "sqlite"])
def test_db_adapters_match_reference(tmp_path, engine):
    ops = _db_ops()
    runs = []
    for name, db_mod in (("r", r_db), ("p", p_db)):
        path = str(tmp_path / f"{name}.db") if engine == "sqlite" else None
        db = db_mod.open_db(engine, path=path)
        runs.append(_run_db(db, ops))
        db.close()
    assert runs[1] == runs[0]
    # and both engines of the port end in the same iteration
    other = "memory" if engine == "sqlite" else "sqlite"
    path = str(tmp_path / "o.db") if other == "sqlite" else None
    db = p_db.open_db(other, path=path)
    assert _run_db(db, ops)[1:] == runs[0][1:]
    db.close()


def test_native_db_engine_not_ported(tmp_path):
    """The `native` engine is ported now (tests/test_torch_logdb.py
    holds it to the reference's): both names open it, it ends the shared
    sequence as the other engines do, and it still needs a path."""
    from garage_tpu_torch.db.native_adapter import NativeDb

    ops = _db_ops()
    for name in ("native", "logdb"):
        db = p_db.open_db(name, path=str(tmp_path / f"{name}.logdb"))
        assert isinstance(db.backend, NativeDb)
        got = _run_db(db, ops)
        db.close()
    db = p_db.open_db("sqlite", path=str(tmp_path / "o.db"))
    assert _run_db(db, ops) == got
    db.close()
    with pytest.raises(p_error.DbError, match="requires a path"):
        p_db.open_db("native")


# --- config -------------------------------------------------------------------

TOML = """
metadata_dir = "/tmp/meta"
data_dir = "/tmp/data"
block_size = "1M"
replication_mode = "2"
rpc_bind_addr = "127.0.0.1:3901"
bootstrap_peers = []

[s3_api]
api_bind_addr = "127.0.0.1:3900"
s3_region = "test"

[codec]
backend = "cpu"
rs_data = 4
rs_parity = 2
"""


def _cluster_dict(i: int, mode: str) -> dict:
    """tests/test_table.py's node config; its backend made explicit (the
    suite's conftest injects "cpu" into the reference's dicts)."""
    return {"metadata_dir": f"/tmp/n{i}/meta", "data_dir": f"/tmp/n{i}/data",
            "replication_mode": mode, "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "table-test", "bootstrap_peers": [],
            "codec": {"backend": "cpu"}}


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    return obj


@pytest.mark.parametrize("case", ["toml", "dict-3", "dict-1", "dict-hybrid"])
def test_config_matches_reference(tmp_path, case):
    if case == "toml":
        p = tmp_path / "c.toml"
        p.write_text(TOML)
        ref, port = r_config.read_config(str(p)), p_config.read_config(str(p))
    else:
        raw = _cluster_dict(0, "1" if case == "dict-1" else "3")
        if case == "dict-hybrid":
            raw["codec"] = {"backend": "hybrid", "store_parity": True,
                            "rs_data": 8, "rs_parity": 4}
        ref, port = r_config.config_from_dict(raw), p_config.config_from_dict(raw)
    assert _fields(port) == _fields(ref)


def test_config_refuses_tpu_backend():
    raw = {"codec": {"backend": "tpu"}}
    r_config.config_from_dict(raw)  # the reference's own backend
    with pytest.raises(p_config.ConfigError, match="cuda"):
        p_config.config_from_dict(raw)
    assert p_config.config_from_dict(
        {"codec": {"backend": "cuda"}}).codec.backend == "cuda"


@pytest.mark.parametrize("backend", ["cuda", "hybrid"])
def test_codec_make_needs_a_gpu(backend):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make() builds on it")
    cfg = p_config.config_from_dict({"codec": {"backend": backend}})
    with pytest.raises(Exception):
        cfg.codec.make()
    # the tests' way onto the CPU: an explicit device
    codec = cfg.codec.make(device="cpu")
    assert codec.params.rs_data == cfg.codec.rs_data
    close = getattr(codec, "close", None)
    if close is not None:
        close()


def test_cpu_backend_has_no_device():
    cfg = p_config.config_from_dict({"codec": {"backend": "cpu"}})
    codec = cfg.codec.make()
    data = [os.urandom(1000)]
    assert [bytes(h) for h in codec.batch_hash(data)] == [
        bytes(blake2s_sum(data[0]))]
