"""The port's `native` metadata engine (garage_tpu_torch.db.native_adapter
over native/logdb.cpp, built by ops/native.py into build/native/) against
the reference's NativeDb (its committed garage_tpu/native/liblogdb.so).

The same numpy-seeded sequence of inserts, removes, transactions (with
reads of their own writes, ordered and reverse iteration over the
overlay, and aborts), range scans, clears and lengths goes through both;
their transcripts, the rows they end with and the log files they write
must be equal byte for byte.  A file written by one package opens in the
other with the same rows, and a log cut off mid-record (a crash before
the commit record reached the disk) reopens to the same committed rows
in both.  A library that cannot be built raises DbError, and so does a
call after close (the port's repair: the reference's adapter crashes the
process there).
"""

import os
import shutil

import numpy as np
import pytest

import garage_tpu.db as r_db
import garage_tpu_torch.db as p_db
import garage_tpu_torch.db.native_adapter as p_native
from garage_tpu.db import TxAbort as r_TxAbort
from garage_tpu_torch.db import TxAbort as p_TxAbort
from garage_tpu_torch.ops import native
from garage_tpu_torch.utils.error import DbError

SEED = 20261021
PKGS = {"ref": (r_db, r_TxAbort), "port": (p_db, p_TxAbort)}


def _ops(n=300, salt=0):
    rng = np.random.default_rng([SEED, salt])
    keys = [bytes(rng.integers(0, 256, int(rng.integers(1, 6)),
                               dtype=np.uint8)) for _ in range(40)]
    ops = []
    for _ in range(n):
        r = float(rng.random())
        t = "ab"[int(rng.integers(0, 2))]
        k = keys[int(rng.integers(0, len(keys)))]
        if r < 0.45:
            ops.append(("insert", t, k, rng.bytes(int(rng.integers(0, 60)))))
        elif r < 0.6:
            ops.append(("remove", t, k, None))
        elif r < 0.75:
            ops.append(("tx", t, k, rng.bytes(int(rng.integers(1, 20)))))
        elif r < 0.8:
            ops.append(("abort", t, k, rng.bytes(4)))
        elif r < 0.95:
            lo, hi = sorted(keys[int(i)] for i in rng.integers(0, 40, 2))
            ops.append(("range", t, (lo, hi), bool(rng.integers(0, 2))))
        elif r < 0.98:
            ops.append(("len", t, None, None))
        else:
            ops.append(("clear", "b", None, None))
    return ops


def _run(pkg, path, ops):
    """Drive `ops` through package `pkg`'s native engine at `path`;
    the transcript of every answer and the rows at the end."""
    db_mod, abort = PKGS[pkg]
    db = db_mod.open_db("native", path=path)
    trees = {t: db.open_tree(t) for t in "ab"}
    log = []
    for op, t, k, v in ops:
        tree = trees[t]
        if op == "insert":
            log.append(tree.insert(k, v))
        elif op == "remove":
            log.append(tree.remove(k))
        elif op == "len":
            log.append(len(tree))
        elif op == "clear":
            tree.clear()
            log.append(len(tree))
        elif op == "range":
            lo, hi = k
            rows = (tree.items_rev(lo, hi) if v else tree.items(lo, hi))
            log.append([(bytes(a), bytes(b)) for a, b in rows])
        else:
            # read, two writes, a remove and both iteration orders over
            # the overlay; "abort" throws it all away
            def fn(tx, tree=tree, k=k, v=v, op=op):
                old = tx.get(tree, k)
                tx.insert(tree, k, v)
                tx.insert(tree, k + b"\x00", (old or b"") + v)
                tx.remove(tree, k[:1])
                seen = (list(tx.iter_range(tree, None, None)),
                        list(tx.iter_range(tree, k, None, reverse=True)),
                        tx.len(tree))
                if op == "abort":
                    raise abort(("aborted", seen))
                return old, seen
            log.append(db.transaction(fn))
    rows = {t: list(tr.items(None, None)) for t, tr in trees.items()}
    rev = list(trees["a"].items_rev(None, None))
    db.close()
    norm = [None if x is None else x for x in log]
    return norm, rows, rev


def test_same_sequence_same_transcript_rows_and_file(tmp_path):
    ops = _ops()
    out = {p: _run(p, str(tmp_path / p / "db.logdb"), ops) for p in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"][1]["a"], "the sequence left no rows"
    assert ((tmp_path / "port" / "db.logdb").read_bytes()
            == (tmp_path / "ref" / "db.logdb").read_bytes())
    # the port's library came from ops/native.py, never the reference's
    # package directory
    assert native._lib_path("logdb").exists()
    assert native._lib_path("logdb").parent == native.BUILD_DIR


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_file_written_by_one_package_opens_in_the_other(tmp_path, writer,
                                                        reader):
    path = str(tmp_path / "db.logdb")
    _log, rows, rev = _run(writer, path, _ops(salt=1))
    db = PKGS[reader][0].open_db("native", path=path)
    got = {t: list(db.open_tree(t).items(None, None)) for t in "ab"}
    got_rev = list(db.open_tree("a").items_rev(None, None))
    assert sorted(db.list_trees()) == ["a", "b"]
    db.close()
    assert got == rows and got_rev == rev
    # and the reader keeps writing to the same file
    more = _ops(n=60, salt=2)
    mine = _run(reader, path, more)
    shutil.copy(path, tmp_path / "again.logdb")
    theirs = _run(writer, str(tmp_path / "again.logdb"), [])
    assert theirs[1] == mine[1]


@pytest.mark.parametrize("cut", [1, 7, 23])
def test_reopen_after_unclean_close(tmp_path, cut):
    """A crash: the file as the disk held it while the engine was still
    open, then a torn tail `cut` bytes short of the last commit record.
    Both packages recover the same committed rows."""
    ops = _ops(n=120, salt=3)
    res = {}
    for pkg in PKGS:
        db_mod, _ = PKGS[pkg]
        path = str(tmp_path / pkg / "db.logdb")
        db = db_mod.open_db("native", path=path)
        a = db.open_tree("a")
        for op, _t, k, v in ops:
            if op == "insert":
                a.insert(k, v)
        committed = list(a.items(None, None))
        size = os.path.getsize(path)
        a.insert(b"last-key", b"z" * 50)
        crashed = str(tmp_path / pkg / "crashed.logdb")
        shutil.copy(path, crashed)  # no close: what the disk held
        db.close()
        with open(crashed, "r+b") as f:
            f.truncate(os.path.getsize(crashed) - cut)
        assert os.path.getsize(crashed) > size
        rows = {}
        for reader in PKGS:
            copy = str(tmp_path / pkg / f"read-by-{reader}.logdb")
            shutil.copy(crashed, copy)
            db = PKGS[reader][0].open_db("native", path=copy)
            rows[reader] = list(db.open_tree("a").items(None, None))
            db.close()
        assert rows["ref"] == rows["port"] == committed
        res[pkg] = rows["port"]
    assert res["ref"] == res["port"]


def test_a_logdb_that_cannot_build_raises(tmp_path, monkeypatch):
    """No fallback: the engine raises DbError, with the compiler's
    reason, and never opens another engine in its place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(DbError, match="native logdb unavailable"):
        p_db.open_db("native", path=str(tmp_path / "db.logdb"))
    assert not (tmp_path / "db.logdb").exists()


def test_use_after_close_raises(tmp_path):
    """A call after close raises DbError: the reference's adapter hands
    the library the NULL or freed handle and the process dies (a crashed
    node's straggling worker did exactly that), so this one runs on the
    port only."""
    db = p_db.open_db("native", path=str(tmp_path / "db.logdb"))
    t = db.open_tree("a")
    for i in range(5):
        t.insert(bytes([i]), b"v")
    live = t.items(None, None)
    assert next(live) == (b"\x00", b"v")
    db.close()
    calls = [lambda: t.get(b"\x01"), lambda: t.insert(b"x", b"y"),
             lambda: len(t), lambda: list(t.items(None, None)),
             lambda: t.remove(b"\x01"), lambda: next(live),
             lambda: db.transaction(lambda tx: tx.insert(t, b"k", b"v")),
             lambda: db.open_tree("new")]
    for call in calls:
        with pytest.raises(DbError, match="closed"):
            call()
    db.close()  # a second close is a no-op
