"""The codewords an erasure-coded deployment says it wrote.

After the daemons have stopped, each node's metadata database is read
for its rows of the parity index (the table that maps a member block to
its codeword).  These rows are the program's output under judgement:
the reference works each codeword's parity out again from the members'
bytes and compares it with the pieces stored on disk.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List


def codewords(meta_dirs: List[Path]) -> Dict[bytes, dict]:
    """Live codewords by id: k, m, member hashes and lengths, parity
    hashes, from every node's rows of the parity index."""
    from garage_tpu_torch.db import open_db
    from garage_tpu_torch.model.parity_index_table import ParityIndexTableSchema

    schema = ParityIndexTableSchema()
    out: Dict[bytes, dict] = {}
    for meta in meta_dirs:
        db = open_db("sqlite", path=str(Path(meta) / "db.sqlite"))
        try:
            for _k, raw in db.open_tree("parity_index:table").items():
                e = schema.decode_entry(raw)
                if e.is_tombstone():
                    continue
                out.setdefault(bytes(e.gid), {
                    "k": e.k, "m": e.m, "members": list(e.members),
                    "lengths": list(e.lengths),
                    "parity": list(e.parity_hashes)})
        finally:
            db.close()
    return out


def sidecars(paths: Iterable[str]) -> List[dict]:
    """The manifests of the local parity sidecars (``parity/<gid>.par``,
    msgpack): k, m, maxlen, member hashes, parity rows."""
    import msgpack

    out = []
    for p in paths:
        if p.endswith(".par"):
            with open(p, "rb") as f:
                out.append(msgpack.unpackb(f.read(), raw=False))
    return out
