"""What an erasure-coded deployment must hold for the codewords it lists.

Each codeword names up to k member blocks and m parity pieces.  A parity
piece is stored as a block whose content is an 8-byte header (the magic
``GTPS`` and a 4-byte salt) followed by the parity shard; its name, like
every block's, is the BLAKE2s-256 of that content.  For each codeword
the reference encodes the members' bytes again (``gf256.encode``) and
holds the stored pieces to it, and it holds every piece of a codeword on
a node of its own, so that any m node losses leave k pieces.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from . import gf256

HEADER = 8
MAGIC = b"GTPS"


def judge(codewords: Iterable[dict], content: Dict[bytes, bytes],
          where: Dict[str, List[int]], read_piece, k: int, m: int,
          written: Iterable[bytes]) -> Dict[str, int]:
    """``content``: member hash -> bytes the client wrote; ``where``: hex
    name -> the nodes holding a file of that name; ``read_piece(hex)``:
    the stored content of a parity piece; ``written``: every block hash
    of every acknowledged object."""
    wrong_parity = missing_piece = shared_node = foreign = bad_geometry = 0
    covered = set()
    pieces: Dict[bytes, bytes] = {}
    n = 0
    for cw in codewords:
        n += 1
        if (cw["k"], cw["m"]) != (k, m) or len(cw["parity"]) != m:
            bad_geometry += 1
            continue
        members = [bytes(h) for h in cw["members"]]
        if any(h not in content for h in members):
            foreign += 1
            continue
        covered.update(members)
        want = gf256.encode(k, m, [content[h] for h in members])
        nodes = []
        for h in members:
            nodes.append(tuple(where.get(h.hex(), ())))
        for j, ph in enumerate(cw["parity"]):
            hx = bytes(ph).hex()
            blob = read_piece(hx) if hx in where else None
            if blob is None:
                missing_piece += 1
                continue
            nodes.append(tuple(where[hx]))
            if blob[:4] != MAGIC or blob[HEADER:] != want[j]:
                wrong_parity += 1
            else:
                pieces[bytes(ph)] = blob
        if any(len(x) == 0 for x in nodes) or len({x[0] for x in nodes if x}) < len(nodes):
            shared_node += 1
    uncovered = sum(1 for h in set(written) if h not in covered)
    return {"codewords": n, "wrong_parity": wrong_parity,
            "missing_pieces": missing_piece, "pieces_sharing_a_node": shared_node,
            "codewords_of_unknown_blocks": foreign, "bad_geometry": bad_geometry,
            "blocks_without_codeword": uncovered, "pieces": pieces}


def judge_sidecars(manifests: Iterable[dict], content: Dict[bytes, bytes],
                   k: int, m: int) -> Dict[str, int]:
    """A node's local parity sidecars: each names up to k member blocks
    and carries the m parity rows of that codeword, which must be the
    reference's encoding of the members' bytes.  A member may be a
    parity piece (a scrub pass makes sidecars of every block it
    verified): ``content`` then holds the stored piece that ``judge``
    found equal to the reference's."""
    wrong = foreign = bad_geometry = n = 0
    for man in manifests:
        n += 1
        members = [bytes(h) for h in man["hashes"]]
        if (man["k"], man["m"]) != (k, m) or len(man["parity"]) != m:
            bad_geometry += 1
            continue
        if any(h not in content for h in members):
            foreign += 1
            continue
        want = encode_padded(k, m, [content[h] for h in members],
                             int(man["maxlen"]))
        if [bytes(p) for p in man["parity"]] != want:
            wrong += 1
    return {"sidecars": n, "wrong_sidecar_parity": wrong,
            "sidecars_of_unknown_blocks": foreign,
            "bad_sidecar_geometry": bad_geometry}


def encode_padded(k: int, m: int, members: List[bytes], width: int) -> List[bytes]:
    """``gf256.encode`` with the shards padded with zeros to ``width``."""
    shards = gf256.encode(k, m, members)
    return [s + bytes(width - len(s)) for s in shards]
