"""The plain reference: RFC 7693's vector, the port's CPU path at a tiny
size (the test imports the port; the reference never does), the reading
of a node's store, read-after-write and the scrub's verdicts."""

import hashlib
import zlib

import numpy as np

from benchmark.reference import blocks, reads, scrub


def test_blake2s_rfc7693_vector():
    # RFC 7693 Appendix B: BLAKE2s-256("abc")
    assert blocks.blake2s256(b"abc").hex() == (
        "508c5e8c327c14e2e1a72ba34eeb452f37458b209ed63a294d999b4c86675982")


def test_reference_agrees_with_the_ports_cpu_paths():
    from garage_tpu_torch.ops import cuda_blake2s
    from garage_tpu_torch.ops.cpu_codec import CpuCodec
    from garage_tpu_torch.ops.codec import CodecParams
    from garage_tpu_torch.utils.data import block_hash

    import torch

    g = np.random.default_rng(5)
    msgs = [b"", g.bytes(1), g.bytes(64), g.bytes(65), g.bytes(300)]
    want = [blocks.blake2s256(m) for m in msgs]
    assert [bytes(block_hash(m)) for m in msgs] == want
    codec = CpuCodec(CodecParams())
    assert [bytes(h) for h in codec.batch_hash(msgs)] == want
    # the kernel's plain version (what the card's K1 is held to)
    row = 320
    data = torch.zeros((len(msgs), row), dtype=torch.uint8)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = torch.frombuffer(bytearray(m), dtype=torch.uint8) if m else 0
    lengths = torch.tensor([len(m) for m in msgs], dtype=torch.int32)
    words = cuda_blake2s.blake2s_batch(data, lengths)
    got = [words[i].numpy().astype("<u4").tobytes() for i in range(len(msgs))]
    assert got == want


def test_compressed_files_decode_both_forms(tmp_path):
    from garage_tpu_torch.block.block import DataBlock

    data = b"abcdefgh" * 1000
    blk = DataBlock.from_buffer(data, 1)
    assert blk.compressed
    assert blocks.decompress(blk.inner) == data
    assert blocks.decompress(b"GTZF" + zlib.compress(data)) == data
    assert blocks.decompress(b"GTZF" + b"junk") is None
    h = blocks.blake2s256(data).hex()
    d = tmp_path / h[:2] / h[2:4]
    d.mkdir(parents=True)
    (d / (h + ".zst")).write_bytes(blk.inner)
    (d / (h + ".zst.corrupted")).write_bytes(b"x")
    (d / "stray.tmp").write_bytes(b"x")
    present, quarantined, other = blocks.walk_store(str(tmp_path))
    assert list(present) == [h] and quarantined == [h] and len(other) == 1
    assert blocks.bad_files(present[h]) == []
    (d / (h + ".zst")).write_bytes(blk.inner[:-1] + bytes([blk.inner[-1] ^ 1]))
    assert blocks.bad_files(present[h]) == present[h]


def _v(key, body, sent, acked):
    return reads.Version(key, hashlib.sha256(body).digest(), sent, acked)


def test_read_after_write():
    h = reads.History()
    h.add(_v("k", b"a", 0.0, 1.0))
    h.add(_v("k", b"b", 2.0, 3.0))   # sent after a was acked
    h.add(_v("k", b"c", 2.5, None))  # failed: may or may not be there
    d = {x: hashlib.sha256(x).digest() for x in (b"a", b"b", b"c")}
    # before b was sent: only a
    assert h.valid("k", 1.5, 1.9) == {d[b"a"]}
    # overlapping b: a or b (c was sent before the answer, may be there)
    assert h.valid("k", 2.1, 2.8) == {d[b"a"], d[b"b"], d[b"c"]}
    # after b's ack: a is superseded
    assert h.valid("k", 3.5, 3.6) == {d[b"b"], d[b"c"]}
    assert len(h.acked()) == 2


def test_scrub_judgement():
    g = np.random.default_rng(1)
    digs = [blocks.blake2s256(g.bytes(8)) for _ in range(64)]
    planted = set(digs[:4])
    lo_half = [(0, 32768)]
    seen = scrub.covered(digs, lo_half)
    hx = {d: d.hex() for d in digs}
    present = {hx[d]: ["p"] for d in digs}
    quarantined = [hx[d] for d in planted & seen]
    counts = scrub.judge(digs, planted, lo_half, present, quarantined,
                         set(present))
    assert counts["verdicts"] == len(seen)
    assert counts["missed_corruptions"] == 0 == counts["false_quarantines"]
    assert counts["unhealed"] == 0 == counts["missing_blocks"]
    # a scrub that set nothing aside misses every planted copy it reached
    counts = scrub.judge(digs, planted, lo_half, present, [], set(present)
                         - {hx[d] for d in planted})
    assert counts["missed_corruptions"] == len(planted & seen)
    assert counts["unhealed"] == len(planted & seen)
    good = next(d for d in seen - planted)
    counts = scrub.judge(digs, planted, lo_half, present, quarantined + [hx[good]],
                         set(present))
    assert counts["false_quarantines"] == 1
