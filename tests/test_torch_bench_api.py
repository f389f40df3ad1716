"""The benchmark's API phases (garage_tpu_torch/tools/bench_api.py) against
bench.py's on the CPU.

Each phase runs through the port (``device="cpu"``: every node's codec a
``CudaCodec`` on the plain versions, ``"backend": "cuda"``) and through
the reference (its CPU codec), with the same small constants (payloads and
blocks of a few KiB: the plain BLAKE2s costs ~4 ms per 64-byte chunk of a
block) and the same seeded payloads.  Both clusters get the same node keys,
so the port's ring places every block where the reference's does.  The key
sets are held equal, and the correctness fields: every request 200 (each
phase asserts it), parity coverage of every RS(4,2) block, the multipart
bytes moved, the degraded phase's lost bytes and every object read back
bit-exact after the two-node loss.
"""

import asyncio
import hashlib
import tempfile

import pytest

import bench as ref
from garage_tpu_torch.tools import bench_api as api

SMALL = {"BLOCK": 4096, "N_PUTS": 4, "RS42_PUTS": 3, "RS42_OBJ": 8192,
         "MP_TOTAL": 4 * 8192, "MP_PART": 8192, "PUT_BATCHED_ROUNDS": 2,
         "PUT_BATCHED_ROUND_PUTS": 4, "DEGRADED_OBJS": 6,
         "DEGRADED_OBJ_SIZE": 8192}


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The small constants in both packages, and every phase's temporary
    directory seeded with the same node keys (n0..n7)."""
    for name, v in SMALL.items():
        monkeypatch.setattr(ref, name, v)
        monkeypatch.setattr(api, name, v)
    made = []

    def mkdtemp(prefix="", **_kw):
        d = tmp_path / f"{prefix}{len(made)}"
        for i in range(8):
            meta = d / f"n{i}" / "meta"
            meta.mkdir(parents=True)
            (meta / "node_key").write_bytes(
                hashlib.sha256(f"bench-node-{i}".encode()).digest())
        made.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    return made


def _both(name: str) -> tuple:
    port = asyncio.run(getattr(api, name)(device="cpu"))
    reference = asyncio.run(getattr(ref, name)())
    assert set(port) == set(reference), (
        sorted(set(port) ^ set(reference)))
    return port, reference


@pytest.mark.parametrize("name, prefix", [
    ("_put_phase_async", "put"), ("_put_solo_phase_async", "put_solo")])
def test_put_phases_report_the_references_keys(small, name, prefix):
    port, reference = _both(name)
    for out in (port, reference):
        assert out[f"{prefix}_p50_ms"] > 0
        assert out[f"{prefix}_conc8_puts_per_s"] > 0
        assert "PutObject" in out[f"{prefix}_critical_path"]


def test_put_batched_phase_batches_through_the_feeder(small):
    port, reference = _both("_put_batched_phase_async")
    for out in (port, reference):
        # the phase asserts dispatches > 0 and no client error
        assert out["put_batched_dispatches"] > 0
        assert out["put_batched_mean_batch_blocks"] >= 1.0


def test_rs_put_phase_covers_every_block_at_write_time(small):
    port, reference = _both("_rs_put_phase_async")
    assert port["rs42_total_blocks"] == reference["rs42_total_blocks"] > 0
    assert port["rs42_covered_blocks"] == port["rs42_total_blocks"]
    assert reference["rs42_covered_blocks"] == reference["rs42_total_blocks"]


def test_mp_phase_moves_every_part(small):
    port, reference = _both("_mp_phase_async")
    # the phase asserts every part and the completion 200
    assert port["mp_gib_moved"] == reference["mp_gib_moved"]
    assert port["mp_part_mibs_p50"] >= 0 and reference["mp_mibs"] >= 0


def test_degraded_phase_reads_every_object_back_after_two_losses(small):
    port, reference = _both("_degraded_phase_async")
    for out in (port, reference):
        assert out["degraded_unhealed"] == 0
        assert out["degraded_blocks_reconstructed"] > 0
    # one ring: the same two victims, the same bytes lost
    assert port["degraded_lost_gib"] == reference["degraded_lost_gib"]


def test_iter_block_files_skips_parity_and_temporaries(tmp_path):
    for rel in ("ab/cd/blk1", "ab/cd/blk2.tmp", "parity/x/p1",
                "ab/cd/side.par", "ef/gh/blk3"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    port = sorted(api._iter_block_files(tmp_path))
    assert port == sorted(ref._iter_block_files(tmp_path))
    assert [p.split("/")[-1] for p in port] == ["blk1", "blk3"]


def test_critical_path_and_slo_report_merge_as_the_reference():
    class Wf:
        def __init__(self, totals):
            self._t = totals

        def totals(self):
            return self._t

    class Slo:
        def __init__(self, rep):
            self._r = rep

        def report(self):
            return self._r

    class Node:
        def __init__(self, totals, rep):
            self.system = type("S", (), {"tracer": type(
                "T", (), {"waterfall": Wf(totals)})()})()
            self.slo = Slo(rep)

    def rep(total, err, slow):
        w = {"total": total, "err": err, "slow": slow}
        return {"PutObject": {"availability_target": 0.999,
                              "latency_target_ms": 500.0,
                              "fast": dict(w), "slow": dict(w)}}

    nodes = [Node({"PutObject": {"count": 4, "seconds": 2.0, "segments": {
                  "block_write": 1.5, "rpc": 0.5}}}, rep(10, 1, 2)),
             Node({"PutObject": {"count": 2, "seconds": 0.4, "segments": {
                  "rpc": 0.4}}}, rep(5, 0, 0))]
    port = api._phase_critical_path(nodes, "put")
    assert port == ref._phase_critical_path(nodes, "put")
    assert port["put_critical_path"]["PutObject"]["dominant"] == \
        "block_write"
    assert port["put_slo_report"]["worst"]["endpoint"] == "PutObject"
