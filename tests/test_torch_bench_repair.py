"""The benchmark's repair and device phases
(garage_tpu_torch/tools/bench_repair.py) against bench.py's on the CPU.

- The transport and pool A/Bs at the reference's shapes (1 MiB blocks,
  RS(8,4), 16-block scrub windows): the port's phases with
  ``device="cpu"`` drive the reference's synthetic link (the port's copy),
  as its ``tools/common.device_codec`` does for ``--synthetic``.  Held to
  the reference's keys, byte counts, copies per block and pool hit/miss
  attribution.
- The repair storm (8 nodes, RS(4,2)) and the rebuild (k=2 and k=4) at
  small object counts and sizes, the port's nodes on the plain versions:
  every object healed with zero client errors, the three repair modes'
  decodes bit-identical (the phase asserts it), the tree aggregation's flat
  ingress.  The reference's phases take 60-125 s on this host even at
  these sizes (each waits out feeder deadlines and 60 s GETs), so the port
  is held to the keys the reference's source writes, not to a run of it.
"""

import asyncio
import hashlib
import inspect
import re
import tempfile

import pytest

import bench as ref
from garage_tpu_torch.tools import bench_repair as rep

SMALL = {"REPAIR_STORM_OBJS": 4, "REPAIR_STORM_OBJ_MIN": 2048,
         "REPAIR_STORM_OBJ_MAX": 6144, "REPAIR_STORM_SAMPLES": 2,
         "REBUILD_PHASE_OBJS": 3, "REBUILD_PHASE_OBJ_MIN": 2048,
         "REBUILD_PHASE_OBJ_MAX": 5000, "REBUILD_PHASE_SAMPLES": 2}


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The small constants in both packages, and every phase's temporary
    directory seeded with the same node keys (n0..n7)."""
    for name, v in SMALL.items():
        monkeypatch.setattr(ref, name, v)
        monkeypatch.setattr(rep, name, v)
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


def _both(name: str) -> tuple:
    port = asyncio.run(getattr(rep, name)(device="cpu"))
    reference = asyncio.run(getattr(ref, name)())
    assert set(port) == set(reference), (
        sorted(set(port) ^ set(reference)))
    return port, reference


def test_transport_phase_matches_the_reference():
    port, reference = _both("_transport_phase_async")
    for key in ("transport_old_copies_per_block",
                "transport_new_copies_per_block", "transport_old_link_gibs",
                "sustained_tpu_frac", "transport_bytes_by_side",
                "transport_old_bytes_level_submissions",
                "transport_new_bytes_level_submissions"):
        assert port[key] == reference[key], key
    assert port["transport_new_bytes_level_submissions"] == 0
    assert port["transport_new_copies_per_block"] <= 1.0
    assert set(reference["transport_stats"]) <= set(port["transport_stats"])


def test_pool_phase_matches_the_reference():
    port, reference = _both("_pool_phase_async")
    for key in ("pool_cold_link_bytes", "pool_warm_link_bytes",
                "pool_hit_bytes", "pool_miss_bytes"):
        assert port[key] == reference[key], key
    assert port["pool_warm_link_bytes"] == 0
    assert port["pool_warm_speedup"] >= 2.0
    assert set(reference["pool_stats"]) <= set(port["pool_stats"])


def _reference_keys(fn, pattern: str) -> set:
    """The JSON keys a reference phase's source writes (string literals
    matching `pattern`)."""
    return set(re.findall(pattern, inspect.getsource(fn)))


def test_repair_storm_phase_heals_every_object(small):
    port = asyncio.run(rep._repair_storm_phase_async(device="cpu"))
    want = _reference_keys(ref._repair_storm_phase_async,
                           r'"(repair_storm_[a-z0-9_]+)":')
    assert len(want) == 12
    assert set(port) == want | {"repair_storm_critical_path",
                                "repair_storm_slo_report"}
    assert port["repair_storm_unhealed"] == 0
    assert port["repair_storm_client_errors"] == 0
    assert port["repair_storm_bytes_per_byte_ppr"] <= \
        port["repair_storm_bytes_per_byte_shard"] <= \
        port["repair_storm_bytes_per_byte_gather"]


def test_rebuild_phase_keeps_coordinator_ingress_flat_in_k(small):
    port = asyncio.run(rep._rebuild_phase_async(device="cpu"))
    per_k = _reference_keys(ref._rebuild_phase_async,
                            r'f"(rebuild_[a-z0-9_]+)_k\{k\}"')
    assert len(per_k) == 10
    assert set(port) == {f"{key}_k{k}" for key in per_k for k in (2, 4)} \
        | {"rebuild_ingress_flat_in_k"}
    assert port["rebuild_ingress_flat_in_k"] is True
    for k in (2, 4):
        assert port[f"rebuild_unhealed_k{k}"] == 0
        assert port[f"rebuild_client_errors_k{k}"] == 0
        done, total = port[f"rebuild_sched_partitions_k{k}"].split("/")
        assert done == total


def test_the_card_rigs_count_bytes_level_calls():
    """On the card the old route's copies are counted by wrapping the
    CudaCodec's bytes-level API: one count per call, each block once."""
    from garage_tpu_torch.ops.codec import CodecParams
    from garage_tpu_torch.ops.cuda_codec import CudaCodec

    dev = CudaCodec(CodecParams(rs_data=2, rs_parity=1), device="cpu")
    counts = rep.BytesLevel(dev)
    blocks = [bytes([i]) * 100 for i in range(4)]
    hashes = dev.batch_hash(blocks)
    assert dev.batch_verify(blocks, hashes).all()
    assert counts.submissions == 2
    assert counts.blocks_submitted == counts.host_copies == 8
    assert [bytes(h) for h in hashes] == [
        hashlib.blake2s(b, digest_size=32).digest() for b in blocks]
