"""The benchmark's robustness and scale phases
(garage_tpu_torch/tools/bench_scale.py) against bench.py's on the CPU.

Every phase runs through the port with ``device="cpu"`` (each node's codec
a ``CudaCodec`` on the plain versions) at cut constants.  The WAN and
metadata phases also run through the reference with the same constants:
equal key sets, and the correctness fields the phases assert (reads
bit-exact, counters exact after churn, Merkle trees and synced stores
identical).  The overload, tenants, replay and rebalance phases of the
reference cannot be brought under ~30 s here (the overload's 6 s levels
are a local of the phase, the replay and rebalance clusters take 30-60 s
to start and stop) or do not hold on this shared host (the reference's own
tenants phase breaks its p99 bound in 2 of 3 runs here), so the port is
held to the keys the reference's source writes and to the fields that do
not depend on the host's timing.  For the same reason the metadata
phase's last check, the listing A/B's win-or-tie timing, may fail in
either package under the whole suite's load; its correctness checks run
before it and are held.
"""

import ast
import asyncio
import inspect
import re

import pytest

import bench as ref
from garage_tpu_torch.tools import bench_scale as scale

SMALL = {"OVERLOAD_LEVEL_SECS": 1.5, "OVERLOAD_OBJ": 2048,
         "TENANTS_WINDOW_SECS": 1.5, "TENANTS_ROUNDS": 1,
         "TENANTS_RAMP_SECS": 0.3, "TENANTS_OBJ": 1024, "WAN_PUTS": 4,
         "REPLAY_SECS": 2.0, "REBALANCE_RATES_MIB": (64.0,),
         "REBALANCE_OBJS": 6, "REBALANCE_OBJ_KIB": 48,
         "REBALANCE_DRAIN_S": 60.0, "META_OBJECTS": 2000,
         "META_SYNC_OBJECTS": 2000, "META_AB_WINDOW": 200,
         "META_LIST_ROUNDS": 5}


@pytest.fixture
def small(monkeypatch):
    for name, v in SMALL.items():
        monkeypatch.setattr(scale, name, v)
        if hasattr(ref, name):
            monkeypatch.setattr(ref, name, v)


def _source_keys(fn, pattern: str) -> set:
    return set(re.findall(pattern, inspect.getsource(fn)))


def test_overload_phase_sheds_beyond_capacity(small):
    port = asyncio.run(scale._overload_phase_async(device="cpu"))
    ovl = port["overload"]
    assert set(ovl) == _source_keys(ref._overload_phase_async,
                                    r'"([a-z_]+_total|max_inflight|levels)":')
    level_keys = _source_keys(ref._overload_phase_async,
                              r'"([a-z0-9_]+)": (?:mult|round|shed|errs)')
    assert [lv["offered_x"] for lv in ovl["levels"]] == [1, 2, 4]
    for lv in ovl["levels"]:
        assert set(lv) == level_keys
        assert lv["errors"] == 0
    # 4x the gate's capacity turns into typed sheds, not queueing
    assert ovl["levels"][-1]["shed"] > 0
    assert ovl["shed_total"] == sum(lv["shed"] for lv in ovl["levels"])
    assert "overload_critical_path" in port


def test_tenants_phase_isolates_the_abuser(small):
    """The phase asserts zero well-behaved sheds, abuser sheds, typed
    rejects, the p99 bound and zero errors, in that order.  On this shared
    host the p99 bound may break (the reference's too); the fields asserted
    before it still hold then, and are read from the assertion's report."""
    try:
        port = asyncio.run(scale._tenants_phase_async(device="cpu"))
        out = port["tenants"]
        assert "tenants_critical_path" in port
    except AssertionError as e:
        msg = str(e)
        assert msg.startswith("well-behaved p99 broke its bound: "), msg
        out = ast.literal_eval(msg.split(": ", 1)[1])
    want = _source_keys(ref._tenants_phase_async,
                        r'"((?:well|abuser)_[a-z0-9_]+|admission)":')
    assert want <= set(out)
    assert out["well_sheds"] == 0
    assert out["abuser_sheds"] > 0
    assert out["abuser_untyped"] == []
    assert out["errors"] == 0


def test_wan_phase_counts_round_trips(small):
    port = asyncio.run(scale._wan_phase_async(device="cpu"))
    reference = asyncio.run(ref._wan_phase_async())
    assert set(port) == set(reference)
    for out in (port, reference):
        # at least one 100 ms round trip per write and per read
        assert out["wan_put_p50_rtt"] >= 1.0
        assert out["wan_get_p50_rtt"] >= 1.0


def test_replay_phase_survives_a_gateway_kill(small):
    port = asyncio.run(scale._replay_phase_async(device="cpu"))
    want = _source_keys(ref._replay_phase_async,
                        r'"(replay_[a-z_]+)"(?::|\])')
    assert want | {"replay_slo_report"} == set(port)
    assert port["replay_deterministic"] and port["replay_gateway_killed"]
    assert port["replay_failover_exercised"]
    assert port["replay_verify_mismatches"] == 0
    assert port["replay_stats"]["errors"] == 0


def test_rebalance_phase_drains_a_zone(small):
    port = asyncio.run(scale._rebalance_phase_async(device="cpu"))
    assert set(port) == _source_keys(
        ref._rebalance_phase_async, r'"(rebalance_[a-z0-9_]+)":')
    sweep_keys = _source_keys(ref._rebalance_one,
                              r'"([a-z0-9_]+)": (?:rate|round|len|all|0)')
    for s in port["rebalance_sweep"]:
        assert sweep_keys | {"budget_ok", "verify_mismatches"} == set(s)
        assert s["rebalance_complete"] and s["moved_mib"] > 0
        assert s["errors"] == 0 and s["verify_mismatches"] == 0


def _metadata(phase) -> dict:
    """The phase's result; when only its last check fails, the listing
    win-or-tie timing (sharded p50 within 1.25x + 2 ms of serial, which a
    loaded shared host can break), the result that check reports, all
    the correctness checks before it having passed."""
    try:
        return asyncio.run(phase())
    except AssertionError as e:
        (arg,) = e.args
        if not (isinstance(arg, tuple) and arg[0] in (
                "root_page", "dir_walk", "delimiter")):
            raise
        return arg[1]


def test_metadata_phase_keeps_counters_exact(small):
    port = _metadata(lambda: scale._metadata_phase_async(device="cpu"))
    reference = _metadata(ref._metadata_phase_async)
    cp = {"meta_critical_path", "meta_slo_report"}
    assert set(port) - cp == set(reference) - cp
    for key in ("meta_objects", "meta_churned", "meta_reinserted",
                "meta_bucket0_live", "meta_bucket0_counter",
                "meta_bucket1_counter", "meta_counters_exact",
                "meta_counted_tree_drift", "merkle_bit_identical",
                "sync_objects", "sync_pernode_roots_agree",
                "sync_batched_roots_agree", "sync_stores_identical",
                "sync_pernode_rpc_rounds", "sync_batched_rpc_rounds"):
        assert port[key] == reference[key], key
    assert port["meta_counters_exact"] and port["merkle_bit_identical"]


def test_meta_helpers_equal_the_references():
    assert [scale._meta_key(i) for i in (0, 7, 8, 399, 400, 123456)] == \
        [ref._meta_key(i) for i in (0, 7, 8, 399, 400, 123456)]
    obj = scale._meta_mk_object(b"\x01" * 32, "d00/obj0000001", 5)
    assert obj.key == "d00/obj0000001"
    assert obj.versions()[0].timestamp == 5
