"""The port's SimCluster and GatewayPool (garage_tpu_torch.testing) against
the reference's.

- The zone plan, and the layout SimCluster applies: with the same node
  keys, both packages' clusters put every partition on the same nodes
  with the same roles, zones and capacities.
- A small port SimCluster (3 storage nodes in 3 zones, a gateway,
  FaultyLinks on every dial path, the port's Garage on device="cpu")
  runs the zone-blackhole drill with zero client errors.
- The GatewayPool fails over when a gateway dies and repoints after its
  restart (tests/test_gateway_pool.py's case, on the port).
- A SimCluster whose nodes need the card raises where there is none.
"""

import os
import shutil

import aiohttp
import pytest

import garage_tpu.testing.sim_cluster as r_sim
import garage_tpu_torch.testing.sim_cluster as p_sim
from garage_tpu_torch.testing.gateway_pool import GatewayPool

pytestmark = pytest.mark.asyncio


@pytest.mark.parametrize("n,z", [(24, 4), (6, 3), (3, 3), (7, 2), (1, 5)])
def test_zone_plan_equals_reference(n, z):
    assert p_sim._zone_plan(n, z) == r_sim._zone_plan(n, z)


def test_node_config_equals_reference(tmp_path):
    for kw in ({}, {"db": "native", "repl": "2",
                    "extra_cfg": {"codec": {"backend": "cuda"}}}):
        r = r_sim.SimCluster(tmp_path, **kw)
        p = p_sim.SimCluster(tmp_path, device="cpu", **kw)
        assert [p._node_config(i) for i in range(3)] == [
            r._node_config(i) for i in range(3)]
        assert p.zones == r.zones and p.rpc_cfg == r.rpc_cfg


def _layout_view(c) -> dict:
    g = c.garages[0]
    ring = g.system.ring
    roles = {nid: (role.zone, role.capacity, list(role.tags))
             for nid, role in g.system.layout.node_roles().items()}
    return {"roles": roles,
            "partitions": [sorted(bytes(x) for x in ring.partition_nodes(p))
                           for p in range(256)],
            "zones": c.zones, "gateways": c.gateway_indices(),
            "storage": c.storage_indices()}


async def test_applied_layout_equals_reference(tmp_path):
    views = {}
    for name, sim in (("ref", r_sim), ("port", p_sim)):
        root = tmp_path / name
        if name == "port":  # the reference's node keys: the same ring
            for i in range(5):
                src = tmp_path / "ref" / f"n{i}" / "meta"
                dst = root / f"n{i}" / "meta"
                os.makedirs(dst)
                for f in os.listdir(src):
                    if f.startswith("node_key"):
                        shutil.copy(src / f, dst / f)
        kw = {"device": "cpu"} if name == "port" else {}
        c = sim.SimCluster(root, n_storage=4, n_zones=2, **kw)
        await c.start(faults=False)
        try:
            views[name] = _layout_view(c)
        finally:
            await c.stop()
    assert views["port"] == views["ref"]
    zones = {z for z, cap, _t in views["port"]["roles"].values()}
    assert zones == {"z1", "z2"}


async def crash_all(c) -> None:
    """Tear a cluster down as a crash of every node: the tests read no
    state after it, and the graceful drains cost seconds per node."""
    for srv in c.servers:
        await srv.stop()
    await c.injector.stop_network()
    for i in range(len(c.garages)):
        if i not in c.injector.dead:
            await c.injector.crash(i)


async def test_small_cluster_zone_blackhole_drill(tmp_path):
    c = p_sim.SimCluster(tmp_path, n_storage=3, n_zones=3, device="cpu")
    await c.start()
    try:
        assert len(c.injector.links) == 4 * 3
        async with aiohttp.ClientSession() as session:
            t = p_sim.TrafficDriver(c, session, bucket="dark")
            await t.make_bucket()
            st = await p_sim.zone_blackhole_drill(c, t, secs=2.0, zone="z2")
            assert st["errors"] == 0, st
            assert st["puts"] > 0 and st["gets"] > 0, st
            assert st["breaker_opened"], st
            assert await t.verify_all() == 0
    finally:
        # Garage.shutdown's graceful drains wait out workers still parked
        # on calls into the blackholed zone
        await crash_all(c)


async def test_pool_fails_over_and_repoints_after_restart(tmp_path):
    c = p_sim.SimCluster(tmp_path, n_storage=3, n_zones=3, n_gateways=2,
                         device="cpu")
    await c.start(faults=False)
    try:
        async with aiohttp.ClientSession() as session:
            pool = GatewayPool(session, c.gateway_endpoints(),
                               c.key_id, c.secret)
            st, _b, _h = await pool.request("PUT", "/fob")
            assert st == 200
            body = b"payload-" * 512
            st, _b, _h = await pool.request("PUT", "/fob/obj", body,
                                            prefer=1)
            assert st == 200

            await c.kill_gateway(1)
            # preferring the dead member: transport error -> sibling
            st, got, _h = await pool.request("GET", "/fob/obj", prefer=1)
            assert st == 200 and got == body
            assert pool.counters["failovers"] >= 1
            probes = await pool.probe()
            assert probes["g0"] is True and probes["g1"] is False

            pool.set_port("g1", await c.restart_gateway(1))
            st, got, _h = await pool.request("GET", "/fob/obj", prefer=1)
            assert st == 200 and got == body
            assert (await pool.probe())["g1"] is True
    finally:
        await c.stop()


async def test_sim_cluster_needing_a_missing_card_raises(tmp_path):
    """SimCluster builds every node on its device, the card by default:
    with a cuda codec and no card, start raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cluster would start")
    c = p_sim.SimCluster(tmp_path, n_storage=3, n_zones=3,
                         extra_cfg={"codec": {"backend": "cuda"}})
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        await c.start(faults=False)


async def test_rebuild_victim_is_chosen_by_its_data_blocks(tmp_path):
    """node_rebuild_drill crashes the node holding the most data-block
    bytes.  The reference counts every block file, and its compressible
    bodies make the distributed parity shards (incompressible) ten times
    their data members: it can pick a node holding only parity, whose
    loss no rebuild heals.  The port counts data blocks only."""
    ec = {"data_replication_mode": "none",
          "codec": {"rs_data": 2, "rs_parity": 2, "store_parity": True,
                    "parity_on_write": True, "parity_distribute": True,
                    "backend": "cpu"}}
    c = p_sim.SimCluster(tmp_path, n_storage=6, n_zones=3, extra_cfg=ec,
                         device="cpu")
    await c.start(faults=False)
    try:
        async with aiohttp.ClientSession() as session:
            t = p_sim.TrafficDriver(c, session, bucket="victim")
            await t.make_bucket()
            for _ in range(12):
                await t.step("seed")
        for g in c.garages:
            if g.block_manager.ec_accumulator is not None:
                await g.block_manager.ec_accumulator.drain()
        inj, parity = c.injector, 0
        for i in c.storage_indices():
            mgr = c.garages[i].block_manager
            files = inj._block_files(i)
            par = [p for p in files if mgr.is_parity_block(
                bytes.fromhex(os.path.basename(p).split(".")[0]))]
            parity += len(par)
            assert p_sim.data_block_bytes(inj, i) == sum(
                os.path.getsize(p) for p in files if p not in par)
        assert parity > 0
        assert max(p_sim.data_block_bytes(inj, i)
                   for i in c.storage_indices()) > 0
    finally:
        await crash_all(c)
