"""The benchmark's repair and device phases.

The port of ``bench.py``'s repair-storm, rebuild, transport and pool
phases (``tools/bench.py`` runs each in its own process by its flag):

  - ``--repair-storm-phase``: an 8-node RS(4,2) cluster, bytes moved per
    byte repaired under three repair modes on the same codewords (decoded
    bit-identical), then the heaviest node crashed and healed under GETs;
  - ``--rebuild-phase``: a full-node loss at k=2 and k=4, the
    coordinator's ingress per repaired byte through the aggregation tree
    and the client GET p99 quiet and during the rebuild;
  - ``--transport-phase``: scrub and hash windows through one CodecFeeder
    over the legacy bytes-level route and over the DeviceTransport, in
    alternating windows;
  - ``--pool-phase``: the same scrub working set with the device pool off
    (cold) and on (warm).

Every cluster's codecs are built on the card (``"backend": "cuda"``):
decodes run K3, encodes K2, hashes K1.  The transport and pool phases
drive a CudaCodec on cuda:0 (``tools/common.device_codec``, as
``transport_smoke`` and ``pool_smoke`` do, K1 and K4); with
``device="cpu"`` they drive the reference's synthetic link instead, the
tests' path.
"""

from __future__ import annotations

import asyncio
import hashlib
import time

import numpy as np

from ..testing.cluster import mk_cluster
from ..testing.s3_client import S3Client
from .bench_api import CARD_CODEC, _phase_critical_path, _tmpdir
from .common import BytesLevel, device_codec
from .device_capture import K, M

REPAIR_STORM_OBJS = 20
REPAIR_STORM_OBJ_MIN = 1 << 20     # varied sizes: the PPR sub-shard
REPAIR_STORM_OBJ_MAX = 4 << 20     # truncation only shows on ragged tails
REPAIR_STORM_SAMPLES = 8
REBUILD_PHASE_SHAPES = ((2, 6), (4, 8))   # (rs_data k, cluster nodes)
REBUILD_PHASE_OBJS = 12
REBUILD_PHASE_OBJ_MIN = 256 << 10
REBUILD_PHASE_OBJ_MAX = 1 << 20
REBUILD_PHASE_SAMPLES = 6
# the block size of the transport and pool windows
DEVICE_PHASE_BLOCK = 1 << 20


def _parity_samples(coord, limit: int) -> list:
    """Up to `limit` live parity-index entries of distinct members."""
    data = coord.parity_index_table.data
    samples, seen = [], set()
    for _kby, raw in data.store.items(b"", None):
        try:
            ent = data.decode_entry(raw)
        except Exception:
            # a row the index does not decode is no sample
            continue
        if (ent.is_tombstone() or bytes(ent.member) in seen
                or ent.member_index >= len(ent.members)):
            continue
        seen.add(bytes(ent.member))
        samples.append(ent)
        if len(samples) >= limit:
            break
    return samples


async def _repair_storm_phase_async(device="cuda") -> dict:
    """Repair bandwidth under a node-kill storm on an 8-node RS(4,2) EC
    cluster.  (1) Bytes moved per byte repaired for the same sampled
    codewords under three repair modes — the fetch-everything gather, the
    planned exact-k whole-shard and the planned PPR — with bit-identical
    outputs; (2) the storm: the heaviest non-gateway node is crashed and
    dropped from the layout, resync heals through the planned path, and
    client GET p50 is measured meanwhile.  Expected ladder: ppr <= shard
    <= gather bytes/byte."""
    import shutil

    import aiohttp

    from ..testing.faults import FaultInjector, crash_heaviest_and_drop
    from ..utils.data import Hash

    tmp = _tmpdir("garage_tpu_torch_bench_storm_")
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=8, repl="3", data_repl="none", db="sqlite",
            codec_cfg=dict(CARD_CODEC, rs_data=4, rs_parity=2,
                           store_parity=True, parity_on_write=True,
                           parity_distribute=True), device=device)
        rng = np.random.default_rng(8)
        bodies = {}
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/stormbkt")
            assert st == 200, st
            for i in range(REPAIR_STORM_OBJS):
                size = int(rng.integers(REPAIR_STORM_OBJ_MIN,
                                        REPAIR_STORM_OBJ_MAX))
                body = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                st, _b, _h = await s3.req("PUT", f"/stormbkt/o{i:03d}", body)
                assert st == 200, st
                bodies[f"o{i:03d}"] = body
        for g in garages:
            if g.block_manager.ec_accumulator is not None:
                await g.block_manager.ec_accumulator.drain()
        await asyncio.sleep(3.0)  # let the distributor finish indexing

        # --- per-mode comparative: same codewords, three repair modes ---
        coord = garages[0]
        mgr = coord.block_manager
        samples = _parity_samples(coord, REPAIR_STORM_SAMPLES)
        assert samples, "no parity-index entries on the coordinator"
        planner = mgr.repair_planner
        assert planner is not None
        ratios, decoded = {}, {}
        for mode in ("gather", "shard", "ppr"):
            if mode == "gather":
                mgr.repair_planner = None
                mgr.repair_gather_everything = True
            else:
                mgr.repair_planner = planner
                mgr.repair_gather_everything = False
                planner.use_ppr = (mode == "ppr")
            f0 = sum(mgr.repair_fetch_bytes.values())
            r0 = mgr.repair_repaired_bytes
            for ent in samples:
                got = await mgr.parity_reconstructor(
                    Hash(bytes(ent.member)))
                assert got is not None, f"{mode} reconstruction failed"
                prev = decoded.setdefault(bytes(ent.member), got)
                assert prev == got, f"{mode} not bit-identical"
            moved = sum(mgr.repair_fetch_bytes.values()) - f0
            repaired = mgr.repair_repaired_bytes - r0
            ratios[mode] = moved / max(1, repaired)
        mgr.repair_planner = planner
        mgr.repair_gather_everything = False
        planner.use_ppr = True

        # --- the storm: kill the heaviest non-gateway node ---------------
        inj = FaultInjector(garages)
        _victim, lost, survivors = await crash_heaviest_and_drop(inj)
        f0 = sum(sum(g.block_manager.repair_fetch_bytes.values())
                 for g in survivors)
        r0 = sum(g.block_manager.repair_repaired_bytes for g in survivors)

        t0 = time.perf_counter()
        lats, client_errors = [], 0
        pending = dict(bodies)
        deadline = time.perf_counter() + 600
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            while pending and time.perf_counter() < deadline:
                for name in list(pending):
                    tq = time.perf_counter()
                    try:
                        st, got, _h = await asyncio.wait_for(
                            s3.req("GET", f"/stormbkt/{name}"), 60)
                    except Exception:
                        # a client-visible failure is what this counts
                        client_errors += 1
                        continue
                    lats.append(time.perf_counter() - tq)
                    if st == 200 and got == bodies[name]:
                        del pending[name]
                    else:
                        client_errors += 1
                if pending:
                    await asyncio.sleep(2.0)
        heal_s = time.perf_counter() - t0
        moved = sum(sum(g.block_manager.repair_fetch_bytes.values())
                    for g in survivors) - f0
        repaired = sum(g.block_manager.repair_repaired_bytes
                       for g in survivors) - r0
        lats.sort()
        out = {
            "repair_storm_bytes_per_byte_gather": round(ratios["gather"], 3),
            "repair_storm_bytes_per_byte_shard": round(ratios["shard"], 3),
            "repair_storm_bytes_per_byte_ppr": round(ratios["ppr"], 3),
            "repair_storm_bytes_per_byte_storm": round(
                moved / max(1, repaired), 3),
            "repair_storm_heal_s": round(heal_s, 1),
            "repair_storm_gibs": round(lost / heal_s / 2**30, 4),
            "repair_storm_lost_gib": round(lost / 2**30, 3),
            "repair_storm_unhealed": len(pending),
            "repair_storm_client_errors": client_errors,
            "repair_storm_client_p50_ms": round(
                lats[len(lats) // 2] * 1000, 1) if lats else 0.0,
            "repair_storm_overfetch_bytes": sum(
                g.block_manager.repair_overfetch_bytes for g in survivors),
            "repair_storm_ppr_fallbacks": sum(
                g.block_manager.repair_ppr_fallbacks for g in survivors),
        }
        out.update(_phase_critical_path(survivors, "repair_storm"))
        await server.stop()
        for i, g in enumerate(inj.garages):
            if i not in inj.dead:
                await g.shutdown()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def _rebuild_phase_async(device="cuda") -> dict:
    """Full-node-loss rebuild at k=2 vs k=4.  Per shape: (1) coordinator
    repair ingress per repaired byte through the TREE-aggregated PPR path
    for the same sampled codewords — one row-sized aggregate regardless
    of k, so the ratio stays near 1 (<= 1.25) at both; (2) client GET p99
    during the node-loss rebuild vs quiet, every object healing
    bit-identically."""
    import shutil

    import aiohttp

    from ..testing.faults import FaultInjector, crash_heaviest_and_drop
    from ..utils.data import Hash

    def _p99_ms(lats):
        if not lats:
            return 0.0
        lats = sorted(lats)
        return round(lats[min(len(lats) - 1, int(len(lats) * 0.99))]
                     * 1000, 1)

    out: dict = {}
    ratios: dict = {}
    for k, n in REBUILD_PHASE_SHAPES:
        tmp = _tmpdir(f"garage_tpu_torch_bench_rbd{k}_")
        try:
            garages, server, port, kid, secret = await mk_cluster(
                tmp, n=n, repl="3", data_repl="none", db="sqlite",
                codec_cfg=dict(CARD_CODEC, rs_data=k, rs_parity=2,
                               store_parity=True, parity_on_write=True,
                               parity_distribute=True), device=device)
            rng = np.random.default_rng(20 + k)
            bodies = {}
            inj = None
            async with aiohttp.ClientSession() as session:
                s3 = S3Client(session, port, kid, secret)
                st, _b, _h = await s3.req("PUT", "/rbdbkt")
                assert st == 200, st
                for i in range(REBUILD_PHASE_OBJS):
                    size = int(rng.integers(REBUILD_PHASE_OBJ_MIN,
                                            REBUILD_PHASE_OBJ_MAX))
                    body = rng.integers(0, 256, size,
                                        dtype=np.uint8).tobytes()
                    st, _b, _h = await s3.req(
                        "PUT", f"/rbdbkt/o{i:03d}", body)
                    assert st == 200, st
                    bodies[f"o{i:03d}"] = body
                for g in garages:
                    if g.block_manager.ec_accumulator is not None:
                        await g.block_manager.ec_accumulator.drain()
                await asyncio.sleep(3.0)  # distributor indexing

                quiet = []
                for name, body in bodies.items():
                    tq = time.perf_counter()
                    st, got, _h = await s3.req("GET", f"/rbdbkt/{name}")
                    quiet.append(time.perf_counter() - tq)
                    assert st == 200 and got == body, name

                # --- coordinator ingress through the aggregation tree ---
                coord = garages[0]
                mgr = coord.block_manager
                samples = _parity_samples(coord, REBUILD_PHASE_SAMPLES)
                assert samples, "no parity-index entries on coordinator"
                planner = mgr.repair_planner
                assert planner is not None and planner.use_tree
                t0b = mgr.repair_fetch_bytes.get("tree", 0)
                repaired = 0
                for ent in samples:
                    got = await planner.reconstruct(
                        Hash(bytes(ent.member)), ent)
                    assert got is not None, "tree reconstruction failed"
                    repaired += len(got)
                tree_bytes = mgr.repair_fetch_bytes.get("tree", 0) - t0b
                ratios[k] = tree_bytes / max(1, repaired)
                out[f"rebuild_tree_plans_k{k}"] = planner.tree_plans
                out[f"rebuild_coord_ingress_per_byte_k{k}"] = round(
                    ratios[k], 3)

                # --- the storm: heaviest node crashed + dropped ---------
                inj = FaultInjector(garages)
                _victim, lost, survivors = await crash_heaviest_and_drop(
                    inj)
                storm, client_errors = [], 0
                pending = dict(bodies)
                deadline = time.perf_counter() + 420
                while pending and time.perf_counter() < deadline:
                    for name in list(pending):
                        tq = time.perf_counter()
                        try:
                            st, got, _h = await asyncio.wait_for(
                                s3.req("GET", f"/rbdbkt/{name}"), 60)
                        except Exception:
                            # a client-visible failure is what this counts
                            client_errors += 1
                            continue
                        storm.append(time.perf_counter() - tq)
                        if st == 200 and got == bodies[name]:
                            del pending[name]
                        else:
                            client_errors += 1
                    if pending:
                        await asyncio.sleep(1.0)
                # bounded wait: every survivor's rebuild scheduler done
                scheds = [g.rebuild_scheduler for g in survivors]
                sched_by = time.monotonic() + 120
                while time.monotonic() < sched_by:
                    if all(s.idle() for s in scheds):
                        break
                    await asyncio.sleep(0.5)
                episodes = [s for s in scheds if s.partitions_total]
                out[f"rebuild_get_p99_quiet_ms_k{k}"] = _p99_ms(quiet)
                out[f"rebuild_get_p99_storm_ms_k{k}"] = _p99_ms(storm)
                out[f"rebuild_unhealed_k{k}"] = len(pending)
                out[f"rebuild_client_errors_k{k}"] = client_errors
                out[f"rebuild_lost_mib_k{k}"] = round(lost / 2**20, 1)
                out[f"rebuild_sched_partitions_k{k}"] = (
                    f"{sum(s.partitions_done for s in episodes)}"
                    f"/{sum(s.partitions_total for s in episodes)}")
                out[f"rebuild_sched_blocks_k{k}"] = sum(
                    s.blocks_healed for s in episodes)
                out[f"rebuild_sched_paced_k{k}"] = sum(
                    s.paced_sleeps for s in episodes)
            await server.stop()
            for i, g in enumerate(inj.garages if inj else garages):
                if inj is None or i not in inj.dead:
                    await g.shutdown()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    # coordinator ingress per repaired byte is FLAT in k: one row-sized
    # aggregated stream (ratio ~1) at every k
    out["rebuild_ingress_flat_in_k"] = bool(
        all(r <= 1.25 for r in ratios.values()))
    return out


def _rig_device(params, device: str, link_gibs: float):
    """(device codec, its bytes-level counts): a CudaCodec on the card, or
    the synthetic link on the CPU (which counts itself)."""
    synthetic = device == "cpu"
    dev = device_codec(params, synthetic, link_gibs=link_gibs,
                       compute_real=True)
    return dev, (dev if synthetic else BytesLevel(dev))


async def _transport_phase_async(device="cuda") -> dict:
    """Paired A/B for the zero-copy device transport: the SAME workload —
    scrub batches (bg) + foreground hash windows riding one CodecFeeder —
    once over the legacy bytes-level route (transport=False) and once over
    the DeviceTransport staging path, windows alternating old/new.
    Reports link GiB/s for both, host copies per staged block, the
    per-side byte attribution and `sustained_tpu_frac`."""
    from ..ops.codec import CodecParams
    from ..ops.feeder import CodecFeeder
    from ..ops.hybrid_codec import HybridCodec
    from ..utils.data import Hash

    blk = DEVICE_PHASE_BLOCK
    n_scrub, scrub_blocks = 4, 2 * K
    n_hash, hash_blocks = 8, 4
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (scrub_blocks, blk), dtype=np.uint8)

    def mk_rig(transport: bool):
        params = CodecParams(rs_data=K, rs_parity=M, block_size=blk,
                             transport=transport)
        dev, counts = _rig_device(params, device, link_gibs=0.3)
        hy = HybridCodec(params, device_codec=dev)
        hy._probe_link()            # cache the open-gate verdict
        feeder = CodecFeeder(hy, slo_ms=1.0, max_batch_blocks=512)
        return params, counts, hy, feeder

    def window(counts, hy, feeder) -> float:
        blocks = [base[i % scrub_blocks].tobytes()
                  for i in range(scrub_blocks)]
        hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest())
                  for b in blocks]
        t0 = time.perf_counter()
        futs = [feeder.submit_scrub(blocks, hashes, want_parity=True)
                for _ in range(n_scrub)]
        futs += [feeder.submit_hash(blocks[:hash_blocks], peers=1)
                 for _ in range(n_hash)]
        for f in futs:
            r = f.result(timeout=300)
            if isinstance(r, tuple):
                assert r[0].all(), "corruption reported in clean batch"
        return time.perf_counter() - t0

    rigs = {"old": mk_rig(False), "new": mk_rig(True)}
    assert rigs["old"][2].transport is None
    assert rigs["new"][2].transport is not None, "transport not armed"
    times = {"old": 0.0, "new": 0.0}
    for tag in ("old", "new"):        # warm (kernels, pools, caches)
        window(*rigs[tag][1:])
    rounds = 3
    for _ in range(rounds):           # paired windows cancel host drift
        for tag in ("old", "new"):
            times[tag] += window(*rigs[tag][1:])
    total_bytes = rounds * (n_scrub * scrub_blocks
                            + n_hash * hash_blocks) * blk
    _p_old, dev_old, hy_old, feeder_old = rigs["old"]
    _p_new, dev_new, hy_new, feeder_new = rigs["new"]
    tr = hy_new.transport
    link_new = tr.probe_link(16 << 20)
    frac = hy_new.obs.tpu_frac()
    by_side = dict(hy_new.obs.bytes_total)
    old_blocks = max(dev_old.blocks_submitted, 1)
    out = {
        "transport_old_gibs": round(total_bytes / times["old"] / 2**30, 4),
        "transport_new_gibs": round(total_bytes / times["new"] / 2**30, 4),
        "transport_speedup": round(times["old"] / times["new"], 3),
        "transport_old_copies_per_block": round(
            dev_old.host_copies / old_blocks, 2),
        "transport_new_copies_per_block": round(tr.copies_per_block(), 4),
        "transport_link_gibs": round(link_new, 4),
        # the old route's link: the synthetic constant on the CPU, the
        # bytes-level path's (cached) probe on the card
        "transport_old_link_gibs": 0.3 if device == "cpu" else round(
            hy_old._probe_link(), 4),
        "sustained_tpu_frac": round(frac, 4),
        "transport_bytes_by_side": by_side,
        "transport_stats": tr.stats(),
        "transport_old_bytes_level_submissions": dev_old.submissions,
        "transport_new_bytes_level_submissions": dev_new.submissions,
    }
    assert frac > 0.0, "gate failed to open through the transport"
    assert tr.copies_per_block() <= 1.0, tr.stats()
    assert dev_new.submissions == 0, \
        "new path leaked a bytes-level device submission"
    for feeder in (feeder_old, feeder_new):
        feeder.shutdown()
    hy_new.close()
    return out


async def _pool_phase_async(device="cuda") -> dict:
    """Warm/cold scrub A/B for the device-resident block pool: the SAME
    working set scrubbed through the feeder + transport, once with the
    pool DISABLED (pool_mib=0: every window re-pays the link) and once
    armed (after one untimed adoption pass every window is a pure hit),
    windows alternating.  Reports GiB/s both ways, the link bytes each
    side moved (warm must be 0), the hit/miss attribution identity and
    the warm rig's per-stage link ledger.  Acceptance: warm >= 2x cold."""
    from ..ops.codec import CodecParams
    from ..ops.feeder import CodecFeeder
    from ..ops.hybrid_codec import HybridCodec
    from ..utils.data import Hash

    blk = DEVICE_PHASE_BLOCK
    n_scrub, scrub_blocks = 4, 2 * K
    rng = np.random.default_rng(18)
    base = rng.integers(0, 256, (scrub_blocks, blk), dtype=np.uint8)
    blocks = [base[i].tobytes() for i in range(scrub_blocks)]
    hashes = [Hash(hashlib.blake2s(b, digest_size=32).digest())
              for b in blocks]

    def mk_rig(pool_mib: int):
        params = CodecParams(rs_data=K, rs_parity=M, block_size=blk,
                             pool_mib=pool_mib, pool_page_kib=256)
        # the synthetic link is slower than --transport-phase's, so the
        # cold side is link-bound on the CPU; on the card the link is
        # the card's own
        dev, _counts = _rig_device(params, device, link_gibs=0.1)
        hy = HybridCodec(params, device_codec=dev)
        hy._probe_link()            # cache the open-gate verdict
        feeder = CodecFeeder(hy, slo_ms=1.0, max_batch_blocks=512)
        return dev, hy, feeder

    def window(feeder) -> float:
        t0 = time.perf_counter()
        futs = [feeder.submit_scrub(blocks, hashes, want_parity=True)
                for _ in range(n_scrub)]
        for f in futs:
            ok, _par = f.result(timeout=300)
            assert ok.all(), "corruption reported in clean batch"
        return time.perf_counter() - t0

    rigs = {"cold": mk_rig(0), "warm": mk_rig(64)}
    assert rigs["cold"][1].pool is None
    assert rigs["warm"][1].pool is not None, "pool not armed"
    for tag in ("cold", "warm"):      # warm-up: kernels, pools, caches —
        window(rigs[tag][2])          # and the pool's adoption pass
    staged0 = {tag: rigs[tag][1].transport.staged_bytes
               for tag in ("cold", "warm")}
    times = {"cold": 0.0, "warm": 0.0}
    rounds = 3
    for _ in range(rounds):           # paired windows cancel host drift
        for tag in ("cold", "warm"):
            times[tag] += window(rigs[tag][2])
    total_bytes = rounds * n_scrub * scrub_blocks * blk
    link_bytes = {tag: rigs[tag][1].transport.staged_bytes - staged0[tag]
                  for tag in ("cold", "warm")}
    hy_warm = rigs["warm"][1]
    pstats = hy_warm.pool.stats()
    prof = hy_warm.obs.link_profiler
    out = {
        "pool_cold_gibs": round(total_bytes / times["cold"] / 2**30, 4),
        "pool_warm_gibs": round(total_bytes / times["warm"] / 2**30, 4),
        "pool_warm_speedup": round(times["cold"] / times["warm"], 3),
        "pool_cold_link_bytes": link_bytes["cold"],
        "pool_warm_link_bytes": link_bytes["warm"],
        "pool_hit_bytes": pstats["hit_bytes"],
        "pool_miss_bytes": pstats["miss_bytes"],
        "pool_stats": pstats,
        "pool_link_stages": prof.summary() if prof is not None else None,
    }
    # the acceptance claims, asserted where the numbers are made: a warm
    # re-scrub moves zero link bytes and wins >= 2x
    assert link_bytes["warm"] == 0, \
        f"warm windows moved {link_bytes['warm']} link bytes"
    assert link_bytes["cold"] >= total_bytes, \
        "cold rig did not re-pay the link every window"
    assert pstats["hit_bytes"] + pstats["miss_bytes"] == \
        (rounds + 1) * n_scrub * scrub_blocks * blk, \
        "hit+miss does not attribute every scrubbed byte"
    assert out["pool_warm_speedup"] >= 2.0, \
        f"warm scrub only {out['pool_warm_speedup']}x cold (want >= 2x)"
    for tag in ("cold", "warm"):
        rigs[tag][2].shutdown()
        rigs[tag][1].close()
    return out
