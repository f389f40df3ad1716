"""The benchmark's robustness and scale phases.

The port of ``bench.py``'s overload, tenants, WAN, replay, rebalance and
metadata phases (``tools/bench.py`` runs each in its own process by its
flag):

  - ``--overload-phase``: goodput, admitted p99 and shed rate at 1x, 2x
    and 4x the gateway's admission capacity;
  - ``--tenants-phase``: Zipf well-behaved tenants against one abuser,
    base and abuse windows alternating over a 20 ms-RTT proxy;
  - ``--wan-phase``: Put/Get p50 in RTT units at 100 ms RTT;
  - ``--replay-phase``: a seeded trace through a 2-gateway pool over the
    WAN matrix, one gateway killed mid-window;
  - ``--rebalance-phase``: one zone drained at each mover rate under GET
    sampling;
  - ``--metadata-phase``: 1M objects through the table engine, the
    Merkle, listing and sync A/Bs and the counters after churn.

Every node's codec is built on the card (``"backend": "cuda"`` through
``testing/cluster.mk_cluster``, ``SimCluster(..., device=)``); only the
tests pass ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import os
import time
import traceback

import numpy as np

from ..testing.cluster import mk_cluster
from ..testing.s3_client import S3Client
from .bench_api import CARD_CODEC, _phase_critical_path, _phase_slo_report, \
    _tmpdir

WAN_RTT_MS = 100.0
WAN_PUTS = 16
TENANTS_WELL = 8          # well-behaved tenants (acceptance: N >= 8)
TENANTS_CAP = 8           # [api] max_inflight on the gateway
TENANTS_ROUNDS = 3        # base/abuse window pairs (order flips per pair)
TENANTS_WINDOW_SECS = 4.0
TENANTS_RAMP_SECS = 1.0   # excluded from each window's p99: the worker
                          # (re)start / connection storm is a client-side
                          # transient, not steady-state (un)fairness
OVERLOAD_LEVEL_SECS = 6.0
OVERLOAD_OBJ = 64 << 10   # each overload PUT's payload
TENANTS_OBJ = 8 << 10     # each tenant PUT's payload
REPLAY_SECS = 12.0
# the low rate sits BELOW the mover's effective per-push throughput
# ceiling, so pacing visibly binds at one end of the sweep
REBALANCE_RATES_MIB = (1.0, 64.0)
REBALANCE_BUDGET_P99_MS = 500.0
REBALANCE_OBJS = 64
REBALANCE_OBJ_KIB = 512
REBALANCE_DRAIN_S = 120.0
META_OBJECTS = int(os.environ.get("GARAGE_BENCH_META_OBJECTS", "1000000"))
META_SYNC_OBJECTS = int(
    os.environ.get("GARAGE_BENCH_META_SYNC_OBJECTS", "20000"))
META_AB_WINDOW = 2000       # items per paired Merkle A/B drain window
META_LIST_ROUNDS = 6        # alternating serial/sharded listing windows
# replication only: these phases measure admission and the metadata
# plane, not erasure coding
NO_EC = dict(CARD_CODEC, rs_data=0, rs_parity=0)


async def _overload_phase_async(device="cuda") -> dict:
    """Saturation baseline: goodput + foreground p99 + shed rate at
    1x/2x/4x the admission gate's capacity, on a 3-replica cluster whose
    gateway caps in-flight requests at a small watermark.  Offered load
    beyond capacity should turn into typed 503 SlowDown sheds, NOT into
    queueing: goodput holds near capacity and admitted p99 stays flat."""
    import shutil

    import aiohttp

    cap = 4          # [api] max_inflight on every node (gateway matters)
    tmp = _tmpdir("garage_tpu_torch_bench_ovl_")
    garages = server = None
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=3, repl="3", db="memory", codec_cfg=NO_EC,
            api_cfg={"max_inflight": cap, "governor_tau": 0.5},
            device=device)
        g0 = garages[0]
        rng = np.random.default_rng(23)
        payload = rng.integers(0, 256, OVERLOAD_OBJ, dtype=np.uint8).tobytes()
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/ovl")
            assert st == 200, st

            async def drive(mult: int) -> dict:
                lats, shed, errs = [], 0, 0
                seq = [0]
                deadline = time.monotonic() + OVERLOAD_LEVEL_SECS

                async def worker():
                    nonlocal shed, errs
                    while time.monotonic() < deadline:
                        seq[0] += 1
                        name = f"x{mult}-{seq[0]:06d}"
                        t0 = time.perf_counter()
                        try:
                            st, _b, _h = await asyncio.wait_for(
                                s3.req("PUT", f"/ovl/{name}", payload), 30.0)
                        except Exception:  # noqa: BLE001 — hang/transport
                            # counted: errors are part of the ladder
                            errs += 1
                            continue
                        took = time.perf_counter() - t0
                        if st == 200:
                            lats.append(took)
                        elif st == 503:
                            shed += 1
                            await asyncio.sleep(0.02)
                        else:
                            errs += 1

                t_run0 = time.monotonic()
                await asyncio.gather(
                    *[worker() for _ in range(mult * cap)])
                dt = time.monotonic() - t_run0
                lats.sort()
                offered = len(lats) + shed + errs
                return {
                    "offered_x": mult,
                    "goodput_puts_s": round(len(lats) / dt, 2),
                    "offered_puts_s": round(offered / dt, 2),
                    "p50_ms": round(
                        lats[len(lats) // 2] * 1000, 2) if lats else None,
                    "p99_ms": round(
                        lats[min(len(lats) - 1, int(len(lats) * 0.99))]
                        * 1000, 2) if lats else None,
                    "shed": shed,
                    "shed_rate": round(shed / max(offered, 1), 4),
                    "errors": errs,
                    "throttle_ratio": round(g0.governor.ratio(), 3),
                }

            levels = [await drive(m) for m in (1, 2, 4)]
        gate = g0.admission.stats()
        return {"overload": {
            "max_inflight": cap,
            "levels": levels,
            "admitted_total": gate["admitted_total"],
            "shed_total": gate["shed_total"],
        }, **_phase_critical_path(garages, "overload")}
    finally:
        try:
            if server is not None:
                await server.stop()
            for g in garages or ():
                await g.shutdown()
        except Exception:
            # a teardown failure must not mask the phase's own result or
            # exception; it is printed
            traceback.print_exc()
        shutil.rmtree(tmp, ignore_errors=True)


async def _tenants_phase_async(device="cuda") -> dict:
    """Zipf many-tenant fairness: one abusive tenant drives >= 4x its fair
    share of the gateway's admission capacity against TENANTS_WELL
    well-behaved tenants whose request rates follow a Zipf distribution.
    The WDRR admission gate must isolate the abuse: zero well-behaved
    requests shed or errored, well-behaved p99 under abuse within 2x the
    no-abuser baseline (floored at 25 ms), the abuser's excess shed TYPED
    (503 SlowDown + Retry-After + RequestId).  Inter-node links ride a
    20 ms-RTT latency proxy; base and abuse windows alternate."""
    import shutil
    import statistics

    import aiohttp

    from ..testing.sim_cluster import check_typed_shed, make_tenant_client, \
        p99

    tmp = _tmpdir("garage_tpu_torch_bench_ten_")
    proxies = []
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=3, repl="3", db="memory", codec_cfg=NO_EC,
            api_cfg={"max_inflight": TENANTS_CAP, "governor_tau": 0.5,
                     "tenant_queue_wait": 2.0,
                     # CoDel target ABOVE this rig's natural p99, so the
                     # adaptive limit reacts to real collapse only
                     "codel_target": 5.0},
            wan_delay=0.01, proxies_out=proxies, device=device)
        g0 = garages[0]
        rng = np.random.default_rng(29)
        out: dict = {"capacity": TENANTS_CAP, "well_tenants": TENANTS_WELL,
                     "errors": 0}
        async with aiohttp.ClientSession() as session:
            well = [await make_tenant_client(g0, session, port,
                                             f"well{i}", f"t-well{i}")
                    for i in range(TENANTS_WELL)]
            abuser = await make_tenant_client(g0, session, port,
                                              "abuser", "t-abuser")
            # warm every tenant's path (key/bucket caches, db)
            for i, s3 in enumerate(well):
                await s3.req("PUT", f"/t-well{i}/warm", b"w" * 1024)

            # Zipf(1.1) request rates across the well-behaved tenants:
            # rank-i tenant paces sleep ~ i^1.1 (rank 1 hottest)
            pace = [0.015 * (i + 1) ** 1.1 for i in range(TENANTS_WELL)]

            async def well_loop(idx: int, s3, lats: list,
                                sheds: list, deadline: float) -> None:
                i = 0
                while time.monotonic() < deadline:
                    i += 1
                    body = rng.integers(
                        0, 256, TENANTS_OBJ, dtype=np.uint8).tobytes()
                    t0 = time.monotonic()
                    try:
                        st, _b, _h = await asyncio.wait_for(s3.req(
                            "PUT", f"/t-well{idx}/o-{i:05d}", body), 30.0)
                    except Exception:  # noqa: BLE001
                        # counted, and asserted zero below
                        out["errors"] += 1
                        continue
                    lats.append((t0, time.monotonic() - t0))
                    if st == 503:
                        sheds.append(f"well{idx}-{i}")
                    elif st != 200:
                        out["errors"] += 1
                    await asyncio.sleep(pace[idx])

            async def abuse_loop(conc: int, shed: list, untyped: list,
                                 deadline: float) -> None:
                seq = [0]

                async def worker(stagger: float) -> None:
                    await asyncio.sleep(stagger)
                    while time.monotonic() < deadline:
                        seq[0] += 1
                        body = rng.integers(
                            0, 256, TENANTS_OBJ, dtype=np.uint8).tobytes()
                        try:
                            st, rb, hdrs = await asyncio.wait_for(
                                abuser.req("PUT",
                                           f"/t-abuser/a-{seq[0]:06d}",
                                           body), 30.0)
                        except Exception:  # noqa: BLE001
                            # counted, and asserted empty below
                            untyped.append("transport")
                            continue
                        if st == 503:
                            bad = check_typed_shed(rb, hdrs,
                                                   codes=("SlowDown",))
                            if bad is not None:
                                untyped.append(bad)
                            else:
                                shed.append(seq[0])
                            # minimally-behaved backoff: offered load stays
                            # several x the fair share without a shed spin
                            await asyncio.sleep(0.05)
                        elif st != 200:
                            untyped.append(f"HTTP {st}")

                await asyncio.gather(
                    *[worker(i * 0.05) for i in range(conc)])

            # alternating windows: "base" = the Zipf well-behaved mix
            # alone; "abuse" = same mix + one tenant at 3/4 of the WHOLE
            # gate's capacity in concurrent closed-loop workers
            windows = {"base": [], "abuse": []}   # per-window sample lists
            sheds = {"base": [], "abuse": []}
            abuser_shed: list = []
            abuser_untyped: list = []

            async def window(mode: str) -> None:
                t0 = time.monotonic()
                deadline = t0 + TENANTS_WINDOW_SECS
                wl: list = []
                tasks = [well_loop(i, s3, wl, sheds[mode], deadline)
                         for i, s3 in enumerate(well)]
                if mode == "abuse":
                    tasks.append(abuse_loop(
                        (3 * TENANTS_CAP) // 4, abuser_shed,
                        abuser_untyped, deadline))
                await asyncio.gather(*tasks)
                # steady state only: drop each window's ramp
                windows[mode].append(
                    [d for ts, d in wl if ts >= t0 + TENANTS_RAMP_SECS])

            for rnd in range(TENANTS_ROUNDS):
                order = ("base", "abuse") if rnd % 2 == 0 \
                    else ("abuse", "base")
                for mode in order:
                    await window(mode)

        gate = g0.admission.stats()

        def window_p99_ms(mode: str) -> float:
            # MEDIAN of per-window p99s: one window polluted by an
            # external stall cannot masquerade as unfairness
            vals = [p99(w) for w in windows[mode] if w]
            return round(statistics.median(vals) * 1000, 2) if vals else 0.0

        base_p99 = window_p99_ms("base")
        abuse_p99 = window_p99_ms("abuse")
        bound = 2 * max(base_p99, 25.0)
        out.update({
            "well_p99_base_ms": base_p99,
            "well_p99_abuse_ms": abuse_p99,
            "well_p99_bound_ms": bound,
            "well_p99_held": abuse_p99 <= bound,
            "well_ops_base": sum(len(w) for w in windows["base"]),
            "well_ops_abuse": sum(len(w) for w in windows["abuse"]),
            "well_sheds": len(sheds["base"]) + len(sheds["abuse"]),
            "abuser_sheds": len(abuser_shed),
            "abuser_untyped": abuser_untyped[:4],
            "admission": {k: gate[k] for k in (
                "admitted_total", "shed_total", "effective_limit")},
        })
        assert out["well_sheds"] == 0, \
            f"well-behaved tenants were shed: {out}"
        assert len(abuser_shed) > 0, f"abuser never shed: {out}"
        assert not abuser_untyped, f"untyped abuser rejects: {out}"
        assert out["well_p99_held"], \
            f"well-behaved p99 broke its bound: {out}"
        assert out["errors"] == 0, out
        cp = _phase_critical_path(garages, "tenants")
        await server.stop()
        for g in garages:
            await g.shutdown()
        return {"tenants": out, **cp}
    finally:
        for p in proxies:
            await p.stop()
        shutil.rmtree(tmp, ignore_errors=True)


async def _wan_phase_async(device="cuda") -> dict:
    """The reference's headline benchmark shape (ref doc/book/design/
    benchmarks/index.md:20-62: mknet 100 ms RTT between zones): a 3-node
    3-replica cluster whose inter-node links run through the LatencyProxy
    at 100 ms RTT; S3 Put/Get p50 in RTT units (the reference claims
    about 1.4 RTT writes and 1 RTT reads)."""
    import shutil

    import aiohttp

    tmp = _tmpdir("garage_tpu_torch_bench_wan_")
    proxies = []
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=3, repl="3", db="sqlite", codec_cfg=CARD_CODEC,
            wan_delay=WAN_RTT_MS / 2000.0, proxies_out=proxies,
            device=device)
        rng = np.random.default_rng(7)
        put_lat, get_lat = [], []
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            st, _b, _h = await s3.req("PUT", "/wanbkt")
            assert st == 200, st
            # small objects (inline path): block streaming would measure
            # bandwidth, not round trips
            await s3.req("PUT", "/wanbkt/warm", b"w" * 1000)
            for i in range(WAN_PUTS):
                body = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
                t0 = time.perf_counter()
                st, _b, _h = await s3.req("PUT", f"/wanbkt/o{i:03d}", body)
                put_lat.append((time.perf_counter() - t0) * 1000)
                assert st == 200, st
                t0 = time.perf_counter()
                st, got, _h = await s3.req("GET", f"/wanbkt/o{i:03d}")
                get_lat.append((time.perf_counter() - t0) * 1000)
                assert st == 200 and got == body
        put_lat.sort()
        get_lat.sort()
        p50p = put_lat[len(put_lat) // 2]
        p50g = get_lat[len(get_lat) // 2]
        out = {
            "wan_rtt_ms": WAN_RTT_MS,
            "wan_put_p50_ms": round(p50p, 1),
            "wan_get_p50_ms": round(p50g, 1),
            "wan_put_p50_rtt": round(p50p / WAN_RTT_MS, 2),
            "wan_get_p50_rtt": round(p50g / WAN_RTT_MS, 2),
        }
        out.update(_phase_critical_path(garages, "wan"))
        await server.stop()
        for g in garages:
            await g.shutdown()
        return out
    finally:
        for p in proxies:
            await p.stop()
        shutil.rmtree(tmp, ignore_errors=True)


async def _replay_phase_async(device="cuda") -> dict:
    """Production-shaped survival: a seeded deterministic workload trace
    (Zipf keys, size mixture, diurnal pacing — testing/replay.py) replayed
    through a 2-gateway GatewayPool over the WAN_3ZONE_RTT latency matrix,
    with one gateway KILLED mid-window.  Asserts the trace reproduces, zero
    client errors and zero acked-data loss through the kill, and embeds
    the merged SLO report with availability budgets intact."""
    import shutil

    import aiohttp

    from ..testing.faults import FAST_CHAOS_HEALTH
    from ..testing.gateway_pool import GatewayPool
    from ..testing.replay import (ReplayConfig, Replayer, generate_ops,
                                  trace_signature)
    from ..testing.sim_cluster import SimCluster

    tmp = _tmpdir("garage_tpu_torch_bench_rply_")
    cluster = SimCluster(tmp, n_storage=6, n_zones=3, repl="3",
                         zone_redundancy="maximum", n_gateways=2,
                         extra_cfg={"health": dict(FAST_CHAOS_HEALTH)},
                         device=device)
    try:
        await cluster.start()
        cluster.apply_wan()
        await cluster.tick(rounds=3)
        cfg = ReplayConfig(seed=19, n_keys=64, base_ops_per_s=12.0,
                           duration_s=REPLAY_SECS, size_preset="small")
        sig = trace_signature(generate_ops(cfg))
        out = {
            "replay_trace_signature": sig,
            "replay_deterministic": sig == trace_signature(
                generate_ops(cfg)),
        }
        async with aiohttp.ClientSession() as session:
            pool = GatewayPool(
                session, cluster.gateway_endpoints(), cluster.key_id,
                cluster.secret,
                metrics=cluster.garages[0].system.metrics)
            st, _b, _h = await pool.request("PUT", f"/{cfg.bucket}")
            assert st == 200, st
            rp = Replayer(cfg, pool)
            kill_at = len(rp.ops) // 2
            killed = [False]

            async def on_op(i: int, _at: float) -> None:
                if i == kill_at and not killed[0]:
                    killed[0] = True
                    await cluster.kill_gateway(1)

            stats = await rp.run(on_op=on_op)
            bad = await rp.verify_all()
        out.update({
            "replay_ops": len(rp.ops),
            "replay_kill_index": kill_at,
            "replay_gateway_killed": killed[0],
            "replay_stats": stats.summary(),
            "replay_verify_mismatches": bad,
            "replay_pool": dict(pool.counters),
            # the kill must INTERSECT live traffic, not merely remove an
            # idle sibling
            "replay_failover_exercised": pool.counters["failovers"] >= 1,
        })
        slo = _phase_slo_report(cluster.garages, "replay")
        out.update(slo)
        spent = [ep["availability"]["budget_spent"] for ep in
                 slo.get("replay_slo_report", {})
                 .get("endpoints", {}).values()]
        out["replay_availability_budget_ok"] = all(
            s < 1.0 for s in spent)
        assert out["replay_deterministic"], out
        assert killed[0], "the mid-window kill never fired"
        assert out["replay_failover_exercised"], dict(pool.counters)
        assert stats.errors == 0, stats.error_notes
        assert bad == 0, f"{bad} acked objects lost"
        assert out["replay_availability_budget_ok"], out
        await cluster.stop()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def _rebalance_one(rate: float, device="cuda") -> dict:
    """One sweep point: drain a whole zone at `rate` MiB/s mover budget
    while sampling client GET latency; report mover throughput, the
    governor's minimum background ratio, and whether the client p99
    held the fixed budget."""
    import shutil

    import aiohttp

    from ..testing.sim_cluster import SimCluster, p99

    tmp = _tmpdir("garage_tpu_torch_bench_rbl_")
    # default zone redundancy: the sweep measures the MOVER, not the
    # assignment solver
    cluster = SimCluster(tmp, n_storage=6, n_zones=3, repl="3",
                         rebalance_rate_mib=rate, device=device)
    try:
        await cluster.start(faults=False)
        rng = np.random.default_rng(int(rate))
        out: dict = {"rate_mib": rate, "errors": 0}
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, cluster.port, cluster.key_id,
                          cluster.secret, honor_retry_after=True,
                          retry_after_cap=0.5)
            # solve the post-drain layout NOW, while the cluster is idle:
            # the operator solves offline, the cluster only ever sees the
            # committed result
            drained = cluster.injector.nodes_in_zone("z3")

            def mutate(lay):
                for i in drained:
                    lay.stage_role(
                        bytes(cluster.garages[i].system.id), None)

            enc = await cluster.precompute_layout_change(mutate)

            st, _b, _h = await s3.req("PUT", "/rbl")
            assert st == 200, st
            bodies = {}
            for i in range(REBALANCE_OBJS):
                body = rng.integers(0, 256, REBALANCE_OBJ_KIB << 10,
                                    dtype=np.uint8).tobytes()
                st, _b, _h = await s3.req("PUT", f"/rbl/o{i:04d}", body)
                assert st == 200, st
                bodies[f"o{i:04d}"] = body

            # quiet the UNPACED resync queue (the refs-only layout sweep
            # feeds it): the paced mover must carry the drain
            for i in cluster.storage_indices():
                cluster.garages[i].block_resync.set_tranquility(30)
            # ALL storage movers: the drained zone's PUSH what they lose,
            # the remaining zones' FETCH what they gain
            movers = [cluster.garages[i].rebalance_mover
                      for i in cluster.storage_indices()]
            lats: list = []
            ratio_min = 1.0
            t0 = time.perf_counter()
            await cluster.apply_encoded_layout(enc)
            deadline = t0 + REBALANCE_DRAIN_S
            names = sorted(bodies)
            k = 0
            while time.perf_counter() < deadline:
                name = names[k % len(names)]
                k += 1
                tg = time.perf_counter()
                st, got, _h = await s3.req("GET", f"/rbl/{name}")
                lats.append(time.perf_counter() - tg)
                if st != 200 or got != bodies[name]:
                    out["errors"] += 1
                ratio_min = min(ratio_min, min(
                    cluster.garages[i].governor.ratio()
                    for i in cluster.storage_indices()
                    if i not in drained))
                if all(m.idle() for m in movers):
                    break
                await asyncio.sleep(0.05)
            drain_s = time.perf_counter() - t0
            moved = sum(m.bytes_moved for m in movers)
            out.update({
                "drain_s": round(drain_s, 2),
                "moved_mib": round(moved / 2**20, 1),
                "mover_mib_s": round(moved / drain_s / 2**20, 1),
                "governor_ratio_min": round(ratio_min, 3),
                "get_p99_ms": round(p99(lats) * 1000, 2),
                "get_ops": len(lats),
                "rebalance_complete": all(
                    m.idle() and m.partitions_done == m.partitions_total
                    for m in movers),
            })
            out["budget_ok"] = (
                out["get_p99_ms"] <= REBALANCE_BUDGET_P99_MS)
            # every seeded object still bit-identical post-drain
            bad = 0
            for name, body in sorted(bodies.items()):
                st, got, _h = await s3.req("GET", f"/rbl/{name}")
                if st != 200 or got != body:
                    bad += 1
            out["verify_mismatches"] = bad
        await cluster.stop()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


async def _rebalance_phase_async(device="cuda") -> dict:
    """Sweep rebalance_rate_mib against the governor under a fixed
    client-latency budget: for each rate, a fresh 6-node/3-zone cluster
    drains one zone under live GET sampling — the operator's
    rebalance-rate picking table."""
    sweep = []
    for rate in REBALANCE_RATES_MIB:
        sweep.append(await _rebalance_one(rate, device=device))
    out = {
        "rebalance_budget_p99_ms": REBALANCE_BUDGET_P99_MS,
        "rebalance_sweep": sweep,
        "rebalance_budget_rates": [
            s["rate_mib"] for s in sweep if s["budget_ok"]],
    }
    for s in sweep:
        assert s["rebalance_complete"], s
        assert s["moved_mib"] > 0, s  # a zero-byte sweep measured nothing
        assert s["errors"] == 0 and s["verify_mismatches"] == 0, s
    return out


# --- metadata plane at millions of objects ---------------------------------
#
# Drives the CRDT table engine at production cardinality: 1M objects
# across 8 buckets loaded straight through the table update transaction,
# the batched Merkle updater draining live, paired serial/batched Merkle
# A/B, serial/sharded listing p50/p99 at three prefixes, batched
# anti-entropy convergence of a cold diverged pair, and index-counter
# exactness after delete+reinsert churn.


def _meta_key(i: int) -> str:
    # 50 "directories" per bucket: the delimiter listing does real
    # common-prefix work and the prefix listing a multi-page walk
    return f"d{(i // 8) % 50:02d}/obj{i:07d}"


def _meta_mk_object(bucket_id, key: str, ts: int):
    from ..model.s3.object_table import (Object, ObjectVersion,
                                         ObjectVersionData,
                                         ObjectVersionHeaders,
                                         ObjectVersionMeta)
    from ..utils.data import gen_uuid

    meta = ObjectVersionMeta.new(ObjectVersionHeaders.new(), 0, "etag")
    v = ObjectVersion(gen_uuid(), ts,
                      ["complete", ObjectVersionData.inline(meta, b"")])
    return Object(bucket_id, key, [v])


async def _meta_listing_ab(s3, garages, bucket: str) -> dict:
    """Paired serial (list_shards=1) vs sharded listing latencies at
    three prefixes: bucket root (one full page), one directory walked to
    completion (multi-page), delimiter aggregation at the root."""

    async def walk(query_base):
        lats = []
        token = None
        while True:
            q = [("list-type", "2")] + list(query_base)
            if token is not None:
                q.append(("continuation-token", token))
            t0 = time.perf_counter()
            st, body, _h = await s3.req("GET", f"/{bucket}", query=q)
            lats.append((time.perf_counter() - t0) * 1000.0)
            assert st == 200, body[:300]
            tok = body.split(b"<NextContinuationToken>")
            token = (tok[1].split(b"<")[0].decode()
                     if len(tok) > 1 else None)
            if token is None:
                return lats

    cases = {
        "root_page": [("max-keys", "1000")],
        "dir_walk": [("prefix", "d07/"), ("max-keys", "1000")],
        "delimiter": [("delimiter", "/"), ("max-keys", "1000")],
    }
    lat = {name: {"serial": [], "sharded": []} for name in cases}
    for _round in range(META_LIST_ROUNDS):
        for mode, shards in (("serial", 1), ("sharded", 4)):
            for g in garages:
                g.config.table.list_shards = shards
            for name, qb in cases.items():
                lat[name][mode] += await walk(qb)
    for g in garages:
        g.config.table.list_shards = 4

    def pct(xs, p):
        xs = sorted(xs)
        return round(xs[min(len(xs) - 1, int(len(xs) * p))], 2)

    out = {}
    for name, modes in lat.items():
        for mode, xs in modes.items():
            out[f"{name}_{mode}_p50_ms"] = pct(xs, 0.50)
            out[f"{name}_{mode}_p99_ms"] = pct(xs, 0.99)
    return out


def _meta_merkle_ab(system) -> dict:
    """Offline paired A/B on bare tables (no live workers): identical
    churn sets drained in alternating serial/batched windows; trees must
    come out bit-identical."""
    from ..db import open_db
    from ..model.index_counter import CounterEntry, counter_table_schema
    from ..rpc.replication_mode import parse_replication_mode
    from ..table import Table, TableShardedReplication

    m = parse_replication_mode("1")

    def mk():
        repl = TableShardedReplication(
            system, m.replication_factor, m.read_quorum, m.write_quorum)
        return Table(system, counter_table_schema("bench_meta_ab"),
                     repl, open_db("memory"))

    ta, tb = mk(), mk()
    n = META_AB_WINDOW * 6
    for i in range(n):
        e = CounterEntry(b"%032d" % (i % 997), f"s{i:06d}",
                         {"objects": {b"n0": [i, i]}})
        enc = e.encode()
        ta.data.update_entry(enc)
        tb.data.update_entry(enc)

    def drain_window(t, batched: bool, limit: int) -> float:
        t0 = time.perf_counter()
        done = 0
        while done < limit:
            items = t.data.merkle_todo.range_scan(
                limit=min(256, limit - done))
            if not items:
                break
            if batched:
                done += t.merkle.update_batch(items)
            else:
                for k, _tv in items:
                    t.merkle.update_item(k)
                done += len(items)
        return time.perf_counter() - t0

    serial_s = batched_s = 0.0
    for _ in range(3):  # alternating paired windows cancel host drift
        serial_s += drain_window(ta, False, META_AB_WINDOW)
        batched_s += drain_window(tb, True, META_AB_WINDOW)
    # drain remainders fully, then compare the whole trees
    drain_window(ta, False, n)
    drain_window(tb, True, n)
    ident = (dict(ta.data.merkle_tree.items())
             == dict(tb.data.merkle_tree.items()))
    per_window = 3 * META_AB_WINDOW
    return {
        "merkle_serial_items_per_s": round(per_window / serial_s, 1),
        "merkle_batched_items_per_s": round(per_window / batched_s, 1),
        "merkle_batched_speedup": round(serial_s / batched_s, 3),
        "merkle_bit_identical": ident,
    }


async def _meta_sync_ab(tmp) -> dict:
    """Cold-node convergence: a 2-node pair diverged by META_SYNC_OBJECTS
    entries, synced per-node vs batched — same final roots, counted RPC
    rounds."""
    from ..db import open_db
    from ..model.index_counter import CounterEntry, counter_table_schema
    from ..rpc.layout import ClusterLayout, NodeRole
    from ..rpc.replication_mode import parse_replication_mode
    from ..rpc.system import System
    from ..table import Table, TableShardedReplication, TableSyncer
    from ..utils.config import config_from_dict

    async def mk_pair(tag):
        systems = []
        for i in range(2):
            cfg = config_from_dict({
                "metadata_dir": str(tmp / f"sync{tag}{i}" / "meta"),
                "data_dir": str(tmp / f"sync{tag}{i}" / "data"),
                "replication_mode": "2",
                "rpc_bind_addr": "127.0.0.1:0",
                "rpc_secret": "bench-meta",
                "bootstrap_peers": [],
            })
            s = System(cfg)
            await s.netapp.listen("127.0.0.1:0")
            systems.append(s)
        ports = [s.netapp._server.sockets[0].getsockname()[1]
                 for s in systems]
        await systems[0].netapp.connect(
            f"127.0.0.1:{ports[1]}", expected_id=systems[1].id)
        lay = systems[0].layout
        for s in systems:
            lay.stage_role(bytes(s.id), NodeRole("dc1", 1000))
        lay.apply_staged_changes()
        enc = lay.encode()
        m = parse_replication_mode("2")
        tables, syncers = [], []
        for s in systems:
            s.layout = ClusterLayout.decode(enc)
            s._rebuild_ring()
            repl = TableShardedReplication(
                s, m.replication_factor, m.read_quorum, m.write_quorum)
            t = Table(s, counter_table_schema("bench_meta_sync"), repl,
                      open_db("memory"))
            tables.append(t)
            syncers.append(TableSyncer(s, t.data, t.merkle))
        # diverge: node 0 holds everything, node 1 is the cold joiner
        for i in range(META_SYNC_OBJECTS):
            tables[0].data.update_entry(CounterEntry(
                b"%032d" % (i % 997), f"s{i:06d}",
                {"objects": {b"n0": [i, i]}}).encode())
        for t in tables:
            while True:
                items = t.data.merkle_todo.range_scan(limit=512)
                if not items:
                    break
                t.merkle.update_batch(items)
        return systems, tables, syncers

    async def converge(tables, syncers):
        t0 = time.perf_counter()
        for part, fh in tables[0].replication.partitions():
            await syncers[0].sync_partition(part, fh)
        wall = time.perf_counter() - t0
        for t in tables:
            while True:
                items = t.data.merkle_todo.range_scan(limit=512)
                if not items:
                    break
                t.merkle.update_batch(items)
        roots = set()
        for part, _fh in tables[0].replication.partitions():
            for t in tables:
                roots.add((part,
                           bytes(t.merkle.partition_root_hash(part))))
        # one root tuple per partition == both nodes agree everywhere
        agreed = len(roots) == len(tables[0].replication.partitions())
        return wall, agreed

    out = {}
    stores = []
    for mode, batch in (("pernode", 1), ("batched", 0)):
        systems, tables, syncers = await mk_pair(mode)
        if batch:
            for s in syncers:
                s.sync_batch_nodes = 1
        wall, agreed = await converge(tables, syncers)
        out[f"sync_{mode}_s"] = round(wall, 2)
        out[f"sync_{mode}_rpc_rounds"] = syncers[0].node_rpcs
        out[f"sync_{mode}_roots_agree"] = agreed
        stores.append(dict(tables[1].data.store.items()))
        for s in systems:
            await s.netapp.shutdown()
    out["sync_objects"] = META_SYNC_OBJECTS
    out["sync_rpc_ratio"] = round(
        out["sync_pernode_rpc_rounds"]
        / max(1, out["sync_batched_rpc_rounds"]), 1)
    out["sync_stores_identical"] = stores[0] == stores[1]
    return out


async def _metadata_phase_async(device="cuda") -> dict:
    """--metadata-phase: the metadata plane at production cardinality."""
    import shutil

    import aiohttp

    tmp = _tmpdir("garage_tpu_torch_bench_meta_")
    try:
        garages, server, port, kid, secret = await mk_cluster(
            tmp, n=1, repl="none", codec_cfg=CARD_CODEC, db="native",
            device=device)
        g = garages[0]
        out = {"meta_objects": META_OBJECTS}
        async with aiohttp.ClientSession() as session:
            s3 = S3Client(session, port, kid, secret)
            buckets = [f"meta{b}" for b in range(8)]
            for b in buckets:
                st, _b, _h = await s3.req("PUT", f"/{b}")
                assert st == 200, st
            helper = g.helper()
            bucket_ids = [await helper.resolve_global_bucket_name(b)
                          for b in buckets]

            # --- load: straight through the table update transaction,
            # the Merkle worker draining live through the batched path
            def load(lo, hi):
                data = g.object_table.data
                for i in range(lo, hi):
                    data.update_entry(_meta_mk_object(
                        bucket_ids[i % 8], _meta_key(i),
                        1_000_000 + i).encode())

            t0 = time.perf_counter()
            await asyncio.to_thread(load, 0, META_OBJECTS)
            load_s = time.perf_counter() - t0
            while g.object_table.data.merkle_todo_len() > 0:
                await asyncio.sleep(0.2)
            pipeline_s = time.perf_counter() - t0
            out["meta_load_s"] = round(load_s, 1)
            out["meta_insert_per_s"] = round(META_OBJECTS / load_s, 1)
            out["meta_pipeline_objects_per_s"] = round(
                META_OBJECTS / pipeline_s, 1)
            out["meta_merkle_residual_drain_s"] = round(
                pipeline_s - load_s, 1)
            assert g.object_table.data.store_len() >= META_OBJECTS

            # --- paired Merkle A/B (offline tables, identical churn)
            out.update(_meta_merkle_ab(g.system))
            assert out["merkle_bit_identical"], "batched tree diverged"

            # --- listing p50/p99, serial vs sharded, three prefixes
            out.update(await _meta_listing_ab(s3, garages, "meta0"))

            # --- churn + counter exactness
            rng = np.random.default_rng(14)
            victims = sorted(
                int(i) * 8 for i in rng.choice(
                    META_OBJECTS // 8, size=min(2000, META_OBJECTS // 16),
                    replace=False))
            for i in victims:
                st, _b, _h = await s3.req(
                    "DELETE", f"/meta0/{_meta_key(i)}")
                assert st in (200, 204), st
            reinserted = victims[: len(victims) // 2]

            def reinsert():
                from ..utils.crdt import now_msec

                data = g.object_table.data
                # versions must postdate the S3 delete markers (stamped
                # now_msec) or the CRDT merge prunes them as stale
                ts0 = now_msec() + 60_000
                for j, i in enumerate(reinserted):
                    data.update_entry(_meta_mk_object(
                        bucket_ids[0], _meta_key(i), ts0 + j).encode())

            await asyncio.to_thread(reinsert)
            for _ in range(600):
                if (g.object_table.data.merkle_todo_len() == 0
                        and all(len(t.data.insert_queue) == 0
                                for t in g.tables)):
                    break
                await asyncio.sleep(0.1)

            # live rows in bucket 0, counted from the store itself
            def live_count(bucket_id) -> int:
                from ..table.schema import hash_partition_key

                data = g.object_table.data
                pfx = bytes(hash_partition_key(bucket_id))
                n = 0
                pos = pfx
                while True:
                    page = data.store.range_scan(pos, None, 4096)
                    for k, v in page:
                        if not k.startswith(pfx):
                            return n
                        if data.decode_entry(v).last_data_version() \
                                is not None:
                            n += 1
                    if len(page) < 4096:
                        return n
                    pos = page[-1][0] + b"\x00"

            expect0 = (META_OBJECTS + 7) // 8 - len(victims) \
                + len(reinserted)
            live0 = await asyncio.to_thread(live_count, bucket_ids[0])
            totals0 = await g.object_counter.get_totals(
                bytes(bucket_ids[0]))
            totals1 = await g.object_counter.get_totals(
                bytes(bucket_ids[1]))
            drift = sum(abs(t.data.merkle_todo.reconcile())
                        + abs(t.data.insert_queue.reconcile())
                        + abs(t.data.gc_todo.reconcile())
                        for t in g.tables)
            out["meta_churned"] = len(victims)
            out["meta_reinserted"] = len(reinserted)
            out["meta_bucket0_live"] = live0
            out["meta_bucket0_counter"] = totals0.get("objects", 0)
            out["meta_bucket1_counter"] = totals1.get("objects", 0)
            out["meta_counters_exact"] = (
                live0 == expect0 == totals0.get("objects", 0)
                and totals1.get("objects", 0) == (META_OBJECTS + 6) // 8)
            out["meta_counted_tree_drift"] = drift
            assert out["meta_counters_exact"], (
                live0, expect0, totals0, totals1)
            assert drift == 0, drift

        # --- cold-node sync convergence A/B (bare 2-node pairs)
        out.update(await _meta_sync_ab(tmp))
        assert out["sync_batched_roots_agree"] \
            and out["sync_pernode_roots_agree"]
        assert out["sync_stores_identical"]
        assert out["sync_rpc_ratio"] >= 10.0, out["sync_rpc_ratio"]

        # paired win-or-tie contract (generous noise slack; the
        # structural wins are multiples, not percents)
        assert out["merkle_batched_speedup"] >= 0.95, out
        for name in ("root_page", "dir_walk", "delimiter"):
            assert out[f"{name}_sharded_p50_ms"] <= \
                1.25 * out[f"{name}_serial_p50_ms"] + 2.0, (name, out)

        out.update(_phase_critical_path(garages, "meta"))
        await server.stop()
        for g2 in garages:
            await g2.shutdown()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
