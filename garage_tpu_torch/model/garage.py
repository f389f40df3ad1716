"""Garage — the god object wiring every subsystem of one node.

Equivalent of reference src/model/garage.rs:36-379 (SURVEY.md §2.6):
opens the metadata DB engine, builds `System` (membership/ring/rpc), the
three replication parameter sets (data: read quorum 1; meta: read+write
quorums; control: full copy — garage.rs:231-248), the BlockManager +
resync manager, and all replicated tables with their cross-table
`updated()` hooks (object → version → block_ref → rc), then spawns all
background workers (garage.rs:358-379).
"""

from __future__ import annotations

import asyncio
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..block.manager import BlockManager
from ..block.repair import RebalanceWorker, RepairWorker, ScrubWorker, ScrubWorkerState
from ..block.resync import (
    MAX_RESYNC_WORKERS,
    BlockResyncManager,
    ResyncPersistedConfig,
    ResyncWorker,
)
from ..db import Db, open_db
from ..rpc.replication_mode import parse_replication_mode
from ..rpc.system import System
from ..table import (
    InsertQueueWorker,
    MerkleWorker,
    Table,
    TableFullReplication,
    TableGc,
    TableShardedReplication,
    TableSyncer,
)
from ..utils.background import BackgroundRunner, BgVars
from ..utils.config import Config
from ..utils.persister import Persister
from .bucket_alias_table import BucketAliasTableSchema
from .bucket_table import BucketTableSchema
from .index_counter import IndexCounter, counter_table_schema
from .key_table import KeyTableSchema
from .s3.block_ref_table import BlockRefTableSchema
from .s3.mpu_table import MpuTableSchema
from .s3.object_table import ObjectTableSchema
from .s3.version_table import VersionTableSchema

logger = logging.getLogger("garage_tpu_torch.model.garage")


class Garage:
    """ref model/garage.rs:36-77.

    `device` is where the block codec runs (``config.codec.make``): the
    GPU by default, so ``Garage(config)`` raises on a host without one
    when ``codec.backend`` is cuda or hybrid.  ``device="cpu"`` runs the
    kernels' plain versions; it exists for the tests."""

    def __init__(self, config: Config, db: Optional[Db] = None,
                 device="cuda"):
        self.config = config
        self.replication_mode = parse_replication_mode(config.replication_mode)
        # Optional asymmetric durability (the erasure-coded storage
        # class): metadata tables keep replication_mode, while BLOCK
        # placement uses data_replication_mode — e.g. meta "3" + data
        # "none" + codec.parity_distribute stores 1× data + m/k parity
        # (1.5× total at RS(8,4)) yet survives the loss of any m
        # codeword nodes, where the reference can only trade whole
        # replicas (replication_mode.rs:41-56, 3× for 2-loss).
        self.data_replication_mode = (
            parse_replication_mode(config.data_replication_mode)
            if config.data_replication_mode else self.replication_mode
        )

        os.makedirs(config.metadata_dir, exist_ok=True)
        self._owns_db = db is None
        if db is not None:
            self.db = db
        else:
            is_native = config.db_engine in ("native", "logdb")
            is_memory = config.db_engine in ("memory", "mem")
            kw = ({"fsync": config.metadata_fsync}
                  if (is_native or is_memory) else {})
            # the memory engine is DURABLE when the daemon opens it
            # (snapshot + WAL under metadata_dir — the sled slot);
            # RAM-only remains available to tests via open_db("memory")
            # with no path
            fname = ("db.logdb" if is_native
                     else "db.mem" if is_memory else "db.sqlite")
            self.db = open_db(
                config.db_engine,
                path=os.path.join(config.metadata_dir, fname),
                **kw,
            )

        self.system = System(config, self.replication_mode)

        factor = self.replication_mode.replication_factor
        # ref garage.rs:231-248: data reads need only one copy (content-
        # addressed, self-verifying); metadata reads/writes use quorums;
        # control tables (buckets/keys/aliases) are fully replicated
        self.data_rep = TableShardedReplication(
            self.system,
            self.data_replication_mode.replication_factor,
            1,
            self.data_replication_mode.write_quorum,
        )
        self.meta_rep = TableShardedReplication(
            self.system,
            factor,
            self.replication_mode.read_quorum,
            self.replication_mode.write_quorum,
        )
        self.control_rep = TableFullReplication(self.system)

        try:
            codec = config.codec.make(
                config.compression_level,
                metrics=self.system.metrics,
                tracer=self.system.tracer,
                block_size=config.block_size,
                device=device,
            )
        except BaseException:
            # no node without its codec: release the db this call opened
            if self._owns_db:
                self.db.close()
            raise
        self.block_manager = BlockManager(
            config, self.db, self.system, self.data_rep, codec=codec
        )
        self.block_resync = BlockResyncManager(
            self.block_manager, self.db,
            persister=Persister(
                config.metadata_dir, "resync_cfg", ResyncPersistedConfig
            ),
        )
        self.block_manager.resync = self.block_resync
        # crash-consistency pass over the data dirs, AFTER resync is
        # attached (quarantined hashes re-enqueue through it): purge
        # orphaned .tmp files from torn writes, bound the .corrupted
        # quarantine (docs/ROBUSTNESS.md "Disk faults & degraded mode")
        self.block_manager.startup_janitor()
        if config.codec.store_parity and config.codec.rs_data > 0:
            from ..block.parity import ParityStore, WriteParityAccumulator

            self.block_manager.parity_store = ParityStore(
                self.block_manager, self.db, self.block_manager.codec
            )
            if config.codec.parity_on_write:
                # BASELINE config #3: RS encode on the PutObject path —
                # parity exists from first write, not from the first
                # scrub pass (encoding itself runs off the write path)
                self.block_manager.write_parity = WriteParityAccumulator(
                    self.block_manager.parity_store,
                    self.block_manager.codec,
                )

        # --- tables, wired bottom-up so hooks can reach lower tables ---
        self.bucket_table = Table(
            self.system, BucketTableSchema(), self.control_rep, self.db
        )
        self.bucket_alias_table = Table(
            self.system, BucketAliasTableSchema(), self.control_rep, self.db
        )
        self.key_table = Table(
            self.system, KeyTableSchema(), self.control_rep, self.db
        )

        self.object_counter_table = Table(
            self.system,
            counter_table_schema("bucket_object_counter"),
            self.meta_rep,
            self.db,
        )
        self.object_counter = IndexCounter(
            self.system, self.object_counter_table, self.db
        )
        self.mpu_counter_table = Table(
            self.system,
            counter_table_schema("bucket_mpu_counter"),
            self.meta_rep,
            self.db,
        )
        self.mpu_counter = IndexCounter(
            self.system, self.mpu_counter_table, self.db
        )

        block_ref_schema = BlockRefTableSchema(self.block_manager)
        self.block_ref_table = Table(
            self.system, block_ref_schema, self.meta_rep, self.db
        )

        # cross-node parity: index sharded by member hash at META
        # replication (the index must outlive data-node loss), parity
        # shards stored as ordinary ring-placed blocks
        from .parity_index_table import ParityIndexTableSchema

        self.parity_index_table = Table(
            self.system, ParityIndexTableSchema(self.block_ref_table),
            self.meta_rep, self.db,
        )
        if config.codec.parity_distribute and config.codec.rs_data > 0:
            from ..block.parity import (
                ParityDistributor,
                WriteParityAccumulator,
            )
            from .parity_repair import make_parity_reconstructor

            # writer-side accumulator: distinct-node codewords, parity
            # distributed cross-node (independent of the storing-side
            # local-sidecar accumulator above)
            self.block_manager.ec_accumulator = WriteParityAccumulator(
                None, self.block_manager.codec,
                distributor=ParityDistributor(
                    self.block_manager, self.parity_index_table
                ),
                manager=self.block_manager,
            )
            from .parity_repair import make_parity_gc

            self.block_manager.parity_reconstructor = (
                make_parity_reconstructor(self)
            )
            # GC rides the GLOBAL deletion signal (last live version-ref
            # tombstoned), never local/migration deletes
            block_ref_schema.on_ref_dropped = make_parity_gc(self)
            self._want_parity_sweeper = True

        version_schema = VersionTableSchema(self.block_ref_table)
        self.version_table = Table(
            self.system, version_schema, self.meta_rep, self.db
        )

        mpu_schema = MpuTableSchema(self.version_table, self.mpu_counter)
        self.mpu_table = Table(self.system, mpu_schema, self.meta_rep, self.db)

        object_schema = ObjectTableSchema(
            self.version_table, self.mpu_table, self.object_counter
        )
        self.object_table = Table(
            self.system, object_schema, self.meta_rep, self.db
        )

        # --- K2V (ref garage.rs k2v section + model/k2v/) ---
        from .k2v.item_table import K2VItemTableSchema
        from .k2v.rpc import K2VRpcHandler, SubscriptionManager

        self.k2v_counter_table = Table(
            self.system,
            counter_table_schema("k2v_index_counter"),
            self.meta_rep,
            self.db,
        )
        self.k2v_counter = IndexCounter(
            self.system, self.k2v_counter_table, self.db
        )
        self.k2v_subscriptions = SubscriptionManager()
        k2v_schema = K2VItemTableSchema(self.k2v_counter, self.k2v_subscriptions)
        self.k2v_item_table = Table(
            self.system, k2v_schema, self.meta_rep, self.db
        )
        self.k2v_rpc = K2VRpcHandler(
            self.system, self.k2v_item_table, self.db, self.k2v_subscriptions
        )

        self.tables: List[Table] = [
            self.bucket_table,
            self.bucket_alias_table,
            self.key_table,
            self.object_counter_table,
            self.mpu_counter_table,
            self.block_ref_table,
            self.parity_index_table,
            self.version_table,
            self.mpu_table,
            self.object_table,
            self.k2v_counter_table,
            self.k2v_item_table,
        ]

        # --- overload protection (docs/ROBUSTNESS.md "Overload &
        # brownout"): the front-door admission gate and the background
        # load governor, wired to the live pressure signals this node
        # already produces ---
        from ..api.admission import AdmissionGate, RemotePressureProbe
        from ..utils.overload import LoadGovernor

        self.admission = AdmissionGate(config.api, metrics=self.system.metrics)
        self.governor = LoadGovernor(config.api, metrics=self.system.metrics)
        self.governor.add_signal("admission", self.admission.occupancy)
        # the Retry-After hint on sheds tracks live pressure, not a
        # constant; gossip carries the same signal to remote gateways
        # (cluster-aware admission) and the probe folds the gossiped
        # pressure of a request's placement nodes back into this node's
        # own front door
        self.admission.pressure_fn = self.governor.pressure
        self.system.governor_pressure_fn = self.governor.pressure
        self.admission_probe = RemotePressureProbe(self.system)
        feeder = self.block_manager.feeder
        if feeder is not None:
            depth_full = max(config.api.governor_feeder_depth_full, 1)
            self.governor.add_signal(
                "feeder_depth",
                lambda: len(feeder._pending) / depth_full)
        health = getattr(self.block_manager, "health", None)
        if health is not None:
            # a sick disk is mild pressure (scrub/resync hammering a
            # degraded root steals the IO the foreground needs) — but
            # CAPPED below governor_high on purpose: a disk can stay
            # failed for days awaiting replacement, and parking ALL
            # background work at min_ratio for that long would throttle
            # the very re-replication that restores redundancy.  Disk
            # state alone therefore throttles partially, never fully;
            # only live foreground signals can drive the ratio to the
            # floor.
            _disk_p = {"ok": 0.0, "degraded": 0.5, "failed": 0.5}
            self.governor.add_signal(
                "disk", lambda: _disk_p.get(health.worst_state(), 0.0))
        # netapp write loops feed per-frame queue waits (HOL pressure)
        self.system.netapp.queue_wait_hook = self.governor.note_queue_wait
        # repair-storm fetch concurrency clamps against the same ratio
        self.block_manager.governor = self.governor
        # the device transport demotes background batches against the
        # same ratio (survives a late async device attach)
        codec = self.block_manager.codec
        if hasattr(codec, "set_governor"):
            codec.set_governor(self.governor.ratio)

        # --- fleet health plane (docs/OBSERVABILITY.md "Fleet health &
        # SLOs"): the SLO burn-rate engine fed by the API front doors,
        # and the incident flight recorder its fast-burn breaches (plus
        # fail-slow flips and disk/cluster degradation) trigger ---
        from ..utils.flightrec import FlightRecorder
        from ..utils.slo import SloTracker

        self.flightrec = FlightRecorder(
            os.path.join(config.metadata_dir, "incidents"),
            node_id=bytes(self.system.id).hex()[:16],
            max_bundles=getattr(config, "incident_max_bundles", 16),
            debounce_s=getattr(config, "incident_debounce_secs", 60.0),
            metrics=self.system.metrics,
        )
        self.slo = SloTracker(
            getattr(config, "slo", None), metrics=self.system.metrics,
            on_fast_burn=lambda ep, slo, burn: self.flightrec.trigger(
                "slo_fast_burn",
                {"endpoint": ep, "slo": slo, "burn": round(burn, 2)}),
        )
        self._wire_flight_recorder()

        # --- continuous CPU profiler (docs/OBSERVABILITY.md "CPU
        # attribution"): always-on thread-stack sampler joined to the
        # waterfall segment taxonomy.  Constructed here so its metric
        # families live on this node's registry; started alongside the
        # workers (spawn_workers) and stopped in shutdown() ---
        from ..utils.cpuprof import CpuProfiler

        self.cpuprof = CpuProfiler(
            metrics=self.system.metrics,
            hz=float(getattr(config, "cpuprof_hz", 29.0)))
        self.flightrec.add_collector(
            "cpu_profile",
            lambda: self.cpuprof.flight_recorder_section())

        self.bg = BackgroundRunner()
        # background workers duty-cycle against foreground pressure
        self.bg.governor = self.governor
        self.bg_vars = BgVars()
        self.scrub_worker: Optional[ScrubWorker] = None

    def _wire_flight_recorder(self) -> None:
        """Collectors (what a bundle contains) + auto-triggers (when one
        is captured).  Everything here is a SYNC snapshot of state the
        node already holds — a capture must never wait on the network;
        cross-node context comes from the gossip tables."""
        fr = self.flightrec
        sys_ = self.system
        mgr = self.block_manager

        fr.add_collector("metrics", lambda: sys_.metrics.render())
        fr.add_collector("slo", lambda: self.slo.status())

        def _waterfalls():
            wf = getattr(sys_.tracer, "waterfall", None)
            if wf is None:
                return None
            return {"endpoints": wf.endpoints(), "retained": wf.entries()}

        fr.add_collector("waterfalls", _waterfalls)
        fr.add_collector(
            "device_timeline",
            lambda: mgr.codec.obs.timeline.chrome_trace(2048))
        fr.add_collector(
            "gate_events", lambda: mgr.codec.obs.events_list(128))

        def _pool_stats():
            # device-resident block pool (ops/device_pool.py): residency,
            # hit/miss byte split and eviction counters — an incident on
            # a device-armed node needs to show whether the warm path
            # was actually warm when things went sideways
            pool = getattr(mgr.codec, "pool", None)
            return pool.stats() if pool is not None else None

        fr.add_collector("device_pool", _pool_stats)
        fr.add_collector("slow_ops", lambda: sys_.tracer.slow.snapshot(32))

        fr.add_collector("peers", lambda: [
            sys_.peer_core_row(nid, st)
            for nid, st in sys_.peering.peers.items()
        ])
        fr.add_collector("governor", lambda: {
            "pressure": round(self.governor.pressure(), 4),
            "ratio": round(self.governor.ratio(), 4),
            "signals": self.governor.signals(),
        })
        fr.add_collector("disk", lambda: {
            "states": mgr.health.states(),
            "worst": mgr.health.worst_state(),
            "error_counts": {f"{op}:{kind}": n for (op, kind), n in
                             dict(mgr.health.error_counts).items()},
            "quarantined": mgr.quarantined,
        })
        fr.add_collector("heals", lambda: dict(mgr.heal_counts))
        fr.add_collector("resync_enqueues", lambda: (
            dict(mgr.resync.enqueue_counts)
            if mgr.resync is not None else None))
        fr.add_collector("admission", lambda: {
            "occupancy": round(self.admission.occupancy(), 4),
            "retry_after_hint": self.admission.retry_after_hint(),
        })

        def _cluster():
            h = sys_.health()
            return {"status": h.status,
                    "connected_nodes": h.connected_nodes,
                    "known_nodes": h.known_nodes,
                    "partitions_quorum": h.partitions_quorum,
                    "partitions": h.partitions}

        fr.add_collector("cluster_health", _cluster)

        # auto-trigger: fail-slow flag transitions (the scorer runs on
        # the gossip cadence; a flip means the fleet just gained or
        # healed a straggler — snapshot the evidence either way)
        sys_.health_scorer.on_change = (
            lambda peer, flagged, score: fr.trigger(
                "fail_slow_set" if flagged else "fail_slow_clear",
                {"peer": peer, "score": score}))

        # auto-trigger: disk / cluster (zone) state degradation, watched
        # on the status-gossip cadence.  Only DEGRADATIONS capture —
        # recovery is good news and the degradation bundle already holds
        # the interesting state
        disk_rank = {"ok": 0, "degraded": 1, "failed": 2}
        cluster_rank = {"healthy": 0, "degraded": 1, "unavailable": 2}
        # baselines initialize from the FIRST observation, not an
        # assumed-healthy state: a booting node is "unavailable" until
        # the mesh connects, and that startup transient must not write
        # a bundle (and eat the debounce window) on every boot
        watch: dict = {}

        def _degradation_watch():
            d = mgr.health.worst_state()
            if ("disk" in watch
                    and disk_rank.get(d, 0) > disk_rank.get(watch["disk"], 0)):
                fr.trigger("disk_degraded", {"state": d})
            watch["disk"] = d
            c = sys_.health().status
            if ("cluster" in watch
                    and cluster_rank.get(c, 0) > cluster_rank.get(
                        watch["cluster"], 0)):
                fr.trigger("cluster_degraded", {"status": c})
            watch["cluster"] = c

        sys_.status_tick_hooks.append(_degradation_watch)

    # --- workers (ref garage.rs:358-379, block/manager.rs:192-227) ---

    def spawn_workers(self) -> None:
        # the node is going live: start the always-on CPU sampler and
        # register this (event-loop) thread so its samples join to the
        # running task's span segment
        from ..utils import cpuprof as _cpuprof

        try:
            _cpuprof.register_loop()
        except RuntimeError:
            pass  # no running loop (sync harnesses): worker roles still join
        else:
            # the to_thread pool (stream digests, zstd, direct-io
            # writes, sqlite scans) is long-lived once spawned: give it
            # a named, role-registered executor so its samples don't
            # fold under other;other.  First Garage on the loop wins;
            # asyncio.run's shutdown_default_executor reaps it.
            loop = asyncio.get_running_loop()
            if getattr(loop, "_default_executor", None) is None:
                loop.set_default_executor(ThreadPoolExecutor(
                    thread_name_prefix="aio-worker",
                    initializer=lambda:
                        _cpuprof.register_thread("aio-worker")))
        self.cpuprof.start()
        for t in self.tables:
            # batched Merkle hashing rides the codec feeder's ragged
            # mhash path (class bg) — the trie drain shares the data
            # plane's batching engine instead of hashing node-at-a-time
            t.merkle.feeder = self.block_manager.feeder
            t.syncer = TableSyncer(self.system, t.data, t.merkle)
            t.gc = TableGc(self.system, t.data)
            self.bg.spawn(MerkleWorker(t.merkle))
            # make_worker (NOT a bare SyncWorker): it attaches the worker
            # to the syncer (admin `repair tables` drives it) and hooks
            # on_ring_change so a layout change triggers immediate
            # re-sync + partition offload (ref sync.rs:589-601) instead
            # of waiting for the anti-entropy timer
            self.bg.spawn(t.syncer.make_worker())
            self.bg.spawn(t.gc.make_worker())
            self.bg.spawn(InsertQueueWorker(t))
        # Spawn the max worker count; the active number is the runtime-
        # tunable persisted `n_workers` — idle extras cost one sleeping
        # task each (ref resync.rs:481-567 + block/manager.rs:209-227).
        for i in range(MAX_RESYNC_WORKERS):
            self.bg.spawn(ResyncWorker(self.block_resync, index=i))
        self.scrub_worker = ScrubWorker(
            self.block_manager,
            persister=Persister(
                self.config.metadata_dir, "scrub_info", ScrubWorkerState
            ),
        )
        self.bg.spawn(self.scrub_worker)
        # Automatic post-layout-change block sweep: a ring change fires no
        # table hook, so a node that gained the data assignment for an
        # already-referenced block (rc>0 — no 0→1 incref will ever come)
        # would hold a hole until an operator ran `repair blocks`.  The
        # refs-only RepairWorker re-enqueues every referenced hash; the
        # resync logic then fetches gained blocks / offloads lost ones.
        # Debounced: a sweep still in flight is rewound, not duplicated
        # (layout propagation delivers several ring changes in a burst).
        # The swept ring digest persists ON COMPLETION: a node that was
        # down for the change (its boot merge sees changed=False, so no
        # callback ever fires) or crashed mid-sweep finds a stale marker
        # here and re-sweeps at startup.
        from ..block.repair import LayoutSweepMarker

        self._layout_sweep = None
        self._layout_sweep_wid = None
        self._sweep_reap_backlog: list = []
        self._sweep_persister = Persister(
            self.config.metadata_dir, "layout_sweep", LayoutSweepMarker)

        def _spawn_sweep():
            if self._layout_sweep is not None and \
                    not self._layout_sweep.finished:
                self._layout_sweep.restart()
                return
            if self._layout_sweep_wid is not None:
                # recurring one-shot: drop the previous completed sweep's
                # registry entry or they accumulate across layout changes.
                # reap() can refuse in the narrow window where the sweep
                # set finished=True but its runner task hasn't returned
                # yet — keep refused wids in a backlog and
                # retry them on every later spawn instead of leaking.
                self._sweep_reap_backlog.append(self._layout_sweep_wid)
                self._layout_sweep_wid = None
            self._sweep_reap_backlog = [
                wid for wid in self._sweep_reap_backlog
                if not self.bg.reap(wid)
            ]
            self._layout_sweep = RepairWorker(
                self.block_manager, refs_only=True,
                on_done=lambda: self._sweep_persister.save(
                    LayoutSweepMarker(self.system.ring.digest())),
            )
            self._layout_sweep_wid = self.bg.spawn(self._layout_sweep)

        self.system.on_ring_change(lambda _ring: _spawn_sweep())
        marker = self._sweep_persister.load()
        if self.system.ring.digest() != (marker.digest if marker else b""):
            _spawn_sweep()
        # Layout-change rebalance mover: the foreground, rate-bounded,
        # observable companion to the sweep above — walks ONLY the
        # partitions whose replica set changed (diffed here against the
        # previous ring) and drives their blocks through the resync
        # convergence step directly, reporting rebalance_partitions_*
        # progress.  The sweep remains the completeness backstop (it
        # also covers changes missed while down, via the marker).
        from ..block.rebalance import RebalanceMover
        from ..rpc.layout import N_PARTITIONS

        self.rebalance_mover = RebalanceMover(
            self.block_manager, self.block_resync,
            rate_mib_s=self.config.rebalance_rate_mib,
            metrics=self.system.metrics,
            governor=self.governor,
        )
        self.bg.spawn(self.rebalance_mover)

        def _part_sets(ring):
            return [frozenset(bytes(n) for n in ring.partition_nodes(p))
                    for p in range(N_PARTITIONS)]

        self._prev_partitions = _part_sets(self.system.ring)

        def _feed_mover(ring):
            new = _part_sets(ring)
            changed = [p for p in range(N_PARTITIONS)
                       if new[p] != self._prev_partitions[p]]
            self._prev_partitions = new
            if changed:
                self.rebalance_mover.enqueue(changed)

        self.system.on_ring_change(_feed_mover)
        # Fleet rebuild scheduler: when a ring change REMOVES a node
        # from the cluster (full-node loss, not a mere reshuffle), the
        # partitions that lost it are planned as one paced, checkpointed
        # rebuild flow (block/rebuild.py) — chain repair per codeword,
        # rotated tree roots, resync dedupe via `owns`.  The mover and
        # layout sweep still run for the same partitions; the owns()
        # seam keeps the three from double-repairing a block.
        from ..block.rebuild import RebuildCheckpoint, RebuildScheduler
        from .parity_repair import lookup_index_entries, try_codeword

        self.rebuild_scheduler = RebuildScheduler(
            self.block_manager, self.block_resync,
            rate_mib_s=self.config.rebuild_rate_mib,
            persister=Persister(
                self.config.metadata_dir, "rebuild_sched",
                RebuildCheckpoint),
            metrics=self.system.metrics,
            governor=self.governor,
            lookup=lambda h: lookup_index_entries(self, h, sweep=True),
            decode_fallback=lambda h, ent: try_codeword(self, h, ent),
            # each owner rebuilds its own lost rows: with sibling pushes
            # two owners of one codeword's lost rows can each decode it
            # and push the other's row, so a row is written and counted
            # twice; without them every lost row is decoded once, at the
            # cost of one more k-piece fetch per codeword whose lost rows
            # have two owners
            probe_siblings=False,
        )
        self.bg.spawn(self.rebuild_scheduler)
        self.block_resync.rebuild = self.rebuild_scheduler
        self._prev_ring_nodes = frozenset(
            n for s in self._prev_partitions for n in s)

        self._rebuild_prev_sets = list(self._prev_partitions)

        def _feed_rebuild(ring):
            prev_sets = self._rebuild_prev_sets
            new = _part_sets(ring)
            self._rebuild_prev_sets = new
            new_nodes = frozenset(n for s in new for n in s)
            lost = self._prev_ring_nodes - new_nodes
            self._prev_ring_nodes = new_nodes
            if not lost:
                return  # reshuffle, not a node loss: mover's job alone
            me = bytes(self.system.id)
            # partitions that LOST one of the dead nodes and still
            # assign this node — the rows we are now responsible for
            mine = [p for p in range(N_PARTITIONS)
                    if me in new[p] and prev_sets[p] & lost]
            if mine:
                self.rebuild_scheduler.node_lost(mine, ring.digest())

        self.system.on_ring_change(_feed_rebuild)
        self.rebuild_scheduler.maybe_resume(self.system.ring.digest())
        self.bg_vars.register_ro(
            "rebuild-progress",
            lambda: (f"{self.rebuild_scheduler.partitions_done}/"
                     f"{self.rebuild_scheduler.partitions_total}"),
        )
        self.bg_vars.register_rw(
            "resync-tranquility",
            lambda: self.block_resync.tranquility,
            self.block_resync.set_tranquility,
        )
        self.bg_vars.register_rw(
            "resync-worker-count",
            lambda: self.block_resync.n_workers,
            self.block_resync.set_n_workers,
        )
        self.bg_vars.register_rw(
            "scrub-tranquility",
            lambda: self.scrub_worker.state.tranquility,
            self.scrub_worker.set_tranquility,
        )
        from .s3.lifecycle_worker import LifecycleWorker, LifecycleWorkerPersisted

        self.lifecycle_worker = LifecycleWorker(
            self,
            Persister(
                self.config.metadata_dir, "lifecycle_worker_state",
                LifecycleWorkerPersisted,
            ),
        )
        self.bg.spawn(self.lifecycle_worker)
        if getattr(self, "_want_parity_sweeper", False):
            from .parity_repair import ParityGcSweeper

            self.parity_gc_sweeper = ParityGcSweeper(self)
            self.bg.spawn(self.parity_gc_sweeper)
        self.bg_vars.register_ro(
            "lifecycle-last-completed",
            lambda: (
                self.lifecycle_worker.last_completed.isoformat()
                if self.lifecycle_worker.last_completed else "never"
            ),
        )

    def helper(self):
        from .helper import GarageHelper

        return GarageHelper(self)

    async def run(self) -> None:
        await self.system.run()

    async def shutdown(self) -> None:
        # flush partial write-time codewords before workers stop
        if self.block_manager.write_parity is not None:
            await self.block_manager.write_parity.drain()
        if self.block_manager.ec_accumulator is not None:
            await self.block_manager.ec_accumulator.drain()
        # post-decode heals would fail noisily against the closing RPC
        # layer; their persistent resync entries finish the job later
        self.block_manager.drain_heals()
        # codec feeder: refuse new submissions and drain accepted ones
        # (acked foreground work must complete; racing late submitters
        # fall back to direct codec calls via the *_or_direct helpers)
        if self.block_manager.feeder is not None:
            import asyncio

            await asyncio.to_thread(self.block_manager.feeder.shutdown)
        # device transport: drain staged/queued device batches (its
        # worker falls back to CPU inline if the device died mid-drain)
        codec = self.block_manager.codec
        if hasattr(codec, "close"):
            import asyncio

            await asyncio.to_thread(codec.close)
        # quorum-write stragglers and cancelled-read losers still talk
        # through the transport: give them a bounded drain BEFORE workers
        # and the netapp go away (System.shutdown drains again, cheaply,
        # for anything spawned in between)
        await self.system.rpc.shutdown(timeout=5.0)
        await self.bg.shutdown()
        self.cpuprof.stop()
        tracer = getattr(self.system, "tracer", None)
        if tracer is not None:
            await tracer.stop()  # final span flush before the node exits
            if tracer.exporter is not None:
                await tracer.exporter.close()
        await self.system.shutdown()
        if self._owns_db:
            self.db.close()
