"""Daemon configuration.

Equivalent of reference src/util/config.rs:14-298: a single TOML file with
secrets loadable from separate files (refusing world-readable secret files,
config.rs:280-287), human-friendly capacities ("10G", config.rs:300-340) and
compression levels, plus env-var secret overrides (ref garage/main.rs:69-85:
GARAGE_RPC_SECRET etc. → here GARAGE_TPU_RPC_SECRET).

Additions under ``[codec]``: backend selection (cpu|cuda|hybrid), block
hash algorithm (blake2s is the device-friendly default), Reed-Solomon (k, m)
data/parity split, and device batch sizing.  The file format is the
reference package's; a ``backend = "tpu"`` left from it is refused, never
read as ``cuda``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import stat
try:
    import tomllib
except ImportError:  # Python < 3.11: the API-identical backport
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..net.resilience import ResilienceTunables
from ..ops.codec import CodecParams as _CodecParams
from .health_score import HealthTunables
from .overload import OverloadTunables
from .slo import SloTunables

_CODEC_DEFAULTS = _CodecParams()


class ConfigError(Exception):
    pass


_CAPACITY_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([kKmMgGtT]?)(i?)[bB]?\s*$")
_CAPACITY_MULT = {"": 1, "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12}
_CAPACITY_MULT_IEC = {"k": 2**10, "m": 2**20, "g": 2**30, "t": 2**40}


def parse_capacity(v: Any) -> int:
    """'10G' / '100M' / int → bytes (ref util/config.rs:300-340, SI units);
    IEC suffixes ('1GiB') are honored as binary multiples."""
    if isinstance(v, int):
        return v
    m = _CAPACITY_RE.match(str(v))
    if not m:
        raise ConfigError(f"invalid capacity: {v!r}")
    unit = m.group(2).lower()
    if m.group(3):
        if not unit:
            raise ConfigError(f"invalid capacity: {v!r}")
        return int(float(m.group(1)) * _CAPACITY_MULT_IEC[unit])
    return int(float(m.group(1)) * _CAPACITY_MULT[unit])


def secret_from_file(path: str) -> str:
    """Read a secret file, refusing world-readable perms
    (ref util/config.rs:268-298)."""
    st = os.stat(path)
    if st.st_mode & (stat.S_IRWXG | stat.S_IRWXO) and not os.environ.get(
        "GARAGE_TPU_ALLOW_WORLD_READABLE_SECRETS"
    ):
        raise ConfigError(
            f"secret file {path} is group/world-accessible "
            f"(mode {oct(st.st_mode & 0o777)}); chmod 0600 it"
        )
    with open(path, "r") as f:
        return f.read().strip()


@dataclass
class CodecConfig:
    """Block-codec settings (new vs reference — the BlockCodec seam)."""
    # Default is the production path: CPU floor + device stealing, the
    # device side a CudaCodec built when the codec is (a host with no GPU
    # raises).  Set "cpu" to pin the floor (no device), "cuda" to run
    # every batch on the GPU.
    backend: str = "hybrid"         # hybrid (cpu + device stealing) | cpu | cuda
    hash_algo: str = "blake2s"      # blake2s (device-offloadable) | blake2b | sha256
    rs_data: int = 8                # Reed-Solomon k (0 = replication only, no RS)
    rs_parity: int = 4              # Reed-Solomon m
    batch_blocks: int = 256         # blocks per device batch (scrub/resync producers)
    shard_mesh: int = 1             # devices to shard codec batches over
    # hybrid backend work-stealing quantum; single source of truth is the
    # CodecParams default (codec.py: cache-resident CPU-side groups)
    hybrid_group_blocks: int = _CODEC_DEFAULTS.hybrid_group_blocks
    # persist scrub-time RS parity sidecars enabling zero-network local
    # reconstruction of corrupted/lost blocks (the decode-repair half of
    # the BlockCodec north star).  Opt-in: costs ~m/k extra disk (+50%
    # at the default 8/4), refreshed and garbage-collected per scrub pass
    store_parity: bool = False
    # RS-encode on the PutObject path (BASELINE config #3): freshly
    # written blocks join write-time codewords whose parity is encoded
    # off the write path and persisted immediately — no unprotected
    # window until the first scrub pass.  Effective only with
    # store_parity; partial codewords (small objects, flush timeouts)
    # encode against implicit zero shards.
    parity_on_write: bool = True
    # Cross-node parity (requires store_parity + parity_on_write): each
    # codeword's parity shards are stored as ordinary ring-placed blocks
    # on OTHER nodes and indexed in a replicated table, so RS survives
    # whole-NODE loss, not just local corruption.  Pair with
    # data_replication_mode = "none" for the erasure-coded storage class
    # (1 + m/k × storage tolerating m codeword-node losses).
    parity_distribute: bool = False
    hybrid_window: int = 1          # hybrid backend: device in-flight groups
    # Device submission width (blocks) for the hybrid feeder.  MEMORY
    # IMPLICATION: host staging + device HBM hold up
    # to (hybrid_window + 1) × device_batch_blocks × block_size at once
    # — 2 GiB at the defaults (window 1 × 1024 blocks × 1 MiB).  The
    # codec clamps this width at construction so the bound never
    # exceeds max_device_staging_mib; see ops/codec.py CodecParams for
    # the full derivation.
    device_batch_blocks: int = _CODEC_DEFAULTS.device_batch_blocks
    # Cap (MiB) on the in-flight staging claim above.  Raise it only on
    # hosts with the RAM/HBM headroom for wider windows.
    max_device_staging_mib: int = _CODEC_DEFAULTS.max_device_staging_mib
    # --- continuous-batching feeder for the FOREGROUND data path
    # (ops/feeder.py): in-flight PUT block-id hashing, write-time RS
    # encodes and degraded-read decodes submit individually and are
    # coalesced into ragged codec batches, dispatched when the batch
    # fills or the SLO deadline expires.  K concurrent puts then pay
    # ~one batched codec pass instead of K serial ones; a lone put
    # waits at most feeder_slo_ms (the solo-latency regression bound).
    feeder: bool = True
    feeder_slo_ms: float = 2.0
    feeder_max_batch_blocks: int = 256
    # --- zero-copy device transport (ops/transport.py): one
    # deadline-aware submission queue from the feeder to the device —
    # staged once into reusable buffers (≤1 host copy per block),
    # double-buffered within max_device_staging_mib, foreground ahead
    # of governor-demoted background.  transport=false restores the
    # legacy per-call serialize+copy routing.
    transport: bool = _CODEC_DEFAULTS.transport
    transport_staging_slots: int = _CODEC_DEFAULTS.transport_staging_slots
    transport_bg_slack_ms: float = _CODEC_DEFAULTS.transport_bg_slack_ms
    # --- device-resident block pool (ops/device_pool.py): bounded
    # fixed-size device pages keyed by block hash, consulted by the
    # transport before staging — a warm re-scrub of a resident working
    # set moves zero link bytes.  Budgeted SEPARATELY from
    # max_device_staging_mib (staging bounds bytes in flight; the pool
    # bounds bytes at rest).  pool_mib=0 disables (staging then
    # behaves byte-identically to the pre-pool transport);
    # pool_prefetch gates the scrub worker's next-range hint.
    pool_mib: int = _CODEC_DEFAULTS.pool_mib
    pool_page_kib: int = _CODEC_DEFAULTS.pool_page_kib
    pool_prefetch: bool = _CODEC_DEFAULTS.pool_prefetch
    # --- repair-bandwidth-optimal degraded reads (block/repair_plan.py):
    # exact-k survivor selection ranked by RTT EWMA / breaker state /
    # zone locality, hedged ranked replacements, and partial-parallel
    # repair (survivors ship GF-scaled partial sums via the `ppr` block
    # RPC instead of whole shards).  repair_planner=False restores the
    # legacy sweep-everything gather; repair_ppr=False keeps exact-k
    # planning but fetches whole shards.  repair_hedge_ms > 0 pins the
    # stalled-fetch hedge delay; 0 derives it from the block endpoint's
    # observed latency quantile.
    repair_planner: bool = True
    repair_ppr: bool = True
    repair_hedge_ms: float = 0.0
    # tree-aggregated PPR (`ppr_tree` block RPC): survivors forward
    # GF-scaled partials along a fanout-shaped aggregation tree so the
    # coordinator ingests ONE stream regardless of k.  repair_tree=False
    # keeps flat PPR; repair_tree_fanout bounds each interior node's
    # child count.
    repair_tree: bool = True
    repair_tree_fanout: int = 4

    def make(self, compression_level: Optional[int] = 1,
             metrics=None, tracer=None, block_size: Optional[int] = None,
             device="cuda"):
        """Build the configured BlockCodec (`backend` selects the impl).

        `device` is where the cuda and hybrid backends run: "cuda" (the
        GPU; raises without one) unless a caller asks for "cpu", where
        the kernels' plain versions run.  It is an argument, not a
        config key: a deployment always runs on the card.  With
        `shard_mesh` = n > 1 the codec splits every batch over the
        first n GPUs (ValueError when the host has fewer), or over n
        times the CPU device.

        metrics/tracer plumb the System's MetricsRegistry/Tracer into
        the codec: per-stage histograms, bytes-by-side counters, and the
        gate-decision event ring (admin `codec info` / `codec events`).
        block_size feeds the staging clamp so the memory bound holds at
        the daemon's configured block size, not the 1 MiB default."""
        from ..ops import make_codec
        from ..ops.codec import CodecParams as _CP

        return make_codec(
            self.backend,
            metrics=metrics,
            tracer=tracer,
            device=device,
            block_size=block_size or _CP.block_size,
            hash_algo=self.hash_algo,
            rs_data=self.rs_data,
            rs_parity=self.rs_parity,
            batch_blocks=self.batch_blocks,
            compression_level=compression_level,
            shard_mesh=self.shard_mesh,
            hybrid_group_blocks=self.hybrid_group_blocks,
            hybrid_window=self.hybrid_window,
            device_batch_blocks=self.device_batch_blocks,
            max_device_staging_mib=self.max_device_staging_mib,
            transport=self.transport,
            transport_staging_slots=self.transport_staging_slots,
            transport_bg_slack_ms=self.transport_bg_slack_ms,
            pool_mib=self.pool_mib,
            pool_page_kib=self.pool_page_kib,
            pool_prefetch=self.pool_prefetch,
        )


@dataclass
class TableTunables:
    """[table] — metadata-plane scaling knobs (docs/OBSERVABILITY.md
    "Metadata plane"): batched Merkle digestion, batched anti-entropy
    descent and bucket-sharded listing fan-out.  Every knob has a
    `<= 1` escape hatch that restores the serial/per-node behavior
    (the bench's paired A/B baseline)."""

    # todo items drained per batched Merkle pass (table/merkle.py):
    # shared trie path nodes are rewritten and re-hashed ONCE per batch
    # instead of once per item, and node hashes ride the codec feeder as
    # one ragged batch.  <= 1 = legacy one-transaction-per-item updates.
    merkle_batch: int = 256
    # Merkle nodes fetched per anti-entropy RPC round (table/sync.py):
    # the syncer ships whole subtree frontiers breadth-wise, collapsing
    # cold-node convergence from O(nodes) round-trips to O(depth).
    # <= 1 = legacy one-node-per-round descent.
    sync_batch_nodes: int = 512
    # concurrent sub-range scans a large ListObjects enumeration fans
    # out across once its first page comes back full (api/s3/list.py):
    # disjoint key sub-ranges prefetch in parallel and are consumed in
    # order, so deep listings stop paying one quorum round-trip per
    # serial page.  <= 1 = serial single-cursor walk.
    list_shards: int = 4
    # rows per server-side range_scan page when a filtered read_range
    # has to keep scanning past rejected rows
    scan_page: int = 1024


@dataclass
class ConsulDiscoveryConfig:
    """[consul_discovery] (ref util/config.rs:185-210, rpc/consul.rs)."""
    consul_http_addr: str = ""
    service_name: str = ""
    api: str = "catalog"            # catalog | agent
    token: Optional[str] = None
    tags: List[str] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)
    ca_cert: Optional[str] = None
    client_cert: Optional[str] = None
    client_key: Optional[str] = None
    tls_skip_verify: bool = False


@dataclass
class KubernetesDiscoveryConfig:
    """[kubernetes_discovery] (ref util/config.rs, rpc/kubernetes.rs)."""
    namespace: str = ""
    service_name: str = ""
    skip_crd: bool = False


@dataclass
class Config:
    """Top-level config (ref util/config.rs:14-107)."""
    metadata_dir: str = "./meta"
    data_dir: List[Dict[str, Any]] = field(default_factory=list)  # [{path, capacity?, read_only?}]
    block_size: int = 1024 * 1024       # ref config.rs:234-236 default 1 MiB
    replication_mode: str = "3"         # ref rpc/replication_mode.rs
    # Block placement may use a DIFFERENT mode than the metadata tables
    # (None = same): meta "3" + data "none" + codec.parity_distribute is
    # the erasure-coded storage class — see CodecConfig.parity_distribute.
    data_replication_mode: Optional[str] = None
    compression_level: Optional[int] = 1  # zstd level; None = off (ref config.rs:342-394)
    rpc_bind_addr: str = "0.0.0.0:3901"
    rpc_public_addr: Optional[str] = None
    rpc_secret: Optional[str] = None
    bootstrap_peers: List[str] = field(default_factory=list)
    db_engine: str = "sqlite"           # sqlite | native | memory (ref model/garage.rs:114-213)
    # disabled by default, matching the reference (ref util/config.rs:
    # 20-25 "disabled by default" for both): commits reach the OS on
    # ack (kill -9-safe, tests/test_db_torture.py); fsync=true narrows
    # the power-loss window at ~0.6 ms per metadata commit (measured,
    # docs/DATAPLANE_PROFILE.md — it was 22% of data-plane CPU)
    metadata_fsync: bool = False
    data_fsync: bool = False
    # --- disk-fault robustness (docs/ROBUSTNESS.md "Disk faults &
    # degraded mode"): per-data-root ok → degraded(read-only) → failed
    # state machine in block/health.py ---
    # free-bytes watermark: a root with less free space preflights every
    # block write into a typed StorageFull rejection (write quorums
    # route around the node; reads keep flowing)
    data_free_space_watermark: int = 128 * 1024 * 1024
    # consecutive read/write disk errors on one root that flip it
    # read-only (degraded); 4× this latches "failed"
    disk_error_threshold: int = 8
    # cooldown before a degraded root admits one half-open probe write
    disk_error_cooldown: float = 30.0
    # startup-janitor quarantine bound: .corrupted files beyond either
    # budget are purged oldest-first at boot
    quarantine_max_files: int = 128
    quarantine_max_bytes: int = 256 * 1024 * 1024
    # version tag advertised in the handshake + status gossip (None =
    # the package version); overridable for mixed-version drills
    node_version: Optional[str] = None
    # layout-change rebalance mover: data streamed per second ceiling
    # (MiB/s) so a zone drain cannot starve foreground traffic
    rebalance_rate_mib: float = 64.0
    # fleet rebuild scheduler (block/rebuild.py): repaired bytes per
    # second ceiling for a full-node-loss storm, further scaled by the
    # LoadGovernor throttle ratio
    rebuild_rate_mib: float = 256.0
    s3_api_bind_addr: Optional[str] = "0.0.0.0:3900"
    s3_region: str = "garage"
    root_domain: Optional[str] = None
    web_bind_addr: Optional[str] = None
    web_root_domain: Optional[str] = None
    admin_api_bind_addr: Optional[str] = None
    admin_metrics_token: Optional[str] = None
    admin_token: Optional[str] = None
    admin_trace_sink: Optional[str] = None  # OTLP/HTTP collector endpoint
    k2v_api_bind_addr: Optional[str] = None
    codec: CodecConfig = field(default_factory=CodecConfig)
    # [table] — metadata-plane scaling: batched Merkle hashing, batched
    # sync descent, bucket-sharded listing fan-out
    table: TableTunables = field(default_factory=TableTunables)
    # [rpc] — degraded-mode resilience tunables (adaptive timeouts,
    # retry/backoff, read hedging, per-peer circuit breaker, the
    # static block-transfer timeout, and the end-to-end request
    # deadline budget); see docs/ROBUSTNESS.md
    rpc: ResilienceTunables = field(default_factory=ResilienceTunables)
    # [api] — overload protection at the front door: admission-gate
    # watermarks (max in-flight requests/bytes → 503 SlowDown past
    # them) and the background load governor's thresholds; see
    # docs/ROBUSTNESS.md "Overload & brownout"
    api: OverloadTunables = field(default_factory=OverloadTunables)
    # [health] — fail-slow peer detection: the comparative scorer's
    # factor/window/hysteresis knobs (docs/OBSERVABILITY.md "Fleet
    # health & SLOs")
    health: HealthTunables = field(default_factory=HealthTunables)
    # [slo] — per-endpoint availability + latency-threshold objectives
    # tracked as multi-window burn rates; [[slo.objective]] tables
    # override the defaults per endpoint
    slo: SloTunables = field(default_factory=SloTunables)
    # incident flight recorder (utils/flightrec.py): bundles kept on
    # disk (oldest deleted first) and the auto-trigger debounce window
    incident_max_bundles: int = 16
    incident_debounce_secs: float = 60.0
    # [cpu] sample_hz — continuous thread-stack sampler rate
    # (utils/cpuprof.py); default is co-prime with the 10/25/50/100 ms
    # periodic workers so sampling can't phase-lock onto them
    cpuprof_hz: float = 29.0
    consul_discovery: Optional[ConsulDiscoveryConfig] = None
    kubernetes_discovery: Optional[KubernetesDiscoveryConfig] = None
    # raw parsed TOML for anything not modeled
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)


_SECRET_ENV = {
    "rpc_secret": "GARAGE_TPU_RPC_SECRET",
    "admin_token": "GARAGE_TPU_ADMIN_TOKEN",
    "admin_metrics_token": "GARAGE_TPU_METRICS_TOKEN",
}


def read_config(path: str) -> Config:
    """Load + validate a TOML config file (ref util/config.rs:239-266)."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    return config_from_dict(raw)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    cfg = Config(raw=raw)
    for key in (
        "metadata_dir", "block_size", "replication_mode",
        "data_replication_mode", "compression_level",
        "rpc_bind_addr", "rpc_public_addr", "rpc_secret", "bootstrap_peers",
        "db_engine", "metadata_fsync", "data_fsync", "root_domain",
        "disk_error_threshold", "disk_error_cooldown",
        "node_version", "rebalance_rate_mib", "rebuild_rate_mib",
    ):
        if key in raw:
            setattr(cfg, key, raw[key])
    if "block_size" in raw:
        cfg.block_size = parse_capacity(raw["block_size"])
    # human-friendly capacities for the disk-health knobs ("100M", "1G")
    for key in ("data_free_space_watermark", "quarantine_max_bytes"):
        if key in raw:
            setattr(cfg, key, parse_capacity(raw[key]))
    if "quarantine_max_files" in raw:
        v = raw["quarantine_max_files"]
        # a file COUNT: capacity suffixes ("1K" → 1000) would be
        # silently misread as counts, so only a plain integer is legal
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ConfigError(
                "quarantine_max_files must be a non-negative integer")
        cfg.quarantine_max_files = v
    if cfg.disk_error_threshold < 1:
        raise ConfigError("disk_error_threshold must be >= 1")
    if cfg.rebalance_rate_mib <= 0:
        raise ConfigError("rebalance_rate_mib must be > 0")
    if cfg.rebuild_rate_mib <= 0:
        raise ConfigError("rebuild_rate_mib must be > 0")
    cfg.replication_mode = str(cfg.replication_mode)

    dd = raw.get("data_dir", "./data")
    if isinstance(dd, str):
        cfg.data_dir = [{"path": dd}]
    elif isinstance(dd, list):
        cfg.data_dir = [
            {**d, "capacity": parse_capacity(d["capacity"])} if "capacity" in d else dict(d)
            for d in dd
        ]
    else:
        raise ConfigError("data_dir must be a string or list of tables")

    s3 = raw.get("s3_api", {})
    cfg.s3_api_bind_addr = s3.get("api_bind_addr", cfg.s3_api_bind_addr)
    cfg.s3_region = s3.get("s3_region", cfg.s3_region)
    cfg.root_domain = s3.get("root_domain", cfg.root_domain)

    web = raw.get("s3_web", {})
    cfg.web_bind_addr = web.get("bind_addr", cfg.web_bind_addr)
    cfg.web_root_domain = web.get("root_domain", cfg.web_root_domain)

    admin = raw.get("admin", {})
    cfg.admin_api_bind_addr = admin.get("api_bind_addr", cfg.admin_api_bind_addr)
    cfg.admin_trace_sink = admin.get("trace_sink", cfg.admin_trace_sink)
    cfg.admin_metrics_token = admin.get("metrics_token", cfg.admin_metrics_token)
    cfg.admin_token = admin.get("admin_token", cfg.admin_token)

    k2v = raw.get("k2v_api", {})
    cfg.k2v_api_bind_addr = k2v.get("api_bind_addr", cfg.k2v_api_bind_addr)

    for section, cls, attr, required in (
        ("consul_discovery", ConsulDiscoveryConfig, "consul_discovery",
         ("consul_http_addr", "service_name")),
        ("kubernetes_discovery", KubernetesDiscoveryConfig,
         "kubernetes_discovery", ("namespace", "service_name")),
    ):
        sec = raw.get(section)
        if sec is not None:
            known = {f.name for f in dataclasses.fields(cls)}
            bad = set(sec) - known
            if bad:
                raise ConfigError(f"unknown [{section}] keys: {sorted(bad)}")
            parsed = cls(**sec)
            missing = [k for k in required if not getattr(parsed, k)]
            if missing:
                raise ConfigError(f"[{section}] requires {missing}")
            setattr(cfg, attr, parsed)
    if cfg.consul_discovery is not None and cfg.consul_discovery.api not in (
        "catalog", "agent"
    ):
        raise ConfigError("consul_discovery.api must be catalog|agent")

    rpc = raw.get("rpc", {})
    known = {f.name for f in dataclasses.fields(ResilienceTunables)}
    bad = set(rpc) - known
    if bad:
        raise ConfigError(f"unknown [rpc] keys: {sorted(bad)}")
    cfg.rpc = ResilienceTunables(**rpc)
    if cfg.rpc.retry_max < 0:
        raise ConfigError("rpc.retry_max must be >= 0")
    if not 0.0 < cfg.rpc.hedge_quantile < 1.0:
        raise ConfigError("rpc.hedge_quantile must be in (0, 1)")
    if cfg.rpc.breaker_failure_threshold < 1:
        raise ConfigError("rpc.breaker_failure_threshold must be >= 1")
    if cfg.rpc.deadline_floor < 0:
        raise ConfigError("rpc.deadline_floor must be >= 0")

    api = dict(raw.get("api", {}))
    known = {f.name for f in dataclasses.fields(OverloadTunables)}
    bad = set(api) - known
    if bad:
        raise ConfigError(f"unknown [api] keys: {sorted(bad)}")
    # human-friendly capacities for the byte-sized QoS knobs
    for key in ("max_inflight_bytes", "wdrr_quantum_bytes",
                "wdrr_request_cost", "streaming_body_estimate"):
        if key in api:
            api[key] = parse_capacity(api[key])
    cfg.api = OverloadTunables(**api)
    if cfg.api.max_inflight < 0:
        raise ConfigError("api.max_inflight must be >= 0 (0 = unlimited)")
    if cfg.api.max_inflight_bytes < 0:
        raise ConfigError("api.max_inflight_bytes must be >= 0")
    if not 0.0 < cfg.api.governor_min_ratio <= 1.0:
        raise ConfigError("api.governor_min_ratio must be in (0, 1]")
    if not 0.0 <= cfg.api.governor_low < cfg.api.governor_high:
        raise ConfigError("api.governor_low must be in [0, governor_high)")
    if cfg.api.tenant_queue_len < 1:
        raise ConfigError("api.tenant_queue_len must be >= 1")
    if cfg.api.tenant_queue_wait < 0:
        raise ConfigError("api.tenant_queue_wait must be >= 0")
    if cfg.api.wdrr_quantum_bytes < 1:
        raise ConfigError("api.wdrr_quantum_bytes must be >= 1")
    if cfg.api.wdrr_request_cost < 0:
        raise ConfigError("api.wdrr_request_cost must be >= 0")
    if cfg.api.max_tracked_tenants < 1:
        raise ConfigError("api.max_tracked_tenants must be >= 1")
    if cfg.api.remote_pressure_shed < 0:
        raise ConfigError(
            "api.remote_pressure_shed must be >= 0 (0 = disabled)")
    if cfg.api.codel_target < 0:
        raise ConfigError("api.codel_target must be >= 0 (0 = static)")
    if cfg.api.codel_interval <= 0:
        raise ConfigError("api.codel_interval must be > 0")
    if cfg.api.streaming_body_estimate < 0:
        raise ConfigError("api.streaming_body_estimate must be >= 0")
    if cfg.api.drain_timeout < 0:
        raise ConfigError("api.drain_timeout must be >= 0")
    if cfg.api.longpoll_max_parked < 0:
        raise ConfigError(
            "api.longpoll_max_parked must be >= 0 (0 = 4x max_inflight)")
    if "retry_after_max" not in api:
        # pre-existing configs may carry retry_after > the new cap's
        # default: an upgrade must not refuse to boot — widen the
        # derived ceiling instead of raising
        cfg.api.retry_after_max = max(cfg.api.retry_after_max,
                                      int(cfg.api.retry_after), 1)
    if cfg.api.retry_after_max < max(int(cfg.api.retry_after), 1):
        raise ConfigError(
            "api.retry_after_max must be >= api.retry_after (and >= 1)")

    health = raw.get("health", {})
    known = {f.name for f in dataclasses.fields(HealthTunables)}
    bad = set(health) - known
    if bad:
        raise ConfigError(f"unknown [health] keys: {sorted(bad)}")
    cfg.health = HealthTunables(**health)
    if cfg.health.fail_slow_factor <= 1.0:
        raise ConfigError("health.fail_slow_factor must be > 1")
    if not 1.0 <= cfg.health.clear_factor <= cfg.health.fail_slow_factor:
        raise ConfigError(
            "health.clear_factor must be in [1, fail_slow_factor] "
            "(the hysteresis band)")
    if cfg.health.window_s < 0:
        raise ConfigError("health.window_s must be >= 0")
    if cfg.health.min_samples < 1 or cfg.health.min_baseline_peers < 1:
        raise ConfigError(
            "health.min_samples and health.min_baseline_peers must be >= 1")
    if cfg.health.sample_ttl_s <= 0:
        raise ConfigError("health.sample_ttl_s must be > 0")

    slo = dict(raw.get("slo", {}))
    # TOML [[slo.objective]] array-of-tables → the objectives list
    if "objective" in slo:
        slo["objectives"] = list(slo.pop("objective") or [])
    known = {f.name for f in dataclasses.fields(SloTunables)}
    bad = set(slo) - known
    if bad:
        raise ConfigError(f"unknown [slo] keys: {sorted(bad)}")
    cfg.slo = SloTunables(**slo)
    if not 0 < cfg.slo.bucket_s <= cfg.slo.fast_window_s \
            <= cfg.slo.slow_window_s:
        raise ConfigError(
            "[slo] needs 0 < bucket_s <= fast_window_s <= slow_window_s")
    if not 0.0 < cfg.slo.default_availability < 1.0:
        raise ConfigError("slo.default_availability must be in (0, 1)")
    if cfg.slo.default_latency_ms <= 0:
        raise ConfigError("slo.default_latency_ms must be > 0")
    if cfg.slo.fast_burn_threshold <= 0 or cfg.slo.min_events < 1:
        raise ConfigError(
            "slo.fast_burn_threshold must be > 0 and slo.min_events >= 1")
    if cfg.slo.max_endpoints < 1:
        raise ConfigError("slo.max_endpoints must be >= 1")
    for o in cfg.slo.objectives:
        if not isinstance(o, dict) or not o.get("endpoint"):
            raise ConfigError(
                "[[slo.objective]] entries need an `endpoint` key")
        extra = set(o) - {"endpoint", "availability", "latency_ms"}
        if extra:
            raise ConfigError(
                f"unknown [[slo.objective]] keys: {sorted(extra)}")
        av = o.get("availability")
        if av is not None and not 0.0 < float(av) < 1.0:
            raise ConfigError("objective availability must be in (0, 1)")
        lm = o.get("latency_ms")
        if lm is not None and float(lm) <= 0:
            raise ConfigError("objective latency_ms must be > 0")

    incident = raw.get("incident", {})
    bad = set(incident) - {"max_bundles", "debounce_secs"}
    if bad:
        raise ConfigError(f"unknown [incident] keys: {sorted(bad)}")
    if "max_bundles" in incident:
        v = incident["max_bundles"]
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ConfigError("incident.max_bundles must be an integer >= 1")
        cfg.incident_max_bundles = v
    if "debounce_secs" in incident:
        v = float(incident["debounce_secs"])
        if v < 0:
            raise ConfigError("incident.debounce_secs must be >= 0")
        cfg.incident_debounce_secs = v

    cpu = raw.get("cpu", {})
    bad = set(cpu) - {"sample_hz"}
    if bad:
        raise ConfigError(f"unknown [cpu] keys: {sorted(bad)}")
    if "sample_hz" in cpu:
        v = float(cpu["sample_hz"])
        if not 0.0 < v <= 1000.0:
            raise ConfigError("cpu.sample_hz must be in (0, 1000]")
        cfg.cpuprof_hz = v

    table = raw.get("table", {})
    known = {f.name for f in dataclasses.fields(TableTunables)}
    bad = set(table) - known
    if bad:
        raise ConfigError(f"unknown [table] keys: {sorted(bad)}")
    cfg.table = TableTunables(**table)
    for key in ("merkle_batch", "sync_batch_nodes", "list_shards",
                "scan_page"):
        v = getattr(cfg.table, key)
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ConfigError(f"table.{key} must be a positive integer")
    if cfg.table.list_shards > 64:
        raise ConfigError("table.list_shards must be <= 64")
    if cfg.table.sync_batch_nodes > 65536:
        raise ConfigError("table.sync_batch_nodes must be <= 65536")

    codec = raw.get("codec", {})
    known = {f.name for f in dataclasses.fields(CodecConfig)}
    bad = set(codec) - known
    if bad:
        raise ConfigError(f"unknown [codec] keys: {sorted(bad)}")
    cfg.codec = CodecConfig(**codec)
    if cfg.codec.backend == "tpu":
        raise ConfigError(
            'codec.backend "tpu" names the reference package\'s JAX codec; '
            'this package runs on CUDA: use "cuda" (or "hybrid", "cpu")'
        )
    if cfg.codec.backend not in ("cpu", "cuda", "hybrid"):
        raise ConfigError(
            f"codec.backend must be cpu|cuda|hybrid, got {cfg.codec.backend!r}"
        )
    if (cfg.codec.rs_data == 0) != (cfg.codec.rs_parity == 0):
        raise ConfigError("codec.rs_data and codec.rs_parity must both be 0 or both be >0")
    if cfg.codec.feeder_slo_ms < 0:
        raise ConfigError("codec.feeder_slo_ms must be >= 0")
    if cfg.codec.feeder_max_batch_blocks < 1:
        raise ConfigError("codec.feeder_max_batch_blocks must be >= 1")
    if cfg.codec.repair_hedge_ms < 0:
        raise ConfigError("codec.repair_hedge_ms must be >= 0")
    if cfg.codec.repair_tree_fanout < 1:
        raise ConfigError("codec.repair_tree_fanout must be >= 1")
    if cfg.codec.transport_staging_slots < 1:
        raise ConfigError("codec.transport_staging_slots must be >= 1")
    if cfg.codec.transport_bg_slack_ms < 0:
        raise ConfigError("codec.transport_bg_slack_ms must be >= 0")
    if cfg.codec.pool_mib < 0:
        raise ConfigError("codec.pool_mib must be >= 0 (0 disables the pool)")
    if cfg.codec.pool_page_kib < 1:
        raise ConfigError("codec.pool_page_kib must be >= 1")

    # secrets: env overrides > `<key>_file` in TOML > inline value
    for key, env in _SECRET_ENV.items():
        if os.environ.get(env):
            setattr(cfg, key, os.environ[env])
        elif raw.get(f"{key}_file"):
            setattr(cfg, key, secret_from_file(raw[f"{key}_file"]))
        elif key in ("admin_token", "admin_metrics_token") and admin.get(f"{key}_file"):
            setattr(cfg, key, secret_from_file(admin[f"{key}_file"]))
    return cfg
