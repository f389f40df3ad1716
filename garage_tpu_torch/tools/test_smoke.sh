#!/usr/bin/env bash
# The operator's smoke suite of the port (the reference's
# scripts/test_smoke.sh), every step through the port's modules: real S3
# flows through the running dev cluster (put/get/diff at several sizes
# across nodes, multipart with out-of-order + skipped part numbers, ranged
# reads, list pagination, website serving, batch deletes, the exposition
# and metrics-docs lints, a live request waterfall, SLOs and incident
# bundles), the metadata plane at 5,000 objects, the transport, pool and
# link smokes and the chaos drills, with every codec on the card.  The
# first failed step ends the suite non-zero; the last line gives its exit
# code and the seconds the suite took.
#
# Usage: garage_tpu_torch/tools/dev_cluster.sh &   (wait for boot)
#        garage_tpu_torch/tools/dev_configure.sh
#        garage_tpu_torch/tools/test_smoke.sh
set -euo pipefail
cd "$(dirname "$0")/../.."
trap 'echo "test_smoke.sh: exit $? after ${SECONDS} s"' EXIT
python -m garage_tpu_torch.tools.smoke "$@"
# metadata-plane smoke: 5k objects loaded live, listings from all 3 nodes
# agree (sharded fan-out on), table_merkle_todo drains to 0 through the
# batched Merkle updater, and the merkle_batch_* / table_scan_* /
# api_list_* families render promlint-clean
python -m garage_tpu_torch.tools.metadata_smoke
# zero-copy device transport smoke: the hybrid gate must OPEN through the
# transport on the card (device-side bytes > 0), staging must pay <= 1
# host copy per block, scrub and foreground verifies must share one feeder
# queue, and the live transport_* metric families must pass the lint
python -m garage_tpu_torch.tools.transport_smoke
# device-resident block pool smoke: scrubbing the SAME range twice through
# the feeder+transport must move zero link bytes on the warm pass, attribute
# every scrubbed byte across pool_hit/pool_miss, stay bit-identical to the
# serial CPU path, and render the pool_* families lint-clean
python -m garage_tpu_torch.tools.pool_smoke
# link microprofiler smoke: the controlled sweep must emit a well-formed
# attribution block whose per-cell stage breakdowns hold the exact-sum
# invariant LIVE, and the probe verdict must carry a per-stage breakdown
# with stage_copy bytes
python -m garage_tpu_torch.tools.link_profile
# continuous CPU profiler smoke: the always-on sampler on a REAL daemon
# must serve a non-empty collapsed-stack profile via `cpu profile` under
# PUT load, measured sampler overhead under the 2% budget, and the cpu_*
# + scrape-self-cost families lint-clean on the live gateway
python -m garage_tpu_torch.tools.cpu_profile
# degraded-mode smoke: one hard partition between the two replicas of an
# in-process 3-node cluster must stay client-invisible (quorum 2/3), and
# one flaky-disk + ENOSPC node must go read-only (typed StorageFull) and
# recover — all with zero client errors
python -m garage_tpu_torch.tools.chaos --quick --phases partition,disk
# fail-slow (gray failure) smoke: one node made slow-but-up must be
# flagged by the comparative scorer within a bounded number of status
# exchanges, demoted in read/repair ranking, and unflagged after heal
python -m garage_tpu_torch.tools.chaos --quick --phases fail_slow
# zone-scale smoke: one zone blackholed, one zone drained under live load
# (rebalance mover completes, acked objects bit-identical), one-zone-at-a-
# time rolling restart with a bumped version — zero client errors
python -m garage_tpu_torch.tools.chaos --quick \
    --phases zone_blackhole,zone_drain,rolling --nodes 6 --zones 3
# repair-storm smoke: one node of an EC cluster killed under live load —
# heal completes with zero client errors and the planned repair path
# moves no more than the whole-shard exact-k baseline (bytes/byte <= k)
python -m garage_tpu_torch.tools.chaos --quick --phases repair_storm
# compound-failure smoke: zone blackhole + flaky disk AT ONCE — zero
# client errors through the compound fault and full recovery after heal
python -m garage_tpu_torch.tools.chaos --quick \
    --phases compound --nodes 6 --zones 3
# overload smoke: 4x past the gateway's admission capacity — every reject
# typed SlowDown/DeadlineExceeded, admitted p99 within 3x the at-capacity
# baseline, background_throttle_ratio cedes and recovers, zero acked loss
python -m garage_tpu_torch.tools.chaos --quick --phases overload
# multi-tenant QoS smoke: one abusive tenant at 2x the gateway's
# admission capacity vs well-behaved tenants — zero well-behaved sheds,
# abuser shed typed per tenant, a remote_pressure shed observed
python -m garage_tpu_torch.tools.chaos --quick --phases noisy_neighbor
# geo-WAN smoke (6-node/3-zone shape): local-zone GET p50 near the local
# RTT, cross-zone reads and write re-quorums pay the matrix, no fail-slow
# false positives on a healthy-but-distant zone
python -m garage_tpu_torch.tools.chaos --quick --phases wan
# gateway-failover smoke (2-gateway shape): one gateway killed mid-PUT
# and mid-streaming-GET — zero acked-data loss, then a graceful drain
python -m garage_tpu_torch.tools.chaos --quick --phases gateway_failover
# full-node-loss smoke (6-node/3-zone EC-only shape): a storage node
# crashed AND dropped from the layout under live traffic — zero client
# errors, every survivor's rebuild scheduler walks to done == total
python -m garage_tpu_torch.tools.chaos --quick --phases node_rebuild
echo "SMOKE+CHAOS OK"
