#!/usr/bin/env bash
# 3-node localhost dev cluster of the port (the reference's
# scripts/dev_cluster.sh): three configs under $GARAGE_TPU_DEV_DIR
# (default /tmp/garage_tpu_dev), RPC on 3901/3911/3921, S3 on
# 3900/3910/3920, web on 3902/3912/3922, admin on 3903/3913/3923, K2V on
# 3904/3914/3924.  Each daemon is `python -m garage_tpu_torch server`; its
# codec is the config default (hybrid) on the card.  The script waits for
# the three daemons, prints each one's exit code ("node<i> exited <rc>")
# and exits non-zero when one of them did.
set -euo pipefail
cd "$(dirname "$0")/../.."

BASE=${GARAGE_TPU_DEV_DIR:-/tmp/garage_tpu_dev}
SECRET=${GARAGE_TPU_RPC_SECRET:-dev-cluster-secret}
mkdir -p "$BASE"

pids=()
for i in 0 1 2; do
  d="$BASE/node$i"
  mkdir -p "$d/meta" "$d/data"
  cat > "$d/garage.toml" <<EOT
metadata_dir = "$d/meta"
data_dir = "$d/data"
db_engine = "sqlite"
replication_mode = "3"
rpc_bind_addr = "127.0.0.1:39${i}1"
rpc_public_addr = "127.0.0.1:39${i}1"
rpc_secret = "$SECRET"
bootstrap_peers = ["127.0.0.1:3901", "127.0.0.1:3911", "127.0.0.1:3921"]

[s3_api]
s3_region = "garage"
api_bind_addr = "127.0.0.1:39${i}0"

[codec]
store_parity = true

[admin]
api_bind_addr = "127.0.0.1:39${i}3"
admin_token = "dev-admin-token"

[s3_web]
bind_addr = "127.0.0.1:39${i}2"
root_domain = ".web.garage.localhost"

[k2v_api]
api_bind_addr = "127.0.0.1:39${i}4"
EOT
  python -m garage_tpu_torch -c "$d/garage.toml" server &
  pids+=("$!")
  echo "node$i pid $!"
done

sleep 2
echo "=== dev cluster up; configure with garage_tpu_torch/tools/dev_configure.sh ==="
rc=0
for i in 0 1 2; do
  if wait "${pids[$i]}"; then code=0; else code=$?; fi
  echo "node$i exited $code"
  [ "$code" -eq 0 ] || rc=1
done
exit "$rc"
