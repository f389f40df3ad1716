#!/usr/bin/env bash
# Assign equal roles to all 3 dev-cluster nodes and apply the layout (the
# reference's scripts/dev_configure.sh), through the port's CLI.
set -euo pipefail
cd "$(dirname "$0")/../.."
BASE=${GARAGE_TPU_DEV_DIR:-/tmp/garage_tpu_dev}
CFG="$BASE/node0/garage.toml"

# connect the mesh (bootstrap peers normally do this; be explicit)
for i in 1 2; do
  ID=$(python -m garage_tpu_torch -c "$BASE/node$i/garage.toml" node-id)
  python -m garage_tpu_torch -c "$CFG" connect "$ID" || true
done

STATUS=$(python -m garage_tpu_torch -c "$CFG" status)
echo "$STATUS"

for i in 0 1 2; do
  ID=$(python -m garage_tpu_torch -c "$BASE/node$i/garage.toml" node-id | cut -d@ -f1)
  python -m garage_tpu_torch -c "$CFG" layout assign "$ID" -z "dc1" -c 1G
done
python -m garage_tpu_torch -c "$CFG" layout apply --version 1
python -m garage_tpu_torch -c "$CFG" status
