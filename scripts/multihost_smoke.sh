#!/usr/bin/env bash
# 2-process multi-host smoke on localhost CPU (2 virtual devices per process).
set -euo pipefail
cd "$(dirname "$0")/.."
# Repo on the path.
export PYTHONPATH="$PWD"
export JAX_PLATFORMS=cpu
export XLA_FLAGS=--xla_force_host_platform_device_count=2
python scripts/multihost_smoke.py 0 2 &
P0=$!
python scripts/multihost_smoke.py 1 2 &
P1=$!
wait $P0 $P1
echo "multihost smoke passed"
