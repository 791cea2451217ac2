#!/bin/bash
# Sequential quality-parity suite (one job at a time on the accelerator). Each run writes docs/results/<name>.json + a training JSONL.
set -x
cd "$(dirname "$0")/.."
mkdir -p docs/results runs/qlogs
run() {
  name=$1; shift
  timeout 7200 python benchmarks/quality_parity.py "$@" \
    --out docs/results/${name}.json --jsonl runs/qlogs/${name}.jsonl \
    > runs/qlogs/${name}.log 2>&1
  echo "=== ${name} exit $? ==="
}
run modelnet_nolbo          --config modelnet_nolbo --steps 20000
run modelnet_nolbo_classic  --config modelnet_nolbo --steps 20000 --classic
run modelnet_vae            --config modelnet_vae   --steps 20000
run modelnet_ae             --config modelnet_ae    --steps 20000

# image->shape family (the paper's headline path)
runq() {
  name=$1; shift
  timeout 7200 python benchmarks/quality_image.py "$@" \
    --out docs/results/${name}.json --jsonl runs/qlogs/${name}.jsonl \
    > runs/qlogs/${name}.log 2>&1
  echo "=== ${name} exit $? ==="
}
runq pascal_nolbo    --config pascal_nolbo    --steps 8000
runq kitti_inst_only --config kitti_inst_only --steps 8000

# CPU-mesh scaling semantics validation (virtual devices; see the JSON note)
XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  timeout 1800 python benchmarks/scaling.py --force-cpu --tiny \
  --per-device-batch 8 --iters 10 > runs/qlogs/scaling_dp.txt 2>/dev/null
echo "SUITE DONE"
