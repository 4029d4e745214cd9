#!/usr/bin/env bash
# TUM MonoVO batch through the port's dataset runner (the counterpart of the
# JAX package's scripts/tum_monovo_batch.sh): the 50 auto-exposure sequences,
# FOV camera (narrow calibration for sequences 1-13 and 21-50, wide for 14-20,
# whose whole images are rectified first), a sequence's own camera.txt where it
# ships one, online photometric calibration on (photo=1), RUNS runs a sequence.
#
#   DATASET_PATH=/data/tum_mono_vo [RUNS=1] hso_tpu_torch/tools/tum_monovo_batch.sh [runner args]
set -u
DATASET_PATH="${DATASET_PATH:?set DATASET_PATH to the TUM MonoVO root}"
RUNS="${RUNS:-1}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

for n in $(seq 1 50); do
  seq=$(printf "sequence_%02d" "$n")
  calib="$ROOT/data/cameras/tum_mono_vo_narrow.txt"
  if [ "$n" -ge 14 ] && [ "$n" -le 20 ]; then
    calib="$ROOT/data/cameras/tum_mono_vo_wide.txt"
  fi
  [ -f "$DATASET_PATH/$seq/camera.txt" ] && calib="$DATASET_PATH/$seq/camera.txt"
  for i in $(seq 0 $((RUNS-1))); do
    python -m hso_tpu_torch.run_dataset image="$DATASET_PATH/$seq/images" \
        calib="$calib" times="$DATASET_PATH/$seq/times.txt" \
        name="$(printf "seq%02d_%d" "$n" "$i")" photo=1 "$@"
  done
done
