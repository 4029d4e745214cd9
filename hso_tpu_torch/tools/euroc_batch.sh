#!/usr/bin/env bash
# EuRoC batch through the port's dataset runner (the counterpart of the JAX
# package's scripts/euroc_batch.sh): the same eleven sequences with the same
# start/end frame skips, RUNS repeated runs a sequence, data/cameras/euroc.txt.
#
#   DATASET_PATH=/data/euroc [RUNS=1] hso_tpu_torch/tools/euroc_batch.sh [runner args]
#
# Expects <DATASET_PATH>/<sequence>/cam0/data (or mav0/cam0/data); extra
# arguments (cpu=1, gt=..., trace=1) go to every run.
set -u
DATASET_PATH="${DATASET_PATH:?set DATASET_PATH to the EuRoC root}"
RUNS="${RUNS:-1}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
CALIB="$ROOT/data/cameras/euroc.txt"
# per-sequence timestamp files are optional: TIMES_DIR holds <SEQ>.txt
TIMES="${TIMES_DIR:-$ROOT/data/timestamps}"
EXTRA=("$@")

run_seq() {  # name seq_dir skips...
  local name="$1" seq="$2"; shift 2
  local img="$DATASET_PATH/$seq/cam0/data"
  [ -d "$img" ] || img="$DATASET_PATH/$seq/mav0/cam0/data"
  local targs=()
  [ -f "$TIMES/$name.txt" ] && targs=("times=$TIMES/$name.txt")
  for i in $(seq 0 $((RUNS-1))); do
    python -m hso_tpu_torch.run_dataset image="$img" calib="$CALIB" \
        "${targs[@]}" name="${name}_$i" "$@" "${EXTRA[@]}"
  done
}

run_seq MH01 MH_01_easy        start=50
run_seq MH02 MH_02_easy
run_seq MH03 MH_03_medium
run_seq MH04 MH_04_difficult   start=450 end=1925
run_seq MH05 MH_05_difficult   start=450 end=2200
run_seq V101 V1_01_easy
run_seq V102 V1_02_medium      start=120
run_seq V103 V1_03_difficult   start=200
run_seq V201 V2_01_easy
run_seq V202 V2_02_medium
run_seq V203 V2_03_difficult
