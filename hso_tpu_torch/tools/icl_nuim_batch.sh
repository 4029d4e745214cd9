#!/usr/bin/env bash
# ICL-NUIM batch through the port's dataset runner (the counterpart of the JAX
# package's scripts/icl_nuim_batch.sh): living room L0-L3 and office O0-O3
# with data/cameras/icl-nuim.txt, RUNS repeated runs a sequence.
#
#   DATASET_PATH=/data/icl-nuim [RUNS=1] hso_tpu_torch/tools/icl_nuim_batch.sh [runner args]
set -u
DATASET_PATH="${DATASET_PATH:?set DATASET_PATH to the ICL-NUIM root}"
RUNS="${RUNS:-1}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
CALIB="$ROOT/data/cameras/icl-nuim.txt"
TIMES="${TIMES_DIR:-$ROOT/data/timestamps}"

for name in L0 L1 L2 L3 O0 O1 O2 O3; do
  targs=()
  [ -f "$TIMES/$name.txt" ] && targs=("times=$TIMES/$name.txt")
  for i in $(seq 0 $((RUNS-1))); do
    python -m hso_tpu_torch.run_dataset image="$DATASET_PATH/$name/rgb" \
        calib="$CALIB" "${targs[@]}" name="${name}_$i" "$@"
  done
done
