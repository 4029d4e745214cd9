#!/usr/bin/env bash
# One sequence through the port's dataset runner (the counterpart of the JAX
# package's scripts/single_sequence.sh); every argument goes to the runner:
#   hso_tpu_torch/tools/single_sequence.sh image=<dir> calib=<file> [times=..] [start=..] [cpu=1]
# Writes result/<name>.txt under the current directory.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python -m hso_tpu_torch.run_dataset "$@"
