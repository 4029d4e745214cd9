"""The bench's two host loops in turns: ``python -m hso_tpu_torch.tools.host_loops``.

    python -m hso_tpu_torch.tools.host_loops [--pairs 4] [--device cpu]

Runs :func:`hso_tpu_torch.bench.host_loop` (a handler from
``artifacts/bench_boot.npz``, warmed with ``add_image`` through three
keyframe events, then ``N_HOST`` timed frames) for the lag-1 loop
(``add_image_pipelined`` + ``flush``) and the synchronous one
(``add_image``), ``--pairs`` pairs after one untimed pair, alternating which
loop runs first in a pair.  Prints one JSON line: frames/s of every run in
order, each loop's median, and the pairs the lag-1 loop was faster in.  Runs
on the GPU; without one it exits 2 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from hso_tpu_torch import bench
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline import scan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("host_loops: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    scan.pin_float32_matmul()
    cam, cfg = bench.bench_camera(), Config()
    scene = bench.bench_scene(cam)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(pipelined: bool) -> dict:
        r = bench.host_loop(cam, cfg, scene, device, sync, pipelined=pipelined)
        if r["ate"] >= bench.ATE_GATE_M:
            raise RuntimeError(f"host loop ATE {r['ate']:.4f} m exceeds the gate")
        return dict(loop="lag-1" if pipelined else "synchronous", frames_per_s=r["fps"],
                    keyframe_events=r["timed_keyframes"], ate_rmse_m=r["ate"])

    run(True), run(False)                     # untimed pair: builds, allocator, handles
    runs, wins = [], 0
    for k in range(args.pairs):
        first = k % 2 == 0                    # lag-1 first in even pairs
        pair = [run(first), run(not first)]
        runs += pair
        lag1, sync_ = sorted(pair, key=lambda r: r["loop"] != "lag-1")
        wins += lag1["frames_per_s"] > sync_["frames_per_s"]
    doc = dict(card=bench.card_line() if device.type == "cuda" else "cpu", frames=bench.N_HOST,
               pairs=args.pairs, runs=runs, lag1_faster_pairs=wins,
               median_frames_per_s={name: statistics.median(
                   r["frames_per_s"] for r in runs if r["loop"] == name)
                   for name in ("lag-1", "synchronous")})
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
