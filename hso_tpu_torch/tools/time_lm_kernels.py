"""Device time of the two serial LM kernels, K3 (coarse level loop) and K5
(pose LM), on the inputs of a real frame.

Run from the repository root on a machine with one CUDA device:

    python3 -m hso_tpu_torch.tools.time_lm_kernels [--other-csrc DIR] [--out FILE]

Records the four coarse levels and the pose LM call of the first frame that
``chip_smoke.py`` tracks, then times back-to-back launches of each kernel on
those inputs (CUDA events, the wrappers' tensor work left out; eager and
from a CUDA graph).  Prints one
JSON object:

* ``resources``: registers, stack, spills and static shared memory of the
  kernels as ``ptxas -v`` reports them;
* ``kernels``: ms per launch of K3 at each level and of K5 in eager
  back-to-back launches, the same in a replayed CUDA graph (``graph_ms``: the
  device time once no host stands between launches), the graph figure with the
  loop cut to its first evaluation, and from the two the time of one further
  evaluation.  With
  ``--other-csrc`` (a directory holding another version of ``csrc/`` with the
  same C interface, for instance the parent commit's) both versions are timed
  in the same process in the order other, this, this, other, and the two
  results are compared;
* ``k3_variants``: K3 at each level with the cluster size and the block size
  forced (``hso_coarse_plan_override``), to show what the plan's choice costs;
* ``latency``: the probes of ``chip_smoke.py``'s ``latency`` phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hso_tpu_torch import _cuda_build  # noqa: E402
from hso_tpu_torch._cuda_build import using_lib  # noqa: E402
from hso_tpu_torch.track import coarse_cuda, pose_cuda  # noqa: E402

VARIANTS = [(c, t) for c in (1, 2, 4, 8) for t in (128, 256, 512)]


def graph_ms(time_ms, prepare, device, n: int = 20) -> float:
    """Device ms per launch: ``n`` launches captured in one CUDA graph and the
    graph replayed, so that no host work stands between two launches (events
    around eager launches time the host once a kernel is shorter than its
    launch call).  ``prepare()`` returns ``(launch, out)`` for the stream that
    is current when it is called; ``time_ms`` is ``chip_smoke.time_ms``."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        prepare()[0]()                    # first launch outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        launch, _ = prepare()
        for _ in range(n):
            launch()
    return time_ms(graph.replay, device, inner=1) / n


def build_verbose(csrc_dir: str, sources=("coarse.cu", "pose.cu")):
    """Build one version of the sources; returns (library handle, resources
    of the kernels of ``sources`` by mangled entry name)."""
    with contextlib.redirect_stdout(io.StringIO()):
        so = _cuda_build.build(verbose=True, csrc_dir=csrc_dir)
    res = {}
    for src in sources:
        res.update(_cuda_build.kernel_resources(_cuda_build.BUILD_LOG[src]))
    return _cuda_build.load(so), res


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()


def write_out(doc: dict, path: str) -> None:
    """Print the result as one JSON line and, with a path, write it there."""
    text = json.dumps(doc)
    print(text, flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text + "\n")


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_lm_kernels: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()

    this, res_this = build_verbose(_cuda_build.CSRC_DIR)
    doc = {"card": card, "resources": {"this": res_this}}
    other = None
    if args.other_csrc:
        other, doc["resources"]["other"] = build_verbose(os.path.abspath(args.other_csrc))

    cam, cfg = cs.bench_camera(), cs.Config()
    with using_lib(this):
        step, _, _ = cs.build_step(cam, cfg, device, whole=True)
        state, book = cs.initial_state(cam, cfg, device)
        frame = cs.bench_scene(cam).render(cs.trajectory(book["frame_count"] + 1)[-1])
        rec, _ = cs.capture_kernel_inputs(step, state, frame)
    calls = {f"coarse_level_ic@level{lv}": (coarse_cuda.coarse_level_ic_prepare, c)
             for lv, c in zip((4, 3, 2, 1), rec["coarse"])}
    calls["coarse_level_ic@global-windows"] = (
        coarse_cuda.coarse_level_ic_prepare, cs.tiled_coarse_call(*rec["coarse"][-1], 1024))
    calls["pose_lm"] = (pose_cuda.pose_lm_prepare, rec["pose"][0])

    def prepared(handle, key, **override):
        prepare, (a, kw) = calls[key]
        with using_lib(handle):
            return prepare(*a, **{**kw, **override})

    doc["kernels"] = {}
    for key in calls:
        launch_t, out_t = prepared(this, key)
        row = {}
        if other is None:
            row["ms"] = cs.time_ms(launch_t, device, inner=20)
        else:
            launch_o, out_o = prepared(other, key)
            t = [cs.time_ms(fn, device, inner=20)
                 for fn in (launch_o, launch_t, launch_t, launch_o)]
            row.update(other_ms=[t[0], t[3]], ms=[t[1], t[2]],
                       speedup=(t[0] + t[3]) / (t[1] + t[2]))
            torch.cuda.synchronize(device)
            row["max_abs_diff_of_T"] = float((out_t[:12] - out_o[:12]).abs().max())
            row["rounds"] = {"this": float(out_t[15 if key != "pose_lm" else 49]),
                             "other": float(out_o[15 if key != "pose_lm" else 49])}
        # the same in a CUDA graph (no host between launches), whole and with
        # the loop cut to its first evaluation (n_iter = 0)
        row["graph_ms"] = graph_ms(cs.time_ms, lambda: prepared(this, key), device)
        if other is not None:
            row["other_graph_ms"] = graph_ms(cs.time_ms, lambda: prepared(other, key), device)
        row["graph_ms_one_evaluation"] = graph_ms(
            cs.time_ms, lambda: prepared(this, key, n_iter=0), device)
        launch_t()
        torch.cuda.synchronize(device)
        rounds = float(out_t[15 if key != "pose_lm" else 49])
        row["evaluations"] = rounds + 1
        row["us_per_further_evaluation"] = (
            (row["graph_ms"] - row["graph_ms_one_evaluation"]) / rounds * 1e3)
        doc["kernels"][key] = row

    override = this.hso_coarse_plan_override
    doc["k3_variants"] = {}
    for key in [k for k in calls if k.startswith("coarse")]:
        _, (a, kw) = calls[key]
        n, p = a[1].shape
        launch, out = prepared(this, key)
        launch()
        torch.cuda.synchronize(device)
        want = out.clone()
        rows = {}
        for c, t in VARIANTS:
            feats = -(-n // c)
            fits = min(coarse_cuda.coarse_block_bytes(t, feats, p, r) for r in (True, False))
            if fits > coarse_cuda.SMEM_MAX:
                continue
            assert override(c, t) == 0
            try:
                launch()
                torch.cuda.synchronize(device)
                rows[f"cluster={c} threads={t}"] = dict(
                    ms=graph_ms(cs.time_ms, lambda: prepared(this, key), device),
                    resident=coarse_cuda.coarse_block_bytes(t, feats, p, True)
                    <= coarse_cuda.SMEM_MAX,
                    max_abs_diff=float((out - want).abs().max()))
            finally:
                assert override(0, 0) == 0
        doc["k3_variants"][key] = rows

    with using_lib(this):
        results = {k: {"evaluations": 1,
                       "threads": coarse_cuda.coarse_launch_plan(*calls[k][1][0][1].shape)[1]}
                   for k in calls if k.startswith("coarse")}
        results["pose_lm"] = {"evaluations": 1, "n": calls["pose_lm"][1][0][1].shape[0]}
        doc["latency"] = cs.latency_floor(results, device)
        del doc["latency"]["latency_floor_ms"]      # per evaluation here: see chip_smoke.py

    write_out(doc, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
