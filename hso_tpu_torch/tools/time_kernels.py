"""Device time of K4 (fused feature alignment) and K6 (ZMNCC epipolar line
search) on the inputs of a real frame.

Run from the repository root on a machine with one CUDA device:

    python3 -m hso_tpu_torch.tools.time_kernels [--other-csrc DIR] [--out FILE]

Records the alignment and line-search calls of the first frame that
``chip_smoke.py`` runs through the whole step, then times each kernel as 20
launches in a replayed CUDA graph (``time_lm_kernels.graph_ms``: no host
stands between two launches; events around single eager launches of a
microsecond kernel would time the host).  Prints one JSON object:

* ``resources``: registers, stack, spills and static shared memory of the two
  kernels as ``ptxas -v`` reports them;
* ``k6``: ms per launch on three inputs — the recorded call (S = 1024 slots,
  EW 40, most of them with no step inside their window), the same shape with
  every row live (noise windows with in-window segments from
  ``testing.line_score_cases``) and S = 256 at EW 48 — each with the rows that
  have a step inside, the map entries their lines read, and the bound of that
  work beside the bound of the dense map over all rows;
* ``k4``: ms per launch at S = 336 win 24 (both passes of the matcher), at
  S = 1024 win 40 as recorded and with ``valid`` all true, each with the
  histogram of the iterations after which a candidate's result stands;
* ``empty_kernel_graph_ms``: what a launch of one block that does nothing
  costs in the same kind of graph (the floor under every figure here);
* ``k4_by_n_iter``: the K4 calls cut to 0, 1, 2, 3, 5 and 10 iterations: the
  cost of the launch without its loop, and of one iteration of the slowest
  candidate;
* with ``--other-csrc`` (a directory holding another version of ``csrc/`` with
  the same C interface, for instance the parent commit's) both versions are
  timed in the same process in the order other, this, this, other, and their
  results are compared.  A trial version of a kernel (another launch plan, a
  step of the design switched off) is timed the same way: copy ``csrc/``,
  edit the copy, pass it as ``--other-csrc``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hso_tpu_torch import _cuda_build, testing  # noqa: E402
from hso_tpu_torch.ops import align_cuda, epipolar_cuda  # noqa: E402
from hso_tpu_torch._cuda_build import using_lib  # noqa: E402
from hso_tpu_torch.tools.time_lm_kernels import (build_verbose, card_line, graph_ms,  # noqa: E402
                                                 write_out)

SOURCES = ("align.cu", "epipolar.cu")


def all_live_case(s: int, ew: int, n_steps: int, device) -> tuple:
    """``testing.line_score_cases`` with the one row whose segment lies outside
    its window given a neighbour's segment: every row has a step inside."""
    case = testing.line_score_cases(s=s, ew=ew, n_steps=n_steps, seed=0)
    for k in ("su0", "sv0", "dir_u", "dir_v", "n_line"):
        case[k][1] = case[k][5]
    return tuple(torch.as_tensor(case[k], device=device) for k in
                 ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
                  "hs", "ws")) + (n_steps,)


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    this, res_this = build_verbose(_cuda_build.CSRC_DIR, SOURCES)
    doc = {"card": card_line(), "resources": {"this": res_this}}
    other = None
    if args.other_csrc:
        other, doc["resources"]["other"] = build_verbose(os.path.abspath(args.other_csrc),
                                                         SOURCES)

    _cuda_build._lib = this            # every wrapper below launches this build
    cam, cfg = cs.bench_camera(), cs.Config()
    step, _, _ = cs.build_step(cam, cfg, device, whole=True)
    state, book = cs.initial_state(cam, cfg, device)
    frame = cs.bench_scene(cam).render(cs.trajectory(book["frame_count"] + 1)[-1])
    rec, _ = cs.capture_kernel_inputs(step, state, frame)

    def timed(prepare, call, compare):
        """ms per launch from a replayed graph (other, this, this, other) and
        what ``compare(this result, other result)`` says."""
        a, kw = call

        def prepared(handle):
            with using_lib(handle):
                return prepare(*a, **kw)

        if other is None:
            return {"graph_ms": graph_ms(cs.time_ms, lambda: prepared(this), device)}
        t = [graph_ms(cs.time_ms, lambda h=h: prepared(h), device)
             for h in (other, this, this, other)]
        launch_t, out_t = prepared(this)
        launch_o, out_o = prepared(other)
        launch_t()
        launch_o()
        torch.cuda.synchronize(device)
        return {"other_graph_ms": [t[0], t[3]], "graph_ms": [t[1], t[2]],
                "speedup": (t[0] + t[3]) / (t[1] + t[2]), **compare(out_t, out_o)}

    # what any launch costs in such a graph: a kernel of one block that does nothing
    idle = torch.zeros((1,), device=device)

    def idle_prepare():
        stream = torch.cuda.current_stream(device).cuda_stream
        return (lambda: _cuda_build.check(this.hso_probe_latency(
            cs.PROBES["block_barrier"], 64, 1, 0, idle.data_ptr(), stream), "probe")), idle

    doc["empty_kernel_graph_ms"] = graph_ms(cs.time_ms, idle_prepare, device)

    # ---- K6 ----
    (k6_args, _), = rec["zmncc"]
    n_steps = k6_args[11]
    k6_calls = {"recorded (S=1024, EW 40)": k6_args,
                "every row live (S=1024, EW 40)": all_live_case(1024, 40, n_steps, device),
                "EW 48 (S=256)": tuple(
                    torch.as_tensor(v, device=device) for v in
                    testing.line_score_cases(s=256, ew=48, n_steps=n_steps, seed=0).values())
                + (n_steps,)}

    def compare_k6(out_t, out_o):
        finite = torch.isfinite(out_o[0])
        return {"same_finite_rows": bool((torch.isfinite(out_t[0]) == finite).all()),
                "same_best_step": bool((out_t[2] == out_o[2]).all()),
                "max_abs_diff_of_scores": float(max(
                    (out_t[i] - out_o[i])[torch.isfinite(out_o[i])].abs().max().item()
                    if bool(torch.isfinite(out_o[i]).any()) else 0.0 for i in (0, 1)))}

    doc["k6"] = {}
    for key, a in k6_calls.items():
        s, ew = a[0].shape[0], a[0].shape[-1]
        rows, entries = cs.line_work(a)
        ow = ew - 7
        work_ms, work_by = cs.bound(rows * (ew * ew + 64) * 4 + s * 12 * 4,
                                    entries * 320 + rows * (n_steps * 30 + 400))
        dense_ms, _ = cs.bound(s * (ew * ew + 64) * 4 + s * 12 * 4,
                               s * (ew * ow * 22 + ow * ow * (14 + 127 + 8) + n_steps * 30))
        doc["k6"][key] = dict(
            rows_with_a_step_inside=rows, map_entries_read=entries,
            bound_of_the_work_done_ms=work_ms, bound_by=work_by,
            bound_dense_map_all_rows_ms=dense_ms,
            **timed(epipolar_cuda.zmncc_line_scores_prepare, (a, {}), compare_k6))

    # ---- K4 ----
    def all_valid(call):
        a, kw = call
        return a[:4] + (torch.ones_like(a[4]),) + a[5:], kw

    k4_calls = {"S=336 win 24, first pass": rec["align"][0],
                "S=336 win 24, second pass": rec["align"][1],
                "S=1024 win 40, as recorded": rec["seed_align"][0],
                "S=1024 win 40, valid all true": all_valid(rec["seed_align"][0])}

    def compare_k4(out_t, out_o):
        return {"same_converged": bool(((out_t[2] > 0.5) == (out_o[2] > 0.5)).all()),
                "max_abs_diff_of_px": float((out_t[:2] - out_o[:2]).abs().max())}

    doc["k4"] = {}
    for key, (a, kw) in k4_calls.items():
        its = cs.align_iterations(*a, **kw)
        live = a[4]
        doc["k4"][key] = dict(
            rows_valid=int(live.sum()),
            iterations_histogram=torch.bincount(its[live].long(),
                                                minlength=kw["n_iter"] + 1).tolist(),
            iterations_mean=float(its[live].float().mean()) if bool(live.any()) else 0.0,
            **timed(align_cuda.align_match_prepare, (a, kw), compare_k4))

    # where a launch's time goes: the same calls cut to n_iter iterations (the
    # slowest candidate sets the time of the launch)
    doc["k4_by_n_iter"] = {
        key: {str(n): graph_ms(cs.time_ms, lambda n=n: align_cuda.align_match_prepare(
            *a, **{**kw, "n_iter": n}), device) for n in (0, 1, 2, 3, 5, 10)}
        for key, (a, kw) in k4_calls.items()}

    write_out(doc, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
