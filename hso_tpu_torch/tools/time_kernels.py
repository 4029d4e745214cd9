"""Device time of K1/K2 (window gather), K4 (fused feature alignment) and K6
(ZMNCC epipolar line search) on the inputs of a real frame.

Run from the repository root on a machine with one CUDA device:

    python3 -m hso_tpu_torch.tools.time_kernels [--other-csrc DIR] [--windows-only]
                                                [--out FILE]

Records the window, alignment and line-search calls of the first frame that
``chip_smoke.py`` runs through the whole step (and the window gather of
``init_seeds`` on the checkpoint's last keyframe), then times each kernel as
20 launches in a replayed CUDA graph (``time_lm_kernels.graph_ms``: no host
stands between two launches; events around single eager launches of a
microsecond kernel would time the host).  Prints one JSON object:

* ``resources``: registers, stack, spills and static shared memory of the
  kernels as ``ptxas -v`` reports them;
* ``k1``: K1 at each coarse level as the tracker calls it — the ref and cur
  windows (2 x 336, win 24) as two single-image launches of the other version
  and of this one, and as one two-job launch of this one — and at the seed
  table's shape (336 rows, win 44, 480 x 640);
* ``k2``: K2 on the matcher's two calls (S = 336, win 24), the sweep's
  (S = 1024, win 40) and ``init_seeds``' (336 rows, win 44), the last also
  against the three K1 launches (one a level) that ``init_seeds`` made before;
* beside each K1/K2 figure, in the same kind of graph, the advanced-indexing
  gather that computes the same windows in one PyTorch call
  (``gather_graph_ms``), and the bytes bound;
* ``host_us_per_call``: host microseconds per call of the K1/K2 wrappers as
  the step calls them (1,000 calls, no synchronisation in between);
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
  edit the copy, pass it as ``--other-csrc``.  ``--windows-only`` times K1/K2
  and nothing else.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hso_tpu_torch import _cuda_build, testing  # noqa: E402
from hso_tpu_torch.ops import align_cuda, epipolar_cuda  # noqa: E402
from hso_tpu_torch._cuda_build import using_lib  # noqa: E402
from hso_tpu_torch.tools.time_lm_kernels import (build_verbose, card_line, graph_ms,  # noqa: E402
                                                 write_out)

SOURCES = ("window.cu", "align.cu", "epipolar.cu")


def all_live_case(s: int, ew: int, n_steps: int, device) -> tuple:
    """``testing.line_score_cases`` with the one row whose segment lies outside
    its window given a neighbour's segment: every row has a step inside."""
    case = testing.line_score_cases(s=s, ew=ew, n_steps=n_steps, seed=0)
    for k in ("su0", "sv0", "dir_u", "dir_v", "n_line"):
        case[k][1] = case[k][5]
    return tuple(torch.as_tensor(case[k], device=device) for k in
                 ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
                  "hs", "ws")) + (n_steps,)


def _flat(out) -> list:
    return [t for o in out for t in _flat(o)] if isinstance(out, (list, tuple)) else [out]


def window_timings(cs, rec, seed_calls, seed_px, this, other, device) -> dict:
    """K1/K2 as the step calls them, this version against the other (or only
    this one), the gather beside them; see the module's docstring.
    ``seed_calls`` are K2's recorded calls from ``init_seeds``, ``seed_px`` the
    level-0 pixels of its detections."""
    from hso_tpu_torch.ops import window_cuda as wc
    from hso_tpu_torch.ops.gatherless import clip_anchor

    def g(prepare):
        return graph_ms(cs.time_ms, prepare, device)

    def on(handle, prepare, *a):
        def prepared():
            with using_lib(handle):
                return prepare(*a)
        return prepared

    def chain(*parts):
        """Several prepared launches as one."""
        def prepared():
            done = [p() for p in parts]
            return (lambda: [launch() for launch, _ in done]), [out for _, out in done]
        return prepared

    def versus(old, new):
        """graph ms of old (on the other version) and new (on this one), in the
        order old, new, new, old; and whether their windows hold the same bits."""
        if other is None:
            return {"graph_ms": [g(new)]}
        t = [g(p) for p in (old, new, new, old)]
        launch_o, out_o = old()
        launch_n, out_n = new()
        launch_o()
        launch_n()
        torch.cuda.synchronize(device)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(_flat(out_o), _flat(out_n)))
        return {"other_graph_ms": [t[0], t[3]], "graph_ms": [t[1], t[2]],
                "speedup": (t[0] + t[3]) / (t[1] + t[2]), "same_bits": same}

    def gather(stack, level, au, av, win):
        ar = torch.arange(win, device=device)
        rows = (av.long()[:, None] + ar)[:, :, None]
        cols = (au.long()[:, None] + ar)[:, None, :]
        lv = level.long()[:, None, None]
        return lambda: ((lambda: stack[lv, rows, cols]), None)

    old_lib = other if other is not None else this
    doc = {"k1": {}, "k2": {}, "host_us_per_call": {}}
    k1_calls = [((cs.contiguous_jobs(jobs), win), kw) for (jobs, win), kw in rec["windows"]]
    for (jobs, win), _ in k1_calls:
        n = jobs[0][1].shape[0]
        h, w = jobs[0][0].shape
        two = [on(old_lib, wc.extract_windows_prepare, *job, win) for job in jobs]
        entry = versus(chain(*two), on(this, wc.extract_windows_multi_prepare, jobs, win))
        entry["this_two_single_launches_graph_ms"] = g(chain(
            *[on(this, wc.extract_windows_prepare, *job, win) for job in jobs]))
        if other is not None and getattr(other, "hso_extract_windows_jobs", None) is not None:
            entry["other_one_two_job_launch_graph_ms"] = g(
                on(other, wc.extract_windows_multi_prepare, jobs, win))
        lv = torch.cat([torch.full((n,), k, dtype=torch.int32, device=device) for k in (0, 1)])
        entry["gather_graph_ms"] = g(gather(torch.stack([jobs[0][0], jobs[1][0]]), lv,
                                            torch.cat([jobs[0][1], jobs[1][1]]),
                                            torch.cat([jobs[0][2], jobs[1][2]]), win))
        entry["bound_ms"] = cs.bound(2 * (2 * n * win * win * 4 + 2 * n * 4), 0)[0]
        doc["k1"][f"level {h}x{w}: ref + cur, 2 x N={n}, win {win}"] = entry

    labels = ["matcher, first pass", "matcher, second pass", "sweep", "init_seeds"]
    k2_calls = [c for c in rec["pack"] if c[0][4] == 24] + \
        [c for c in rec["pack"] if c[0][4] != 24] + list(seed_calls)
    for label, ((pyr, level, au, av, win, n_levels), _) in zip(labels, k2_calls):
        pyr = [p.contiguous() for p in pyr[:n_levels]]
        s = level.shape[0]
        entry = versus(on(old_lib, wc.pack_level_windows_prepare, pyr, level, au, av, win,
                          n_levels),
                       on(this, wc.pack_level_windows_prepare, pyr, level, au, av, win, n_levels))
        entry["gather_graph_ms"] = g(gather(cs.level_stack(pyr, n_levels, device), level, au, av,
                                            win))
        entry["bound_ms"] = cs.bound(2 * s * win * win * 4 + 3 * s * 4, 0)[0]
        if label == "init_seeds":
            # what init_seeds did before: one K1 launch a level over every row
            per_level = []
            for lvl in range(n_levels):
                scale = 1.0 / (1 << lvl)
                a_u, a_v = clip_anchor(seed_px[:, 0] * scale, seed_px[:, 1] * scale, win, 0,
                                       *pyr[lvl].shape)
                per_level.append((pyr[lvl], a_u, a_v))
            entry["other_three_k1_launches_graph_ms"] = g(chain(
                *[on(old_lib, wc.extract_windows_prepare, *job, win) for job in per_level]))
            k1_44 = versus(on(old_lib, wc.extract_windows_prepare, *per_level[0], win),
                           on(this, wc.extract_windows_prepare, *per_level[0], win))
            k1_44["gather_graph_ms"] = g(gather(pyr[0][None], torch.zeros_like(au), *per_level[0][1:],
                                                win))
            k1_44["bound_ms"] = cs.bound(2 * s * win * win * 4 + 2 * s * 4, 0)[0]
            doc["k1"][f"seed table: N={s}, win {win}, {pyr[0].shape[0]}x{pyr[0].shape[1]}"] = k1_44
        doc["k2"][f"{label}: S={s}, win {win}, {n_levels} levels"] = entry

    def host_us(fn, n=1000) -> float:
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize(device)
        return (t1 - t0) / n * 1e6

    (jobs, win), _ = k1_calls[-1]
    (pyr, level, au, av, win2, n_levels), _ = k2_calls[0]
    (pyr_s, level_s, au_s, av_s, win_s, _), _ = k2_calls[2]
    pyr, pyr_s = ([p.contiguous() for p in q[:n_levels]] for q in (pyr, pyr_s))
    calls = {
        "K1, one image (extract_windows_cuda), N=336 win 24":
            lambda: wc.extract_windows_cuda(*jobs[1], win),
        "K1, two single-image calls, 2 x N=336 win 24":
            lambda: [wc.extract_windows_cuda(*job, win) for job in jobs],
        "K2 (pack_level_windows_cuda), S=336 win 24":
            lambda: wc.pack_level_windows_cuda(pyr, level, au, av, win2, n_levels),
        "K2, S=1024 win 40": lambda: wc.pack_level_windows_cuda(pyr_s, level_s, au_s, av_s,
                                                                win_s, n_levels),
    }
    for key, fn in calls.items():
        t = []
        for handle in ((old_lib, this, this, old_lib) if other is not None else (this,)):
            with using_lib(handle):
                t.append(host_us(fn))
        doc["host_us_per_call"][key] = ({"other": [t[0], t[3]], "this": [t[1], t[2]]}
                                        if other is not None else {"this": t})
    with using_lib(this):
        doc["host_us_per_call"]["K1, one two-job call (extract_windows_multi_cuda), "
                                "2 x N=336 win 24"] = {
            "this": [host_us(lambda: wc.extract_windows_multi_cuda(jobs, win)) for _ in range(2)]}
    return doc


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default="")
    ap.add_argument("--windows-only", action="store_true")
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
    rec, out0 = cs.capture_kernel_inputs(step, state, frame)
    seed_px = torch.as_tensor(cs.keyframe_detections(book)[0]["px"], dtype=torch.float32,
                              device=device)
    doc.update(window_timings(cs, rec, cs.record_init_seeds(state, book, out0, device), seed_px,
                              this, other, device))
    if args.windows_only:
        write_out(doc, args.out)
        return 0

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
