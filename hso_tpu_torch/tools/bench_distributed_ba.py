"""Weak scaling of the point-sharded BA (``hso_tpu_torch.ba.distributed``).

The port's counterpart of the JAX package's ``scripts/bench_distributed_ba.py``.
The per-rank load stays constant while the rank count grows: for ``n`` ranks
the problem is ``testing.ba_problem(n_kf=kf, n_pts=pts_per_dev·n, K=kf,
P=pts_per_dev·n, noise_px=0.3, seed=7)`` (every point seen by every keyframe
but its host), robust deltas on the whole problem, and each rank's block of
points solved by :func:`make_distributed_ba` (``iters`` LM iterations, one
process a rank).

    python -m hso_tpu_torch.tools.bench_distributed_ba [devices=1,2,4,8]
        [pts_per_dev=640] [kf=12] [iters=10] [reps=5] [cpu=1] [out=FILE]

On the card 1 rank runs over NCCL and more over gloo with every rank's
tensors on ``cuda:0`` (NCCL takes one rank a card); ``cpu=1`` runs gloo ranks
on the CPU; without a GPU it exits 2 unless ``cpu=1`` is given.  One card
cannot give classic weak scaling (the ranks share its silicon): the figure
there is ``overhead_efficiency`` (the same whole problem solved by one rank,
over the ``n``-rank solve), and the projection below.

Per rank count one JSON line with the JAX harness's keys (``devices``,
``pts_total``, ``pts_per_dev``, ``obs_total``, ``step_ms`` — the mean of
``reps`` solves after one warm-up, host clock, synchronised —,
``step_ms_1dev_same_problem``, ``overhead_efficiency``, ``chi2``), and
beside them: the largest difference of the solution from the local solver
(``ba/local_ba.py``) on the same problem, held to the tolerances of
``tools/multiproc_ba.py``; whether every repeated solve gave the same bits;
the measured time of one collective of 16 bytes on that world.  Then the
summary lines with ``weak_scaling_efficiency``, and one line with:

* ``collectives_measured``: every ``all_reduce`` and ``all_gather`` the
  ranks of the largest world sent (counted at ``dist`` inside
  ``ba/distributed.py``: the tensors ``_reduce`` packed, ``_gather``'s
  block), its bytes, and whether it fired in the initial build, in the LM
  loop or in the gather of the result after the solve; the payload per LM
  iteration and per solve;
* ``projection``: the ring formula of the JAX harness,
  ``eff(n) = t_anchor / (t_anchor + (iters+1)·(2·V·(n−1)/n/BW + n_coll·L))``,
  with the 1-rank solve measured in this run as ``t_anchor`` (its
  ``step_ms_1dev_same_problem``: timed without a barrier), ``V`` and
  ``n_coll`` the loop's payload and collectives per iteration, ``L`` the
  1-rank ``all_reduce`` of 16 bytes measured in this run, and ``BW`` the
  H100 SXM's NVLink rate per direction from NVIDIA's data sheet (a
  specification, not a measurement); and the same at 8 ranks with a 10×
  worse link.

With ``out=`` the whole object is written there too.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from hso_tpu_torch import testing
from hso_tpu_torch.ba import distributed
from hso_tpu_torch.ba.local_ba import compute_deltas, local_bundle_adjustment

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FOCAL = 450.0
STRIP_PX = 2.0
RANK_TIMEOUT_S = 900
#: NVLink 4 of one H100 SXM: 900 GB/s both directions together, 450 GB/s each
#: way (NVIDIA H100 Tensor Core GPU data sheet); a specification
NVLINK_BYTES_PER_S = 4.5e11
NVLINK_SOURCE = ("NVIDIA H100 SXM data sheet: NVLink 900 GB/s bidirectional, 450 GB/s per "
                 "direction (a specification, not a measurement)")
#: the JAX harness's measured payload at kf=12 (WEAK_SCALING.json), for comparison
JAX_PAYLOAD_BYTES_PER_LM_ITERATION_KF12 = 42052


class CountingDist:
    """``torch.distributed`` with every ``all_reduce`` and ``all_gather``
    recorded: what was sent, its bytes, and which function issued it."""

    def __init__(self, real, log: list):
        self._real, self._log = real, log

    def __getattr__(self, name):
        return getattr(self._real, name)

    def _note(self, op: str, t: torch.Tensor) -> None:
        caller = sys._getframe(2)                 # _reduce / _gather
        parts = caller.f_locals.get("parts") if op == "all_reduce" else [t]
        self._log.append({"op": op, "shapes": [list(p.shape) for p in parts],
                          "dtype": str(t.dtype).replace("torch.", ""),
                          "bytes": t.numel() * t.element_size(),
                          "issued_by": sys._getframe(3).f_code.co_name})

    def all_reduce(self, t, *a, **k):
        self._note("all_reduce", t)
        return self._real.all_reduce(t, *a, **k)

    def all_gather(self, parts, t, *a, **k):
        self._note("all_gather", t)
        return self._real.all_gather(parts, t, *a, **k)


@contextlib.contextmanager
def counting(log: list):
    """Collectives of ``ba/distributed.py`` recorded into ``log``."""
    real = distributed.dist
    distributed.dist = CountingDist(real, log)
    try:
        yield log
    finally:
        distributed.dist = real


def inventory(solve_log: list, gather_log: list, n_iter: int) -> dict:
    """The collectives of one solve and of the result's gather, each marked
    where it fired: the solve's first reduction is its initial build, the
    others are the LM loop's."""
    assert solve_log and solve_log[0]["issued_by"] == "build", solve_log[:1]
    assert len(solve_log) == 1 + 2 * n_iter, len(solve_log)
    inv = ([dict(c, where="initial_build") for c in solve_log[:1]]
           + [dict(c, where="lm_loop") for c in solve_log[1:]]
           + [dict(c, where="result_gather") for c in gather_log])
    loop = [c for c in inv if c["where"] == "lm_loop"]
    # one entry per kind of collective, with how often it fired
    kinds = {}
    for c in inv:
        key = json.dumps([c["op"], c["shapes"], c["where"], c["issued_by"]])
        kinds.setdefault(key, dict(c, count=0))["count"] += 1
    return {"collectives": list(kinds.values()),
            "payload_bytes_per_lm_iteration": sum(c["bytes"] for c in loop) // n_iter,
            "collectives_per_lm_iteration": len(loop) // n_iter,
            "lm_iterations": n_iter,
            "payload_bytes_per_solve": sum(c["bytes"] for c in inv
                                           if c["where"] != "result_gather"),
            "note": ("counted at torch.distributed inside ba/distributed.py on one solve of "
                     "the largest world: each all_reduce carries the tensors _reduce packed "
                     "into one flat float32 buffer; the all_gather brings the blocks of "
                     "inverse distances and residual norms back after the solve")}


# ------------------------------------------------------------------ one rank
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, reps: int, barrier=None) -> tuple:
    """One warm call, then ``reps`` calls each between synchronisations (and
    a barrier first, when given); returns (ms of each, outputs)."""
    fn()
    ms, outs = [], []
    for _ in range(reps):
        _sync(dev)
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        outs.append(fn())
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def collective_us(dev, n_calls: int = 200) -> dict:
    """µs of one ``all_reduce`` of 16 bytes over the world: back to back
    (synchronised at the end) and each followed by a synchronisation."""
    x = torch.zeros(4, dtype=torch.float32, device=dev)
    for _ in range(20):
        dist.all_reduce(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        dist.all_reduce(x)
    _sync(dev)
    back_to_back = (time.perf_counter() - t0) / n_calls * 1e6
    t0 = time.perf_counter()
    for _ in range(n_calls):
        dist.all_reduce(x)
        _sync(dev)
    return {"back_to_back_us": back_to_back,
            "synchronised_us": (time.perf_counter() - t0) / n_calls * 1e6}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_rank(rank: int, world: int, init: str, backend: str, device: str, pts_per_dev: int,
             n_kf: int, n_iter: int, reps: int, row_path: str | None = None) -> dict | None:
    """One rank of an ``n``-rank run; rank 0 returns (and writes) the row."""
    from hso_tpu_torch.pipeline.scan import pin_float32_matmul
    from hso_tpu_torch.tools.multiproc_ba import hold

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        pin_float32_matmul()
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    try:
        n_pts = pts_per_dev * world
        prob = testing.ba_problem(n_kf=n_kf, n_pts=n_pts, K=n_kf, P=n_pts, noise_px=0.3, seed=7)

        def t(a):
            return torch.as_tensor(a, device=dev)

        T_kf, free, idist, pv = (t(prob[k]) for k in ("T_kf", "free", "idist", "point_valid"))
        obs = {k: t(v) for k, v in prob["obs"].items()}
        deltas = compute_deltas(T_kf, idist, obs, FOCAL)
        obs_s, idist_s, pv_s, p_local = distributed.shard_problem(obs, idist, pv, world)
        lo, hi = rank * p_local, (rank + 1) * p_local
        obs_b = {k: v[lo:hi] for k, v in obs_s.items()}
        solve = distributed.make_distributed_ba(n_kf, p_local, n_iter)

        def run():
            return solve(T_kf, free, idist_s[lo:hi], pv_s[lo:hi], obs_b, *deltas)

        solve_log, gather_log = [], []
        with counting(solve_log):
            first = run()
        with counting(gather_log):
            both = distributed._gather(torch.cat([first[1][:, None], first[3]], dim=1), None)
        ms, outs = timed(run, dev, reps, barrier=dist.barrier)
        bitwise = all(_same(first, o) for o in outs)
        assert bitwise, f"rank {rank}: a repeated solve gave other bits"
        lat = collective_us(dev)
        one = dist.new_group([0])               # every rank takes part in making it
        if rank != 0:
            return None

        solve1 = distributed.make_distributed_ba(n_kf, n_pts, n_iter, group=one)
        ms1, _ = timed(lambda: solve1(T_kf, free, idist, pv, obs, *deltas), dev, reps)
        ref = local_bundle_adjustment(T_kf, free, idist, pv, obs, n_kf=n_kf, n_pts=n_pts,
                                      n_iter=n_iter, focal=FOCAL, strip_px=STRIP_PX)
        rn = both[:n_pts, 1:]
        thresh = torch.where(obs["is_edgelet"], torch.full_like(rn, 0.6 * STRIP_PX / FOCAL),
                             torch.full_like(rn, STRIP_PX / FOCAL))
        sol = {"T_kf": first[0], "idist": both[:n_pts, 0], "chi2_final": first[2],
               "obs_inlier": obs["valid"] & (rn <= thresh)}
        vs_local = hold(sol, ref, pv)
        assert vs_local["T_max_abs"] < 5e-3, vs_local
        step_ms, step1_ms = sum(ms) / len(ms), sum(ms1) / len(ms1)
        row = {"devices": world, "pts_total": n_pts, "pts_per_dev": p_local,
               "obs_total": int(obs["valid"].sum()), "step_ms": step_ms,
               "step_ms_1dev_same_problem": step1_ms,
               "overhead_efficiency": step1_ms / step_ms, "chi2": float(first[2]),
               "backend": backend, "device": str(dev), "step_ms_all": ms,
               "step_ms_1dev_all": ms1, "step_ms_median": statistics.median(ms),
               "vs_local_solver": vs_local, "agrees_with_local_solver": True,
               "bitwise_second_run": bitwise, "collective_16_bytes": lat,
               "collectives": (inventory(solve_log, gather_log, n_iter) if world > 1
                               else None)}
        if row_path:
            with open(row_path, "w") as fh:
                json.dump(row, fh)
        return row
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the harness
def launch(world: int, device: str, pts_per_dev: int, n_kf: int, n_iter: int,
           reps: int) -> dict:
    """``world`` rank processes of this module; rank 0's row.  Every process
    is waited for or killed; a failed rank raises with the ranks' output."""
    backend = "nccl" if device == "cuda" and world == 1 else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        row_path = os.path.join(tmp, "row.json")
        cmd = [sys.executable, "-m", "hso_tpu_torch.tools.bench_distributed_ba", f"world={world}",
               f"init=file://{tmp}/store", f"backend={backend}", f"device={device}",
               f"pts_per_dev={pts_per_dev}", f"kf={n_kf}", f"iters={n_iter}", f"reps={reps}",
               f"row={row_path}"]
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(cmd + [f"rank={r}"], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"weak scaling, {world} ranks:\n" + "\n".join(logs)[-3000:])
        with open(row_path) as fh:
            return json.load(fh)


def projection(collectives: dict, anchor: dict, n_iter: int, card: str | None) -> dict:
    """The JAX harness's ring model with this run's anchor and collective
    time and the H100's NVLink specification."""
    V = collectives["payload_bytes_per_lm_iteration"]
    n_coll = collectives["collectives_per_lm_iteration"]
    t_anchor = anchor["step_ms_1dev_same_problem"]
    lat_s = anchor["collective_16_bytes"]["back_to_back_us"] * 1e-6
    where = f"on {card}" if card else "on the CPU (not a device figure)"

    def eff(n, bw, lat):
        t_comm = (n_iter + 1) * (2.0 * V * (n - 1) / n / bw + n_coll * lat)
        return t_anchor / (t_anchor + t_comm * 1e3)

    return {"model": ("ring all-reduce: eff(n) = t_anchor / (t_anchor + (iters+1)·"
                      "(2·V·(n−1)/n/BW + n_coll·L))"),
            "anchor_solve_ms": t_anchor,
            "anchor_source": f"1-rank solve over {anchor['backend']} {where}, this run",
            "payload_bytes_per_lm_iteration": V, "collectives_per_lm_iteration": n_coll,
            "link_bytes_per_s": NVLINK_BYTES_PER_S, "link_source": NVLINK_SOURCE,
            "collective_latency_s": lat_s,
            "collective_latency_source": (f"1-rank {anchor['backend']} all_reduce of 16 bytes, "
                                          f"back to back, {where}, this run"),
            "projected_efficiency_by_devices": {str(n): eff(n, NVLINK_BYTES_PER_S, lat_s)
                                                for n in (2, 4, 8, 16, 32)},
            "sensitivity_8dev_10x_worse_link": eff(8, NVLINK_BYTES_PER_S / 10, lat_s * 10)}


def weak_scaling(device: str, dev_counts=(1, 2, 4, 8), pts_per_dev: int = 640, n_kf: int = 12,
                 n_iter: int = 10, reps: int = 5, card: str | None = None, emit=None) -> dict:
    """Rows for each rank count, the summary, the largest world's collectives
    and the projection (the module's docstring); ``emit(obj)`` sees each line."""
    emit = emit or (lambda obj: None)
    rows = []
    for n in dev_counts:
        row = launch(n, device, pts_per_dev, n_kf, n_iter, reps)
        rows.append(row)
        emit({k: v for k, v in row.items() if k != "collectives"})
    t1 = rows[0]["step_ms"]
    for row in rows:
        row["weak_scaling_efficiency"] = t1 / row["step_ms"]
        emit({"metric": "weak_scaling_efficiency", "devices": row["devices"],
              "value": row["weak_scaling_efficiency"],
              "overhead_efficiency": row["overhead_efficiency"]})
    collectives = next((r["collectives"] for r in reversed(rows) if r["collectives"]), None)
    if collectives is not None:
        collectives["jax_payload_bytes_per_lm_iteration_kf12"] = \
            JAX_PAYLOAD_BYTES_PER_LM_ITERATION_KF12
    anchor = next((r for r in rows if r["devices"] == 1), None)
    proj = (projection(collectives, anchor, n_iter, card)
            if collectives is not None and anchor is not None else None)
    emit({"collectives_measured": collectives, "projection": proj})
    for row in rows:
        row.pop("collectives")
    return {"collectives_measured": collectives, "projection": proj, "n_kf": n_kf,
            "n_iter": n_iter, "pts_per_dev": pts_per_dev, "results": rows}


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    if "rank" in args:
        torch.set_num_threads(1)
        run_rank(int(args["rank"]), int(args["world"]), args["init"], args["backend"],
                 args["device"], int(args["pts_per_dev"]), int(args["kf"]), int(args["iters"]),
                 int(args["reps"]), args.get("row"))
        return 0
    from hso_tpu_torch.tools.make_hard_artifact import device_of, hardware

    device = device_of(args, "bench_distributed_ba")
    if device is None:
        return 2
    hw = hardware(device)
    doc = weak_scaling(device.type, [int(x) for x in args.get("devices", "1,2,4,8").split(",")],
                       int(args.get("pts_per_dev", 640)), int(args.get("kf", 12)),
                       int(args.get("iters", 10)), int(args.get("reps", 5)), hw.get("card"),
                       emit=lambda obj: print(json.dumps(obj), flush=True))
    doc["hardware"] = hw
    doc["note"] = (
        "one process a rank; on the card 1 rank over NCCL and more over gloo, every rank's "
        "tensors on the one card, so the ranks share its silicon and the host: step_ms "
        "rising with the rank count is the shared card and host, not the algorithm. "
        "overhead_efficiency is t(1 rank, same whole problem) / t(n ranks); the projection "
        "carries the measured 1-rank solve and collective time to NVLink's specified rate.")
    if args.get("out"):
        with open(args["out"], "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"# wrote {args['out']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
