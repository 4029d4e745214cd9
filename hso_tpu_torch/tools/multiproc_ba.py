"""Rank body of the multi-process windowed BA:
``python -m hso_tpu_torch.tools.multiproc_ba``.

    python -m hso_tpu_torch.tools.multiproc_ba --rank R --world N --init URL
        [--backend gloo|nccl] [--device cuda|cpu] [--repeat 2] [--out PREFIX]

Start one process per rank, all with the same ``--world`` and ``--init``
(``file://<path>`` of a file that does not exist yet, or
``tcp://localhost:<port>``).  Each rank joins the process group, loads
``artifacts/bench_ba.npz`` (the BA window the JAX bench captured from its live
pipeline: K 16, P 2,048, the scan's full BA width), and solves it with
:func:`hso_tpu_torch.ba.distributed.distributed_bundle_adjustment` over the
world, ``--repeat`` times: every solve must give the same bits, and every
rank the same result.  Rank 0 holds it against
:func:`hso_tpu_torch.ba.local_ba.local_bundle_adjustment` on the same device
with the JAX package's tolerances (chi2 rtol 0.1, inverse distances rtol 0.05
/ atol 1e-3, inlier agreement above 0.98), times that solver ``--repeat``
times too (host clock, synchronised), prints one JSON line, and with
``--out`` writes ``PREFIX.json`` and the solution to ``PREFIX.npz``.  Exits
non-zero on a failed check.  Runs on the card (every rank on ``cuda:0``;
NCCL takes one rank a card, gloo more); without one it exits 2 unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from hso_tpu_torch.ba.distributed import distributed_bundle_adjustment
from hso_tpu_torch.ba.local_ba import local_bundle_adjustment

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BA_NPZ = os.path.join(ROOT, "artifacts", "bench_ba.npz")
#: the JAX package's tolerances (tests/test_distributed_ba.py)
TOL = dict(chi2_rtol=0.1, chi2_atol=1e-5, idist_rtol=0.05, idist_atol=1e-3,
           inlier_agreement=0.98)


def load_ba_problem(path: str, device) -> tuple:
    """(args, kwargs) of a BA problem written by the JAX bench's capture:
    T_kf, free, idist, point_valid and the observation dict on ``device``."""
    z = np.load(path)
    obs = {k[4:]: torch.as_tensor(z[k]).to(device) for k in z.files if k.startswith("obs_")}
    kw = json.loads(bytes(z["kw_json"]).decode())
    args = tuple(torch.as_tensor(z[k]).to(device) for k in ("T_kf", "free", "idist", "pvalid"))
    return args + (obs,), kw


def hold(out: dict, ref: dict, pvalid: torch.Tensor) -> dict:
    """Distances of a solution from the reference, asserted within ``TOL``."""
    c, c_ref = float(out["chi2_final"]), float(ref["chi2_final"])
    assert np.isfinite(c) and abs(c - c_ref) <= TOL["chi2_rtol"] * abs(c_ref) + TOL["chi2_atol"], \
        (c, c_ref)
    pv = pvalid.cpu().numpy()
    a, b = out["idist"].cpu().numpy()[pv], ref["idist"].cpu().numpy()[pv]
    over = np.abs(a - b) - (TOL["idist_atol"] + TOL["idist_rtol"] * np.abs(b))
    assert (over <= 0).all(), f"inverse distances differ by {float(np.abs(a - b).max())}"
    agree = float((out["obs_inlier"] == ref["obs_inlier"]).to(torch.float32).mean())
    assert agree > TOL["inlier_agreement"], agree
    return dict(chi2_final=c, chi2_final_local=c_ref, idist_max_abs=float(np.abs(a - b).max()),
                T_max_abs=float((out["T_kf"] - ref["T_kf"]).abs().max()),
                inlier_agreement=agree)


def same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("T_kf", "idist", "obs_inlier", "chi2_final"))


def run(rank: int, world: int, init: str, backend: str, device: str, repeat: int,
        out_prefix: str | None = None) -> dict | None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    try:
        args, kw = load_ba_problem(BA_NPZ, dev)
        solves, ms = [], []
        for _ in range(repeat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            solves.append(distributed_bundle_adjustment(*args, **kw))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        first = solves[0]
        assert all(same_bits(first, s) for s in solves[1:]), f"rank {rank}: a solve differs"
        # every rank holds the same result: rank 0's T_kf against each rank's
        T0 = first["T_kf"].clone()
        dist.broadcast(T0, src=0)
        assert torch.equal(T0, first["T_kf"]), f"rank {rank}: T_kf differs from rank 0's"
        if rank != 0:
            return None
        local_ms = []
        for _ in range(repeat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ref = local_bundle_adjustment(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            local_ms.append((time.perf_counter() - t0) * 1e3)
        doc = dict(ok=True, world=world, backend=backend, device=str(dev),
                   problem=os.path.relpath(BA_NPZ, ROOT), n_kf=kw["n_kf"], n_pts=kw["n_pts"],
                   p_local=-(-kw["n_pts"] // world), repeats=repeat, bitwise_repeat=True,
                   solve_ms=ms, solve_ms_median_after_first=(statistics.median(ms[1:])
                                                             if len(ms) > 1 else None),
                   local_solve_ms=local_ms,
                   chi2_init=float(first["chi2_init"]), **hold(first, ref, args[3]))
        if out_prefix:
            with open(out_prefix + ".json", "w") as fh:
                json.dump(doc, fh)
            np.savez(out_prefix + ".npz", **{k: first[k].cpu().numpy() for k in
                                             ("T_kf", "idist", "obs_inlier", "chi2_final")})
        print(json.dumps(doc), flush=True)
        return doc
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="file://<path> or tcp://localhost:<port>")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (default; every rank on cuda:0) "
                                                     "or cpu")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--out", default=None, help="rank 0 writes PREFIX.json and PREFIX.npz")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("multiproc_ba: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    run(a.rank, a.world, a.init, a.backend, a.device, a.repeat, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
