"""Scale-aligned ATE between an estimated TUM trajectory and ground truth.

The port's counterpart of the JAX package's ``scripts/evaluate_ate.py``, over
the port's own evaluation helpers (:mod:`hso_tpu_torch.utils.evaluate`):

    python -m hso_tpu_torch.tools.evaluate_ate result/MH01.txt MH01_gt.csv
        [--max-dt 0.02] [--no-scale] [--json]

Ground truth may be TUM (``stamp tx ty tz qx qy qz qw``) or EuRoC csv
(comma-separated, stamps in nanoseconds), told apart by the first data line.
Exits 2 below three associated pairs.  Runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import sys

from hso_tpu_torch.utils.evaluate import associate, ate, load_any, load_tum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground truth (TUM or EuRoC csv)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--no-scale", action="store_true", help="SE3 alignment instead of Sim3")
    ap.add_argument("--json", action="store_true", help="one JSON line")
    args = ap.parse_args(argv)

    st_e, rows_e = load_tum(args.est)
    st_g, xyz_g = load_any(args.gt)
    ia, ib = associate(st_e, st_g, max_dt=args.max_dt)
    if len(ia) < 3:
        print(f"error: only {len(ia)} associated pairs", file=sys.stderr)
        return 2
    res = ate(rows_e[ia, :3], xyz_g[ib], with_scale=not args.no_scale)
    if args.json:
        print(json.dumps({
            "ate_rmse": res.rmse, "ate_mean": res.mean, "ate_median": res.median,
            "ate_max": res.max, "n_pairs": res.n_pairs, "scale": res.scale,
        }))
    else:
        print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
