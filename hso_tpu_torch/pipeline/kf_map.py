"""The handler's keyframe map work as device programs: the map work of a
keyframe event and the pre-frame backfill sweeps, each a pure device
function, captured in CUDA graphs on the card.

Counterpart of the JAX handler's jitted helpers, which have no module of
their own in the JAX package (``hso_tpu/pipeline/frame_handler.py``:
``_kf_map_dispatch`` and ``_backfill_new_seeds`` call
``memoize_level_windows_packed``, ``harvest_and_prune``, ``occupancy_grid``,
``detect_features``, ``init_seeds`` and ``update_seeds``, each one compiled
program).  Here the whole map work is one graph and the sweeps of one event
another:

  * :func:`map_body` — the patch-source windows of the step's slots, the seed
    harvest and prune, the occupancy of the kept matches and the matched
    seeds, detection, the detections' bearings and the new seed batch, in the
    JAX order;
  * :func:`backfill_body` — the backfill mask (the new batch and the seeds
    that never fused a measurement), then one masked ``update_seeds`` a
    retained pre-frame, in the deque's order.

The host keeps what the JAX handler keeps there: the activation threshold,
the ring bookkeeping and the counters as numbers, which go in as staged
device scalars (``batch`` and ``ring_slot`` int32, as ``init_seeds`` takes
them; the thresholds and depths float32), and the ring poses and exposures as
numpy arrays staged through pinned memory.  Neither body reads the device on
the host or makes a tensor from host data, so a capture replays all of it.

:func:`captured_kf_map` and :func:`captured_backfill` keep the graphs in a
cache on the handler, as :func:`hso_tpu_torch.pipeline.ba_glue.captured_local_ba`
keeps the BA solves: one :class:`~hso_tpu_torch.pipeline.step_graph.StepGraph`
with one instance for the map work, and one a count ``k`` of pre-frames swept
(1 to ``Config.pre_frames_max``; an event with none sweeps nothing), each
captured at its first event.  One instance is enough: the handler reads
every result of an event (the harvest bundle, the windows, the seed table
before the harvest) before its next event calls the graph again, and keeps
a copy of the seed table the event leaves (a graph's output, which the next
event of that key overwrites), as it keeps copies of the step's outputs.
``graph=False`` (and every CPU handler) calls the same bodies directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hso_tpu_torch.mapping.depth_filter import harvest_and_prune, init_seeds, update_seeds
from hso_tpu_torch.ops.detect import detect_features, occupancy_grid
from hso_tpu_torch.ops.warp import memoize_level_windows_packed
from hso_tpu_torch.pipeline.step_graph import StepGraph, _tree_map

#: the step outputs the map work reads, and the members of the frame's data
STEP_KEYS = ("px", "level", "success", "inlier", "seed_match_px", "seed_matched")
DATA_KEYS = ("pyr", "sobel_x", "sobel_y", "grad_mean")
OCC_CELL = 32            #: detection and occupancy cell edge at level 0
DETECT_LEVELS = 3        #: pyramid levels searched by detection

#: optional observer called with ``(kind, args)`` of every map ("map") and
#: backfill ("backfill") call of a handler's keyframe event, graph or eager
#: (the tests and ``chip_smoke.py`` hold the calls through it)
call_capture = None


def map_inputs(out, data) -> tuple:
    """What :func:`map_body` reads of a step's output ``out`` and of the
    frame's ``data``."""
    return {k: out[k] for k in STEP_KEYS}, {k: data[k] for k in DATA_KEYS}


def map_body(seeds, step_sub, data, ring_T, batch, ring_slot, min_act, depth_mean, depth_min,
             converge_thresh, *, cam, cfg):
    """The map work of a keyframe event: returns ``(seeds', bundle,
    refresh_buf)``.

    ``seeds`` the table the event's frame swept; ``step_sub``/``data`` as
    :func:`map_inputs`; ``ring_T`` the host ring's poses before the new
    keyframe takes its slot; ``batch`` the harvest's batch counter (the new
    batch is ``batch + 1``) and ``ring_slot`` the new keyframe's slot, 0-d
    int32; ``min_act`` (the activation's minimum observations),
    ``depth_mean``, ``depth_min`` and ``converge_thresh`` 0-d float32."""
    f32 = torch.float32
    # per-slot patch-source windows (read by the handler's patch refresh)
    refresh_buf = memoize_level_windows_packed(data["pyr"], step_sub["px"], step_sub["level"])
    seeds, bundle = harvest_and_prune(seeds, batch, ring_T, cfg.max_seed_kf_batches, min_act,
                                      float(cam.focal_mean))
    # detection with the device-side occupancy: the kept matches and the
    # matched seeds
    px_occ = torch.cat([step_sub["px"], step_sub["seed_match_px"]], dim=0)
    v_occ = torch.cat([step_sub["success"] & step_sub["inlier"], step_sub["seed_matched"]], dim=0)
    occ = occupancy_grid(px_occ, v_occ, cam.height, cam.width, OCC_CELL)
    det = detect_features(data["pyr"][:DETECT_LEVELS], data["sobel_x"], data["sobel_y"],
                          data["grad_mean"], occ, n_out=cfg.n_fts_max,
                          with_gradient=bool(cfg.use_gradient_features))
    f_det = cam.cam2world(det["px"]).to(f32)
    seeds = init_seeds(seeds, det, data["pyr"], f_det, ring_slot, batch + 1, depth_mean,
                       depth_min, converge_thresh)
    return seeds, bundle, refresh_buf


def backfill_body(seeds, batch, ring_T, ring_exp, pre, px_error_angle, *, cam):
    """The backfill sweeps of a keyframe event: ``seeds`` swept against each
    pre-frame of ``pre`` (tuples ``(pyr, sobel_x, sobel_y, T_f_w,
    exposure)``), masked to the batch ``batch`` (0-d int32) and to the seeds
    that never fused a measurement (a seed with successes is left out, so no
    pre-frame is fused twice).  ``ring_T``/``ring_exp``: the host ring with
    the new keyframe in its slot."""
    new_mask = ((seeds["batch_id"] == batch) | (seeds["n_updates"] < 0.5)) & seeds["valid"]
    for pyr, sobel_x, sobel_y, T_f_w, exposure in pre:
        seeds, _ = update_seeds(seeds, ring_T, ring_exp, pyr, sobel_x, sobel_y, T_f_w, exposure,
                                px_error_angle, cam, update_mask=new_mask)
    return seeds


def eager(body, device):
    """``body`` called directly, with its numpy leaves copied to ``device``
    first (what a :class:`StepGraph` stages through pinned memory)."""
    device = torch.device(device)

    def upload(x):
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.array(x, copy=True))
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    def call(*args):
        return body(*_tree_map(upload, args))

    return call


def captured_kf_map(cache: dict, device, cam, cfg) -> StepGraph:
    """The map work from ``cache``, made on first use: a :class:`StepGraph`
    of :func:`map_body` with one instance, captured at its first call.  On
    the CPU the instance calls the body on its staged inputs."""
    if "map" not in cache:
        cache["map"] = StepGraph(functools.partial(map_body, cam=cam, cfg=cfg), device,
                                 instances=1, image=False)
    return cache["map"]


def captured_backfill(cache: dict, device, cam, k: int) -> StepGraph:
    """The ``k`` backfill sweeps from ``cache`` (key ``("backfill", k)``),
    made on first use, as :func:`captured_kf_map`."""
    key = ("backfill", int(k))
    if key not in cache:
        cache[key] = StepGraph(functools.partial(backfill_body, cam=cam), device, instances=1,
                               image=False)
    return cache[key]
