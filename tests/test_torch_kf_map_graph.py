"""The handler's keyframe map work as device programs, on the CPU:
``pipeline/kf_map.py`` (``map_body``: patch-source windows, harvest,
occupancy, detection, the new seed batch; ``backfill_body``: the pre-frame
sweeps), on the card captured graphs from the handler's cache
(``captured_kf_map``, ``captured_backfill``), the counterpart of the JAX
handler's jitted ``_kf_map_dispatch`` and ``_backfill_new_seeds`` calls.

Input: the port's handler resumed from ``artifacts/bench_boot.npz``
(``resume_stage="default"``) through the first keyframe event it decides
(as ``tests/test_torch_frame_handler.py``), the calls of that event as
``kf_map.call_capture`` saw them.

(a) Each body on its staged inputs (a CPU ``_Instance``: the tensors a
    capture would see, after one warm call as ``StepGraph`` makes before a
    capture) under the guard of ``tests/test_torch_keyframe_graph.py``, the
    plain versions of the six kernels allowed (one launch each on the card):
    no host read, no scalar read by PyTorch's indexing, no tensor made from
    host data; the direct call's bits.
(b) The same inputs through the JAX package's functions in the JAX handler's
    order (``memoize_level_windows_packed``, ``harvest_and_prune``,
    ``occupancy_grid``, ``detect_features``, ``cam2world``, ``init_seeds``,
    then the masked ``update_seeds`` a pre-frame): the bundle's selection
    columns, the seed table's integer members and the new batch (the
    detections) exact, the windows and ``refresh_buf`` to 1e-6, bearings to
    1e-6, the float members as ``tests/test_torch_depth_filter.py`` holds
    them: 1e-7 after the map work; each sweep from the same table on both
    sides, at most 1 % of the live rows matched by one side only, on the rows
    both matched the pixel 2e-2, ``mu`` 1e-3, the observation 5e-5 and
    ``sigma2`` 1e-4 or 1 % of itself.  The backfill sweeps fresh seeds
    (σ² up to 0.12 here, ≈ 1e-3 in that file's scene) over the pre-frames'
    short baselines, where the triangulation's cancellation moves σ² by up
    to 0.4 % on matches of the same bits (0.116451 against 0.115992 on this
    input, ``mu`` 2e-4 apart).
(c) The handler through the keyed cache (``h._graph = True``: on the CPU a
    ``StepGraph`` calls the body on its staged inputs) against the eager
    handler, bit for bit in every result, the seed table, the point table and
    the counters: on the resumed segment (an event with 3 pre-frames) and on
    the bootstrap of ``tests/test_pipeline_e2e.py``'s plane up to the event
    forced after it (1 pre-frame, the first keyframe).  The cache holds one
    map graph and one backfill graph a count of pre-frames reached.
(d) The lag-1 loop through an event with the cached bodies: the eager loop's
    bits, and the table dispatched two frames after the event carries the
    event's new batch (the graft, ``tests/test_torch_pipelined.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.mapping import depth_filter as jdf
from hso_tpu.ops.detect import detect_features as jax_detect, occupancy_grid as jax_occupancy
from hso_tpu.ops.warp import memoize_level_windows_packed as jax_refresh_windows
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.mapping import depth_filter as tdf
from hso_tpu_torch.ops import align_cuda, epipolar_cuda, window_cuda
from hso_tpu_torch.pipeline import kf_map
from hso_tpu_torch.pipeline.frame_handler import RESULT_KEYFRAME, STAGE_DEFAULT, FrameHandler
from hso_tpu_torch.pipeline.step_graph import StepGraph, _Instance
from hso_tpu_torch.track import coarse_cuda, pose_cuda
from hso_tpu_torch.utils.checkpoint import load_checkpoint
from hso_tpu_torch.utils.synthetic import PlaneScene
from test_pipeline_e2e import make_trajectory
from test_torch_keyframe_graph import _DeviceReads, host_reads_forbidden

torch.set_num_threads(1)

#: the plain versions of the six kernels: on the card each is one launch
KERNEL_TWINS = tuple(f.__code__ for f in (
    window_cuda.extract_windows_plain, window_cuda.extract_windows_multi_plain,
    window_cuda.pack_level_windows_plain, coarse_cuda.coarse_level_ic_plain,
    align_cuda.align_match_plain, pose_cuda.pose_lm_plain,
    epipolar_cuda.zmncc_line_scores_plain))
N_MAX = 12               #: at most this many frames to find the first decided event
SEED_EXACT = ("valid", "host", "level", "species", "batch_id", "host_anchor", "obs_count",
              "temp_point", "px", "grad", "host_win", "obs_valid")
SEED_FLOAT = ("mu", "sigma2", "a", "b", "z_range", "converge_thresh", "n_updates")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(x):
    return jnp.asarray(_np(x))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(_bits(a), _bits(b)), path
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _run(h, frames, start, stop_after=1, pipelined=False):
    """Frames through ``h`` (``add_image``, or the lag-1 loop then ``flush``)
    until ``stop_after`` frames past the first keyframe result of a decided
    event; the results, the event's index and the map and backfill calls."""
    calls = []
    kf_map.call_capture = lambda kind, args: calls.append((kind, cs.clone_tree(args)))
    try:
        results, event = [], None
        for k, img in enumerate(frames):
            if pipelined:
                r = h.add_image_pipelined(img, ts=float(start + k))
                results += [r] if r is not None else []
            else:
                results.append(h.add_image(img, ts=float(start + k)))
            if event is None:
                event = next((i for i, x in enumerate(results)
                              if x.status == RESULT_KEYFRAME), None)
            if event is not None and k >= event + stop_after:
                break
        if pipelined:
            results += h.flush()
    finally:
        kf_map.call_capture = None
    assert event is not None, [r.status for r in results]
    return results, event, calls


def _resumed_handler(graph: bool):
    h = FrameHandler(cs.bench_camera(), Config(), device="cpu")
    load_checkpoint(h, cs.BOOT_NPZ, resume_stage="default")
    h._graph = graph               # on the CPU a graph is the instance path
    return h


@pytest.fixture(scope="module")
def resumed_frames():
    cam = cs.bench_camera()
    start = int(np.load(cs.BOOT_NPZ)["frame_count"])
    return start, cs.render_frames(cs.bench_scene(cam), cs.trajectory(start + N_MAX)[start:])


@pytest.fixture(scope="module")
def resumed(resumed_frames):
    """The resumed segment on an eager handler and through the cache."""
    start, frames = resumed_frames
    runs = {}
    for graph in (False, True):
        h = _resumed_handler(graph)
        res, event, calls = _run(h, frames, start)
        runs[graph] = dict(h=h, results=res, event=event, calls=calls)
    return runs


def _call(resumed, kind):
    calls = [a for k, a in resumed[False]["calls"] if k == kind]
    assert len(calls) == 1, [k for k, _ in resumed[False]["calls"]]
    return calls[0]


def _body(kind):
    cam, cfg = cs.bench_camera(), Config()
    return (lambda *a: kf_map.map_body(*a, cam=cam, cfg=cfg)) if kind == "map" else \
        (lambda *a: kf_map.backfill_body(*a, cam=cam))


# ---------------------------------------------------------------- (a)
@pytest.fixture(scope="module", params=["map", "backfill"])
def guarded(resumed, request):
    kind = request.param
    args = _call(resumed, kind)
    body = _body(kind)
    want = kf_map.eager(body, "cpu")(*args)
    inst = _Instance(args, torch.device("cpu"), image=False)
    inst.stage(args)
    body(*inst.inputs)                   # the warm call a StepGraph makes before capturing
    log = {"kernel_twin": 0}
    reads = _DeviceReads(KERNEL_TWINS)
    with host_reads_forbidden(log, KERNEL_TWINS), reads:
        got = body(*inst.inputs)
    return dict(kind=kind, got=got, want=want, reads=reads, log=log)


def test_staged_body_reads_nothing_on_the_host(guarded):
    assert guarded["reads"].scalar_reads == 0, guarded["kind"]
    assert guarded["reads"].uploads == 0, guarded["kind"]


def test_staged_body_is_the_direct_call(guarded):
    _same_tree(guarded["got"], guarded["want"], guarded["kind"])


# ---------------------------------------------------------------- (b)
@pytest.fixture(scope="module")
def against_jax(resumed):
    """The event's map and backfill calls through the port's bodies and
    through the JAX functions in the JAX handler's order."""
    cam, cfg = cs.bench_camera(), Config()
    cam_j = JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    m_args = _call(resumed, "map")
    b_args = _call(resumed, "backfill")
    port_map = kf_map.eager(_body("map"), "cpu")(*m_args)
    port_bf = kf_map.eager(_body("backfill"), "cpu")(*b_args)

    seeds, sub, data, ring_T, batch, ring_slot, min_act, d_mean, d_min, thresh = m_args
    seeds_j = {k: _j(v) for k, v in seeds.items()}
    pyr_j = tuple(_j(p) for p in data["pyr"])
    refresh_j = jax_refresh_windows(pyr_j, _j(sub["px"]), _j(sub["level"]))
    sj, bundle_j = jdf.harvest_and_prune(seeds_j, int(batch), _j(ring_T),
                                         cfg.max_seed_kf_batches, float(min_act),
                                         float(cam.focal_mean))
    px_occ = jnp.concatenate([_j(sub["px"]), _j(sub["seed_match_px"])], axis=0)
    v_occ = jnp.concatenate([_j(sub["success"]) & _j(sub["inlier"]), _j(sub["seed_matched"])],
                            axis=0)
    occ = jax_occupancy(px_occ, v_occ, cam.height, cam.width, kf_map.OCC_CELL)
    det = jax_detect(pyr_j[:3], tuple(_j(p) for p in data["sobel_x"]),
                     tuple(_j(p) for p in data["sobel_y"]), _j(data["grad_mean"]), occ,
                     n_out=cfg.n_fts_max, with_gradient=bool(cfg.use_gradient_features))
    f_det = cam_j.cam2world(det["px"]).astype(jnp.float32)
    sj = jdf.init_seeds(sj, det, pyr_j, f_det, int(ring_slot), int(batch) + 1, float(d_mean),
                        float(d_min), float(thresh))

    # the sweeps one at a time, each side from the port's table before it (as
    # tests/test_torch_depth_filter.py compares a sweep), the mask made once
    b_seeds, b_batch, b_ring_T, b_ring_exp, pre, px_err = b_args
    mask = ((b_seeds["batch_id"] == b_batch) | (b_seeds["n_updates"] < 0.5)) & b_seeds["valid"]
    sweeps, table = [], b_seeds
    for pyr, sx, sy, T, exposure in pre:
        nxt, stats = tdf.update_seeds(table, torch.as_tensor(b_ring_T),
                                      torch.as_tensor(b_ring_exp), pyr, sx, sy, T, exposure,
                                      px_err, cam, update_mask=mask)
        ref, stats_j = jdf.update_seeds(
            {k: _j(v) for k, v in table.items()}, _j(b_ring_T), _j(b_ring_exp),
            tuple(_j(p) for p in pyr), tuple(_j(p) for p in sx), tuple(_j(p) for p in sy),
            _j(T), float(exposure), float(px_err), cam_j, update_mask=_j(mask))
        sweeps.append(({k: _np(v) for k, v in nxt.items()}, {k: _np(v) for k, v in stats.items()},
                       {k: np.asarray(v) for k, v in ref.items()},
                       {k: np.asarray(v) for k, v in stats_j.items()}))
        table = nxt
    return dict(port_map=port_map, port_bf=port_bf, chained=table, sweeps=sweeps,
                b_in={k: _np(v) for k, v in b_seeds.items()}, mask=_np(mask),
                jax_map=({k: np.asarray(v) for k, v in sj.items()}, np.asarray(bundle_j),
                         np.asarray(refresh_j)),
                batch=int(batch) + 1)


def test_map_work_bundle_and_windows_match_the_jax_handler(against_jax):
    _, bundle, refresh = against_jax["port_map"]
    _, bundle_j, refresh_j = against_jax["jax_map"]
    bundle, refresh = _np(bundle), _np(refresh)
    assert bundle.shape == bundle_j.shape and refresh.shape == refresh_j.shape
    # converged, stale, host, px, f, level, species, grad; temp_point, n_updates
    np.testing.assert_array_equal(bundle[:, :12], bundle_j[:, :12])
    np.testing.assert_array_equal(bundle[:, 13:], bundle_j[:, 13:])
    np.testing.assert_allclose(bundle[:, 12], bundle_j[:, 12], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(refresh, refresh_j, rtol=0, atol=1e-6)
    assert (bundle[:, 0] > 0.5).sum() + (bundle[:, 1] > 0.5).sum() > 0   # the harvest took rows


def test_map_work_seed_table_matches_the_jax_handler(against_jax):
    seeds = {k: _np(v) for k, v in against_jax["port_map"][0].items()}
    ref = against_jax["jax_map"][0]
    for k in SEED_EXACT:
        np.testing.assert_array_equal(seeds[k], ref[k], err_msg=k)
    np.testing.assert_allclose(seeds["f"], ref["f"], rtol=0, atol=1e-6)
    for k in SEED_FLOAT:
        np.testing.assert_allclose(seeds[k], ref[k], rtol=1e-7, atol=1e-7, err_msg=k)
    # the new batch: the event's detections, in the JAX order
    new = seeds["valid"] & (seeds["batch_id"] == against_jax["batch"])
    assert new.sum() == (ref["valid"] & (ref["batch_id"] == against_jax["batch"])).sum() > 50


def test_backfill_body_is_its_sweeps_in_turn(against_jax):
    _same_tree(against_jax["port_bf"], against_jax["chained"], "backfill")
    assert len(against_jax["sweeps"]) == 3


def test_backfill_sweeps_match_the_jax_handler(against_jax):
    """Each sweep from the same table on both sides, held as
    tests/test_torch_depth_filter.py holds a sweep."""
    before, mask = against_jax["b_in"], against_jax["mask"]
    live = int(before["valid"].sum())
    n_both = 0
    for k, (got, gs, ref, rs) in enumerate(against_jax["sweeps"]):
        assert int(gs["n_visible"]) == int(rs["n_visible"]), k
        flips = int((gs["matched"] != rs["matched"]).sum())
        assert flips <= max(1, live // 100), (k, flips)
        assert not gs["matched"][~mask].any()
        for name in ("valid", "host", "level", "species", "batch_id", "host_anchor",
                     "temp_point", "px", "f", "grad", "host_win"):
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        same = gs["matched"] == rs["matched"]
        for name in ("obs_count", "obs_valid", "b", "n_updates"):
            np.testing.assert_array_equal(got[name][same], ref[name][same], err_msg=name)
        both = gs["matched"] & rs["matched"]
        np.testing.assert_allclose(gs["px_match"][both], rs["px_match"][both], atol=2e-2)
        np.testing.assert_allclose(got["mu"][both], ref["mu"][both], atol=1e-3)
        # 1e-4, or 1 % of a fresh seed's large variance (see the docstring)
        np.testing.assert_allclose(got["sigma2"][both], ref["sigma2"][both], rtol=1e-2,
                                   atol=1e-4)
        np.testing.assert_allclose(got["obs_uv"][both], ref["obs_uv"][both], atol=5e-5)
        n_both += int(both.sum())
    assert n_both > 20
    # the sweeps touch the masked rows only
    got = against_jax["sweeps"][-1][0]
    for name in ("mu", "sigma2", "b", "n_updates", "obs_count"):
        np.testing.assert_array_equal(got[name][~mask], before[name][~mask], err_msg=name)


# ---------------------------------------------------------------- (c)
def _same_handler(a, b):
    for name in ("batch_counter", "frame_count", "stage", "mean_converge_frames"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.seed_ring, b.seed_ring)
    _same_tree(a.seeds, b.seeds, "seeds")
    for name in ("valid", "type", "idist", "host_kf", "host_win", "patch_win", "patch_px",
                 "n_succ", "n_fail"):
        np.testing.assert_array_equal(getattr(a.points, name), getattr(b.points, name),
                                      err_msg=name)
    np.testing.assert_array_equal(a.kfs.poses, b.kfs.poses)
    assert len(a.kfs.frames) == len(b.kfs.frames)


def _same_results(ra, rb):
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert (x.status, x.n_matches, x.n_inliers, x.n_seeds_updated) == \
            (y.status, y.n_matches, y.n_inliers, y.n_seeds_updated)
        np.testing.assert_array_equal(x.T_f_w, y.T_f_w)


def test_resumed_event_through_the_cache_is_the_eager_event(resumed):
    e, g = resumed[False], resumed[True]
    assert e["event"] == g["event"]
    _same_results(e["results"], g["results"])
    _same_handler(e["h"], g["h"])
    assert [k for k, _ in g["calls"]] == [k for k, _ in e["calls"]] == ["map", "backfill"]
    for (_, a), (_, b) in zip(e["calls"], g["calls"]):
        _same_tree(a, b, "call")
    k = len(g["calls"][1][1][4])
    assert k == 3
    assert sorted(g["h"]._kf_graphs, key=str) == [("backfill", k), "map"]
    assert all(isinstance(v, StepGraph) for v in g["h"]._kf_graphs.values())
    assert not e["h"]._kf_graphs


@pytest.fixture(scope="module")
def bootstrap():
    """The plane of tests/test_pipeline_e2e.py from frame 0 to one frame past
    the event forced after the bootstrap, on an eager handler and through
    the cache."""
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    frames = [scene.render(T) for T in make_trajectory(36)]
    runs = {}
    for graph in (False, True):
        h = FrameHandler(cam, Config(), device="cpu")
        h._graph = graph
        calls = []
        kf_map.call_capture = lambda kind, args: calls.append((kind, len(args[4])
                                                               if kind == "backfill" else 0))
        try:
            res, after = [], None
            for k, img in enumerate(frames):
                res.append(h.add_image(img, ts=float(k)))
                if after is None and h.stage == STAGE_DEFAULT and len(h.kfs.frames) == 3:
                    after = k
                if after is not None and k == after + 1:
                    break
        finally:
            kf_map.call_capture = None
        assert after is not None, [r.status for r in res]
        runs[graph] = dict(h=h, results=res, calls=calls)
    return runs


def test_bootstrap_event_through_the_cache_is_the_eager_event(bootstrap):
    e, g = bootstrap[False], bootstrap[True]
    _same_results(e["results"], g["results"])
    _same_handler(e["h"], g["h"])
    # the bootstrap's own backfill (eager on both) and the forced event's
    # sweeps: one pre-frame each, the first keyframe
    assert g["calls"] == e["calls"] == [("backfill", 1), ("map", 0), ("backfill", 1)]
    assert sorted(g["h"]._kf_graphs, key=str) == [("backfill", 1), "map"]


def test_cache_keys_are_made_once():
    cache, cam, cfg = {}, cs.bench_camera(), Config()
    m = kf_map.captured_kf_map(cache, "cpu", cam, cfg)
    b2 = kf_map.captured_backfill(cache, "cpu", cam, 2)
    assert kf_map.captured_kf_map(cache, "cpu", cam, cfg) is m
    assert kf_map.captured_backfill(cache, "cpu", cam, 2) is b2
    assert kf_map.captured_backfill(cache, "cpu", cam, 3) is not b2
    assert sorted(cache, key=str) == [("backfill", 2), ("backfill", 3), "map"]
    assert m.n_instances == b2.n_instances == 1 and not m.image and not b2.image


# ---------------------------------------------------------------- (d)
@pytest.fixture(scope="module")
def lag1(resumed_frames):
    start, frames = resumed_frames
    runs = {}
    for graph in (False, True):
        h = _resumed_handler(graph)
        sent = []
        dispatch = h._dispatch_default

        def rec_dispatch(frame, img, seeds_in, I_rel, _d=dispatch, _s=sent):
            _s.append({k: seeds_in[k].clone() for k in ("valid", "batch_id")})
            return _d(frame, img, seeds_in, I_rel)

        h._dispatch_default = rec_dispatch
        res, event, calls = _run(h, frames, start, stop_after=2, pipelined=True)
        del h._dispatch_default
        runs[graph] = dict(h=h, results=res, event=event, calls=calls, sent=sent)
    return runs


def test_lag1_event_through_the_cache_is_the_eager_loop(lag1):
    e, g = lag1[False], lag1[True]
    assert e["event"] == g["event"]
    _same_results(e["results"], g["results"])
    _same_handler(e["h"], g["h"])
    assert [k for k, _ in g["calls"]] == ["map", "backfill"]
    assert sorted(g["h"]._kf_graphs, key=str) == [("backfill", 3), "map"]


def test_lag1_graft_carries_the_event_batch(lag1):
    """The event of frame e is finalised after frame e+1's dispatch; the table
    dispatched for frame e+2 holds the event's whole new batch."""
    g = lag1[True]
    e = g["event"]
    batch = int(g["calls"][1][1][1])                # the backfill's batch: the new one
    seeds = g["calls"][1][1][0]                     # the table the map work left
    n_new = int((seeds["valid"] & (seeds["batch_id"] == batch)).sum())
    sent = g["sent"][e + 2]
    assert int((sent["valid"] & (sent["batch_id"] == batch)).sum()) == n_new > 50
    assert int((g["sent"][e + 1]["valid"] & (g["sent"][e + 1]["batch_id"] == batch)).sum()) == 0
