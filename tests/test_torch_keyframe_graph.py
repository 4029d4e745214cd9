"""The keyframe work as device programs, on the CPU: the scan's keyframe
body (``pipeline/scan.py::make_keyframe_body``, the JAX bench's ``lax.cond``
around ``kf_work``, ``bench.py:533-534``) and the handler's windowed-BA solve
(``pipeline/ba_glue.py::captured_local_ba``, the JAX package's
``_jitted_local_ba``), each a ``StepGraph`` on the card.

(a) The body on its staged inputs (a CPU ``_Instance``: the tensors a capture
    would see) under a guard that makes ``Tensor.__bool__``, ``.item()``,
    ``.tolist()``, ``__float__``, ``__int__`` and ``__index__`` raise, but
    inside K2's plain version (one launch on the card), and that counts the
    scalar reads PyTorch's C++ makes (``aten._local_scalar_dense``: a 0-d
    integer tensor used as a subscript is read so, where the Python guard
    cannot see it) and the tensors made from host data (``aten.lift_fresh``:
    an upload a graph could not replay).  Input: the scan's start state from
    ``artifacts/bench_boot.npz`` and the JAX step's output on the next frame,
    as in ``tests/test_torch_keyframe.py``; the result against the JAX body
    (``tests/scan_reference_jax.py``) at that file's tolerances: selection
    and copied members exact, poses 1e-5, inverse distances and positions
    1e-4 relative, chi2 1e-3 relative, seeds as ``tests/test_torch_depth_filter.py``.
(b) The counters ``kf_count`` and ``batch``: 0-d int32 tensors on the
    state's device, equal to the JAX bench's before and after the event.
(c) The scan with its body behind a (CPU) ``StepGraph``, two instances used in
    turns, over two events: the eager scan's bits in every output, the map
    state and the seed table; each event's statistics outlive the instance
    that made them.
(d) The handler's solve through its cache: the direct solver's bits at
    ``n_iter`` 10 and 30 on the problem ``run_local_ba`` assembles, one
    cached solve a key, ``solve_capture`` called, and ``cfg.distributed_ba``
    solving outside the cache.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.config import Config
from hso_tpu_torch.ops import window_cuda
from hso_tpu_torch.pipeline import ba_glue, scan
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.pipeline.keyframe import R_RES
from hso_tpu_torch.pipeline.step_graph import StepGraph, _Instance
from hso_tpu_torch.utils.checkpoint import load_checkpoint, scan_state_from_checkpoint
from scan_reference_jax import JaxScan

torch.set_num_threads(1)

HOST_READS = ("__bool__", "item", "tolist", "__float__", "__int__", "__index__")
#: K2's plain version: one launch on the card, host reads allowed on the CPU
K2_PLAIN = window_cuda.pack_level_windows_plain.__code__


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _in_twin(frame, twins=(K2_PLAIN,)) -> bool:
    """Whether ``frame`` runs inside one of ``twins`` (code objects of kernels'
    plain versions: on the card each is one launch)."""
    while frame is not None:
        if frame.f_code in twins:
            return True
        frame = frame.f_back
    return False


class _DeviceReads(TorchDispatchMode):
    """Counts the scalar reads of PyTorch's own (``_local_scalar_dense``,
    what ``.item()`` and C++ indexing call) outside the plain versions
    ``twins`` (K2's by default), and the tensors made from host data."""

    def __init__(self, twins=(K2_PLAIN,)):
        super().__init__()
        self.twins = tuple(twins)
        self.scalar_reads = 0
        self.uploads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default \
                and not _in_twin(sys._getframe(1), self.twins):
            self.scalar_reads += 1
        if func is torch.ops.aten.lift_fresh.default:
            self.uploads += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_reads_forbidden(log, twins=(K2_PLAIN,)):
    """Every host read of a tensor raises, but inside the plain versions
    ``twins`` (K2's by default); ``log["kernel_twin"]`` counts those."""
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}

    def guarded(name, orig):
        def read(self, *a, **k):
            if _in_twin(sys._getframe(1), twins):
                log["kernel_twin"] += 1
                return orig(self, *a, **k)
            raise AssertionError(f"Tensor.{name} in the keyframe body")
        return read

    for name, orig in saved.items():
        setattr(torch.Tensor, name, guarded(name, orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


# ---------------------------------------------------------------- (a), (b)
@pytest.fixture(scope="module")
def guarded():
    cam, cfg = cs.bench_camera(), Config()
    js = JaxScan(cs.BOOT_NPZ)
    carry, meta = scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    fc = meta["frame_count"]
    img = cs.bench_scene(cam).render(cs.trajectory(fc + 1)[fc])
    carry_j = js.carry0()
    out_j = js.frame_step(carry_j, jnp.asarray(img))
    st_j0 = jax.tree.map(np.asarray, carry_j[8])
    st_r, seeds_r, chk_r, extra = js.kf_work(out_j, carry_j[8], out_j["seeds"])
    ref = dict(st=jax.tree.map(np.asarray, st_r), seeds=jax.tree.map(np.asarray, seeds_r),
               chk=float(chk_r), rows_b=np.asarray(extra["rows_b"]),
               rows=np.asarray(extra["rows"]),
               chi2=(float(extra["ba"]["chi2_init"]), float(extra["ba"]["chi2_final"])))

    kf_in = {k: _t(out_j[k]) for k in scan.KF_OUT_KEYS}
    kf_in["data"] = {k: tuple(_t(p) for p in out_j["data"][k]) if k != "grad_mean"
                     else _t(out_j["data"][k]) for k in scan.KF_DATA_KEYS}
    seeds_in = {k: _t(out_j["seeds"][k]).to(v.dtype) for k, v in carry["seeds"].items()}
    args = (carry["st"], seeds_in, kf_in)
    inst = _Instance(args, torch.device("cpu"), image=False)
    inst.stage(args)
    body = scan.make_keyframe_body(cam, cfg, "cpu")
    assert not isinstance(body, StepGraph)             # the CPU's body is eager
    log = {"kernel_twin": 0}
    reads = _DeviceReads()
    with host_reads_forbidden(log), reads:
        res = body(*inst.inputs)
    return dict(res=res, ref=ref, log=log, reads=reads, st0=carry["st"], st_j0=st_j0)


def test_staged_body_reads_nothing_on_the_host(guarded):
    assert guarded["reads"].scalar_reads == 0
    assert guarded["reads"].uploads == 0
    # (the guard lets K2's plain version read on the host: on the card it is
    # one launch; today it reads nothing, guarded["log"]["kernel_twin"] == 0)


def test_staged_body_matches_the_jax_body(guarded):
    st_t, seeds_t, chk_t, stats = guarded["res"]
    ref = guarded["ref"]
    st_j = ref["st"]
    np.testing.assert_array_equal(_np(stats["rows_b"]), ref["rows_b"])
    np.testing.assert_array_equal(_np(stats["rows_act"]), ref["rows"])
    p_t = st_j["light"].shape[0]
    for k in ("ba_pack", "light", "host_kf", "species", "f_host", "pt_pack", "ring_T",
              "ring_exp", "ring_kf", "kf_exposure", "cursor"):
        rows = slice(None, -1) if st_j[k].ndim and st_j[k].shape[0] == p_t else ...
        np.testing.assert_array_equal(_np(st_t[k])[rows], st_j[k][rows], err_msg=k)
    np.testing.assert_allclose(_np(st_t["kf_poses"]), st_j["kf_poses"], atol=1e-5)
    np.testing.assert_allclose(_np(st_t["idist"])[:-1], st_j["idist"][:-1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(st_t["pos_w"])[:-1], st_j["pos_w"][:-1], rtol=1e-4, atol=1e-5)
    ci, cf = ref["chi2"]
    np.testing.assert_allclose(float(stats["chi2_init"]), ci, rtol=1e-3)
    np.testing.assert_allclose(float(stats["chi2_final"]), cf, rtol=1e-3)
    s_j = ref["seeds"]
    for k in ("valid", "host", "level", "species", "batch_id", "host_anchor", "obs_count",
              "temp_point", "px", "grad", "host_win", "obs_valid"):
        np.testing.assert_array_equal(_np(seeds_t[k]), s_j[k], err_msg=k)
    np.testing.assert_allclose(_np(seeds_t["f"]), s_j["f"], atol=1e-6)
    for k in ("mu", "sigma2", "z_range", "converge_thresh", "a", "b", "n_updates"):
        np.testing.assert_allclose(_np(seeds_t[k]), s_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(stats["seeds_initialised"]) > 0 and int(stats["activated"]) > 0
    np.testing.assert_allclose(float(chk_t), ref["chk"], rtol=1e-5)


@pytest.mark.parametrize("when", ["before", "after"])
def test_counters_are_device_int32_as_in_the_jax_bench(guarded, when):
    st_t = guarded["st0"] if when == "before" else guarded["res"][0]
    st_j = guarded["st_j0"] if when == "before" else guarded["ref"]["st"]
    want = {"before": (6, 5), "after": (7, 6)}[when]
    for k, n in zip(("kf_count", "batch"), want):
        v = st_t[k]
        assert isinstance(v, torch.Tensor) and v.dtype == torch.int32 and v.shape == (), k
        assert v.device == st_t["light"].device, k
        assert st_j[k].dtype == np.int32 and st_j[k].shape == (), k
        assert int(v) == int(st_j[k]) == n, k


# ---------------------------------------------------------------- (c)
N_SCAN = 12       #: frames of the scan: keyframe events at frames 5 and 11


@pytest.fixture(scope="module")
def scans():
    cam, cfg = cs.bench_camera(), Config()
    carry0, meta = scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    start = meta["frame_count"]
    frames = torch.as_tensor(cs.render_frames(cs.bench_scene(cam),
                                              cs.trajectory(start + N_SCAN)[start:]))
    step = scan.make_scan_step(cam, cfg, "cpu")
    ref = scan.run_scan(step, carry0, frames, cam, cfg, meta["px_error_angle"])
    body = StepGraph(step.keyframe_body, "cpu", image=False)
    step.keyframe_body = body
    got = scan.run_scan(step, carry0, frames, cam, cfg, meta["px_error_angle"])
    return dict(ref=ref, got=got, body=body)


def _equal_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_scan_through_the_captured_body_is_the_eager_scan(scans):
    ref, got = scans["ref"], scans["got"]
    assert [scan.is_keyframe(i) for i in range(N_SCAN)].count(True) == 2
    for k in ("traj", "chk", "n_inliers", "kf_stats", "carry"):
        _equal_tree(ref[k], got[k], k)
    assert int(got["carry"]["st"]["kf_count"]) == int(ref["carry"]["st"]["kf_count"]) == 8
    assert int(got["carry"]["st"]["batch"]) == 7


def test_the_body_instances_take_turns_and_the_stats_are_copies(scans):
    body, got = scans["body"], scans["got"]
    a, b = body._instances
    assert a is not b and a.out is not None and b.out is not None
    # each event's statistics are copies: the first event's outlived its
    # instance's output (the second event ran on the other instance, and the
    # statistics are not the instance's tensors)
    stats0 = got["kf_stats"][0]
    assert all(v is not a.out[3][k] and v is not b.out[3][k] for k, v in stats0.items())
    assert int(got["carry"]["st"]["cursor"]) == int(sum(int(s["activated"])
                                                       for s in got["kf_stats"])) % R_RES


# ---------------------------------------------------------------- (d)
def _handler(graph: bool, cfg=None):
    h = FrameHandler(cs.bench_camera(), cfg or Config(), device="cpu")
    load_checkpoint(h, cs.BOOT_NPZ, resume_stage="default")
    h._graph = graph        # on the CPU a graph is the instance path
    return h


@pytest.fixture(scope="module")
def solved():
    """run_local_ba around the last keyframe, through the cache and directly
    (two handlers from the checkpoint), the problems seen by solve_capture."""
    runs = {}
    for graph in (True, False):
        seen = []
        ba_glue.solve_capture = lambda a, kw: seen.append((cs.clone_tree(a), dict(kw)))
        try:
            h = _handler(graph)
            stats = ba_glue.run_local_ba(h, h.kfs.frames[-1])
        finally:
            ba_glue.solve_capture = None
        runs[graph] = dict(h=h, stats=stats, seen=seen)
    return runs


@pytest.mark.parametrize("n_iter", [10, 30])
def test_cached_solve_is_the_direct_solve(solved, n_iter):
    args, kw = solved[True]["seen"][0]
    kw = dict(kw, n_iter=n_iter)
    cache = {}
    got = ba_glue.captured_local_ba(cache, "cpu", **kw)(*args)
    want = local_bundle_adjustment(*args, **kw)
    _equal_tree(want, got)
    assert list(cache) == [tuple(kw[k] for k in ba_glue.BA_KEY)]
    again = ba_glue.captured_local_ba(cache, "cpu", **kw)
    assert again is cache[next(iter(cache))] and len(cache) == 1


def test_run_local_ba_through_the_cache(solved):
    g, e = solved[True], solved[False]
    assert len(g["seen"]) == len(e["seen"]) == 1            # solve_capture fired
    _equal_tree(g["seen"][0][0], e["seen"][0][0])
    assert g["seen"][0][1]["n_iter"] == Config().loba_num_iter   # 6 keyframes: 10
    assert g["stats"] == e["stats"] and g["stats"]["n_points"] > 100
    np.testing.assert_array_equal(g["h"].points.idist, e["h"].points.idist)
    for fg, fe in zip(g["h"].kfs.frames, e["h"].kfs.frames):
        np.testing.assert_array_equal(fg.obs["point_id"], fe.obs["point_id"])
    key = tuple(g["seen"][0][1][k] for k in ba_glue.BA_KEY)
    assert list(g["h"]._ba_solves) == [key] and not e["h"]._ba_solves


def test_distributed_ba_bypasses_the_cache():
    seen = []
    ba_glue.solve_capture = lambda a, kw: seen.append(kw)
    try:
        h = _handler(True, Config(distributed_ba=True))
        stats = ba_glue.run_local_ba(h, h.kfs.frames[-1])
    finally:
        ba_glue.solve_capture = None
    assert len(seen) == 1 and stats is not None and stats["chi2_final"] <= stats["chi2_init"]
    assert not h._ba_solves
