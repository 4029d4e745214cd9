"""The frame step as one device program, on the CPU: the pieces of
``hso_tpu_torch.pipeline.step_graph`` and ``hso_tpu_torch.utils.control_flow``
that run without a card.

(a) The FC level LM as a gated loop (``coarse_cuda.lm_level_loop``, the JAX
    ``lax.while_loop`` of ``hso_tpu/track/coarse_tracker.py:260-290``): the
    same bits as the loop it replaces (kept below as ``todays_loop``, the
    parent's code, which stopped on the host) through the FC tracker and
    through the IC tracker of a radial-tangential camera (K3's plain version
    runs the same loop), iterations exact, including a loop that stops at
    its first iteration and one that runs all ``n_iter``; and the JAX
    tracker on the problem of ``tests/test_torch_coarse.py`` at that file's
    tolerances (pose 1e-3 as |log| of the relative transform, exposure ratio
    1e-3, the same ``n_tracked``, energy within 5 %).
(b) The step body on its staged inputs under a guard that makes
    ``Tensor.__bool__``, ``.item()``, ``.tolist()``, ``__float__`` and
    ``__int__`` raise, but in ``control_flow.read_flag`` (the FC/IC predicate
    and the loop gate: IF nodes on the card) and inside the plain versions of
    the six kernels (one launch each on the card); no tensor is made from
    host data in the body either (``aten.lift_fresh``: an upload a graph
    could not replay).  One IC frame and one FC frame from
    ``artifacts/bench_boot.npz`` against the JAX step, at the tolerances of
    ``tests/test_torch_frame_step.py`` (``T_new`` 1e-6, selection exact,
    packed scalars 1e-4 relative).
(c) The two instances and the staging, with the body called directly (a
    CPU ``StepGraph``): a result stays valid through the next call and is
    overwritten by the one after; the scan through the graph gives the eager
    scan's bits over a keyframe event; the lag-1 loop's pending frame and
    the handler's kept state survive, bit for bit against the eager handler,
    through a keyframe event and a black frame; staging rejects a changed
    structure, shape or type and reads an argument that is one of the
    instance's own inputs before it writes any.
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
from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.config import Config as JaxConfig
from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu.track.coarse_tracker import make_coarse_tracker as jax_make_tracker
from hso_tpu_torch import testing
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3, se3np
from hso_tpu_torch.math.linalg_small import solve_spd_small
from hso_tpu_torch.ops import align_cuda, epipolar_cuda, window_cuda
from hso_tpu_torch.pipeline import scan
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.pipeline.step_graph import StepGraph, _Instance
from hso_tpu_torch.track import coarse_cuda, coarse_tracker, pose_cuda
from hso_tpu_torch.utils import control_flow
from hso_tpu_torch.utils.checkpoint import load_checkpoint, scan_state_from_checkpoint
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

T_GT = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
N_MAX = 96
K = (320, 240, 200.0, 200.0, 160.0, 120.0)
#: EuRoC's radial-tangential coefficients, as tests/test_torch_cameras_path.py
RADTAN = (-0.2834, 0.0740, 1.9e-4, 1.8e-5)


def todays_loop(evaluate, T, a, n_iter: int, inverse: bool):
    """The level LM as it was before the gated loop: a host test of the stop
    after every iteration."""
    E_c, H_c, b_c, nt_c = evaluate(T, a)
    lam = torch.full((), 0.1, dtype=torch.float32, device=T.device)
    it = 0
    while it < n_iter:
        Hl = H_c + torch.diag(torch.diagonal(H_c)) * lam
        step = solve_spd_small(Hl, b_c)
        extrap = torch.where(lam < 1e-3, torch.sqrt(torch.sqrt(1e-3 / lam)),
                             torch.ones_like(lam))
        step = step * extrap
        step = torch.where(torch.all(torch.isfinite(step)), step, torch.zeros_like(step))

        a_new = a + step[0]
        dT = se3.exp(-step[1:7])
        T_new = se3.mul(T, dT) if inverse else se3.mul(dT, T)

        E_new, H_new, b_new, nt_new = evaluate(T_new, a_new)
        accept = E_new < E_c
        T = torch.where(accept, T_new, T)
        a = torch.where(accept, a_new, a)
        E_c = torch.where(accept, E_new, E_c)
        H_c = torch.where(accept, H_new, H_c)
        b_c = torch.where(accept, b_new, b_c)
        nt_c = torch.where(accept, nt_new, nt_c)
        lam = torch.where(accept, lam * 0.5, torch.clamp_min(lam * 4.0, 1e-3))
        it += 1
        if bool(torch.linalg.norm(step) <= 1e-4):
            break
    iters = torch.full((), it, dtype=torch.int32, device=T.device)
    return T, a, E_c, nt_c, iters


@contextlib.contextmanager
def with_loop(fn):
    """Route the tracker and K3's plain version to ``fn`` as their level LM."""
    old = (coarse_tracker.lm_level_loop, coarse_cuda.lm_level_loop)
    coarse_tracker.lm_level_loop = coarse_cuda.lm_level_loop = fn
    try:
        yield
    finally:
        coarse_tracker.lm_level_loop, coarse_cuda.lm_level_loop = old


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.int32) if a.dtype == torch.float32 else a,
        b.reshape(-1).view(torch.int32) if b.dtype == torch.float32 else b)


def _se3_dist(Ta, Tb):
    return np.linalg.norm(se3np.log(se3np.mul(np.asarray(Ta, np.float64),
                                              se3np.inv(np.asarray(Tb, np.float64)))))


# ---------------------------------------------------------------- (a)
@pytest.fixture(scope="module", params=["fc", "ic-radtan"])
def tracked(request):
    """The problem of tests/test_torch_coarse.py (the radial-tangential
    camera of tests/test_torch_cameras_path.py for IC), tracked by the port
    with the gated loop and with today's loop, and by the JAX tracker."""
    fc = request.param == "fc"
    cam, cam_j = ((PinholeCamera(*K), JaxPinhole(*K)) if fc
                  else (PinholeCamera(*K, *RADTAN), JaxPinhole(*K, *RADTAN)))
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    ref_img, cur_img = scene.render(), scene.render(T_GT, exposure=0.97)
    px, f, dist = scene.grid_features(step=28, border=28)
    px, f, dist = testing.pad_features(px, f, dist, N_MAX)
    T0 = se3np.identity().astype(np.float32)
    ref = jax.tree.map(np.asarray, jax_make_tracker(cam_j, max_level=3, inverse=not fc)(
        jax_pyramids(jnp.asarray(ref_img))["pyr"], jax_pyramids(jnp.asarray(cur_img))["pyr"],
        px, f, dist, T0, 1.0))
    track = make = coarse_tracker.make_coarse_tracker
    args = (build_frame_pyramids(ref_img, device="cpu")["pyr"],
            build_frame_pyramids(cur_img, device="cpu")["pyr"], px, f, dist, T0, 1.0)
    reads = [0]
    read = control_flow.read_flag

    def counted(flag):
        reads[0] += 1
        return read(flag)

    control_flow.read_flag = counted
    try:
        track = make(cam, max_level=3, inverse=not fc, device="cpu")
        gated = track(*args)
    finally:
        control_flow.read_flag = read
    with with_loop(todays_loop):
        today = make(cam, max_level=3, inverse=not fc, device="cpu")(*args)
    return dict(gated=gated, today=today, jax=ref, reads=reads[0], fc=fc)


def test_gated_loop_gives_todays_bits(tracked):
    g, t = tracked["gated"], tracked["today"]
    for k in ("T_cur_ref", "exposure_ratio", "energy", "n_tracked", "n_iters"):
        assert _same_bits(g[k], t[k]), k
    iters = g["n_iters"]
    assert iters.dtype == torch.int32 and iters.shape == (3,)
    # the host read the gate once an iteration and once more where it stopped early
    n = int(iters.sum())
    assert tracked["reads"] == n + int((iters < 30).sum())
    assert (iters >= 1).all() and (iters <= 30).all()


def test_gated_loop_matches_jax(tracked):
    out, ref = tracked["gated"], tracked["jax"]
    for r in (ref["T_cur_ref"], out["T_cur_ref"].numpy()):
        assert _se3_dist(r, T_GT) < 1.5e-2
    assert _se3_dist(out["T_cur_ref"].numpy(), ref["T_cur_ref"]) < 1e-3
    assert abs(float(out["exposure_ratio"]) - float(ref["exposure_ratio"])) < 1e-3
    assert int(out["n_tracked"]) == int(ref["n_tracked"])
    np.testing.assert_allclose(float(out["energy"]), float(ref["energy"]), rtol=0.05)


def _quadratic(b_norm: float, rejects: bool):
    """A 7-parameter problem in (a, T) around the state it is first evaluated
    at, x0: E = |x - x0|², H = 2I, b = -2(x - x0) + g with |g| = ``b_norm``;
    with ``rejects`` every new evaluation reports a larger energy (every step
    is refused and lambda grows)."""
    calls, x0 = [0], []
    g = torch.tensor([1.0, -2.0, 0.5, 0.25, -1.0, 0.75, 1.5])
    g = g / torch.linalg.norm(g) * b_norm

    def evaluate(T, a):
        calls[0] += 1
        x = torch.cat([a.reshape(1), T[:, 3], T[2, 1:2], T[0, 2:3], T[1, 0:1]])
        if not x0:
            x0.append(x.clone())
        r = x - x0[0]
        E = torch.sum(r * r) + (float(calls[0]) if rejects else 0.0)
        return E.to(torch.float32), 2.0 * torch.eye(7), -2.0 * r + g, torch.tensor(
            7, dtype=torch.int32)

    return evaluate


@pytest.mark.parametrize("case,n_iter,want", [("stops-at-first", 30, 1), ("runs-all", 5, 5)])
@pytest.mark.parametrize("inverse", [True, False], ids=["ic", "fc"])
def test_gated_loop_iterations(case, n_iter, want, inverse):
    """A step of norm 0 stops the loop after its first iteration; refused
    steps of norm ≥ 0.1 run it to ``n_iter``."""
    T0 = torch.eye(3, 4)
    a0 = torch.ones(())
    b_norm, rejects = (0.0, False) if case == "stops-at-first" else (1.0, True)
    got = coarse_cuda.lm_level_loop(_quadratic(b_norm, rejects), T0, a0, n_iter, inverse)
    ref = todays_loop(_quadratic(b_norm, rejects), T0, a0, n_iter, inverse)
    assert int(got[4]) == int(ref[4]) == want
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    assert torch.equal(T0, torch.eye(3, 4)) and float(a0) == 1.0      # inputs untouched


# ---------------------------------------------------------------- (b)
#: the plain versions of the six kernels: on the card each is one launch
KERNEL_TWINS = (window_cuda.extract_windows_plain, window_cuda.extract_windows_multi_plain,
                window_cuda.pack_level_windows_plain, coarse_cuda.coarse_level_ic_plain,
                align_cuda.align_match_plain, pose_cuda.pose_lm_plain,
                epipolar_cuda.zmncc_line_scores_plain)
HOST_READS = ("__bool__", "item", "tolist", "__float__", "__int__")


class _NoUploads(TorchDispatchMode):
    """Counts tensors made from host data (a graph could not replay them)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def host_reads_forbidden(log):
    """Every host read of a tensor raises, but from ``control_flow.read_flag``
    and inside a kernel's plain version; ``log`` counts the two kinds."""
    twins = {f.__code__ for f in KERNEL_TWINS}
    flag = control_flow.read_flag.__code__
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}

    def guarded(name, orig):
        def read(self, *a, **k):
            frame = sys._getframe(1)
            if frame.f_code is flag:
                log["read_flag"] += 1
                return orig(self, *a, **k)
            while frame is not None:
                if frame.f_code in twins:
                    log["kernel_twin"] += 1
                    return orig(self, *a, **k)
                frame = frame.f_back
            raise AssertionError(f"Tensor.{name} in the step body")
        return read

    for name, orig in saved.items():
        setattr(torch.Tensor, name, guarded(name, orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


@pytest.fixture(scope="module")
def world():
    cam, cfg = cs.bench_camera(), Config()
    state, book = cs.initial_state(cam, cfg, torch.device("cpu"))
    fc = book["frame_count"]
    img = cs.bench_scene(cam).render(cs.trajectory(fc + 1)[fc])
    return dict(cam=cam, cfg=cfg, state=state, img=img)


@pytest.fixture(scope="module")
def jax_handler():
    from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
    from hso_tpu.utils.checkpoint import load_checkpoint as jax_load

    vo = JaxHandler(JaxPinhole(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    jax_load(vo, BOOT_NPZ, resume_stage="default")
    return vo


@pytest.fixture(scope="module", params=["ic", "fc"])
def guarded(world, jax_handler, request):
    """One frame through the staged body under the guard (FC forced by a
    previous gradient mean far below), and the JAX step on the same inputs."""
    fc = request.param == "fc"
    st = world["state"]
    prev_gm = -1e6 if fc else st["prev_grad_mean"]
    step = scan.make_scan_step(world["cam"], world["cfg"], torch.device("cpu"))
    args = (world["img"], st["prev_pyr"], prev_gm, st["T_prev"], st["prev_obs"],
            st["prev_intensity"], st["exposure_prev"], st["T_rel"], st["snap"], st["seeds"],
            st["px_error_angle"], st["acc"])
    inst = _Instance(args, torch.device("cpu"))
    inst.stage(args)
    # what StepGraph does before a capture: both branches once, eagerly (the
    # pattern tables reach the device there)
    with control_flow.warm_both_branches():
        step(*inst.inputs)
    log = {"read_flag": 0, "kernel_twin": 0}
    uploads = _NoUploads()
    with host_reads_forbidden(log), uploads:
        out = step(*inst.inputs)

    vo = jax_handler
    last = vo.last_frame
    ref = vo._fused_step()(
        jnp.asarray(world["img"]), last.data["pyr"],
        jnp.float32(-1e6 if fc else last.grad_mean), jnp.asarray(last.T_f_w, jnp.float32),
        vo._prev_obs_dev(last), jnp.float32(last.intensity_mean), jnp.float32(last.exposure),
        jnp.asarray(np.eye(3, 4), jnp.float32), vo._snapshot(), vo.seeds,
        jnp.float32(vo.px_error_angle), jnp.zeros((2, vo.points.p_max), jnp.int32))
    return dict(fc=fc, out=out, ref=jax.tree.map(np.asarray, ref), log=log,
                uploads=uploads.n)


def test_body_reads_the_device_only_at_the_if_nodes(guarded):
    log = guarded["log"]
    assert guarded["uploads"] == 0
    assert bool(guarded["out"]["used_fc"]) == guarded["fc"]
    # the FC/IC predicate, then the level LM's gate (IC: inside K3's plain
    # version; FC: the gated loop itself), at least once a level
    assert log["read_flag"] >= 1 + 4
    if guarded["fc"]:
        assert log["read_flag"] <= 1 + 4 * 31
    # the pose LM's plain version tests its convergence on the host
    assert log["kernel_twin"] > 0


def test_body_matches_the_jax_step(guarded):
    out, ref = guarded["out"], guarded["ref"]
    np.testing.assert_allclose(out["T_new"].numpy(), ref["T_new"], atol=1e-6)
    np.testing.assert_allclose(out["T_track"].numpy(), ref["T_track"], atol=1e-6)
    for k in ("cv1", "cp1", "cp2", "cid", "species", "level", "success", "inlier", "s1",
              "tried2", "s2_used"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(out["packed"].numpy(), ref["packed"], rtol=1e-4, atol=1e-5)
    assert int(out["n_inliers"]) == int(ref["n_inliers"]) > 200


# ---------------------------------------------------------------- (c)
def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_snapshot(v) for v in tree)
    return tree.clone()


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _toy_step(img, pyr, s, acc):
    return {"y": img * 2.0 + pyr[0], "z": (acc + 1, pyr[1] * s)}


def _toy_args(k):
    rng = np.random.default_rng(k)
    return (rng.integers(0, 255, (4, 5)).astype(np.uint8),
            (torch.as_tensor(rng.normal(size=(4, 5)), dtype=torch.float32),
             torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.float32)),
            float(rng.normal()), torch.as_tensor(rng.integers(0, 9, (2, 6)), dtype=torch.int32))


def test_a_result_lives_until_the_call_after_next():
    sg = StepGraph(_toy_step, "cpu")
    outs, want = [], []
    for k in range(4):
        args = _toy_args(k)
        outs.append(sg(*args))
        want.append(_toy_step(torch.as_tensor(args[0], dtype=torch.float32), *args[1:]))
        if k >= 1:
            assert _equal(outs[k - 1], want[k - 1])      # through the next call
        if k >= 2:
            assert outs[k - 2] is outs[k]                # the same instance, overwritten
            assert not _equal(outs[k - 2], want[k - 2])
    assert outs[0] is not outs[1]


def test_staging_rejects_a_changed_argument():
    sg = StepGraph(_toy_step, "cpu")
    img, pyr, s, acc = _toy_args(0)
    sg(img, pyr, s, acc)
    with pytest.raises(ValueError, match="shape"):
        sg(img[:3], pyr, s, acc)
    with pytest.raises(ValueError, match="type"):
        sg(img, pyr, s, acc.to(torch.int64))
    with pytest.raises(ValueError, match="structure"):
        sg(img, pyr[:1], s, acc)
    with pytest.raises(ValueError, match="number"):
        sg(img, pyr, s, 3.0)
    # uint8 or float32 images and a number or a 0-d tensor all stage
    out = sg(img.astype(np.float32), pyr, torch.full((), s), acc)
    assert _equal(out, _toy_step(torch.as_tensor(img, dtype=torch.float32), pyr, s, acc))


def test_staging_reads_its_own_inputs_before_writing():
    """An argument that is one of the instance's input tensors (here the
    first pyramid level passed as the second) is copied aside first."""
    img, pyr, s, acc = _toy_args(1)
    inst = _Instance((img, pyr, s, acc), torch.device("cpu"))
    inst.stage((img, pyr, s, acc))
    first, second = inst.inputs[1][0].clone(), inst.inputs[1][1].clone()
    # swap two inputs of the instance through one staging
    swapped = (np.zeros((4, 5), np.uint8), (inst.inputs[0], inst.inputs[1][0][:2, :3]), s, acc)
    inst.stage(swapped)
    assert torch.equal(inst.inputs[1][0], torch.as_tensor(img, dtype=torch.float32))
    assert torch.equal(inst.inputs[1][1], first[:2, :3])
    assert not torch.equal(inst.inputs[1][1], second)
    assert torch.equal(inst.inputs[0], torch.zeros(4, 5))


N_SCAN = 7      #: frames of the scan, a keyframe event at frame 5


def test_scan_through_the_graph_is_the_eager_scan():
    cam, cfg = bench_camera(), Config()
    carry0, meta = scan_state_from_checkpoint(BOOT_NPZ, cam, cfg, "cpu")
    start = meta["frame_count"]
    frames = torch.as_tensor(np.stack([bench_scene(cam).render(T)
                                       for T in trajectory(start + N_SCAN)[start:]]))
    step = scan.make_scan_step(cam, cfg, "cpu")
    assert not isinstance(step, StepGraph)                # the CPU's step is eager
    kept = {}

    def keep(i, kf, out, carry):
        kept[i] = (_snapshot(out["T_new"]), carry)

    ref = scan.run_scan(step, carry0, frames, cam, cfg, meta["px_error_angle"])
    got = scan.run_scan(StepGraph(step, "cpu"), carry0, frames, cam, cfg,
                        meta["px_error_angle"], on_frame=keep)
    assert torch.equal(ref["traj"], got["traj"]) and torch.equal(ref["chk"], got["chk"])
    assert torch.equal(ref["n_inliers"], got["n_inliers"])
    assert len(got["kf_stats"]) == 1
    for k, v in ref["carry"]["st"].items():
        assert torch.equal(v, got["carry"]["st"][k]) if isinstance(v, torch.Tensor) \
            else v == got["carry"]["st"][k], k
    assert _equal(ref["carry"]["seeds"], got["carry"]["seeds"])
    # the per-frame records are copies: frame 0's pose outlived its instance
    assert torch.equal(got["traj"][0], kept[0][0])


N_HANDLER = 10    #: frames of the lag-1 loop from the checkpoint, a black one at BLACK
BLACK = 7


@pytest.fixture(scope="module")
def handlers():
    """The lag-1 loop from the checkpoint with the eager step and with the
    step behind a (CPU) StepGraph: frames 0..N_HANDLER, black at BLACK."""
    cam = bench_camera()
    runs = {}
    for kind in ("eager", "graph"):
        h = FrameHandler(cam, Config(), device="cpu")
        load_checkpoint(h, BOOT_NPZ, resume_stage="default")
        if kind == "graph":
            # the CPU's step is eager: ask for the graph (a CPU StepGraph)
            h._graph = True
            assert isinstance(h._fused_step(), StepGraph)
        start = h.frame_count
        frames = [bench_scene(cam).render(T) for T in trajectory(start + N_HANDLER)[start:]]
        frames[BLACK] = np.zeros_like(frames[0])
        res = []
        for k, img in enumerate(frames):
            r = h.add_image_pipelined(img, ts=float(start + k))
            if r is not None:
                res.append(r)
        res += h.flush()
        runs[kind] = dict(h=h, res=res)
    return runs


def test_lag1_loop_through_the_graph_is_the_eager_loop(handlers):
    e, g = handlers["eager"], handlers["graph"]
    assert len(e["res"]) == len(g["res"]) == N_HANDLER
    statuses = [r.status for r in e["res"]]
    assert "keyframe" in statuses and statuses[BLACK] == "failure", statuses
    for a, b in zip(e["res"], g["res"]):
        assert (a.status, a.n_matches, a.n_inliers, a.n_seeds_updated) == \
            (b.status, b.n_matches, b.n_inliers, b.n_seeds_updated)
        np.testing.assert_array_equal(a.T_f_w, b.T_f_w)
    he, hg = e["h"], g["h"]
    assert _equal(he.seeds, hg.seeds)
    assert torch.equal(he._acc, hg._acc)
    assert [f.frame_id for f in he.pre_frames] == [f.frame_id for f in hg.pre_frames]
    for fe, fg in zip(he.pre_frames, hg.pre_frames):
        assert _equal(fe.data["pyr"], fg.data["pyr"])
