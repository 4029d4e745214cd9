"""The lag-1 host loop: the port's ``FrameHandler.add_image_pipelined`` and
``flush`` against the JAX package's, on the CPU.

Both handlers resume from ``artifacts/bench_boot.npz`` (``resume_stage=
"default"``) and run the bench trajectory's frames through their lag-1 loops
until two frames past the first keyframe event they decide.  Frame e's event
is finalised after frame e+1 was dispatched, so its edits first reach the
dispatch of frame e+2.

(a) On every frame dispatched before that (0..e+1) the two loops agree:
    statuses, matches, inliers and updated seeds exactly, ``T_f_w`` to 1e-5
    (the synchronous loops' tolerance, tests/test_torch_frame_handler.py).
(b) The table dispatched for frame e+2: the port's holds the event's new seed
    batch and lacks the slots the event harvested; the JAX loop's holds none
    of the batch and sweeps harvested slots again (ROADMAP §3: the
    reference overwrites the grafted table with frame e+1's sweep output).
(c) Counters: over the run, the per-frame increments of ``acc`` equal what
    the port drained plus what it still holds, on every row no drain had to
    leave out; the JAX loop's fall short (it zeroes the counters at the
    drain, losing frame e+1's counts).
(d) A black frame: the speculative dispatch after it is discarded, the
    counters are those before it, the image goes through the synchronous
    path, and one result comes back per frame, in order.

The JAX side runs its Pallas kernels' plain references on the CPU, as its own
tests do.
"""

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.checkpoint import load_checkpoint as jax_load
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline.frame_handler import (RESULT_FAILURE, RESULT_KEYFRAME,
                                                  STAGE_DEFAULT, FrameHandler)
from hso_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

N_MAX = 14          #: at most this many frames to find the first event


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def instrument(h):
    """Record, per dispatch, the seed table swept and the counters before and
    after; per drain, the host counts; the table after each finalise."""
    log = dict(seeds_in=[], acc_in=[], acc_out=[], drained=[], after=[], resets=[])
    dispatch, finalize, lifecycle = h._dispatch_default, h._finalize_pipelined, h._apply_lifecycle

    def rec_dispatch(frame, img, seeds_in, I_rel):
        acc_in = h._acc
        out = dispatch(frame, img, seeds_in, I_rel)
        log["seeds_in"].append({k: _np(seeds_in[k]) for k in ("valid", "batch_id",
                                                                "temp_point")})
        log["acc_in"].append(np.zeros(out["acc"].shape, np.int64) if acc_in is None
                             else _np(acc_in).astype(np.int64))
        log["acc_out"].append(_np(out["acc"]).astype(np.int64))
        if hasattr(frame, "acc_reset"):
            log["resets"].append(frame.acc_reset)
        return out

    def rec_finalize(frame, out, ts):
        res = finalize(frame, out, ts)
        log["after"].append(({k: _np(h.seeds[k]) for k in ("valid", "batch_id")},
                             {k: _np(out["seeds"][k]) for k in ("valid", "batch_id")},
                             h.batch_counter))
        return res

    def rec_lifecycle(frame, acc, *a, **k):
        log["drained"].append(np.asarray(acc).astype(np.int64))
        return lifecycle(frame, acc, *a, **k)

    h._dispatch_default, h._finalize_pipelined = rec_dispatch, rec_finalize
    h._apply_lifecycle = rec_lifecycle
    return log


def run_pipelined(h, frames, start, log, stop_after_event=2):
    """``add_image_pipelined`` until ``stop_after_event`` frames past the first
    keyframe result, then ``flush``: the results and the event's frame."""
    results, event = [], None
    for k, img in enumerate(frames):
        r = h.add_image_pipelined(img, ts=float(start + k))
        if r is not None:
            results.append(r)
        if event is None:
            event = next((i for i, x in enumerate(results) if x.status == RESULT_KEYFRAME), None)
        if event is not None and k >= event + stop_after_event:
            break
    results += h.flush()
    return results, event


@pytest.fixture(scope="module")
def both():
    hj = JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    load_checkpoint(ht, BOOT_NPZ, resume_stage="default")
    start = ht.frame_count
    scene = bench_scene(bench_camera())
    frames = [scene.render(T) for T in trajectory(start + N_MAX)[start:]]
    lj, lt = instrument(hj), instrument(ht)
    rj, ej = run_pipelined(hj, frames, start, lj)
    rt, et = run_pipelined(ht, frames, start, lt)
    assert ej is not None and et is not None, [r.status for r in rt]
    return dict(hj=hj, ht=ht, rj=rj, rt=rt, ej=ej, et=et, lj=lj, lt=lt, scene=scene,
                start=start, n=len(rt))


def test_one_result_per_frame_in_order(both):
    for h, res in ((both["hj"], both["rj"]), (both["ht"], both["rt"])):
        assert len(res) == both["n"] and both["n"] == both["ej"] + 3
        ts = [int(t) for t, _ in h.trajectory]
        assert ts[-both["n"]:] == list(range(both["start"], both["start"] + both["n"]))
        assert not any(r.status == RESULT_FAILURE for r in res)
        assert h.stage == STAGE_DEFAULT


def test_loops_agree_until_the_event_reaches_a_dispatch(both):
    e = both["et"]
    assert both["ej"] == e
    for k in range(e + 2):                      # frames dispatched before the graft
        a, b = both["rj"][k], both["rt"][k]
        assert (a.status, a.n_matches, a.n_inliers, a.n_seeds_updated) == \
            (b.status, b.n_matches, b.n_inliers, b.n_seeds_updated), k
        np.testing.assert_allclose(b.T_f_w, a.T_f_w, rtol=0, atol=1e-5, err_msg=str(k))


def test_the_event_reaches_the_swept_chain_in_the_port_only(both):
    """ROADMAP §3 item 1: the table dispatched for frame e+2 carries the
    event's batch and none of the slots it harvested (port); the JAX loop's
    carries no new seed and sweeps harvested slots again."""
    e = both["et"]
    out = {}
    for side in ("lj", "lt"):
        log = both[side]
        after, before, batch = log["after"][e]      # the table as the event left it
        new = after["valid"] & (after["batch_id"] == batch)
        # slots whose seed the event took out (harvested or pruned; the new
        # batch may have refilled them)
        harvested = before["valid"] & (~after["valid"] | new)
        sent = log["seeds_in"][e + 2]
        old = sent["valid"] & (sent["batch_id"] == before["batch_id"])
        out[side] = dict(n_new=int(new.sum()), harvested=harvested,
                         sent_new=int((sent["valid"] & (sent["batch_id"] == batch)).sum()),
                         sent_harvested=int(old[harvested].sum()))
    j, t = out["lj"], out["lt"]
    assert t["n_new"] == j["n_new"] > 0 and t["harvested"].sum() == j["harvested"].sum() > 0
    np.testing.assert_array_equal(t["harvested"], j["harvested"])
    assert t["sent_new"] == t["n_new"] and t["sent_harvested"] == 0
    assert j["sent_new"] == 0 and j["sent_harvested"] > 0


def test_drained_counts_add_up_in_the_port_only(both):
    """ROADMAP §3: the drain subtracts the drained frame's counts on the
    device; the JAX loop zeroes the counters and loses frame e+1's."""
    lt, lj, ht, hj = both["lt"], both["lj"], both["ht"], both["hj"]
    keep = np.ones(ht.points.p_max, bool)
    for resets in lt["resets"]:
        for rows in resets:
            keep[rows] = False
    sums = {}
    for side, log, h in (("port", lt, ht), ("jax", lj, hj)):
        inc = sum(o - i for o, i in zip(log["acc_out"], log["acc_in"]))
        drained = sum(log["drained"])
        assert len(log["drained"]) == 1
        sums[side] = (inc[:, keep], (drained + _np(h._acc).astype(np.int64))[:, keep])
    inc, held = sums["port"]
    assert inc.sum() > 0
    np.testing.assert_array_equal(held, inc)
    inc_j, held_j = sums["jax"]
    np.testing.assert_array_equal(inc_j, inc)              # the same frames were counted
    assert (held_j <= inc_j).all() and held_j.sum() < inc_j.sum()


def test_black_frame_discards_the_speculative_dispatch(both):
    """On from where the parity run ended: two frames, a black one, three
    more.  The frame after the black one is dispatched, found to chain off a
    failure, discarded with the counters put back, and handed to the
    synchronous path (relocalization)."""
    ht = both["ht"]
    start = ht.frame_count
    gt = trajectory(start + 6)[start:]
    frames = [both["scene"].render(T) for T in gt]
    frames.insert(2, np.zeros_like(frames[0]))
    seen, add_image = [], ht.add_image
    acc_before = []

    def spy(img, ts=0.0):
        seen.append((ts, ht._acc))
        return add_image(img, ts)

    ht.add_image = spy
    results = []
    try:
        for k, img in enumerate(frames):
            if k == 3:
                acc_before.append(ht._acc)
            r = ht.add_image_pipelined(img, ts=float(start + k))
            if r is not None:
                results.append(r)
        results += ht.flush()
    finally:
        del ht.add_image
    assert len(results) == len(frames)
    assert results[2].status == RESULT_FAILURE
    # the discarded dispatch: the synchronous path took frame 3 with the
    # counters as they were before it was dispatched
    assert seen and seen[0][0] == float(start + 3)
    assert seen[0][1] is acc_before[0]
    assert results[-1].status != RESULT_FAILURE and ht.stage == STAGE_DEFAULT
    ts = [int(t) for t, _ in ht.trajectory]
    assert ts[-len(frames):] == list(range(start, start + len(frames)))


N_SPARSE = 60       #: kept matches a frame is cut to, so that it goes through the seed rescue


def sparsify_first_dispatch(h):
    """Cut the next step result to its first ``N_SPARSE`` kept matches (as the
    step reports a frame where fewer than 100 points match), on either
    package's handler."""
    orig = h._dispatch_default

    def cut(frame, img, seeds_in, I_rel):
        out = orig(frame, img, seeds_in, I_rel)
        h._dispatch_default = orig
        sp, packed = _np(out["slot_pack"]).copy(), _np(out["packed"]).copy()
        kept = np.where((sp[:, 10].astype(np.int32) & 3) == 3)[0]
        sp[kept[N_SPARSE:], 10] = 0
        packed[13] = min(packed[13], N_SPARSE)
        packed[14] = min(packed[14], N_SPARSE)
        if isinstance(out["packed"], torch.Tensor):
            out["slot_pack"], out["packed"] = torch.as_tensor(sp), torch.as_tensor(packed)
        else:
            import jax.numpy as jnp

            out["slot_pack"], out["packed"] = jnp.asarray(sp), jnp.asarray(packed)
        return out

    h._dispatch_default = cut


def test_seed_rescue_links_survive_a_passing_frame():
    """ROADMAP §3 item 9: the first resumed frame, cut to 60 matches, goes
    through the seed rescue on both sides and passes.  The JAX table after
    it links no seed to its TEMPORARY point (the sweep's output replaced the
    linked table); the port's links one seed per TEMPORARY point, in the
    synchronous loop and, grafted onto the branch in flight, in the lag-1
    loop's next dispatch."""
    scene = bench_scene(bench_camera())
    hj = JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    load_checkpoint(ht, BOOT_NPZ, resume_stage="default")
    start = ht.frame_count
    frames = [scene.render(T) for T in trajectory(start + 3)[start:]]
    n_tmp0 = [int((h.points.type == 1).sum()) for h in (hj, ht)]
    for h in (hj, ht):
        sparsify_first_dispatch(h)
    rj, rt = hj.add_image(frames[0], ts=float(start)), ht.add_image(frames[0], ts=float(start))
    assert rj.status == rt.status != RESULT_FAILURE
    n_tmp = [int((h.points.type == 1).sum()) - n0 for h, n0 in zip((hj, ht), n_tmp0)]
    assert n_tmp[0] > 0 and abs(n_tmp[0] - n_tmp[1]) <= 2, n_tmp
    assert int((_np(hj.seeds["temp_point"]) >= 0).sum()) == 0
    links = _np(ht.seeds["temp_point"])
    assert int((links >= 0).sum()) == n_tmp[1]
    assert (ht.points.type[links[links >= 0]] == 1).all()

    # the lag-1 loop: frame 0 finalised after frame 1 was dispatched; the
    # links reach the table of frame 2's dispatch
    hp = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(hp, BOOT_NPZ, resume_stage="default")
    n0 = int((hp.points.type == 1).sum())
    log = instrument(hp)
    sparsify_first_dispatch(hp)
    for k, img in enumerate(frames):
        hp.add_image_pipelined(img, ts=float(start + k))
    hp.flush()
    n_tmp_p = int((hp.points.type == 1).sum()) - n0
    assert n_tmp_p == n_tmp[1]
    sent = [int((d["temp_point"] >= 0).sum()) for d in log["seeds_in"]]
    assert sent == [0, 0, n_tmp_p], sent


def test_a_row_restarted_in_flight_leaves_the_drain():
    """ROADMAP §3 item 8, the bookkeeping alone, on made-up counts, in the
    lag-1 loop's order: frames 1 and 2 are in flight when row 3 is handed out
    again (its device counters restart at 0); frame 1 has an event and
    drains, frame 2 does not, frame 3 is dispatched and drains at the next
    event.  The host gets frame 1's counts but row 3's, the device keeps
    frame 2's (row 3 at 0) for the next drain, and in the end the host holds
    every count of the rows that kept their point and, for row 3, only the
    new point's (frame 3's)."""
    from hso_tpu_torch.mapmodel.structures import empty_obs

    h = FrameHandler(bench_camera(), Config(), device="cpu")
    P, g = h.points.p_max, np.random.default_rng(5)
    c1, c2, c3 = (torch.as_tensor(g.integers(0, 3, (2, P)), dtype=torch.int32)
                  for _ in range(3))
    h._acc = torch.zeros((2, P), dtype=torch.int32)

    def dispatch(c):
        f = type("F", (), {})()
        f.acc_reset, f.obs = [], empty_obs(8)
        out = {"acc": h._acc + c}
        h._acc = out["acc"]
        h._acc_open.append(f)
        return f, out

    host = np.zeros((2, P), np.int64)

    def drain(f, out):
        nonlocal host
        reset = np.concatenate(f.acc_reset) if f.acc_reset else np.zeros(0, np.int64)
        acc = out["acc"].numpy().astype(np.int64)
        acc[:, reset] = 0
        host = host + acc
        h._apply_lifecycle(f, acc, out["acc"], reset)
        h._acc_open.remove(f)

    f1, o1 = dispatch(c1)
    f2, _ = dispatch(c2)
    h._zero_acc_rows([np.array([3])])                # row 3 handed out again
    assert len(f1.acc_reset) == len(f2.acc_reset) == 1
    drain(f1, o1)                                    # frame 1's event
    want = c2.clone()
    want[:, 3] = 0
    assert torch.equal(h._acc, want)                 # frame 2's counts stay on the device
    h._acc_open.remove(f2)                           # frame 2: no event
    f3, o3 = dispatch(c3)
    drain(f3, o3)                                    # the next event
    keep = np.arange(P) != 3
    total = (c1 + c2 + c3).numpy().astype(np.int64)
    np.testing.assert_array_equal(host[:, keep], total[:, keep])
    np.testing.assert_array_equal(host[:, 3], c3.numpy()[:, 3])
    assert not h._acc.any()
