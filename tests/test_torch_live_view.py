"""The port's live viewer (``hso_tpu_torch.utils.live_view``) against what the
JAX package's viewer would draw, on the CPU.

Both handlers resume from ``artifacts/bench_boot.npz`` and take the same five
frames of the bench trajectory; the fifth is a keyframe on both (the frames
between events keep their matches on the device, so both viewers draw rings
on keyframes and sparse frames only).  The port's ``LiveViewer(every=5)``
writes its PNGs at frame 5, read back with the port's ``read_png``; a second
viewer with ``every=2`` writes at frames 2 and 4.

* ``tracking.png`` is the frame as RGB with a ring at every kept match of the
  JAX handler's last frame, at the JAX viewer's centre (the pixel truncated to
  integers) in the JAX viewer's colour, and the JAX viewer's counter line in
  the viewer's font: every pixel as expected, except around a match whose
  pixel lies within 1e-3 of an integer, where the two packages' float32
  positions may truncate apart.
* ``map.png`` has ink at every valid JAX map point's x–z position (a 3×3
  neighbourhood, for the same reason).
"""

import os

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.checkpoint import load_checkpoint as jax_load
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu_torch.config import Config
from hso_tpu_torch.io.image_reader import read_png
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.utils import live_view
from hso_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)
N_FRAMES, EVERY = 5, 5


@pytest.fixture(scope="module")
def viewed(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("live"))
    hj = JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    load_checkpoint(ht, BOOT_NPZ, resume_stage="default")
    start = ht.frame_count
    scene = bench_scene(bench_camera())
    viewer = live_view.LiveViewer(out_dir=out, every=EVERY)
    out2 = str(tmp_path_factory.mktemp("live2"))
    viewer2 = live_view.LiveViewer(out_dir=out2, every=2)
    written, written2 = [], []
    for k, T in enumerate(trajectory(start + N_FRAMES)[start:]):
        img = scene.render(T)
        hj.add_image(img, ts=float(start + k))
        ht.add_image(img, ts=float(start + k))
        viewer.update(ht, img)
        viewer2.update(ht, img)
        written.append(os.path.exists(os.path.join(out, "tracking.png")))
        written2.append(os.path.exists(os.path.join(out2, "map.png")))
    return dict(hj=hj, ht=ht, viewer=viewer, out=out, img=img, written=written,
                written2=written2, status=(hj.kfs.frames[-1].frame_id, ht.kfs.frames[-1].frame_id,
                                           start + N_FRAMES - 1))


def test_written_every_n_frames(viewed):
    assert viewed["written"] == [False] * 4 + [True]
    assert viewed["written2"] == [False, True, True, True, True]
    assert viewed["viewer"].count == N_FRAMES
    for name in ("tracking.png", "map.png"):
        assert os.path.getsize(os.path.join(viewed["out"], name)) > 0


def _jax_rings(hj):
    """(x, y, colour, near an integer) of each ring the JAX viewer draws."""
    o = hj.last_frame.obs
    ov = o["valid"] & (o["point_id"] >= 0)
    ptype = hj.points.type[np.where(ov, o["point_id"], 0)]
    rings = []
    for i in np.where(ov)[0]:
        px = o["px"][i].astype(np.float64)
        color = (live_view.CYAN if ptype[i] == 1 else
                 live_view.MAGENTA if o["species"][i] == 1 else live_view.GREEN)
        near = bool((np.abs(px - np.round(px)) < 1e-3).any())
        rings.append((int(o["px"][i, 0]), int(o["px"][i, 1]), color, near))
    return rings


def test_tracking_rings_and_counter_line(viewed):
    hj, viewer = viewed["hj"], viewed["viewer"]
    got = read_png(os.path.join(viewed["out"], "tracking.png"))
    img = viewed["img"]
    assert got.shape == img.shape + (3,) and got.dtype == np.uint8

    kf_j, kf_t, last = viewed["status"]
    assert kf_j == kf_t == last                   # the drawn frame is a keyframe on both
    rings = _jax_rings(hj)
    assert len(rings) > 100
    text = (f"frame {N_FRAMES}  inl {len(rings)}  kfs {len(hj.kfs.frames)} "
            f"pts {int(hj.points.valid.sum())}  stage {hj.stage}")
    assert viewer.last_text == text

    want = np.repeat(img[..., None], 3, axis=-1)
    loose = np.zeros(img.shape, bool)
    h, w = img.shape
    for x, y, color, near in rings:
        xs, ys = live_view.ring_pixels(x, y, h, w)
        want[ys, xs] = color
        if near:
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    xs, ys = live_view.ring_pixels(x + dx, y + dy, h, w)
                    loose[ys, xs] = True
    live_view.draw_text(want, text, live_view.TEXT_ORIGIN, live_view.YELLOW)
    differ = (got != want).any(axis=-1)
    assert not (differ & ~loose).any(), np.argwhere(differ & ~loose)[:10]
    # the counter line is ink of the font, in yellow
    m = live_view.text_mask(text)
    x0, y0 = live_view.TEXT_ORIGIN
    region = got[y0:y0 + m.shape[0], x0:x0 + m.shape[1]]
    assert (region[m] == live_view.YELLOW).all()


def test_map_shows_the_jax_points(viewed):
    hj, viewer = viewed["hj"], viewed["viewer"]
    got = read_png(os.path.join(viewed["out"], "map.png"))
    assert got.shape == (live_view.MAP_SIZE, live_view.MAP_SIZE, 3)
    ink = (got != 255).any(axis=-1)
    p = np.asarray(hj.points.positions(hj.kfs.poses))[hj.points.valid]
    assert len(p) > 100
    u, v = viewer.map_pixels(p[:, 0], p[:, 2])
    assert ((u >= 0) & (u < live_view.MAP_SIZE) & (v >= 0) & (v < live_view.MAP_SIZE)).all()
    pad = np.pad(ink, 1)
    near = np.zeros(len(u), bool)
    for du in (0, 1, 2):
        for dv in (0, 1, 2):
            near |= pad[v + dv, u + du]
    assert near.all(), int((~near).sum())
    # the port's own points land where the JAX ones do
    pt = viewed["ht"].points.positions(viewed["ht"].kfs.poses)[viewed["ht"].points.valid]
    np.testing.assert_allclose(pt, p, rtol=0, atol=1e-3)


def test_show_without_opencv_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(live_view, "_cv2", lambda: None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        live_view.LiveViewer(out_dir=str(tmp_path), show=True)
