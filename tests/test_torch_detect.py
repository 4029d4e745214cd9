"""Port ↔ JAX parity of feature detection (CPU): ``fast9_mask``,
``nms3_keep``, ``shi_tomasi_map``, ``edgelet_map``, ``detect_features`` and
``occupancy_grid``.

Inputs: the last keyframe's pyramid stored in ``artifacts/bench_boot.npz``
(480×640, three levels), each side with its own Sobel-5 and the stored
gradient mean, occupancy from that keyframe's valid observations (191 of the
300 cells); and the synthetic images of ``tests/test_detect.py`` (bright
squares, diagonal stripes, smooth shading with only the gradient species).

Tolerances, and why.  The FAST test, the NMS (given the same score map) and
the occupancy grid are comparisons: exact.  The score maps are float32 sums
in the same order of taps, to 1e-5 relative to the map's largest value (the
measured distance is 4e-8 for Shi-Tomasi, 2e-7 for the edgelet strength).
``detect_features`` selects by score, so a score on a tie could choose
another pixel or cell: ``px``/``level``/``species``/``valid`` must agree on
at least 99 % of the 320 rows (measured: all 320, on every input here), and
``score``/``grad`` to 1e-4 relative on the rows that agree (measured 0).

On the squares every corner ties with its mirror images, and the ties decide
which of them fill the cells.  The compiled JAX function contracts
multiply-adds in its Shi-Tomasi map (scores 0.6 off at 5,640 on levels 1-2),
which breaks those ties its own way: 59 of its 63 features are the port's.
There the port is held to the JAX function run op by op
(``jax.disable_jit``), whose float32 steps are the port's: every row equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from hso_tpu.image import pyramid as jpyr
from hso_tpu.ops import detect as jd
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image import pyramid as tpyr
from hso_tpu_torch.ops import detect as td
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

N_OUT = 320


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def kf():
    z = np.load(cs.BOOT_NPZ, allow_pickle=False)
    pyr = [z[f"lastkf_pyr_{l}"] for l in range(3)]
    last = int(z["kf_count"]) - 1
    occ_px = z[f"kf{last}_obs_px"]
    occ_valid = z[f"kf{last}_obs_valid"]
    return dict(pyr=pyr, gm=np.float32(z["lastkf_stats"][0]), occ_px=occ_px,
                occ_valid=occ_valid)


def _both_sides(pyr_np, gm, occ, op_by_op=False):
    """Each side's own Sobel of the same pyramid, then detection; with
    ``op_by_op`` the JAX function runs without its compile."""
    pj = tuple(jnp.asarray(p) for p in pyr_np)
    sj = [jpyr.sobel5(p) for p in pj]
    with jax.disable_jit(op_by_op):
        dj = jd.detect_features(pj, tuple(s[0] for s in sj), tuple(s[1] for s in sj),
                                jnp.float32(gm), jnp.asarray(occ), n_out=N_OUT)
    pt = tuple(_t(p) for p in pyr_np)
    st = [tpyr.sobel5(p) for p in pt]
    dt = td.detect_features(pt, tuple(s[0] for s in st), tuple(s[1] for s in st),
                            torch.tensor(gm), _t(occ), n_out=N_OUT)
    return {k: np.asarray(v) for k, v in dj.items()}, {k: v.numpy() for k, v in dt.items()}


def _agree(dj, dt):
    same = np.ones(N_OUT, bool)
    for k in ("px", "level", "species", "valid"):
        eq = dj[k] == dt[k]
        same &= eq.all(-1) if eq.ndim > 1 else eq
    assert same.mean() >= 0.99, f"{(~same).sum()} of {N_OUT} rows differ"
    for k in ("score", "grad"):
        np.testing.assert_allclose(dt[k][same], dj[k][same], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in dj:
        assert dt[k].dtype == dj[k].dtype and dt[k].shape == dj[k].shape, k
    return same


def _image_cases():
    rng = np.random.default_rng(0)
    return {
        "noise": rng.integers(0, 256, (48, 64)).astype(np.float32),
        "squares": testing.corner_test_image(),
        "stripes": testing.stripe_image().astype(np.float32),
    }


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fast9_and_nms_on_the_keyframe(kf, level):
    img = kf["pyr"][level]
    a = np.asarray(jd.fast9_mask(jnp.asarray(img), kf["gm"]))
    b = td.fast9_mask(_t(img), torch.tensor(kf["gm"])).numpy()
    np.testing.assert_array_equal(b, a)
    assert a.sum() > 1000
    score = np.where(a, np.asarray(jd.shi_tomasi_map(jnp.asarray(img))), 0.0).astype(np.float32)
    np.testing.assert_array_equal(td.nms3_keep(_t(score)).numpy(),
                                  np.asarray(jd.nms3_keep(jnp.asarray(score))))


@pytest.mark.parametrize("name", ["noise", "squares", "stripes"])
@pytest.mark.parametrize("thresh", [7.0, 20.0])
def test_fast9_on_synthetic_images(name, thresh):
    img = _image_cases()[name]
    np.testing.assert_array_equal(td.fast9_mask(_t(img), thresh).numpy(),
                                  np.asarray(jd.fast9_mask(jnp.asarray(img), thresh)))


def test_nms_keeps_one_pixel_of_a_plateau():
    score = np.zeros((12, 14), np.float32)
    score[3:6, 4:8] = 5.0           # a plateau: ties everywhere
    score[9, 2] = score[9, 3] = 2.0
    got = td.nms3_keep(_t(score)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd.nms3_keep(jnp.asarray(score))))
    assert got[3:6, 4:8].sum() == 1 and got[3, 4]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_score_maps_on_the_keyframe(kf, level):
    img = kf["pyr"][level]
    a = np.asarray(jd.shi_tomasi_map(jnp.asarray(img)))
    b = td.shi_tomasi_map(_t(img)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    gx, gy = (np.asarray(g) for g in jpyr.sobel5(jnp.asarray(img)))
    ea = np.asarray(jd.edgelet_map(jnp.asarray(gx), jnp.asarray(gy), kf["gm"])[0])
    eb = td.edgelet_map(_t(gx), _t(gy), torch.tensor(kf["gm"]))[0].numpy()
    np.testing.assert_allclose(eb, ea, rtol=0, atol=1e-5 * np.abs(ea).max())
    np.testing.assert_array_equal(eb > 0, ea > 0)


@pytest.mark.parametrize("name", ["noise", "squares", "stripes"])
def test_shi_tomasi_on_synthetic_images(name):
    img = _image_cases()[name]
    a = np.asarray(jd.shi_tomasi_map(jnp.asarray(img)))
    b = td.shi_tomasi_map(_t(img)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * max(np.abs(a).max(), 1.0))


def test_detect_on_the_keyframe_with_occupancy(kf):
    occ = np.asarray(jd.occupancy_grid(jnp.asarray(kf["occ_px"]), jnp.asarray(kf["occ_valid"]),
                                       480, 640, 32))
    assert 150 < occ.sum() < 300
    dj, dt = _both_sides(kf["pyr"], kf["gm"], occ)
    same = _agree(dj, dt)
    assert same.all() and dt["valid"].sum() > 50
    cells = (dt["px"][dt["valid"]] // 32).astype(int)
    assert not occ[cells[:, 1], cells[:, 0]].any()


def test_detect_on_the_keyframe_without_occupancy(kf):
    dj, dt = _both_sides(kf["pyr"], kf["gm"], np.zeros((15, 20), bool))
    same = _agree(dj, dt)
    assert same.all() and dt["valid"].sum() > 250


@pytest.mark.parametrize("name", ["squares", "stripes"])
def test_detect_on_synthetic_images(name):
    img = _image_cases()[name].astype(np.uint8)
    out = jpyr.build_frame_pyramids(jnp.asarray(img))
    pyr = [np.asarray(p) for p in out["pyr"][:3]]
    occ = np.zeros((-(-img.shape[0] // 32), -(-img.shape[1] // 32)), bool)
    dj, dt = _both_sides(pyr, float(out["grad_mean"]), occ, op_by_op=name == "squares")
    assert _agree(dj, dt).all()
    assert dt["valid"].sum() > 20
    want = td.CORNER if name == "squares" else td.EDGELET
    assert (dt["species"][dt["valid"]] == want).sum() > 5


def test_detect_gradient_species_and_full_occupancy():
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    img = PlaneScene(cam, z0=2.0, extent=2.0, tex=testing.low_texture_texture()).render()
    out = tpyr.build_frame_pyramids(img, device="cpu")
    pyr = [p.numpy() for p in out["pyr"][:3]]
    occ = np.zeros((8, 10), bool)
    dj, dt = _both_sides(pyr, float(out["grad_mean"]), occ)
    _agree(dj, dt)
    assert dt["valid"].sum() > 30 and (dt["species"][dt["valid"]] == td.GRADIENT).all()
    dj1, dt1 = _both_sides(pyr, float(out["grad_mean"]), np.ones((8, 10), bool))
    assert dt1["valid"].sum() == dj1["valid"].sum() == 0


def test_detect_with_fewer_cells_than_rows_pads():
    img = testing.corner_test_image(96, 128)
    pyr = [img, img[::2, ::2].copy(), img[::4, ::4].copy()]
    dj, dt = _both_sides(pyr, 10.0, np.zeros((3, 4), bool), op_by_op=True)
    assert _agree(dj, dt).all()
    assert not dt["valid"][12:].any() and (dt["px"][12:] == 0).all()


def test_occupancy_grid_on_the_keyframe(kf):
    a = np.asarray(jd.occupancy_grid(jnp.asarray(kf["occ_px"]), jnp.asarray(kf["occ_valid"]),
                                     480, 640, 32))
    b = td.occupancy_grid(_t(kf["occ_px"]), _t(kf["occ_valid"]), 480, 640, 32).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_grid_edges_and_invalid_rows(seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-40, 700, (300, 2)).astype(np.float32)
    px[:4] = [[0.0, 0.0], [639.9, 479.9], [31.99, 32.0], [640.0, 480.0]]
    valid = rng.random(300) < 0.3
    valid[:4] = True
    px[~valid][:10] = np.nan                # invalid rows may hold anything
    a = np.asarray(jd.occupancy_grid(jnp.asarray(px), jnp.asarray(valid), 480, 640, 32))
    b = td.occupancy_grid(_t(px), _t(valid), 480, 640, 32).numpy()
    np.testing.assert_array_equal(b, a)
    assert b.shape == (15, 20)
