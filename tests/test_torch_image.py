"""Port ↔ JAX parity of the image frontend (CPU): every output of
``build_frame_pyramids``.  Tolerance 1e-4 on 0–255 images: the Sobel taps
are summed in the same order on both sides; the means differ by the
reduction order over ~70k pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu_torch.image.pyramid import build_frame_pyramids, half_sample, sobel5

torch.set_num_threads(1)


def _image(h, w, seed):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rs.normal(0, 6.0, (h, w)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(240, 320), (30, 26)])
def test_build_frame_pyramids(shape):
    img = _image(*shape, seed=0)
    n_total = 5 if shape[0] > 32 else 2
    ref = jax_pyramids(jnp.asarray(img), n_pyr_levels=min(3, n_total), n_total_levels=n_total)
    out = build_frame_pyramids(img, n_pyr_levels=min(3, n_total), n_total_levels=n_total,
                               device="cpu")
    for key in ("pyr", "sobel_x", "sobel_y"):
        assert len(out[key]) == len(ref[key])
        for a, b in zip(out[key], ref[key]):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(float(out["grad_mean"]), float(ref["grad_mean"]), atol=1e-4)
    np.testing.assert_allclose(float(out["intensity_mean"]), float(ref["intensity_mean"]),
                               atol=1e-4)


def test_half_sample_and_sobel_odd_sizes():
    from hso_tpu.image.pyramid import half_sample as j_half, sobel5 as j_sobel

    img = _image(33, 47, seed=1).astype(np.float32)
    np.testing.assert_allclose(half_sample(torch.as_tensor(img)).numpy(),
                               np.asarray(j_half(jnp.asarray(img))), atol=1e-5)
    gx, gy = sobel5(torch.as_tensor(img))
    jx, jy = j_sobel(jnp.asarray(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), atol=1e-4)


def test_accepts_tensor_input():
    img = _image(48, 64, seed=2)
    a = build_frame_pyramids(img, device="cpu")
    b = build_frame_pyramids(torch.as_tensor(img), device="cpu")
    for x, y in zip(a["pyr"], b["pyr"]):
        assert torch.equal(x, y)


def _coords(h, w, n, seed):
    """Sub-pixel coordinates: inside, on integers, and past every border."""
    rs = np.random.RandomState(seed)
    u = rs.uniform(-3.0, w + 2.0, n).astype(np.float32)
    v = rs.uniform(-3.0, h + 2.0, n).astype(np.float32)
    u[:4] = [0.0, w - 1.0, 5.0, w - 1.5]
    v[:4] = [0.0, h - 1.0, 7.0, h - 1.0]
    return u, v


def test_interp_bilinear_and_grad():
    """Clamped 4-tap reads: 1e-4 on 0–255 images (same taps, same weights;
    the products are summed in another order)."""
    from hso_tpu.image import interp as j_interp
    from hso_tpu_torch.image import interp as t_interp

    img = _image(60, 80, seed=3).astype(np.float32)
    u, v = _coords(60, 80, 200, seed=4)
    t = torch.as_tensor
    np.testing.assert_allclose(
        t_interp.bilinear(t(img), t(u), t(v)).numpy(),
        np.asarray(j_interp.bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))),
        atol=1e-4)
    got = t_interp.bilinear_with_grad(t(img), t(u), t(v))
    ref = j_interp.bilinear_with_grad(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    # an integer coordinate reads the pixel itself
    assert float(t_interp.bilinear(t(img), t(u[2:3]), t(v[2:3]))) == img[7, 5]


def test_interp_patch_values():
    from hso_tpu.image import interp as j_interp
    from hso_tpu_torch.image import interp as t_interp
    from hso_tpu_torch.ops.patterns import PATTERNS

    img = _image(60, 80, seed=5).astype(np.float32)
    u0, v0 = _coords(60, 80, 40, seed=6)
    off = np.asarray(PATTERNS[2], np.int32)
    t = torch.as_tensor
    got = t_interp.patch_values(t(img), t(u0), t(v0), t(off))
    ref = j_interp.patch_values(jnp.asarray(img), jnp.asarray(u0), jnp.asarray(v0),
                                jnp.asarray(off))
    assert tuple(got.shape) == ref.shape == (40, len(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    got3 = t_interp.patch_values_with_grad(t(img), t(u0), t(v0), t(off))
    ref3 = j_interp.patch_values_with_grad(jnp.asarray(img), jnp.asarray(u0), jnp.asarray(v0),
                                           jnp.asarray(off))
    for a, b in zip(got3, ref3):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_remap_bilinear_undistorts_like_jax():
    from hso_tpu.cameras import PinholeCamera as JaxPinhole
    from hso_tpu.image.pyramid import remap_bilinear as jax_remap
    from hso_tpu_torch.cameras import PinholeCamera
    from hso_tpu_torch.image.pyramid import remap_bilinear

    dist = (-0.28, 0.07, 2e-4, 1e-5, 0.0)
    cam = PinholeCamera(80, 60, 60.0, 61.0, 40.0, 30.0, *dist, undistort_image=True)
    cam_j = JaxPinhole(80, 60, 60.0, 61.0, 40.0, 30.0, *dist, undistort_image=True)
    mx, my = cam.undistort_remap()
    for a, b in zip((mx, my), cam_j.undistort_remap()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    img = _image(60, 80, seed=7)
    got = remap_bilinear(torch.as_tensor(img), torch.as_tensor(mx), torch.as_tensor(my))
    ref = jax_remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my))
    assert got.dtype == torch.float32 and tuple(got.shape) == (60, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
