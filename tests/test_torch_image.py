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
