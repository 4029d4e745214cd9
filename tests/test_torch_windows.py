"""Port ↔ JAX parity of window extraction (CPU): the plain versions of
kernels K1/K2 against ``extract_windows_xla`` and ``pack_level_windows``,
with corner anchors and out-of-range centres.  Windows 1e-6 (a window is a
copy of pixels), anchors and level dims exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.ops.epipolar import pack_level_windows as jax_pack
from hso_tpu.ops.gatherless import (bilinear_grid as jax_bilinear_grid,
                                    bilinear_scatter_in_windows as jax_scatter,
                                    clip_anchor as jax_clip_anchor, extract_windows_xla,
                                    sample_gradient_in_windows as jax_sample_grad)
from hso_tpu_torch import testing
from hso_tpu_torch.ops import gatherless, window_cuda
from hso_tpu_torch.ops.epipolar import pack_level_windows

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pyr():
    rs = np.random.RandomState(0)
    img = rs.uniform(0, 255, (240, 320)).astype(np.float32)
    out = [img]
    for _ in range(2):
        p = out[-1]
        out.append(0.25 * (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]))
    return out


@pytest.mark.parametrize("win", [24, 40])
def test_extract_windows(pyr, win):
    img = pyr[0]
    au, av = testing.window_anchor_cases(*img.shape, win, 60, seed=0)
    ref = extract_windows_xla(jnp.asarray(img), jnp.asarray(au), jnp.asarray(av), win)
    args = (torch.as_tensor(img), torch.as_tensor(au), torch.as_tensor(av), win)
    np.testing.assert_allclose(window_cuda.extract_windows_plain(*args).numpy(),
                               np.asarray(ref), atol=1e-6)
    # the dispatcher takes the plain version for CPU tensors and launches nothing
    before = dict(window_cuda.LAUNCHES)
    np.testing.assert_allclose(gatherless.extract_windows(*args).numpy(), np.asarray(ref),
                               atol=1e-6)
    assert window_cuda.LAUNCHES == before


def test_extract_windows_out_of_range_reads_zero(pyr):
    img = pyr[2]
    h, w = img.shape
    au = np.array([-5, w - 10, 3], np.int32)
    av = np.array([-3, h - 7, h + 30], np.int32)
    ref = extract_windows_xla(jnp.asarray(img), jnp.asarray(au), jnp.asarray(av), 24)
    out = window_cuda.extract_windows_plain(torch.as_tensor(img), torch.as_tensor(au),
                                            torch.as_tensor(av), 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    assert float(out[2].abs().max()) == 0.0


@pytest.mark.parametrize("win", [24, 48])
def test_pack_level_windows(pyr, win):
    n_levels = 3
    level, cu, cv = testing.level_center_cases([p.shape for p in pyr], 70, seed=1)
    ref_w, ref_a, ref_hw = jax_pack(tuple(jnp.asarray(p) for p in pyr), jnp.asarray(level),
                                    jnp.asarray(cu), jnp.asarray(cv), win, n_levels)
    out_w, out_a, out_hw = pack_level_windows(
        tuple(torch.as_tensor(p) for p in pyr), torch.as_tensor(level), torch.as_tensor(cu),
        torch.as_tensor(cv), win, n_levels)
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), atol=1e-6)
    for k in range(2):
        assert out_a[k].dtype == torch.int32 and out_hw[k].dtype == torch.int32
        np.testing.assert_array_equal(out_a[k].numpy(), np.asarray(ref_a[k]))
        np.testing.assert_array_equal(out_hw[k].numpy(), np.asarray(ref_hw[k]))


def test_clip_anchor_floor_and_clip():
    cu = np.array([-3.7, 0.2, 11.999, 12.0, 158.5, 400.0], np.float32)
    cv = np.array([5.5, -0.1, 100.9, 119.99, 0.0, 60.0], np.float32)
    for grid in (0, 5, 10):
        ref = jax_clip_anchor(jnp.asarray(cu), jnp.asarray(cv), 24, grid, 120, 160)
        out = gatherless.clip_anchor(torch.as_tensor(cu), torch.as_tensor(cv), 24, grid, 120, 160)
        for a, b in zip(out, ref):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bilinear_sampling_in_windows():
    """4-tap gathers against the JAX banded-matmul sampling, including
    samples that fall partly and wholly outside the window (they read 0)."""
    rs = np.random.RandomState(2)
    wins = rs.uniform(0, 255, (12, 24, 24)).astype(np.float32)
    rel_u = rs.uniform(-2.0, 18.0, 12).astype(np.float32)
    rel_v = rs.uniform(-2.0, 18.0, 12).astype(np.float32)
    rel_u[0], rel_v[0] = 0.0, 16.0          # grid ends exactly on the last pixel
    ref = jax_bilinear_grid(jnp.asarray(wins), jnp.asarray(rel_u), jnp.asarray(rel_v), 8)
    out = gatherless.bilinear_grid(torch.as_tensor(wins), torch.as_tensor(rel_u),
                                   torch.as_tensor(rel_v), 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    np.testing.assert_array_equal(
        gatherless.grid_in_window(torch.as_tensor(rel_u), torch.as_tensor(rel_v), 8, 24).numpy(),
        (rel_u >= 0) & (rel_v >= 0) & (rel_u + 7 <= 23) & (rel_v + 7 <= 23))

    pu = rs.uniform(-3.0, 27.0, (12, 9)).astype(np.float32)
    pv = rs.uniform(-3.0, 27.0, (12, 9)).astype(np.float32)
    ref = jax_scatter(jnp.asarray(wins), jnp.asarray(pu), jnp.asarray(pv))
    out = gatherless.bilinear_scatter_in_windows(torch.as_tensor(wins), torch.as_tensor(pu),
                                                 torch.as_tensor(pv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)

    au = rs.randint(0, 100, 12).astype(np.int32)
    av = rs.randint(0, 100, 12).astype(np.int32)
    u = (au + rs.uniform(4, 20, 12)).astype(np.float32)
    v = (av + rs.uniform(4, 20, 12)).astype(np.float32)
    rgx, rgy = jax_sample_grad(jnp.asarray(wins), jnp.asarray(au), jnp.asarray(av),
                               jnp.asarray(u), jnp.asarray(v))
    gx, gy = gatherless.sample_gradient_in_windows(
        torch.as_tensor(wins), torch.as_tensor(au), torch.as_tensor(av), torch.as_tensor(u),
        torch.as_tensor(v))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), atol=2e-4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), atol=2e-4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never carries on with another implementation: handed
    tensors it cannot launch on, it raises."""
    img = torch.zeros((32, 32))
    a = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        window_cuda.extract_windows_cuda(img, a, a, 24)
    with pytest.raises(ValueError):
        window_cuda.pack_level_windows_cuda([img], a, a, a, 24, 1)


@pytest.mark.parametrize("win", [24, 44])
def test_memoize_level_windows(pyr, win):
    """Host windows cut once from each row's own level (24 px for the point
    table, 44 px for the seed table); the packed form is the same data in one
    buffer."""
    from hso_tpu.ops.warp import (memoize_level_windows as jax_memoize,
                                  memoize_level_windows_packed as jax_memoize_packed)
    from hso_tpu_torch.ops.warp import memoize_level_windows, memoize_level_windows_packed

    rs = np.random.RandomState(6)
    n = 50
    px = np.stack([rs.uniform(-4, 324, n), rs.uniform(-4, 244, n)], -1).astype(np.float32)
    px[:4] = [[0, 0], [319, 239], [0, 239], [319, 0]]
    level = rs.randint(0, 3, n).astype(np.int32)
    pyr_j = tuple(jnp.asarray(p) for p in pyr)
    pyr_t = tuple(torch.as_tensor(p) for p in pyr)
    w_ref, a_ref = jax_memoize(pyr_j, jnp.asarray(px), jnp.asarray(level), win=win)
    w, a = memoize_level_windows(pyr_t, torch.as_tensor(px), torch.as_tensor(level), win=win)
    assert a.dtype == torch.int32 and tuple(w.shape) == (n, win, win)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    packed = memoize_level_windows_packed(pyr_t, torch.as_tensor(px), torch.as_tensor(level),
                                          win=win)
    ref_packed = jax_memoize_packed(pyr_j, jnp.asarray(px), jnp.asarray(level), win=win)
    assert tuple(packed.shape) == ref_packed.shape == (n, win * win + 2)
    np.testing.assert_allclose(packed.numpy(), np.asarray(ref_packed), atol=1e-6)


def test_sample_points(pyr):
    """Single-point reads of a whole (non-square) image; outside reads 0 and
    fades over one pixel at the border.  1e-3 on 0–255 values: the JAX side
    sums each point's two-tap row of a dense matrix product."""
    from hso_tpu.ops.gatherless import sample_points as jax_sample_points

    img = pyr[1]
    h, w = img.shape
    rs = np.random.RandomState(8)
    u = rs.uniform(-3.0, w + 2.0, 120).astype(np.float32)
    v = rs.uniform(-3.0, h + 2.0, 120).astype(np.float32)
    u[:5] = [0.0, w - 1.0, -0.5, w - 0.5, 10.0]
    v[:5] = [0.0, h - 1.0, 3.0, h - 0.5, 11.0]
    got = gatherless.sample_points(torch.as_tensor(img), torch.as_tensor(u), torch.as_tensor(v))
    ref = jax_sample_points(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    assert float(got[4]) == img[11, 10] and float(got[0]) == img[0, 0]
    outside = (u < -1) | (u > w) | (v < -1) | (v > h)
    assert outside.sum() > 3 and np.all(got.numpy()[outside] == 0.0)
    nan = gatherless.sample_points(torch.as_tensor(img), torch.tensor([float("nan")]),
                                   torch.tensor([2.0]))
    assert float(nan) == 0.0
