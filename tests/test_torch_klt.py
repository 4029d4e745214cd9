"""The port's batched pyramidal KLT (``hso_tpu_torch.ops.klt.track_klt``, the
bootstrap's feature tracker) against the JAX package's ``track_klt`` on a
``PlaneScene`` pair at 640×480: the same pyramids (built once by the JAX
package and handed to both), the same seeded feature positions and motion
prior.  Tolerances: tracked positions to 5e-3 px (the align tolerance of
``tests/test_pallas_parity.py``), NCC to 2e-4, the ``ok`` masks equal except
on rows within 1e-4 of the 0.6 NCC gate."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.image.pyramid import build_frame_pyramids
from hso_tpu.ops.klt import track_klt as track_klt_jax
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops.klt import track_klt
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

N = 256


@pytest.fixture(scope="module")
def pair():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    T1 = se3np.exp(np.r_[0.12, -0.03, 0.02, 0.01, -0.02, 0.005])
    pyr0 = build_frame_pyramids(jnp.asarray(scene.render(se3np.identity())))["pyr"]
    pyr1 = build_frame_pyramids(jnp.asarray(scene.render(T1)))["pyr"]
    rng = np.random.default_rng(0)
    px = np.stack([rng.uniform(24, 616, N), rng.uniform(24, 456, N)], -1).astype(np.float32)
    prior = (px + rng.normal(0, 2.0, (N, 2))).astype(np.float32)
    valid = rng.uniform(size=N) > 0.05
    return dict(pyr0=pyr0, pyr1=pyr1, px=px, prior=prior, valid=valid)


@pytest.fixture(scope="module", params=[False, True], ids=["no-prior", "prior"])
def both(pair, request):
    prior = pair["prior"] if request.param else None
    j = track_klt_jax(pair["pyr0"], pair["pyr1"], jnp.asarray(pair["px"]),
                      jnp.asarray(pair["valid"]),
                      px_prior=None if prior is None else jnp.asarray(prior))
    tt = lambda p: tuple(torch.from_numpy(np.array(x)) for x in p)   # noqa: E731
    t = track_klt(tt(pair["pyr0"]), tt(pair["pyr1"]), torch.as_tensor(pair["px"]),
                  torch.as_tensor(pair["valid"]),
                  px_prior=None if prior is None else torch.as_tensor(prior))
    return ({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()})


def test_ok_masks_agree_off_the_gate(both):
    j, t = both
    off_gate = np.abs(j["ncc"] - 0.6) > 1e-4
    assert np.array_equal(j["ok"][off_gate], t["ok"][off_gate])
    assert j["ok"].sum() > 0.4 * N         # a comparison over most rows


def test_tracked_positions_and_ncc(both):
    j, t = both
    ok = j["ok"] & t["ok"]
    assert np.abs(t["px_cur"] - j["px_cur"])[ok].max() <= 5e-3
    fin = np.isfinite(j["ncc"]) & np.isfinite(t["ncc"])
    assert np.array_equal(np.isfinite(j["ncc"]), np.isfinite(t["ncc"]))
    assert np.abs(t["ncc"] - j["ncc"])[fin].max() <= 2e-4
