"""The tile-budget growth of the port's trainer against the JAX package's:
both train the same seeded scene (a `helpers.make_scene` point cloud with
400 sky points, uncertainty disabled; the JAX side with
`rasterizer_backend="pallas"`, `pallas_pack16=False`, its Pallas kernels in
interpret mode) for 10 steps from a tile budget of 4, on the same cameras.
Each step's truncated-entry count (`overflow`), raw largest tile rect
(`max_tiles`) and rendered entries agree exactly, and after each step so do
`max_tiles_per_gaussian` and `pallas_big_fraction`: 10 steps of overflow
grow the budget, after step 9, to the largest rect + 1 (13) and the
big-Gaussian pool by 1.5x, on both sides.

Run as a script from the repository's root, it prints the same comparison
at another size and budget: `PYTHONPATH=. python
tests/test_torch_tile_budget.py --width 224 --height 160 --budget 16
--steps 10` (the default config's budget, where the sky's rects exceed 127
tiles and both grow straight to the cap of 128; ~1 min on a CPU).

One test (see test_torch_isolation.py)."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.wildgaussians as jwg
import wildgaussians_tpu.ops.knn_native as jknn_native
from test_torch_train_step import _dataset
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch import WildGaussians
import wildgaussians_torch.models.wildgaussians as twg
from wildgaussians_torch.types import new_cameras

OVERRIDES = dict(uncertainty_mode="disabled", rasterizer_backend="pallas",
                 pallas_pack16=False, num_sky_gaussians=400)
STEPS = 10
KEYS = ("overflow", "max_tiles", "num_rendered")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_knn(monkeypatch):
    """Both sides get the JAX package's Morton-window 3-NN distances, so
    that their initial stores are bit-identical."""
    monkeypatch.setattr(jknn_native, "available", lambda: False)
    monkeypatch.setattr(twg, "mean_knn_dist2",
                        lambda t: torch.as_tensor(np.asarray(jknn(jnp.asarray(t.numpy())))))


def compare(width, height, budget, steps):
    """Per step: (JAX metrics, port metrics, JAX (budget, big fraction)
    after the step, the port's)."""
    overrides = dict(OVERRIDES, max_tiles_per_gaussian=budget)
    jm = jwg.WildGaussians(train_dataset=_dataset(jcameras, width=width, height=height),
                           config_overrides=dict(overrides))
    tm = WildGaussians(train_dataset=_dataset(new_cameras, width=width, height=height),
                       config_overrides=dict(overrides), device="cpu")
    rows = []
    for step in range(steps):
        jout = jm.train_iteration(step, camera_id=step % 3)
        tout = tm.train_iteration(step, camera_id=step % 3)
        rows.append(({k: int(jout[k]) for k in KEYS}, {k: int(tout[k]) for k in KEYS},
                     (jm.config.max_tiles_per_gaussian, jm.config.pallas_big_fraction),
                     (tm.config.max_tiles_per_gaussian, tm.config.pallas_big_fraction)))
    return rows


def test_tile_budget_grows_as_jax(monkeypatch):
    _same_knn(monkeypatch)
    rows = compare(64, 48, 4, STEPS)
    for step, (jmet, tmet, jcfg, tcfg) in enumerate(rows):
        assert tmet == jmet, f"step {step}"
        assert tcfg == jcfg, f"step {step}"
        assert tmet["overflow"] > 0, f"step {step}"
    assert rows[-2][3] == (4, 0.16)
    assert rows[-1][3] == (rows[-1][1]["max_tiles"] + 1, pytest.approx(0.24))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=224)
    parser.add_argument("--height", type=int, default=160)
    parser.add_argument("--budget", type=int, default=16)
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    with pytest.MonkeyPatch.context() as mp:
        _same_knn(mp)
        for step, (jmet, tmet, jcfg, tcfg) in enumerate(
                compare(args.width, args.height, args.budget, args.steps)):
            print(f"step {step}: jax {jmet} budget {jcfg} | port {tmet} budget {tcfg}",
                  flush=True)
