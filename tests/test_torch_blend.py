"""The blend (K1) and the sort-engine rasterizer against the JAX package.

On the CPU the port's wrapper runs `blend_forward_plain`; it is held against
the JAX package's `rasterize_pallas_multi(pack16=False)`, whose `_fwd_kernel`
runs in Pallas interpret mode off the TPU. The check against the literal
sequential loop is in test_torch_blend_wrapper.py, the CUDA kernel's against
the plain version in test_torch_kernels.py.

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
from wildgaussians_tpu.ops.rasterize_pallas import rasterize_pallas_multi
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid

ATOL_JAX = 2e-5   # same log-space arithmetic, another summation order


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n, width, height):
    """Preprocessed arrays of a seeded scene (the port's preprocess, which
    test_torch_ops holds against the JAX package's); both rasterizers get
    the same arrays."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n=n)
    cam, w, h = make_camera_params(make_camera(width=width, height=height))
    pre = preprocess(torch.tensor(scene["xyz"]),
                     compute_cov3d(torch.tensor(scene["scales"]), torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), cam, w, h, 0.1)
    arrays = {k: v.numpy() for k, v in pre._asdict().items()}
    colors = [scene["colors"]] + [rng.uniform(0, 1, (n, 3)).astype(np.float32) for _ in range(2)]
    return arrays, colors, w, h


_GEO = ("mean2d", "conic", "opacity")
_REST = ("depth", "rect_min", "rect_max", "tiles_touched", "valid")


def _port(arrays, colors, w, h, bg):
    return tblend.rasterize_multi(
        *[torch.tensor(arrays[k]) for k in _GEO], [torch.tensor(c) for c in colors],
        *[torch.tensor(arrays[k]) for k in _REST], torch.tensor(bg),
        grid=make_grid(w, h, 16), max_tiles_per_gaussian=16, d_small=4, big_fraction=0.16)


def test_rasterize_multi_matches_jax_pallas():
    arrays, colors, w, h = _scene(3, 240, 80, 48)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    n = arrays["valid"].shape[0]
    # JAX blends all three color sets once: the passes share one alpha/T
    # recurrence, so its first k passes are those of a k-pass blend
    j_out = rasterize_pallas_multi(
        *[jnp.asarray(arrays[k]) for k in _GEO], [jnp.asarray(c) for c in colors],
        jnp.zeros((n, 2), jnp.float32), *[jnp.asarray(arrays[k]) for k in _REST],
        jnp.asarray(bg), grid=jmake_grid(w, h, 16), max_tiles_per_gaussian=16,
        d_small=4, big_fraction=0.16, pack16=False)
    for n_passes in (1, 2, 3):
        t_out, aux = _port(arrays, colors[:n_passes], w, h, bg)
        assert len(t_out) == n_passes
        for (jc, jt), (tc, tt) in zip(j_out, t_out):
            assert tc.shape == (h, w, 3) and tt.shape == (h, w)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL_JAX, rtol=0,
                                       err_msg=f"{n_passes} passes")
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL_JAX, rtol=0,
                                       err_msg=f"{n_passes} passes")
        counts = aux["tile_counts"].numpy()
        walked = aux["walked"].numpy()
        assert np.all((walked >= 0) & (walked <= counts)) and counts.sum() > 0
