"""The port's static viewer path (`bin_static` + `render_static`, the
sort-once / blend-many path over K4) against the JAX package's, on the CPU,
on the same numpy inputs:

  - exact: against `_make_static_renderer(..., pack16=False)`, driven as
    `bin_static` and `render_static` drive it: the entry table, tile
    starts and counts equal on the same (the port's) preprocess arrays, and
    the frame (color, final_T) within 1e-6 (both sides blend in the
    log-space form, f32; the JAX static kernel runs in interpret mode);
  - loose: against `bin_static` + `render_static` as shipped, whose table
    packs geometry to f16 pairs and colors to 10-bit fixed point: within
    PACKED_TOL = 2e-2 (measured on this scene: 5.4e-3);
  - the planar plain version against `blend_forward_plain` rearranged,
    exactly, and the static frame against the port's
    `rasterize_gaussians(backend="pallas")` of the same scene within 1e-6
    (the JAX test's own bound, tests/test_rasterize_pallas.py).

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
import wildgaussians_tpu.cameras as jcameras
from wildgaussians_tpu.ops import rasterize as jrast
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_tpu.ops.rasterize_tiled import tiles_to_image as jtiles_to_image
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import rasterize as trast
from wildgaussians_torch.ops import static_blend as tstatic
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid

N, W, H = 250, 64, 48
D_MAX, D_SMALL, BIG_FRACTION = 16, 4, 0.16
EXACT_TOL, PACKED_TOL = 1e-6, 2e-2
_ARGS = ("xyz", "scales", "rotations", "opacities", "colors")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_exact(pre, scene, bg):
    """The JAX static renderer at pack16=False on the port's preprocess
    arrays `pre` (the two preprocesses may round an ulp apart), driven as
    bin_static and render_static drive it (one color pass)."""
    grid = jmake_grid(W, H, 16)
    bin_fn, blend_fn = jpal._make_static_renderer(grid, 256, N, D_MAX, 1, D_SMALL,
                                                  BIG_FRACTION, False)
    p = {k: jnp.asarray(v.numpy()) for k, v in pre._asdict().items()}
    table, starts, counts = bin_fn(p["mean2d"], p["conic"], p["opacity"],
                                   jnp.asarray(scene["colors"])[None], p["depth"], p["rect_min"],
                                   p["rect_max"], jnp.minimum(p["tiles_touched"], D_MAX),
                                   p["valid"])
    pack = blend_fn(table, starts, counts, jnp.asarray(bg))[0]
    color = jnp.stack([jtiles_to_image(pack[c], grid) for c in range(3)], axis=-1)
    return ([np.asarray(x) for x in (table, starts, counts)],
            np.asarray(color), np.asarray(jtiles_to_image(pack[3], grid)))


def test_static_path_matches_jax():
    rng = np.random.default_rng(7)
    scene = make_scene(rng, n=N)
    # tie-free depths (tools/tpu_parity.py): one blend order on both sides
    scene["xyz"][:, 2] = rng.permutation(2.0 * np.exp(np.linspace(0.0, 1.3, N))).astype(np.float32)
    scene["scales"][:40] *= 3.0      # rects of more than d_small tiles: tier 2
    cam = make_camera(width=W, height=H)
    jcam, _w, _h = jcameras.make_camera_params(cam)
    tcam, _w, _h = make_camera_params(cam)
    bg = np.array([0.2, 0.5, 0.1], np.float32)
    knobs = dict(max_tiles_per_gaussian=D_MAX, d_small=D_SMALL, big_fraction=BIG_FRACTION)

    sb = trast.bin_static(*[torch.tensor(scene[k]) for k in _ARGS], tcam, W, H,
                          kernel_size=0.1, **knobs)
    color, final_t = trast.render_static(sb, N, W, H, bg=torch.tensor(bg), **knobs)
    assert color.shape == (H, W, 3) and final_t.shape == (H, W)
    assert float(sb.color_scale) == 1.0
    assert float(final_t.min()) < 0.5, "the scene must cover the frame"

    # exact: the JAX static renderer at pack16=False
    pre = preprocess(torch.tensor(scene["xyz"]), compute_cov3d(torch.tensor(scene["scales"]),
                                                               torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), tcam, W, H, 0.1)
    (j_table, j_starts, j_counts), j_color, j_t = _jax_exact(pre, scene, bg)
    n_bin = int(sb.tile_starts[-1])
    assert n_bin > 0 and sb.table.shape == (9, n_bin)
    np.testing.assert_array_equal(sb.tile_starts.numpy(), j_starts)
    np.testing.assert_array_equal(sb.tile_counts.numpy(), j_counts)
    np.testing.assert_array_equal(sb.table.numpy(), j_table[:9, :n_bin])
    assert int((pre.tiles_touched > D_SMALL).sum()) > 0, "tier 2 must hold entries"
    np.testing.assert_allclose(color.numpy(), j_color, atol=EXACT_TOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy(), j_t, atol=EXACT_TOL, rtol=0)

    # loose: the JAX static path as shipped (packed table)
    jb = jrast.bin_static(*[jnp.asarray(scene[k]) for k in _ARGS], jcam, W, H, kernel_size=0.1,
                          **knobs)
    p_color, p_t = jrast.render_static(jb, N, W, H, bg=jnp.asarray(bg), **knobs)
    packed_err = max(float(np.abs(color.numpy() - np.asarray(p_color)).max()),
                     float(np.abs(final_t.numpy() - np.asarray(p_t)).max()))
    assert packed_err <= PACKED_TOL, packed_err

    # the planar plain version is K1's plain version rearranged
    grid = make_grid(W, H, 16)
    bg_t = torch.tensor(bg)
    planar = tstatic.blend_forward_planar_plain(sb.table, sb.tile_starts, sb.tile_counts, grid,
                                                1, bg_t)
    colors, ft, _walked, _sat = tblend.blend_forward_plain(sb.table, sb.tile_starts, sb.tile_counts,
                                                     grid, 1)
    assert planar.shape == (1, 4, grid.num_tiles, 256)
    np.testing.assert_array_equal(planar[0, 3].numpy(), ft.numpy())
    np.testing.assert_array_equal(planar[0, :3].numpy(),
                                  (colors[0].permute(2, 0, 1) + ft[None] * bg_t[:, None, None])
                                  .numpy())
    assert tstatic.blend_forward_planar(sb.table, sb.tile_starts, sb.tile_counts, grid, 1,
                                        bg_t).equal(planar)

    # the static frame is the pallas backend's frame of the same scene
    out = trast.rasterize_gaussians(*[torch.tensor(scene[k]) for k in _ARGS], tcam, W, H,
                                    kernel_size=0.1, backend="pallas", bg=bg_t, **knobs)
    np.testing.assert_allclose(color.numpy(), out.color.numpy(), atol=EXACT_TOL, rtol=0)
    np.testing.assert_allclose(final_t.numpy(), out.final_T.numpy(), atol=EXACT_TOL, rtol=0)
