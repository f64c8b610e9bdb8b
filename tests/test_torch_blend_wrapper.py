"""K1's wrapper on the CPU, where it runs the plain version: walked counts
and the pair counts of K1's bound on hand-built tiles, its input checks, and
`rasterize_multi` against the literal sequential loop of
`helpers.numpy_sequential_rasterize`."""
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene, numpy_sequential_rasterize
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize import engine_overflow_count
from wildgaussians_torch.ops.rasterize_tiled import make_grid

ATOL_SEQ = 1e-4   # log-space prefix vs the sequential product


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(k, faint_and_flat=False):
    """Tile 0 of a 32x16 canvas holds k entries centred on it, wide and
    nearly opaque (alpha ~0.985-0.99); tile 1 holds none. With
    `faint_and_flat` the first entry is faint (alpha < 1/255) and the
    second has a non-positive-definite conic (power > 0 everywhere)."""
    table = torch.zeros((9, k))
    table[0], table[1] = 7.5, 7.5
    table[2], table[4] = 1e-4, 1e-4
    table[5] = 0.99
    table[6:9] = 1.0
    if faint_and_flat:
        table[5, 0] = 1e-3
        table[2, 1], table[4, 1] = -1e-4, -1e-4
    starts = torch.tensor([0, k, k], dtype=torch.int32)
    counts = torch.tensor([k, 0], dtype=torch.int32)
    return table, starts, counts


def test_blend_wrapper_on_cpu():
    grid = make_grid(32, 16, 16)

    # walked counts: T falls to ~2e-2, ~3e-4, then below 1e-4 at the third
    # entry, which is excluded; the empty tile walks nothing
    table, starts, counts = _stack(8)
    colors, final_t, walked, _sat = tblend.blend_forward(table, starts, counts, grid, 1)
    assert int(walked[0]) == 3 and int(walked[1]) == 0
    assert torch.all(final_t[0] >= 1e-4) and torch.all(final_t[1] == 1.0)
    np.testing.assert_allclose(colors[0, 0].numpy(),
                               np.repeat(1.0 - final_t[0, :, None].numpy(), 3, axis=1), atol=1e-5)

    # K1's bound counts each (pixel, entry) pair by the work it needs; the
    # two entries after the crossing need nothing
    table, starts, counts = _stack(7, faint_and_flat=True)
    n = tblend.blend_pair_counts(table, starts, counts, grid)
    assert n == {"evaluated": 256 * 5, "exp": 256 * 4, "used": 256 * 3, "contributing": 256 * 2}
    assert int(tblend.blend_forward(table, starts, counts, grid, 1)[2][0]) == 5

    # K2's bound, with K2's 8x4 pixel blocks: an entry's pairs count only
    # on the blocks it reaches; a narrow entry at (2, 0.5) reaches block 0
    # alone, a wide faint one all eight (no pixel stops)
    table = torch.tensor([[2.0, 7.5], [0.5, 7.5], [1.0, 1e-4], [0.0, 0.0], [1.0, 1e-4],
                          [0.99, 0.5], [1.0, 1.0], [1.0, 1.0], [1.0, 1.0]])
    starts = torch.tensor([0, 2, 2], dtype=torch.int32)
    counts = torch.tensor([2, 0], dtype=torch.int32)
    n = tblend.blend_pair_counts(table, starts, counts, grid, warp_block=(8, 4))
    assert (n["evaluated"], n["exp"]) == (2 * 256, 2 * 256)
    assert (n["reach_tests"], n["evaluated_reached"], n["exp_reached"]) == (16, 32 + 256, 32 + 256)

    # a tensor on neither the CPU nor a card is refused
    with pytest.raises(ValueError, match="device"):
        tblend.blend_forward(table.to("meta"), starts, counts, grid, 1)

    # rasterize_multi against the literal sequential loop
    rng = np.random.default_rng(11)
    scene = make_scene(rng, n=80)
    cam, w, h = make_camera_params(make_camera(width=40, height=32))
    t = torch.tensor
    pre = preprocess(t(scene["xyz"]), compute_cov3d(t(scene["scales"]), t(scene["rotations"])),
                     t(scene["opacities"]), cam, w, h, 0.1)
    bg = np.array([0.3, 0.0, 0.7], np.float32)
    ((tc, tt),), aux = tblend.rasterize_multi(
        pre.mean2d, pre.conic, pre.opacity, [t(scene["colors"])], pre.depth, pre.rect_min,
        pre.rect_max, pre.tiles_touched, pre.valid, t(bg), grid=make_grid(w, h, 16))
    # nothing truncated: the sort engine bins every visible cell
    assert int(engine_overflow_count(pre.tiles_touched, aux["vis_count"], 16)) == 0
    a = {k: v.numpy() for k, v in pre._asdict().items()}
    ref_c, ref_t = numpy_sequential_rasterize(
        a["mean2d"], a["depth"], a["conic"], a["opacity"], scene["colors"], a["valid"],
        a["rect_min"], a["rect_max"], w, h, bg=bg)
    np.testing.assert_allclose(tc.numpy(), ref_c, atol=ATOL_SEQ, rtol=0)
    np.testing.assert_allclose(tt.numpy(), ref_t, atol=ATOL_SEQ, rtol=0)
