"""The plain K1 and K2 (`blend_forward_plain`, `blend_backward_plain`) with a
tile base, as the sharded engines call them on a band of the grid.

On a surfel table at 96x80 (30 tiles), split into 4 bands of 8 tiles (the last
one padded past the grid's end with empty tiles, as the engines pad):
  - the call over the whole grid at tile base 0 is the call without one,
    bit for bit (and the latter is what tests/test_torch_blend.py and
    tests/test_torch_blend_bwd.py hold against the JAX kernels);
  - each band's colors, final T, walked counts and saturation votes are
    the whole call's for its tiles, and its gradient rows the whole call's
    for its entries (zero elsewhere), bit for bit: the plain versions batch
    tiles with their entry lists padded to the batch's longest, which
    rounds differently in another batch, so both sides here batch one tile
    at a time.

One test (see test_torch_isolation.py)."""
import numpy as np
import torch

from wildgaussians_torch.cameras import make_camera_params_torch
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.partition_engine import band_of
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sort_engine import _build_sorted_table
from wildgaussians_torch.parallel.mesh import TileMesh
from wildgaussians_torch.scenes import make_surfel_scene

W, H, N_PASSES, D = 96, 80, 2, 4


def _table():
    rng = np.random.default_rng(0)
    f = W / 1.4
    xyz, scales, rots, opac, colors = make_surfel_scene(rng, 3000, W, H, f)
    t = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    cam = make_camera_params_torch(torch.eye(4)[:3], t([f, f, W / 2, H / 2]), W, H)
    pre = preprocess(t(xyz), compute_cov3d(t(scales), t(rots)), t(opac), cam, W, H, 0.1)
    stack = torch.stack([t(colors), t(rng.uniform(0, 1, (3000, 3)))])
    grid = make_grid(W, H, 16)
    st = _build_sorted_table(grid, 3000, 16, N_PASSES, 4, 0.16, pre.mean2d, pre.conic,
                             pre.opacity, stack, pre.depth, pre.rect_min, pre.rect_max,
                             torch.clamp_max(pre.tiles_touched, 16), pre.valid)
    return st, grid, rng


def test_plain_blend_with_tile_base(monkeypatch):
    monkeypatch.setattr(tblend, "_PLAIN_BATCH_ELEMS", 1)     # one tile a batch
    st, grid, rng = _table()
    T = grid.num_tiles
    whole = tblend.blend_forward_plain(st.table, st.tile_starts, st.tile_counts, grid, N_PASSES)
    at0 = tblend.blend_forward_plain(st.table, st.tile_starts, st.tile_counts, grid, N_PASSES,
                                     tile_base=0, num_tiles=T)
    assert all(torch.equal(a, b) for a, b in zip(whole, at0))
    assert int(whole[2].sum()) > 0 and float(whole[1].min()) < 0.5
    gcol = torch.tensor(rng.normal(0, 1e-3, whole[0].shape).astype(np.float32))
    gte = torch.tensor(rng.normal(0, 1e-3, whole[1].shape).astype(np.float32))
    ndc = (0.5 * W, 0.5 * H)
    rows = tblend.blend_backward_plain(st.table, st.tile_starts, st.tile_counts, grid, N_PASSES,
                                       gcol, gte, whole[0], whole[1], ndc)
    assert torch.equal(rows, tblend.blend_backward_plain(
        st.table, st.tile_starts, st.tile_counts, grid, N_PASSES, gcol, gte, whole[0], whole[1],
        ndc, tile_base=0))

    T_band = -(-T // D)
    pad = T_band * D - T
    assert pad > 0
    for r in range(D):
        starts, counts, t0, nt = band_of(st.tile_starts, st.tile_counts, T,
                                         TileMesh(None, r, D, torch.device("cpu")))
        assert (t0, nt) == (r * T_band, T_band)
        band = tblend.blend_forward_plain(st.table, starts, counts, grid, N_PASSES,
                                          tile_base=t0, num_tiles=nt)
        real = min(T, t0 + nt) - t0
        for got, want in zip(band, whole):
            assert torch.equal(got[:, :real] if got.dim() == 4 else got[:real],
                               want[:, t0:t0 + real] if want.dim() == 4 else want[t0:t0 + real])
        # the padding tiles past the grid are empty: nothing blended
        assert torch.all(band[0][:, real:] == 0) and torch.all(band[1][real:] == 1)
        gc = torch.zeros_like(band[0])
        gc[:, :real] = gcol[:, t0:t0 + real]
        gt = torch.zeros_like(band[1])
        gt[:real] = gte[t0:t0 + real]
        brows = tblend.blend_backward_plain(st.table, starts, counts, grid, N_PASSES, gc, gt,
                                            band[0], band[1], ndc, tile_base=t0)
        lo, hi = int(starts[0]), int(starts[nt])
        assert torch.equal(brows[:, lo:hi], rows[:, lo:hi]), r
        assert torch.all(brows[:, :lo] == 0) and torch.all(brows[:, hi:] == 0)
