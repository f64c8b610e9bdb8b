"""The port's sort engine against the JAX package's (pack16=False): the same
preprocess arrays must give exactly the same entry table, tile ranges, slot
order, big-Gaussian pool, visible-cell counts and overflow. The engine sizes
are compared in test_torch_ops.py. The port culls the rect cells in chunks
(`sort_engine._CELL_CHUNK`); chunks of 3, which split D_MAX's cells
unevenly, give the same table and counts as one chunk of all of them.

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
from wildgaussians_tpu.ops import rasterize as jrast
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.gaussians import PreprocessOutput as JPre
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import gaussians as tgauss
from wildgaussians_torch.ops import rasterize as trast
from wildgaussians_torch.ops import sort_engine as tsort
from wildgaussians_torch.ops.rasterize_tiled import make_grid

D_MAX = 16
D_SMALL = 2
BIG_FRACTION = 0.02   # m_cap = 8 of 300: the big pool overflows
N_PASSES = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preprocess(seed):
    """A scene with some big Gaussians, preprocessed by the port (whose
    preprocess test_torch_ops holds against the JAX package's); numpy
    arrays, which both sort engines get."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n=300, spread=2.0, z_range=(2.0, 8.0))
    big = rng.uniform(size=300) < 0.15
    scene["scales"][big] *= 6.0
    cam, w, h = make_camera_params(make_camera(width=80, height=48))
    pre = tgauss.preprocess(
        torch.tensor(scene["xyz"]),
        tgauss.compute_cov3d(torch.tensor(scene["scales"]), torch.tensor(scene["rotations"])),
        torch.tensor(scene["opacities"]), cam, w, h, 0.1)
    arrays = {k: v.numpy() for k, v in pre._asdict().items()}
    colors = rng.uniform(0, 1, (N_PASSES, 300, 3)).astype(np.float32)
    return arrays, colors, w, h


def test_sort_engine_matches_jax_exactly(monkeypatch):
    arrays, colors, w, h = _preprocess(7)
    n = arrays["valid"].shape[0]
    tt = np.minimum(arrays["tiles_touched"], D_MAX)
    geo = [arrays[k] for k in ("mean2d", "conic", "opacity")]
    rest = [arrays["depth"], arrays["rect_min"], arrays["rect_max"], tt, arrays["valid"]]
    j_table, j_flat, j_starts, j_counts, j_big, j_key = [np.asarray(x) for x in jpal._build_sorted_table(
        jmake_grid(w, h, 16), 256, n, D_MAX, N_PASSES, D_SMALL, BIG_FRACTION, False,
        *[jnp.asarray(a) for a in geo], jnp.asarray(colors), *[jnp.asarray(a) for a in rest])]
    t = tsort._build_sorted_table(
        make_grid(w, h, 16), n, D_MAX, N_PASSES, D_SMALL, BIG_FRACTION,
        *[torch.tensor(a) for a in geo], torch.tensor(colors),
        *[torch.tensor(np.asarray(a)) for a in rest])

    # tile ranges and order
    n_bin = int(j_starts[-1])
    assert n_bin > 0
    np.testing.assert_array_equal(t.tile_starts.numpy(), j_starts)
    np.testing.assert_array_equal(t.tile_counts.numpy(), j_counts)
    np.testing.assert_array_equal(t.sorted_flat.numpy()[:n_bin], j_flat[:n_bin])
    np.testing.assert_array_equal(t.sorted_key.numpy()[:n_bin], j_key[:n_bin].astype(np.int64))
    np.testing.assert_array_equal(t.big_list.numpy(), j_big)

    # the entry table
    rows = 6 + 3 * N_PASSES
    assert t.table.shape == (rows, n_bin)
    np.testing.assert_array_equal(t.table.numpy(), j_table[:rows, :n_bin])

    # the same result whatever the cell chunk
    monkeypatch.setattr(tsort, "_CELL_CHUNK", 3)
    t3 = tsort._build_sorted_table(
        make_grid(w, h, 16), n, D_MAX, N_PASSES, D_SMALL, BIG_FRACTION,
        *[torch.tensor(a) for a in geo], torch.tensor(colors),
        *[torch.tensor(np.asarray(a)) for a in rest])
    for got, want in zip(t3, t):
        assert torch.equal(got, want)
    monkeypatch.undo()

    # visible-cell counts and overflow
    jpre = JPre(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tpre = tgauss.PreprocessOutput(**{k: torch.tensor(v) for k, v in arrays.items()})
    grid_j, grid_t = jmake_grid(w, h, 16), make_grid(w, h, 16)
    j_vis = np.asarray(jpal.visible_cell_counts(
        jpre.mean2d, jpre.conic, jpre.opacity, jpre.rect_min, jpre.rect_max,
        jpre.tiles_touched, jpre.valid, grid_j, D_MAX))
    t_vis = tsort.visible_cell_counts(tpre.mean2d, tpre.conic, tpre.opacity, tpre.rect_min,
                                      tpre.rect_max, tpre.tiles_touched, tpre.valid,
                                      grid_t, D_MAX)
    np.testing.assert_array_equal(t_vis.numpy(), j_vis)
    # the render path takes the sort engine's own count
    np.testing.assert_array_equal(t.vis_count.numpy(), j_vis)
    # tier 2 runs and the big pool truncates
    assert int(np.sum(j_vis > D_SMALL)) > max(int(300 * BIG_FRACTION), 8)
    j_over = jrast.overflow_count(jpre, "pallas", D_MAX, d_small=D_SMALL,
                                  big_fraction=BIG_FRACTION, binning="sort", grid=grid_j)
    t_over = trast.engine_overflow_count(tpre.tiles_touched, t.vis_count, D_MAX, d_small=D_SMALL,
                                  big_fraction=BIG_FRACTION)
    assert int(t_over) == int(j_over) > 0
