"""The plain versions of the port's probes against the JAX package's probe
kernels run in Pallas interpret mode, on the CPU:

  - P1 (`profiles/probe_cfin.py`) against `_probe_kernel` of
    tools/profiles/probe_cfin.py, through a `pallas_call` built here as
    that script builds it (:93-111), on the sort engine's tables of one
    scene at the probe's settings (d_max 10, d_small 4, big fraction 0.16;
    the JAX table packed, as the script's). The JAX probe counts chunks
    from each tile's 128-aligned floor, `shift` entries before its start,
    so per tile c_fin_jax 256 - shift >= walked_port > (c_fin_jax - 1) 256
    - shift. Its exit test (max T < 1e-4) never fires, because a pixel's T
    stops just above 1e-4 (the crossing entry is excluded): c_fin_jax is
    every tile's chunk count. The scene's opacities are low enough that no
    tile saturates, so the port's walk runs to the end of every list and
    the bound holds on both sides. The port's own c_fin, n_chunks and
    walked are checked against K1's plain walked counts.
  - P2 (`profiles/probe_sortdesign.py`) against the JAX `kern` of
    tools/profiles/probe_sortdesign.py (:140, rebuilt here as the script
    builds it inside `dma_probe`) at W=8, C=4, E=2, RUN=128: bit for bit.

One test (see test_torch_isolation.py)."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from helpers import make_camera, make_scene
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sort_engine import _build_sorted_table
from wildgaussians_torch.profiles import probe_cfin as tcfin
from wildgaussians_torch.profiles import probe_sortdesign as tsort

N, W, H = 900, 64, 48
K = 256
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_probe_module():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_cfin", ROOT / "tools" / "profiles" / "probe_cfin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cfin(pre, colors):
    """c_fin and n_chunks per tile from the JAX probe kernel in interpret
    mode, and the JAX tile starts."""
    grid = jmake_grid(W, H, 16)
    p = {k: jnp.asarray(v.numpy()) for k, v in pre._asdict().items()}
    table, _f, starts, counts, _b, _k = jpal._build_sorted_table(
        grid, K, N, tcfin.D_MAX, 1, tcfin.D_SMALL, tcfin.BIG_FRACTION, True, p["mean2d"],
        p["conic"], p["opacity"], jnp.asarray(colors)[None], p["depth"], p["rect_min"],
        p["rect_max"], jnp.minimum(p["tiles_touched"], tcfin.D_MAX), p["valid"])
    call = pl.pallas_call(
        functools.partial(_jax_probe_module()._probe_kernel, grid=grid, K=K),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3, grid=(grid.num_tiles,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=[pl.BlockSpec((1, 8, 128), lambda i, *_: (i, 0, 0))],
            scratch_shapes=[pltpu.VMEM((2, table.shape[0], K), jnp.float32),
                            pltpu.SemaphoreType.DMA((2,))]),
        out_shape=[jax.ShapeDtypeStruct((grid.num_tiles, 8, 128), jnp.int32)],
        interpret=True)
    (cf,) = call(jnp.zeros((1,), jnp.int32), starts, counts, table)
    cf = np.asarray(cf)[:, 0, :2]
    return cf[:, 0], cf[:, 1], np.asarray(starts), np.asarray(counts)


def _check_p1():
    rng = np.random.default_rng(5)
    scene = make_scene(rng, n=N, spread=1.0)      # lists of more than one chunk
    scene["opacities"] *= 0.15                    # no tile saturates
    tcam, _w, _h = make_camera_params(make_camera(width=W, height=H))
    pre = preprocess(torch.tensor(scene["xyz"]), compute_cov3d(torch.tensor(scene["scales"]),
                                                               torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), tcam, W, H, 0.1)
    grid = make_grid(W, H, 16)
    st = _build_sorted_table(grid, N, tcfin.D_MAX, 1, tcfin.D_SMALL, tcfin.BIG_FRACTION,
                             pre.mean2d, pre.conic, pre.opacity,
                             torch.tensor(scene["colors"])[None], pre.depth, pre.rect_min,
                             pre.rect_max, torch.clamp_max(pre.tiles_touched, tcfin.D_MAX),
                             pre.valid)
    out = tcfin.probe_cfin(st.table, st.tile_starts, st.tile_counts, grid).numpy()
    c_fin, n_chunks, walked = out[:, 0], out[:, 1], out[:, 2]
    counts = st.tile_counts.numpy()
    assert counts.max() > K, "a tile must hold more than one chunk"
    k1_walked = tblend.blend_forward_plain(st.table, st.tile_starts, st.tile_counts, grid, 1)[2]
    np.testing.assert_array_equal(walked, k1_walked.numpy())
    np.testing.assert_array_equal(walked, counts)              # no tile saturates
    np.testing.assert_array_equal(n_chunks, (counts + K - 1) // K)
    np.testing.assert_array_equal(c_fin, (walked + K - 1) // K)

    j_cfin, j_nchunks, j_starts, j_counts = _jax_cfin(pre, scene["colors"])
    np.testing.assert_array_equal(j_starts[:grid.num_tiles], st.tile_starts.numpy()[:-1])
    np.testing.assert_array_equal(j_counts, counts)
    shift = j_starts[:grid.num_tiles] % 128
    np.testing.assert_array_equal(j_cfin, j_nchunks)           # the exit never fires
    assert np.all(j_cfin * K - shift >= walked), "walked past the JAX probe's chunks"
    assert np.all(walked > (j_cfin - 1) * K - shift), "the JAX probe walked a spare chunk"


def _jax_run_scatter(src, starts, C, E, run):
    """The JAX probe's run-scatter kernel (probe_sortdesign.py `dma_probe`)
    in interpret mode."""
    def kern(starts_ref, src_ref, dst_ref, sem):
        c = pl.program_id(0)

        def mkdma(e):
            st = pl.multiple_of(starts_ref[c * E + e], 128)
            return pltpu.make_async_copy(
                src_ref.at[:, pl.ds(st, run)],
                dst_ref.at[:, e, pl.ds(pl.multiple_of(c * run, 128), run)], sem.at[e])
        for e in range(E):
            mkdma(e).start()
        for e in range(E):
            mkdma(e).wait()

    call = pl.pallas_call(
        kern, grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(C,), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.SemaphoreType.DMA((E,))]),
        out_shape=jax.ShapeDtypeStruct((src.shape[0], E, C * run), jnp.uint32),
        interpret=True)
    return np.asarray(call(jnp.asarray(starts), jnp.asarray(src)))


def _check_p2():
    C, Kc, E, run = 4, 256, 2, 128
    rng = np.random.default_rng(2)
    src = rng.integers(0, 2 ** 32, (tsort.W, C * Kc + Kc), dtype=np.uint64).astype(np.uint32)
    starts = (np.arange(C)[:, None] * Kc + np.arange(E)[None, :] * run).astype(np.int32).ravel()
    want = _jax_run_scatter(src, starts, C, E, run)
    got = tsort.run_scatter(torch.from_numpy(src.view(np.int32)), torch.from_numpy(starts),
                            E, run).numpy().view(np.uint32)
    assert got.shape == want.shape == (tsort.W, E, C * run)
    np.testing.assert_array_equal(got, want)
    # the inputs chip_smoke.py and the probe build: starts c K + e RUN
    src_t, starts_t = tsort.scatter_inputs(C, Kc, E, run, torch.device("cpu"))
    np.testing.assert_array_equal(starts_t.numpy(), starts)
    assert src_t.shape == (tsort.W, C * Kc + Kc) and src_t.dtype == torch.int32


def test_probes_match_jax():
    _check_p1()
    _check_p2()
