"""`pallas_binning`, `saturation_culling` and `rasterizer_backend` reach
the port's render and training paths, and are never ignored.

On a seeded tie-free dataset (geometric point depths, 64x48, the port's
own preprocess inside `render_internal`):
  - `pallas_binning: partition` renders through the partition engine: the
    render's entry table is the one `build_partition_table` makes of the
    render's own preprocess arrays (tests/test_torch_partition_engine.py
    holds that table against the JAX engine's), and its overflow count is
    the JAX package's `overflow_count(..., binning="partition")` of the same
    arrays, as the sort engine's is its `binning="sort"` count; at a small
    big pool the two engines' counts differ;
  - `pallas_binning: gather`, `saturation_culling: true` and
    `rasterizer_backend: tiled` construct, from a config override and from
    a checkpoint's config.yaml, and reach the path they name: the gather
    engine's table, the trainer's saturation maps (a render serves without
    a map, and gives each tile's saturation depth), the tiled blend (no
    blend-kernel table); the loaded checkpoint renders the partition
    engine's image within the partition engine test's tolerance (1e-5),
    under the tiled backend within 1e-4; an unknown binning raises;
  - with overflow 0, one train_iteration under "partition" matches one
    under "sort" from the same init (metrics rtol 1e-4; every gradient atol
    5e-3 max|g| + rtol 5e-2, the tolerances tests/test_torch_train_step.py
    holds the port's step to; so do the densification statistics);
  - the checkpoint saved after that step renders the same image under
    either engine (1e-5), whichever config.yaml names.

One test (see test_torch_isolation.py)."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_scene
from wildgaussians_tpu.ops import rasterize as jrast
from wildgaussians_tpu.ops.gaussians import PreprocessOutput as JPre
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch import WildGaussians
import wildgaussians_torch.models.gaussian_store as gs
import wildgaussians_torch.models.renderer as trenderer
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import partition_engine as teng
from wildgaussians_torch.ops import rasterize as trast
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sort_engine import _build_sorted_table
from wildgaussians_torch.types import new_cameras

W, H = 64, 48
OVERRIDES = dict(uncertainty_mode="disabled", num_sky_gaussians=40, pallas_big_fraction=0.5)
METRIC_RTOL, GRAD_ATOL, GRAD_RTOL, TOL_IMG = 1e-4, 5e-3, 5e-2, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(n_points=200, n_cams=2):
    """Points in front of camera 0 at geometrically spaced depths (no two
    24-bit depth keys tie), photos of random pixels."""
    rng = np.random.default_rng(5)
    scene = make_scene(rng, n=n_points, spread=1.5)
    scene["xyz"][:, 2] = rng.permutation(3.0 * np.exp(np.linspace(0.0, 0.9, n_points)))
    poses = np.stack([np.eye(4, dtype=np.float32)[:3]] * n_cams)
    poses[1:, 0, 3] = 0.3
    f = W / (2 * np.tan(np.radians(50.0) / 2))
    cams = new_cameras(poses=poses,
                       intrinsics=np.array([[f, f, W / 2, H / 2]] * n_cams, np.float32),
                       camera_models=np.zeros((n_cams,), np.int32),
                       distortion_parameters=np.zeros((n_cams, 6), np.float32),
                       image_sizes=np.array([[W, H]] * n_cams, np.int32))
    images = [rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(n_cams)]
    return dict(cameras=cams, images=images, masks=None, points3D_xyz=scene["xyz"],
                points3D_rgb=(scene["colors"] * 255).astype(np.uint8),
                image_paths=[f"{i:03d}.png" for i in range(n_cams)], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={},
                images_points3D_indices=None)


def _check_render_path(model, monkeypatch):
    """The partition engine's table and both engines' overflow counts on the
    render's own preprocess arrays."""
    seen = {}
    orig_pre = trenderer.preprocess

    def record(*args, **kwargs):
        seen["pre"] = orig_pre(*args, **kwargs)
        return seen["pre"]
    monkeypatch.setattr(trenderer, "preprocess", record)
    cfg = model.config
    cam = model.train_cameras[0]
    with torch.no_grad():
        pkg = model.render_pkg(cam)
    monkeypatch.setattr(trenderer, "preprocess", orig_pre)
    pre = seen["pre"]
    n, d_max = pre.valid.shape[0], cfg.max_tiles_per_gaussian
    grid = make_grid(W, H, 16)
    pt = teng.build_partition_table(
        grid, n, d_max, 2, teng.engine_d_small(cfg.pallas_d_small), cfg.pallas_big_fraction, pre.mean2d,
        pre.conic, pre.opacity, torch.zeros((2, n, 3)), pre.depth, pre.rect_min, pre.rect_max,
        torch.clamp_max(pre.tiles_touched, d_max), pre.valid)
    got = pkg.blend["entry_table"]
    assert got.shape == pt.table.shape
    nkey = pt.sizes.nkey
    np.testing.assert_array_equal(got[:nkey + 6].numpy(), pt.table[:nkey + 6].numpy())
    np.testing.assert_array_equal(pkg.blend["tile_starts"].numpy(), pt.tile_starts.numpy())
    np.testing.assert_array_equal(pkg.blend["big_list"].numpy(), pt.big_list.numpy())
    assert "vis_count" not in pkg.blend

    jpre = JPre(**{k: jnp.asarray(v.numpy()) for k, v in pre._asdict().items()})
    counts = {}
    for binning, big_fraction in (("partition", cfg.pallas_big_fraction), ("partition", 0.02),
                                  ("sort", 0.02)):
        want = int(jrast.overflow_count(jpre, "pallas", d_max, d_small=cfg.pallas_d_small,
                                        big_fraction=big_fraction, binning=binning,
                                        grid=jmake_grid(W, H, 16)))
        vis = _build_sorted_table(
            grid, n, d_max, 1, cfg.pallas_d_small, big_fraction, pre.mean2d, pre.conic,
            pre.opacity, torch.zeros((1, n, 3)), pre.depth, pre.rect_min, pre.rect_max,
            torch.clamp_max(pre.tiles_touched, d_max), pre.valid).vis_count
        d_small = (teng.engine_d_small(cfg.pallas_d_small) if binning == "partition"
                   else cfg.pallas_d_small)
        got = int(trast.engine_overflow_count(pre.tiles_touched, vis, d_max, d_small=d_small,
                                       big_fraction=big_fraction, binning=binning,
                                       valid=pre.valid))
        assert got == want, (binning, big_fraction)
        counts[binning, big_fraction] = got
    assert int(pkg.overflow) == counts["partition", cfg.pallas_big_fraction] == 0
    assert counts["partition", 0.02] != counts["sort", 0.02]


def _check_refusals(tmp_path, ckpt, ds, reference):
    """The three settings the port once refused now construct and reach
    their paths (`reference`: the partition engine's render of the
    checkpoint's first training camera)."""
    cam = ds["cameras"][0]
    # the checkpoint's config.yaml names the partition engine; the cull
    # runs on the sort engine's binning
    for key, value, yaml_value, tol in (
            ("pallas_binning", "gather", "gather", TOL_IMG),
            ("saturation_culling", True, "true\npallas_binning: sort", TOL_IMG),
            ("rasterizer_backend", "tiled", "tiled", 1e-4)):
        trainer = WildGaussians(train_dataset=ds, config_overrides=dict(OVERRIDES, **{key: value}),
                                device="cpu")
        assert getattr(trainer.config, key) == value
        assert trainer._use_satcull() == (key == "saturation_culling")
        path = os.path.join(str(tmp_path), f"with_{key}")
        shutil.copytree(ckpt, path)
        with open(os.path.join(path, "config.yaml"), "a", encoding="utf8") as f:
            f.write(f"{key}: {yaml_value}\n")
        loaded = WildGaussians(checkpoint=path, device="cpu")
        assert getattr(loaded.config, key) == value
        pkg = loaded.render_pkg(cam)
        if key == "pallas_binning":
            assert "gid" in pkg.blend and pkg.sat_depth is None
        elif key == "saturation_culling":
            assert "vis_count" in pkg.blend and pkg.sat_depth.shape == (12,)
        else:
            assert pkg.blend == {} and pkg.sat_depth is None
        image = loaded.render(cam)
        for k in ("color", "accumulation"):
            np.testing.assert_allclose(image[k], reference[k], atol=tol, rtol=0,
                                       err_msg=f"{key}: {k}")
    with pytest.raises(ValueError, match="pallas_binning"):
        tblend.check_binning("bogus")


def _with_binning(ckpt, tmp_path, binning):
    out = os.path.join(str(tmp_path), binning)
    shutil.copytree(ckpt, out)
    with open(os.path.join(out, "config.yaml"), "a", encoding="utf8") as f:
        f.write(f"pallas_binning: {binning}\n")
    return out


def test_partition_binning_is_honoured(monkeypatch, tmp_path):
    ds = _dataset()
    models = {b: WildGaussians(train_dataset=ds, device="cpu",
                               config_overrides=dict(OVERRIDES, pallas_binning=b))
              for b in ("sort", "partition")}
    for k, v in models["sort"]._trainable().items():
        assert torch.equal(v, models["partition"]._trainable()[k]), k
    _check_render_path(models["partition"], monkeypatch)
    # SH degree 3 and anisotropic Gaussians, so that every parameter gets a
    # gradient (an initial Gaussian is a sphere, which no rotation changes)
    rng = np.random.default_rng(0)
    for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
        noise = torch.tensor(rng.normal(0, sigma, models["sort"].params[k].shape)
                             .astype(np.float32))
        for m in models.values():
            with torch.no_grad():
                m.params[k].add_(noise)
            m.aux = m.aux._replace(active_sh_degree=torch.tensor(3, dtype=torch.int32))

    grads = {}
    for b, m in models.items():
        def record(params, g, *args, b=b, **kwargs):
            grads[b] = {k: v.detach().clone() for k, v in g.items()}
            return orig(params, g, *args, **kwargs)
        orig = gs.adam_update
        monkeypatch.setattr(gs, "adam_update", record)
        metrics = m.train_iteration(0, camera_id=0)
        monkeypatch.setattr(gs, "adam_update", orig)
        grads[b, "metrics"] = metrics
    want, got = grads["sort", "metrics"], grads["partition", "metrics"]
    assert got["overflow"] == want["overflow"] == 0 and got["num_rendered"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, err_msg=k)
    alive = models["sort"].aux.alive
    for k, gw in grads["sort"].items():
        gp = grads["partition"][k]
        if gw.shape[0] == alive.shape[0]:
            gw, gp = gw[alive], gp[alive]
        scale = float(gw.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(gp.numpy(), gw.numpy(), atol=GRAD_ATOL * scale + 1e-30,
                                   rtol=GRAD_RTOL, err_msg=k)
    for field in ("xyz_grad", "xyz_gradient_accum_abs", "xyz_gradient_accum_abs_max"):
        gw = getattr(models["sort"].aux, field).numpy()
        assert gw.max() > 0, field
        np.testing.assert_allclose(getattr(models["partition"].aux, field).numpy(), gw,
                                   atol=GRAD_ATOL * gw.max(), rtol=GRAD_RTOL, err_msg=field)

    # a checkpoint saved under "partition" renders the same under either engine
    ckpt = os.path.join(str(tmp_path), "ckpt")
    models["partition"].save(ckpt)
    cam = models["partition"].train_cameras[0]
    images = {}
    for b in ("sort", "partition"):
        loaded = WildGaussians(checkpoint=_with_binning(ckpt, tmp_path, b), device="cpu")
        assert loaded.config.pallas_binning == b
        images[b] = loaded.render(cam)
    for key in ("color", "accumulation"):
        assert images["sort"][key].max() > 0
        np.testing.assert_allclose(images["partition"][key], images["sort"][key], atol=TOL_IMG,
                                   rtol=0, err_msg=key)
    _check_refusals(tmp_path, ckpt, ds, images["partition"])
