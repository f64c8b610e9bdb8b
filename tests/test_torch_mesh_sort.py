"""The Gaussian-sharded sort engine (`ops/sharded_sort_engine.py`) on gloo
ranks against the JAX package's single-device sort engine.

The reference is what `tests/test_parallel.py:122-172` holds the JAX
sharded engine to: `rasterize_pallas_multi(..., mesh=None, pack16=False)`
on the same numpy inputs (its sharded engine's interpret-mode compile takes
minutes at 8 devices, `tests/test_send_cap.py`). Scene "a" is that test's
(n = 200, 64x64, every 25th Gaussian 20 times larger, big_fraction 0.5,
bg (0.1, 0.2, 0.3)), run on 4 ranks of one spawn: at D = 4 with the store
sharded (each rank's gradients are its block) and at D = 2 on ranks
{0, 1} with it replicated. The ranks round the blend backward's per-entry
rows to f16 as the JAX package's exact mode does. Tolerances are that
test's: image atol 2e-5, loss abs 1e-6, gradients rtol 1e-4 and atol
2e-5 max|g|.

Scene "b" is `tests/test_send_cap.py`'s (n = 2400 within 0.3 of the axis at
depth 4-5, scales x6): at send_beta 0.01 the send buffer holds C = 512
entries (the floor 2K), and `send_drops` must equal the sum over (sender,
band) of max(segment - C, 0), counted in numpy from the port's
single-device sort table of each sender's Gaussians, and be > 0; at the
default beta 2 it is 0.

Scene "c" is `tests/test_skew.py`'s worst case of ownership skew at D = 4:
rank 0's block (N_VIS Gaussians within 1.2 of the axis at depth 4-6,
scales x2.5, big_fraction 1.0) is the only one in view, the other 3 N_VIS
Gaussians sit behind the camera. The send cap is per rank, so at
send_beta 0.05 the send buffer holds C = 512 entries, the largest band
segment must exceed it, and `send_drops` must equal the numpy count and be
> 0; at D x 1.1 it is 0 and the image is, within the image atol, both the
JAX package's single-device sort engine's forward (computed while the ranks
run) and the port's.

The engine merges the D received streams with one stable sort. The JAX
engine offers a bitonic merge network (`stream_merge=True`) and a stable
sort; its network is held here to give the stable sort's order on
streams full of tied keys, so the two orders are one.

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from helpers import make_camera, make_scene
from wildgaussians_tpu.ops import bitonic
from wildgaussians_tpu.ops.rasterize_pallas import rasterize_pallas_multi
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sharded_sort_engine import sharded_sort_sizes
from wildgaussians_torch.ops.sort_engine import _build_sorted_table

D_MAX, D_SMALL = 16, 4
IMG_ATOL, LOSS_ABS, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-6, 1e-4, 2e-5
N_VIS = 1024   # scene "c": rank 0's block, the only one in view


def _inputs(rng, n, spread=2.0, z_range=(2.0, 8.0), scale=None, behind=0):
    """n Gaussians of make_scene, then `behind` at z = -10, which preprocess
    culls."""
    scene = make_scene(rng, n=n, spread=spread, z_range=z_range)
    if scale is not None:
        scale(scene["scales"])
    for k, v in dict(xyz=(0, 0, -10.0), scales=(0.01,) * 3, rotations=(1, 0, 0, 0),
                     opacities=0.5, colors=(0,) * 3).items():
        scene[k] = np.concatenate([scene[k], np.broadcast_to(
            np.asarray(v, np.float32), (behind, *scene[k].shape[1:]))])
    cam, w, h = make_camera_params(make_camera(width=64, height=64))
    pre = preprocess(torch.tensor(scene["xyz"]),
                     compute_cov3d(torch.tensor(scene["scales"]),
                                   torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), cam, w, h, 0.1)
    x = {k: v.numpy() for k, v in pre._asdict().items()}
    x.update(colors=scene["colors"], target=rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
             d_max=D_MAX, d_small=D_SMALL)
    return x


def _jax_image(x, m2d, con, op, col, bg):
    """The JAX single-device sort engine's image on x's tables and the
    given mean2d, conic, opacity, colors and bg."""
    n = x["valid"].shape[0]
    h, w = x["target"].shape[:2]
    ((img, _t),) = rasterize_pallas_multi(
        m2d, con, op, [col], jnp.zeros((n, 2)), *[jnp.asarray(x[k]) for k in W.REST], bg,
        grid=jmake_grid(w, h, 16), max_tiles_per_gaussian=D_MAX,
        big_fraction=float(x["big_fraction"]), mesh=None, binning="sort", pack16=False)
    return img


def _jax_args(x):
    return [jnp.asarray(x[k]) for k in (*W.GEO, "colors", "bg")]


def _jax_reference(x):
    import jax

    def loss(*a):
        img = _jax_image(x, *a)
        return jnp.mean((img - jnp.asarray(x["target"])) ** 2), img

    (value, img), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *_jax_args(x))
    return np.asarray(img), float(value), [np.asarray(g) for g in grads]


def _hold(tag, outs, want, sharded):
    img, loss, grads = want
    np.testing.assert_allclose(outs[0][tag + "img"], img, atol=IMG_ATOL, rtol=0, err_msg=tag)
    for o in outs:
        assert float(o[tag + "loss"]) == pytest.approx(loss, abs=LOSS_ABS), tag
        assert int(o[tag + "send_drops"]) == 0, tag
    for i, gw in enumerate(grads):
        gp = (np.concatenate([o[f"{tag}g{i}"] for o in outs])
              if sharded and i < 4 else outs[0][f"{tag}g{i}"])
        np.testing.assert_allclose(gp, gw, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * (np.abs(gw).max() + 1e-12),
                                   err_msg=f"{tag}g{i}")


def _numpy_send_drops(x, D, send_beta):
    """Sum over senders s and bands b of max(entries of s's Gaussians in
    b's tiles - C, 0), from the single-device sort table of each sender's
    Gaussians; and C and the largest segment."""
    grid = make_grid(64, 64, 16)
    n = x["valid"].shape[0]
    sz = sharded_sort_sizes(grid, n, D, D_MAX, D_SMALL, float(x["big_fraction"]), send_beta)
    k = n // D
    drops = largest = 0
    for s in range(D):
        t = {key: torch.tensor(x[key][s * k:(s + 1) * k]) for key in (*W.GEO, *W.REST)}
        st = _build_sorted_table(grid, k, D_MAX, 1, D_SMALL, float(x["big_fraction"]),
                                 t["mean2d"], t["conic"], t["opacity"],
                                 torch.tensor(x["colors"][s * k:(s + 1) * k])[None],
                                 t["depth"], t["rect_min"], t["rect_max"],
                                 torch.clamp_max(t["tiles_touched"], D_MAX), t["valid"])
        counts = np.zeros(sz.T_shpad, np.int64)
        counts[:grid.num_tiles] = st.tile_counts.numpy()
        seg = counts.reshape(D, sz.T_band).sum(1)
        drops += int(np.maximum(seg - sz.C, 0).sum())
        largest = max(largest, int(seg.max()))
    return drops, sz.C, largest


def _single_device(x):
    """The port's single-device sort engine's image on the inputs x."""
    from wildgaussians_torch.ops import blend as tblend
    h, w = x["target"].shape[:2]
    with torch.no_grad():
        ((img, _t),), _aux = tblend.rasterize_multi(
            *[torch.tensor(x[k]) for k in W.GEO], [torch.tensor(x["colors"])],
            *[torch.tensor(x[k]) for k in W.REST], torch.tensor(x["bg"]),
            grid=make_grid(w, h, 16), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
            big_fraction=float(x["big_fraction"]), binning="sort")
    return img.numpy()


def _merge_orders_agree():
    """The JAX bitonic merge of 4 sorted streams of 8 keys with many ties
    gives the stable sort's order of their concatenation."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 5, (4, 8)), axis=1).astype(np.uint32).reshape(-1)
    src = np.arange(keys.shape[0], dtype=np.uint32)
    _k, rows, _bits = bitonic.bitonic_merge(jnp.asarray(keys), jnp.asarray(src[None]), 4)
    order = torch.sort(torch.tensor(keys.astype(np.int64)), stable=True).indices.numpy()
    np.testing.assert_array_equal(np.asarray(rows)[0], order)


def test_sharded_sort_engine_matches_single_device(tmp_path):
    _merge_orders_agree()
    rng = np.random.default_rng(0)
    a = _inputs(rng, 200, scale=lambda s: s.__setitem__(slice(None, None, 25), s[::25] * 20.0))
    a.update(bg=np.array([0.1, 0.2, 0.3], np.float32), big_fraction=0.5)
    b = _inputs(rng, 2400, spread=0.3, z_range=(4.0, 5.0), scale=lambda s: s.__imul__(6.0))
    b.update(bg=np.zeros(3, np.float32), big_fraction=0.5)
    c = _inputs(rng, N_VIS, spread=1.2, z_range=(4.0, 6.0), scale=lambda s: s.__imul__(2.5),
                behind=3 * N_VIS)
    c.update(bg=np.zeros(3, np.float32), big_fraction=1.0)
    np.savez(tmp_path / "inputs.npz", **a, **{"b_" + k: v for k, v in b.items()},
             **{"c_" + k: v for k, v in c.items()})
    # the references are computed while the ranks run
    outs, (want, jax_c, single) = W.spawn(
        W.mesh_sort_case, 4, str(tmp_path),
        meanwhile=lambda: (_jax_reference(a), np.asarray(_jax_image(c, *_jax_args(c))),
                           _single_device(c)))
    _hold("d4_", outs, want, sharded=True)
    _hold("d2_", outs[:2], want, sharded=False)

    drops, C, _largest = _numpy_send_drops(b, 4, 0.01)
    assert C == 512 and drops > 0
    for o in outs:
        assert int(o["tight_send_drops"]) == drops
        assert int(o["default_send_drops"]) == 0
        assert np.isfinite(o["tight_img"]).all()

    drops, C, largest = _numpy_send_drops(c, 4, 0.05)
    print(f"scene c: largest band segment {largest}, C {C}, drops {drops}")
    assert C == 512 and largest > C and drops > 0
    for ref, name in ((jax_c, "JAX"), (single, "port")):
        print(f"scene c: |image - {name} single device| max "
              f"{max(np.abs(o['skew_img'] - ref).max() for o in outs):.3g}")
    for o in outs:
        assert int(o["skew_tight_send_drops"]) == drops
        assert np.isfinite(o["skew_tight_img"]).all()
        assert int(o["skew_send_drops"]) == 0
        np.testing.assert_allclose(o["skew_img"], jax_c, atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(o["skew_img"], single, atol=IMG_ATOL, rtol=0)
