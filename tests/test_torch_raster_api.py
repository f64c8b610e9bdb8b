"""The port's public rasterizer API against the JAX package's, on the CPU,
on the same numpy inputs: `rasterize_gaussians` on its three backends
(forward values and the gradients of means, scales, rotations, opacities,
colors and the abs hook), `rasterize_pallas`, the pallas backend's gather
engine against its partition engine (the same raw-cell binning: images
within 1e-5, equal overflow), `mark_visible`, the public `overflow_count`
(sort, partition and tiled) and `GaussianRasterizer` against the JAX
adapter (SH degree 3 colors, the means2D hook).

Tolerances:
  - "tiled" and "reference": the same f32 arithmetic on both sides, summed
    in another order: values within 1e-5, each gradient within 1e-4 of its
    largest |g| (atol) plus 1e-3 relative;
  - "pallas" (JAX with `pack16=False`, its kernels in interpret mode): the
    JAX backward rounds its per-entry rows to f16 pairs and the port keeps
    f32 (ROADMAP.md Queue 3), so values within 1e-5 and gradients within
    5e-3 max|g| + 5e-2 relative, as tests/test_torch_blend_bwd.py;
  - the adapter as its backend ("tiled").

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
import wildgaussians_tpu.cameras as jcameras
from wildgaussians_tpu.ops import raster_api as japi
from wildgaussians_tpu.ops import rasterize as jrast
from wildgaussians_tpu.ops.gaussians import compute_cov3d as jcov3d
from wildgaussians_tpu.ops.gaussians import preprocess as jpreprocess
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import raster_api as tapi
from wildgaussians_torch.ops import rasterize as trast
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid

N, W, H = 200, 64, 48
# no tier 2 (d_small = d_max): the JAX tier-2 merge in interpret mode would
# triple this test's time; tests/test_torch_blend_bwd.py holds tier 2
D_MAX, D_SMALL = 6, 6
NDC = (32.0, 24.0)
_ARGS = ("xyz", "scales", "rotations", "opacities", "colors")
TOL = {"tiled": (1e-4, 1e-3), "reference": (1e-4, 1e-3), "pallas": (5e-3, 5e-2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss(color, final_t, target, xp):
    return xp.mean((color - target) ** 2) + 0.1 * xp.mean(final_t)


def _jax_run(scene, jcam, target, bg, backend):
    kw = dict(kernel_size=0.1, backend=backend, max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
              pack16=False,
              ndc_scale=jnp.asarray(NDC), bg=jnp.asarray(bg))

    def f(xyz, scales, rots, opac, colors, hook):
        out = jrast.rasterize_gaussians(xyz, scales, rots, opac, colors, jcam, W, H,
                                        absgrad_hook=hook, **kw)
        return _loss(out.color, out.final_T, target, jnp), out

    args = [jnp.asarray(scene[k]) for k in _ARGS] + [jnp.zeros((N, 2), jnp.float32)]
    # one XLA program compiles in a third of the time of eager dispatch
    (_l, out), g = jax.jit(jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True))(*args)
    return out, [np.asarray(x) for x in g]


def _port_run(scene, tcam, target, bg, backend):
    args = [torch.tensor(scene[k], requires_grad=True) for k in _ARGS]
    hook = torch.zeros((N, 2), requires_grad=True)
    out = trast.rasterize_gaussians(*args, tcam, W, H, kernel_size=0.1, backend=backend,
                                    max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
                                    absgrad_hook=hook,
                                    ndc_scale=NDC, bg=torch.tensor(bg))
    g = torch.autograd.grad(_loss(out.color, out.final_T, torch.tensor(target), torch),
                            args + [hook], allow_unused=True)
    # the reference backend leaves the hook out of its graph
    return out, [np.zeros((N, 2), np.float32) if x is None else x.numpy() for x in g]


def _check_backend(backend, scene, jcam, tcam, target, bg):
    jout, jg = _jax_run(scene, jcam, target, bg, backend)
    tout, tg = _port_run(scene, tcam, target, bg, backend)
    for name in ("color", "final_T"):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), atol=1e-5, rtol=0,
                                   err_msg=f"{backend} {name}")
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert int(tout.num_rendered) == int(jout.num_rendered), backend
    assert int(tout.overflow) == int(jout.overflow) == 0, backend
    atol, rtol = TOL[backend]
    for name, gw, gp in zip(_ARGS + ("absgrad_hook",), jg, tg):
        scale = np.abs(gw).max()
        assert scale > 0 or name == "absgrad_hook" and backend == "reference", (backend, name)
        np.testing.assert_allclose(gp, gw, atol=atol * scale, rtol=rtol,
                                   err_msg=f"{backend} d{name}")
    return tout


def _check_overflow(scene, jcam, tcam):
    """The public overflow_count of both packages, on a scene whose big
    Gaussians overflow the big pool: sort (visible cells), partition (raw
    cells, d_small floored at 6) and the tiled backend's."""
    big = dict(scene, scales=scene["scales"] * 6.0)
    cases = (("pallas", "sort", True), ("pallas", "partition", True), ("tiled", "sort", False))

    def jax_counts(xyz, scales, rots, opac):
        jpre = jpreprocess(xyz, jcov3d(scales, rots), opac, jcam, W, H, 0.1)
        return [jrast.overflow_count(jpre, backend, 8, grid=jmake_grid(W, H) if grid else None,
                                     d_small=4, big_fraction=0.02, binning=binning)
                for backend, binning, grid in cases]

    # one XLA program: about half the time of eager dispatch
    wants = jax.jit(jax_counts)(*[jnp.asarray(big[k])
                                  for k in ("xyz", "scales", "rotations", "opacities")])
    tpre = preprocess(torch.tensor(big["xyz"]), compute_cov3d(torch.tensor(big["scales"]),
                                                              torch.tensor(big["rotations"])),
                      torch.tensor(big["opacities"]), tcam, W, H, 0.1)
    seen = set()
    for (backend, binning, grid), want in zip(cases, wants):
        kw = dict(d_small=4, big_fraction=0.02, binning=binning)
        got = int(trast.overflow_count(tpre, backend, 8, grid=make_grid(W, H) if grid else None,
                                       **kw))
        assert got == int(want), (backend, binning)
        seen.add(got)
    assert len(seen) > 1 and max(seen) > 0


def _check_adapter(scene, jcam, tcam, target, rng):
    """GaussianRasterizer at SH degree 3 against the JAX adapter (values
    and the means2D gradient), and against rasterize_gaussians on the
    colors it precomputes; markVisible."""
    shs = rng.normal(0, 0.2, (N, 16, 3)).astype(np.float32)
    common = dict(image_height=H, image_width=W, tanfovx=float(tcam.tan_fov[0]),
                  tanfovy=float(tcam.tan_fov[1]), kernel_size=0.1, subpixel_offset=None,
                  scale_modifier=1.0, sh_degree=3, prefiltered=False, debug=False)
    js = japi.GaussianRasterizationSettings(
        bg=jnp.zeros((3,)), viewmatrix=jcam.viewmatrix.T, projmatrix=jcam.projmatrix.T,
        campos=jcam.campos, **common)
    ts = tapi.GaussianRasterizationSettings(
        bg=torch.zeros((3,)), viewmatrix=tcam.viewmatrix.T, projmatrix=tcam.projmatrix.T,
        campos=tcam.campos, **common)
    jr, tr = japi.GaussianRasterizer(js), tapi.GaussianRasterizer(ts)
    targ = target.transpose(2, 0, 1)

    def jloss(m2d):
        color, radii, acc = jr(jnp.asarray(scene["xyz"]), m2d, jnp.asarray(scene["opacities"]),
                               shs=jnp.asarray(shs), scales=jnp.asarray(scene["scales"]),
                               rotations=jnp.asarray(scene["rotations"]),
                               max_tiles_per_gaussian=D_MAX)
        return jnp.mean((color - targ) ** 2), (color, radii, acc)

    (_l, (jc, jradii, jacc)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.zeros((N, 2), jnp.float32))
    m2d = torch.zeros((N, 2), requires_grad=True)
    tc, tradii, tacc = tr(torch.tensor(scene["xyz"]), m2d, torch.tensor(scene["opacities"]),
                          shs=torch.tensor(shs), scales=torch.tensor(scene["scales"]),
                          rotations=torch.tensor(scene["rotations"]), max_tiles_per_gaussian=D_MAX)
    torch.mean((tc - torch.tensor(targ)) ** 2).backward()
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tacc.detach().numpy(), np.asarray(jacc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tradii.numpy(), np.asarray(jradii))
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(m2d.grad.numpy(), np.asarray(jg), atol=1e-4 * scale, rtol=1e-3)
    # the adapter equals the functional API on the colors it precomputes
    from wildgaussians_torch.ops.sh import eval_sh_switch
    xyz = torch.tensor(scene["xyz"])
    dirs = xyz - tcam.campos[None]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cols = torch.clamp_min(eval_sh_switch(3, 3, torch.tensor(shs).transpose(1, 2), dirs) + 0.5, 0)
    want = trast.rasterize_gaussians(xyz, torch.tensor(scene["scales"]),
                                     torch.tensor(scene["rotations"]),
                                     torch.tensor(scene["opacities"]), cols, tcam, W, H,
                                     kernel_size=0.1, max_tiles_per_gaussian=D_MAX)
    np.testing.assert_allclose(tc.detach().numpy(), want.color.permute(2, 0, 1).numpy(),
                               atol=1e-6, rtol=0)
    pts = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [0.0, 0.0, 0.1], [1.0, 2.0, 3.0]],
                   np.float32)
    got = tr.markVisible(torch.tensor(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jr.markVisible(jnp.asarray(pts))))
    np.testing.assert_array_equal(got, [True, False, False, True])
    with pytest.raises(ValueError):
        tr(xyz, m2d, torch.tensor(scene["opacities"]))        # neither shs nor colors


def test_raster_api_matches_jax():
    rng = np.random.default_rng(3)
    scene = make_scene(rng, n=N)
    # tie-free depths, so that every backend blends in one order
    scene["xyz"][:, 2] = rng.permutation(2.0 * np.exp(np.linspace(0.0, 1.3, N))).astype(np.float32)
    cam = make_camera(width=W, height=H)
    jcam, _w, _h = jcameras.make_camera_params(cam)
    tcam, _w, _h = make_camera_params(cam)
    target = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    outs = {b: _check_backend(b, scene, jcam, tcam, target, bg)
            for b in ("tiled", "pallas", "reference")}
    # the backends agree with each other where no truncation happens
    for b in ("pallas", "reference"):
        np.testing.assert_allclose(outs[b].color.detach().numpy(),
                                   outs["tiled"].color.detach().numpy(), atol=1e-5, rtol=0)
    # rasterize_pallas, the single-pass wrapper, is the pallas backend's blend
    pre = preprocess(torch.tensor(scene["xyz"]), compute_cov3d(torch.tensor(scene["scales"]),
                                                               torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), tcam, W, H, 0.1)
    color, final_t = tblend.rasterize_pallas(
        pre.mean2d, pre.conic, pre.opacity, torch.tensor(scene["colors"]), None, pre.depth,
        pre.rect_min, pre.rect_max, pre.tiles_touched, pre.valid, torch.tensor(bg),
        grid=make_grid(W, H), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL)
    np.testing.assert_array_equal(color.numpy(), outs["pallas"].color.detach().numpy())
    np.testing.assert_array_equal(final_t.numpy(), outs["pallas"].final_T.detach().numpy())
    # the gather engine renders the partition engine's image (both bin raw
    # rect cells), within the partition engine test's 1e-5
    by_engine = {b: trast.rasterize_gaussians(*[torch.tensor(scene[k]) for k in _ARGS], tcam, W,
                                              H, kernel_size=0.1, backend="pallas", binning=b)
                 for b in ("gather", "partition")}
    for field in ("color", "final_T"):
        np.testing.assert_allclose(getattr(by_engine["gather"], field).detach().numpy(),
                                   getattr(by_engine["partition"], field).detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=field)
    assert int(by_engine["gather"].overflow) == int(by_engine["partition"].overflow)
    _check_overflow(scene, jcam, tcam)
    _check_adapter(scene, jcam, tcam, target, rng)
