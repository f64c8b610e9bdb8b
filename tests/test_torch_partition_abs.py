"""The partition engine's abs-gradient channels with two color passes, on
the CPU (the plain K1, K2, K3, K5 and K6): the hook's gradient of a
two-pass render whose cotangent reaches both passes equals the sum of the
two one-pass renders, each with its own pass's cotangent, on both channels
(ch0 = sum over passes of sx sum|dmx_pix|, ch1 = the same of sy
sum|dmy_pix|, the JAX partition engine's per-pass channels,
rasterize_pallas.py:2426-2438). Tolerance 1e-5 of the largest value: the
sums over the passes run in another order. The sort engine keeps its fused
channel on the same render (ch0 only, ch1 = 0), and where one pass carries
the gradient the two engines' g_abs.sum(-1) agree. The JAX engine itself is
held against the port's on two passes by the slow
tests/test_torch_partition_engine.py.

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid

N, W, H = 100, 64, 48
D_MAX, D_SMALL, BIG_FRACTION = 16, 4, 0.1
NDC = (32.0, 24.0)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hook_grad(pre, colors, cots, binning):
    """The abs hook's gradient of one render of `colors` (a list of
    [N, 3]), with `cots` the (color, T) cotangent of each pass."""
    hook = torch.zeros((N, 2), requires_grad=True)
    images, _aux = tblend.rasterize_multi(
        pre.mean2d, pre.conic, pre.opacity, [torch.tensor(c) for c in colors], pre.depth,
        pre.rect_min, pre.rect_max, pre.tiles_touched, pre.valid, torch.tensor([0.1, 0.2, 0.3]),
        grid=make_grid(W, H, 16), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
        big_fraction=BIG_FRACTION, binning=binning, absgrad_hook=hook, ndc_scale=NDC)
    outs = [x for pair in images for x in pair]
    grads = [torch.tensor(g) for pair in cots for g in pair]
    if binning == "sort":
        # the sort engine's passes share one final_T image: its cotangents add
        outs = [outs[0], outs[1]] + outs[2::2]
        grads = [grads[0], sum(grads[1::2])] + grads[2::2]
    (g,) = torch.autograd.grad(outs, [hook], grad_outputs=grads)
    return g.numpy()


def test_partition_abs_channels_sum_over_passes():
    rng = np.random.default_rng(4)
    scene = make_scene(rng, n=N)
    scene["scales"][:15] *= 5.0                 # tier 2 carries gradient too
    tcam, _w, _h = make_camera_params(make_camera(width=W, height=H))
    pre = preprocess(torch.tensor(scene["xyz"]), compute_cov3d(torch.tensor(scene["scales"]),
                                                               torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), tcam, W, H, 0.1)
    pre = pre._replace(**{k: v.detach() for k, v in pre._asdict().items()})
    colors = [scene["colors"], rng.uniform(0, 1, (N, 3)).astype(np.float32)]
    cots = [(rng.normal(0, 1e-2, (H, W, 3)).astype(np.float32),
             rng.normal(0, 1e-2, (H, W)).astype(np.float32)) for _ in colors]

    both = _hook_grad(pre, colors, cots, "partition")
    each = [_hook_grad(pre, [c], [g], "partition") for c, g in zip(colors, cots)]
    scale = np.abs(both).max(axis=0)
    assert (scale > 0).all(), "both channels carry the statistic"
    np.testing.assert_allclose(both, each[0] + each[1], atol=TOL * scale.max(), rtol=0)
    # the per-pass channels differ from the fused channel of the summed gradient
    fused = _hook_grad(pre, colors, cots, "sort")
    assert np.all(fused[:, 1] == 0) and np.abs(fused[:, 0]).max() > 0
    assert np.abs(fused[:, 0] - both.sum(-1)).max() > 1e3 * TOL * scale.max()
    # with one pass, both engines give the trainer the same g_abs.sum(-1)
    fused_one = _hook_grad(pre, colors[:1], cots[:1], "sort")
    np.testing.assert_allclose(each[0].sum(-1), fused_one.sum(-1), atol=TOL * scale.max(), rtol=0)
