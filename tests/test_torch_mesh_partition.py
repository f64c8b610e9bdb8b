"""The tile-sharded partition path (`PartitionBlend` under a mesh) on 2 gloo
ranks against the JAX package's single-device engine and the port's.

The scene is `tests/test_parallel.py:72-118`'s (n = 200, 64x64, the first 8
Gaussians 20 times larger, so that the rank merge and tier 2 run). The
ranks round the blend backward's per-entry rows to f16, as the JAX
package's exact mode does, so that the JAX single-device sort engine
(`rasterize_pallas_multi(..., mesh=None, pack16=False)`, big_fraction 0.5
as in `tests/test_parallel.py:122-172`) is a reference of the same
arithmetic. Against it: the loss within 1e-7, the gradients of mean2d,
conic, opacity, colors and bg within rtol 1e-5 and atol 1e-6 max|g|
(`tests/test_parallel.py:113-118`; each Gaussian's entries are split over
the bands, so the sum over the ranks reassociates), the image within 2e-5
(`:168`: the two engines compose a pixel's entries in chunks of their own
tables). The JAX partition engine itself is not the reference: it runs its
radix passes in Pallas interpret mode off the TPU, ~110 s for this scene's
forward and as much again for its gradient on a CPU core;
`tests/test_torch_partition_engine.py` (slow) holds the port's
single-device engine to it. Against the port's single-device partition
engine, with the same f16 rows: the image bit for bit and the rest at the
tolerances above, as `tests/test_parallel.py:72-118` holds the JAX
package's sharded path to its single-device engine.

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from test_torch_mesh_sort import _inputs, _jax_reference
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops.rasterize_tiled import make_grid

IMG_ATOL, LOSS_ABS, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-7, 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the ranks run: the references are computed
    beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_device(x):
    """The port's single-device partition engine, f16 rows."""
    geo = [torch.tensor(x[k], requires_grad=True) for k in W.GEO]
    col = torch.tensor(x["colors"], requires_grad=True)
    bg = torch.tensor(x["bg"], requires_grad=True)
    plain = tblend.blend_backward
    tblend.blend_backward = W.f16_rows(plain)
    try:
        ((img, _t),), _aux = tblend.rasterize_multi(
            *geo, [col], *[torch.tensor(x[k]) for k in W.REST], bg,
            grid=make_grid(64, 64, 16), max_tiles_per_gaussian=int(x["d_max"]),
            d_small=int(x["d_small"]), binning="partition")
        loss = torch.mean((img - torch.tensor(x["target"])) ** 2)
        grads = torch.autograd.grad(loss, [*geo, col, bg])
    finally:
        tblend.blend_backward = plain
    return img.detach().numpy(), float(loss.detach()), [g.numpy() for g in grads]


def _hold(o, want, img_atol, what):
    img, loss, grads = want
    np.testing.assert_allclose(o["img"], img, atol=img_atol, rtol=0, err_msg=what)
    assert float(o["loss"]) == pytest.approx(loss, abs=LOSS_ABS), what
    for i, gw in enumerate(grads):
        # every rank holds the whole gradient (the store is replicated)
        np.testing.assert_allclose(o[f"g{i}"], gw, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * (np.abs(gw).max() + 1e-12),
                                   err_msg=f"{what}: g{i}")


def test_tile_sharded_partition_matches_single_device(tmp_path):
    rng = np.random.default_rng(1)
    x = _inputs(rng, 200, scale=lambda s: s.__setitem__(slice(None, 8), s[:8] * 20.0))
    x.update(bg=np.zeros(3, np.float32), big_fraction=0.16)
    np.savez(tmp_path / "inputs.npz", **x)
    # the references are computed while the ranks run
    outs, (jax_want, port_want) = W.spawn(
        W.mesh_partition_case, 2, str(tmp_path), True,
        meanwhile=lambda: (_jax_reference(dict(x, big_fraction=0.5)), _single_device(x)))
    for o in outs:
        assert int(o["send_drops"]) == 0
        _hold(o, jax_want, IMG_ATOL, "against the JAX single-device engine")
        _hold(o, port_want, 0.0, "against the port's single-device engine")
