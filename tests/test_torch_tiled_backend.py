"""`rasterizer_backend: tiled` in the port's model against the JAX
package's: the renderer's tiled branch (`bin_gaussians` with
`depth_sort_mode`, then the plain-torch `rasterize_tiled` once per color
pass, its abs-gradient hook pre-scaled by the NDC factors). On
test_torch_train_step.py's dataset, with appearance (a raw and a toned
pass): one render of a training camera with and without depth, the images
within TOL_IMG and the counters equal; then one training step, the metrics
to rtol 1e-4 and every parameter's gradient as test_torch_train_step.py
holds them (`test_torch_gather.step_against_jax`).

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

from test_torch_gather import STEP_OVERRIDES, step_against_jax

TOL_IMG = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_render(jm, tm):
    cam = tm.train_cameras[2:3]
    emb = tm.get_train_embedding(2)
    for outputs in ((), ("depth",)):
        options = {"embedding": emb, "outputs": outputs}
        want = jm.render(jm.train_cameras[2:3], options=options)
        got = tm.render(cam, options=options)
        assert set(got) <= set(want) and ("depth" in got) == bool(outputs)
        for k, v in got.items():
            scale = 1.0 if k != "depth" else float(np.abs(want[k]).max())
            np.testing.assert_allclose(v, np.asarray(want[k]), atol=TOL_IMG * scale, rtol=0,
                                       err_msg=k)
    assert float(got["accumulation"].max()) > 0.5
    pkg = tm.render_pkg(cam, options={"embedding": emb})
    assert pkg.blend == {} and pkg.sat_depth is None and int(pkg.num_rendered) > 0


def test_tiled_backend_matches_jax(monkeypatch):
    metrics = step_against_jax(monkeypatch, dict(STEP_OVERRIDES, rasterizer_backend="tiled"),
                               before_step=_check_render)
    assert metrics["overflow"] > 0   # a budget of 8: some rects are cut, on both sides
