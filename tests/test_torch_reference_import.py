"""The port's reference-checkpoint importer against the JAX package's.

A checkpoint fabricated in the reference's layout, as
test_reference_import.py builds one (40 Gaussians, SH degree 2, appearance
on, a config field the Config lacks, Adam state for xyz), goes through both
importers: every array of the two `chkpnt-<step>.npz` is equal, key for
key, dtype and value, and the two `config.yaml` are the same text. The port
then loads its import and renders a camera, within the render test's
tolerance (1e-4) of the JAX package's render of the JAX import, with the
scene on the screen.

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

from helpers import make_camera
from test_reference_import import _make_reference_state, _write_reference_checkpoint
from wildgaussians_tpu.io.reference_import import \
    import_reference_checkpoint as jimport_reference_checkpoint
from wildgaussians_tpu.models.wildgaussians import WildGaussians as JWildGaussians
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.io.reference_import import import_reference_checkpoint

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_import_matches_jax(rng, tmp_path):
    state = _make_reference_state(rng)
    n = state["xyz"].shape[0]
    exp_avg = torch.from_numpy(rng.normal(0, 1e-4, (n, 3)).astype(np.float32))
    state["optimizer"] = {"state": {0: {"step": torch.tensor(123.0), "exp_avg": exp_avg,
                                        "exp_avg_sq": exp_avg.abs()}},
                          "param_groups": []}
    src = _write_reference_checkpoint(str(tmp_path / "ref"), state, step=7000,
                                      a_field_the_config_lacks=1)
    dst = tmp_path / "port"
    assert import_reference_checkpoint(src, str(dst)) == str(dst)
    jdst = jimport_reference_checkpoint(src, str(tmp_path / "jax"))
    with np.load(dst / "chkpnt-7000.npz") as got, np.load(f"{jdst}/chkpnt-7000.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert int(got["adam/step"]) == 123 and int(got["aux/alive"].sum()) == n
    assert (dst / "config.yaml").read_text() == (tmp_path / "jax" / "config.yaml").read_text()

    tm = WildGaussians(checkpoint=str(dst), device="cpu")
    jm = JWildGaussians(checkpoint=jdst)
    assert tm._loaded_step == jm._loaded_step == 7000
    cam = make_camera(width=64, height=48)
    emb = tm.get_train_embedding(2)
    got = tm.render(cam, options={"embedding": emb})
    want = jm.render(cam, options={"embedding": emb})
    for k in ("color", "accumulation"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)
    assert float(got["accumulation"].max()) > 0.1
