"""The port's k-NN init statistic (`wildgaussians_torch/ops/knn.py`) equals the
JAX trainer's default, the native simple-knn (`native/simple_knn.cpp` through
`wildgaussians_tpu/ops/knn_native.py`, the JAX package's own loader), within
rtol 1e-6: the native build (-O3 -march=native) may contract the squared
distances into FMAs, which moves them by a few ulp.

The clouds are clustered (50 clusters uniform in [0, 10]^3, sigma 0.05,
100k points): there a quantisation of the Morton cell that rounds unlike the
native code's moves points into other cells, the window then finds other
neighbors, and single points' distances move by up to a few hundred percent.

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

from wildgaussians_tpu.ops import knn_native
from wildgaussians_torch.ops.knn import mean_knn_dist2

KNN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered_cloud(seed, n=100_000, clusters=50, sigma=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 10, (clusters, 3))
    members = rng.randint(0, clusters, n)
    return (centers[members] + rng.normal(0, sigma, (n, 3))).astype(np.float32)


def test_knn_matches_jax_native():
    assert knn_native.available()
    for seed in (2, 6, 8):
        pts = _clustered_cloud(seed)
        want = knn_native.mean_knn_dist2_native(pts)
        got = mean_knn_dist2(torch.tensor(pts)).numpy()
        np.testing.assert_allclose(got, want, rtol=KNN_RTOL, atol=0, err_msg=f"seed {seed}")
