"""The seed decides the inputs, and only the seed: the same seed gives the
same scene, photos, state and camera order; another seed another draw of
the same work (the same cameras, the same layout, the same sizes)."""
import numpy as np
import torch

from harness import scene as S
from harness import state as ST
from kinds import train

CFG = {"num_sky_gaussians": 500, "appearance_n_fourier_freqs": 4, "sh_degree": 3,
       "appearance_enabled": True, "appearance_embedding_dim": 32, "uncertainty_mode": "dino"}
SC = {"surfel_gaussians": 1000, "capacity_per_live": 1.25, "head_conv_std": 0.06,
      "head_conv_bias": -1.5, "adam_grad_scale": {k: 1e-4 for k in (
          "xyz", "features_dc", "features_rest", "scales", "rotations", "opacities", "embeddings",
          "appearance_embeddings", "appearance_mlp", "uncertainty")}}


def make(seed):
    return ST.make(seed, CFG, SC, torch.device("cpu"), 3, [[64, 48], [48, 64]], True, 100)


def test_same_seed_same_inputs_other_seed_other_draw():
    a, b, c = make(2 ** 31 + 11), make(2 ** 31 + 11), make(99)
    assert a.flat.keys() == b.flat.keys() == c.flat.keys()
    for k in a.flat:
        assert np.array_equal(a.flat[k], b.flat[k]), k
    assert not np.array_equal(a.flat["params/xyz"], c.flat["params/xyz"])
    for x, y in zip(a.images, b.images):
        assert torch.equal(x, y)
    for x, y in zip(a.cams, c.cams):
        assert torch.equal(x.pose, y.pose) and x.size == y.size
    assert a.flat["params/xyz"].shape == c.flat["params/xyz"].shape


def test_camera_order_is_the_seeds_permutations():
    a = train.camera_order(2 ** 40 + 3, 8, 3)
    assert a == train.camera_order(2 ** 40 + 3, 8, 3)
    assert a != train.camera_order(5, 8, 3)
    for e in range(3):
        assert sorted(a[8 * e:8 * e + 8]) == list(range(8))


def test_viewer_poses_are_fixed():
    a = S.view_poses(16, 1280, 720, torch.device("cpu"))
    b = S.view_poses(16, 1280, 720, torch.device("cpu"))
    assert all(torch.equal(x.pose, y.pose) for x, y in zip(a, b))
