"""The port's DINOv2 backbone (`wildgaussians_torch/models/dinov2.py`)
against the JAX package's:

- the seeded random init (no local checkpoint): the features after block
  num_heads - 1 of a 336x336 input and of a non-square 98x154 one (7x11
  patches, so the position embedding is interpolated from its 37x37 grid)
  within 1e-4 of the largest |feature|;
- `_torch_bicubic_matrix` equal to the JAX package's, array for array;
- a fabricated state dict with the public checkpoint's key names (random
  values, the real shapes) saved as a `.pth` and named by
  `WG_DINOV2_WEIGHTS`: both packages load it to the same features (98x154,
  within 1e-4), and the port reports it pretrained; the JAX model's
  parameters carried into the port by `DinoV2.from_numpy` give them too;
- a URL in `WG_DINOV2_WEIGHTS` raises in the port, without a socket being
  opened (a connect fails the test).

One test (see test_torch_isolation.py)."""
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.dinov2 as jd
import wildgaussians_torch.models.dinov2 as td

FEATURE_ATOL = 1e-4
BACKBONE = "dinov2_vits14_reg"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_features(jmodel, tmodel, image, what):
    want = np.asarray(jmodel.features(jnp.asarray(image)))
    got = tmodel.features(torch.tensor(image)).numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_ATOL * np.abs(want).max(), err_msg=what)


def _public_state(rng, arch):
    """A state dict under the public checkpoint's names and shapes."""
    d, ps, mlp = arch["embed_dim"], arch["patch_size"], arch["embed_dim"] * arch["mlp_ratio"]

    def r(*shape, std=0.02):
        return torch.tensor((rng.standard_normal(shape) * std).astype(np.float32))
    state = {"patch_embed.proj.weight": r(d, 3, ps, ps), "patch_embed.proj.bias": r(d),
             "cls_token": r(1, 1, d), "register_tokens": r(1, arch["num_register_tokens"], d),
             "pos_embed": r(1, 1 + 37 * 37, d), "mask_token": r(1, d),
             "norm.weight": 1 + r(d), "norm.bias": r(d)}
    for i in range(arch["depth"]):
        pre = f"blocks.{i}."
        state.update({
            pre + "norm1.weight": 1 + r(d), pre + "norm1.bias": r(d),
            pre + "attn.qkv.weight": r(3 * d, d), pre + "attn.qkv.bias": r(3 * d),
            pre + "attn.proj.weight": r(d, d), pre + "attn.proj.bias": r(d),
            pre + "ls1.gamma": 1 + r(d, std=0.1),
            pre + "norm2.weight": 1 + r(d), pre + "norm2.bias": r(d),
            pre + "mlp.fc1.weight": r(mlp, d), pre + "mlp.fc1.bias": r(mlp),
            pre + "mlp.fc2.weight": r(d, mlp), pre + "mlp.fc2.bias": r(d),
            pre + "ls2.gamma": 1 + r(d, std=0.1)})
    return state


def test_dinov2_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("WG_DINOV2_WEIGHTS", raising=False)
    # no local checkpoint: each package's cache directories are empty
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(td, "LOCAL_CACHE", str(tmp_path / "home" / "cache"))
    rng = np.random.default_rng(0)
    jmodel, tmodel = jd.DinoV2(BACKBONE), td.DinoV2(BACKBONE)
    assert not jmodel.pretrained and not tmodel.pretrained
    big = rng.normal(size=(336, 336, 3)).astype(np.float32)
    small = rng.normal(size=(98, 154, 3)).astype(np.float32)
    _same_features(jmodel, tmodel, big, "random init, 336x336")
    _same_features(jmodel, tmodel, small, "random init, 98x154")

    for m, out in ((37, 24), (37, 7), (37, 11), (37, 37), (16, 40)):
        assert np.array_equal(td._torch_bicubic_matrix(m, out, 0.1),
                              jd._torch_bicubic_matrix(m, out, 0.1)), (m, out)

    path = tmp_path / "dinov2_vits14_reg4_pretrain.pth"
    torch.save(_public_state(rng, td.ARCHS[BACKBONE]), path)
    monkeypatch.setenv("WG_DINOV2_WEIGHTS", str(path))
    jmodel, tmodel = jd.DinoV2(BACKBONE), td.DinoV2(BACKBONE)
    assert jmodel.pretrained and tmodel.pretrained
    _same_features(jmodel, tmodel, small, "checkpoint, 98x154")
    carried = td.DinoV2.from_numpy({k: np.asarray(v) for k, v in jmodel.params.items()}, BACKBONE)
    _same_features(jmodel, carried, small, "from_numpy, 98x154")

    def no_connect(*_args, **_kwargs):
        raise AssertionError("a socket was opened")
    monkeypatch.setattr(socket.socket, "connect", no_connect)
    monkeypatch.setenv("WG_DINOV2_WEIGHTS", "https://example.invalid/dinov2.pth")
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        td.DinoV2(BACKBONE)
