"""Training with the uncertainty model: the port's `WildGaussians` against
the JAX package's on test_torch_train_step.py's seeded 64x48 dataset
(occluder masks, sky points, SH degree 3, appearance on), both with
`uncertainty_mode: dino` (the random-init DINOv2), dropout 0, no warm-up
and no protected iterations, so that `loss_mult` (0 or 1) and the head's
gradient act from the first step, and the head's convolution scaled by
HEAD_SCALE so that `loss_mult` is 1 on some pixels and 0 on others; the JAX side with
`rasterizer_backend="pallas"`, `pallas_pack16=False` (its Pallas kernels
in interpret mode) and the port's K2 rows rounded to f16 as the JAX exact
mode rounds them (see test_torch_train_step.py).

Checked:
- the initial store, the uncertainty head included, bit-identical (the
  head is drawn from the trainer's generator after the appearance MLP);
- three steps, each from the same state (the JAX store after its step and
  an Adam step on its gradients, carried into the port through
  `train_state_from_numpy` with the head, its Adam moments and the running
  batch-norm statistics): the metrics, the `uncertainty_*` ones included,
  within rtol 1e-4; the Gaussians' gradients as test_torch_train_step.py
  holds them; the head's within 1e-3 of each one's largest |g|; the new
  batch-norm statistics within rtol 1e-5 (and 1e-5 of the largest). The third step lies in the
  protected window after a reset (`uncertainty_protected_iters` raised on
  both sides): the head's gradient is exactly zero on both, so its update
  is its Adam moments' decay alone, equal to the JAX package's;
- `optimize_embedding` under "dssim+l1-scaled" (the default) on a test
  image with its occluder mask: the uncertainty mask
  (`loss_mult_for_image` > 1) equal to the JAX package's but where a value
  lies within 1e-4 of 1, the loss and mse of each iteration within rtol
  1e-4, the embedding within 1e-3;
- a port checkpoint, with `params/uncertainty/*`, `adam/*/uncertainty/*`
  and `uncertainty_bn/*`, read by the JAX package's loader array for array,
  and resumed by the port; loaded alone (to serve), it builds the
  uncertainty model at its first "-scaled" fit, with the same mask.

One test (see test_torch_isolation.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.gaussian_store as jgs
import wildgaussians_tpu.models.wildgaussians as jwg
import wildgaussians_tpu.ops.knn_native as jknn_native
import wildgaussians_torch.models.gaussian_store as gs
import wildgaussians_torch.models.wildgaussians as twg
import wildgaussians_torch.ops.blend as tblend
from test_torch_train_step import _dataset, _f16_rows, _jax_flat, _port_layout
from wildgaussians_tpu.ops.knn import mean_knn_dist2 as jknn
from wildgaussians_tpu.types import new_cameras as jcameras
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.io.convert import train_state_from_numpy
from wildgaussians_torch.types import new_cameras

OVERRIDES = dict(uncertainty_mode="dino", uncertainty_dropout=0.0, uncertainty_warmup_start=0,
                 uncertainty_warmup_iters=0, uncertainty_protected_iters=0,
                 rasterizer_backend="pallas", pallas_pack16=False, num_sky_gaussians=400,
                 max_tiles_per_gaussian=4, appearance_embedding_optim_iters=2)
# (camera, protected) of the three compared steps
STEPS = ((1, False), (2, False), (0, True))
# the head's 1x1 convolution scaled from its init, so that the uncertainty
# takes both sides of the threshold (an initial head gives u ~ 1 and a
# loss_mult below 1 on every pixel)
HEAD_SCALE = 15.0
METRIC_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-3, 5e-2
HEAD_GRAD_ATOL = 1e-3
BN_RTOL = 1e-5
HEAD_RTOL = 1e-6
MULT_ATOL = 1e-4
LOSS_RTOL, EMB_ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(jm, tm):
    """The JAX model's training state, the uncertainty model's included,
    into the port."""
    state = train_state_from_numpy(jm._state_dict(), tm.config)
    (tm.params, tm.mlp, tm.aux), tm.adam = state.model, state.adam
    tm.uparams, tm._uncertainty.bn_state = state.uncertainty, state.uncertainty_bn
    for t in tm._trainable().values():
        t.requires_grad_(True)


def _check_step(jm, tm, step, camera, protected, captured, jadam):
    """One step on both sides from the same state; then the JAX side's Adam
    step on its gradients (its jitted step hands them back as parameters)."""
    jparams0 = jax.tree_util.tree_map(np.asarray, jm.params)
    jmetrics = jm.train_iteration(step, camera_id=camera)
    loss_mult = []
    terms = tm._uncertainty_terms
    tm._uncertainty_terms = lambda *a: loss_mult.append(terms(*a)) or loss_mult[-1]
    tmetrics = tm.train_iteration(step, camera_id=camera)
    del tm._uncertainty_terms
    share = float(loss_mult[0][1].mean())
    assert 0.05 < share < 0.95, f"step {step}: loss_mult is 1 on {share} of the pixels"
    assert {"uncertainty_loss", "msssim", "ssim_discounted", "mse_discounted",
            "psnr_discounted", "beta"} <= set(tmetrics) <= set(jmetrics)
    for k, v in tmetrics.items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=METRIC_RTOL, err_msg=f"step {step}: {k}")
    jgrads = _jax_flat(jm.params)
    alive = tm.aux.alive.numpy()
    for k, g in captured.items():
        want, got = np.nan_to_num(_port_layout(k, jgrads[k])), g.numpy()
        if k.startswith("uncertainty/"):
            if protected:
                assert not want.any() and not got.any(), f"step {step}: {k} has gradient"
                continue
            scale = np.abs(want).max()
            assert scale > 0, f"step {step}: {k} has no gradient"
            np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_GRAD_ATOL * scale,
                                       err_msg=f"step {step}: gradient of {k}")
            continue
        if want.shape[0] == alive.shape[0]:
            want, got = want[alive], got[alive]
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=f"step {step}: gradient of {k}")
    for k in ("mean", "var"):
        want = np.asarray(jm._uncertainty.bn_state[k])
        np.testing.assert_allclose(tm._uncertainty.bn_state[k].numpy(), want, rtol=BN_RTOL,
                                   atol=BN_RTOL * np.abs(want).max(),
                                   err_msg=f"step {step}: batch-norm {k}")
    grads = jax.tree_util.tree_map(lambda g: jnp.nan_to_num(g), jm.params)
    jm.params, jm.adam = jadam(
        jax.tree_util.tree_map(jnp.asarray, jparams0), grads, jm.adam,
        jgs.param_learning_rates(jm.config, jm.spatial_lr_scale, jnp.float32(step + 1)),
        weight_decay={"appearance_embeddings": jm.config.appearance_embedding_regularization})
    if protected:
        # the head moved by its moments' decay alone, as in the JAX package
        for k, v in tm.uparams.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jm.params["uncertainty"][k]),
                                       rtol=HEAD_RTOL, atol=1e-9, err_msg=f"protected head {k}")


def _check_fit(jm, tm, tds, jds):
    """optimize_embedding with the uncertainty mask ("dssim+l1-scaled")."""
    assert tm.config.appearance_optim_type == "dssim+l1-scaled"
    j_one = dict(jds, cameras=jds["cameras"][2:3], images=[jds["images"][2]],
                 masks=[jds["masks"][2]], image_paths=[jds["image_paths"][2]])
    t_one = dict(tds, cameras=tds["cameras"][2:3], images=[tds["images"][2]],
                 masks=[tds["masks"][2]], image_paths=[tds["image_paths"][2]])
    # the JAX model's uncertainty multiplier, as its fit computes it
    seen = []
    lm_for_image = jm._uncertainty.loss_mult_for_image
    jm._uncertainty.loss_mult_for_image = lambda *a: seen.append(lm_for_image(*a)) or seen[-1]
    j_out = jm.optimize_embedding(j_one)
    t_out = tm.optimize_embedding(t_one)
    want = np.asarray(seen[0])
    got = tm._embed_opt_inputs(t_one)[-1].numpy()
    mask = np.where(jds["masks"][2] > 0, 1.0, 0.0)
    near = np.abs(want - 1.0) <= MULT_ATOL * max(want.max(), 1.0)
    assert np.array_equal(got[~near], ((want > 1) * mask)[~near])
    assert 0.01 < (want > 1).mean() < 0.99, (want > 1).mean()
    for k in ("loss", "mse"):
        np.testing.assert_allclose(t_out["metrics"][k], j_out["metrics"][k], rtol=LOSS_RTOL,
                                   err_msg=f"fit {k}")
    np.testing.assert_allclose(t_out["embedding"], j_out["embedding"], atol=EMB_ATOL, rtol=0)


def test_train_uncertainty_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("WG_DINOV2_WEIGHTS", raising=False)
    monkeypatch.delenv("WG_ADE20K_HEAD", raising=False)
    # both sides get one array of 3-NN distances (see test_torch_train_step.py)
    monkeypatch.setattr(jknn_native, "available", lambda: False)
    monkeypatch.setattr(twg, "mean_knn_dist2",
                        lambda t: torch.tensor(np.asarray(jknn(jnp.asarray(t.numpy())))))
    jds, tds = _dataset(jcameras), _dataset(new_cameras)
    jm = jwg.WildGaussians(train_dataset=jds, config_overrides=dict(OVERRIDES))
    tm = WildGaussians(train_dataset=tds, config_overrides=dict(OVERRIDES), device="cpu")
    # the JAX model's eager DINO calls (loss_mult_for_image) through its
    # jitted one, compiled once by its training steps
    jm._uncertainty._dino_features = jm._uncertainty._dino_jit
    # and its fit's loss multiplier compiled whole (eager, its resizes and
    # head compile operation by operation)
    jm._uncertainty.loss_mult_for_image = jax.jit(jm._uncertainty.loss_mult_for_image)
    jflat = _jax_flat(jm.params)
    tflat = {k: v.detach().numpy() for k, v in tm._trainable().items()}
    assert sorted(jflat) == sorted(tflat) and "uncertainty/conv_w" in tflat
    for k, v in tflat.items():
        assert np.array_equal(v, _port_layout(k, jflat[k])), f"initial {k}"
    for k in ("mean", "var"):
        assert np.array_equal(tm._uncertainty.bn_state[k].numpy(),
                              np.asarray(jm._uncertainty.bn_state[k]))
    # SH degree 3 and anisotropic Gaussians, so that every parameter gets
    # gradient (see test_torch_train_step.py)
    jm.aux = jm.aux._replace(active_sh_degree=jnp.int32(3))
    rng = np.random.default_rng(0)
    for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
        jm.params[k] = jnp.asarray((tflat[k] + rng.normal(0, sigma, tflat[k].shape))
                                   .astype(np.float32))
    jm.params["uncertainty"]["conv_w"] = jm.params["uncertainty"]["conv_w"] * HEAD_SCALE
    _carry(jm, tm)

    captured = {}
    # the JAX side's Adam step compiled whole, as its trainer runs it: eager
    # dispatch compiles each of its operations on their own (the weight
    # decay, a dict of floats the step branches on, is the one every call
    # passes)
    decay = {"appearance_embeddings": jm.config.appearance_embedding_regularization}
    jadam_jit = jax.jit(functools.partial(jgs.adam_update, weight_decay=decay))

    def jadam(params, grads, state, lrs, weight_decay=None):
        assert weight_decay == decay
        return jadam_jit(params, grads, state, lrs)
    tadam = gs.adam_update

    def t_capture(params, grads, state, lrs, weight_decay=None):
        captured.update({k: g.detach().clone() for k, g in grads.items()})
        return tadam(params, grads, state, lrs, weight_decay=weight_decay)
    monkeypatch.setattr(jgs, "adam_update", lambda p, g, s, lrs, weight_decay=None: (g, s))
    monkeypatch.setattr(gs, "adam_update", t_capture)
    monkeypatch.setattr(tblend, "blend_backward", _f16_rows(tblend.blend_backward))
    for step, (camera, protected) in enumerate(STEPS):
        if protected:
            for m in (jm, tm):
                m.config.uncertainty_protected_iters = 1000
        _check_step(jm, tm, step, camera, protected, captured, jadam)
        if not protected:
            _carry(jm, tm)

    _carry(jm, tm)
    _check_fit(jm, tm, tds, jds)

    tm.save(str(tmp_path))
    loaded = jwg.WildGaussians(checkpoint=str(tmp_path))
    for k, v in _jax_flat(loaded.params).items():
        assert np.array_equal(_port_layout(k, v), tm._trainable()[k].detach().numpy()), k
    for which in ("mu", "nu"):
        for k, v in _jax_flat(getattr(loaded.adam, which)).items():
            assert np.array_equal(_port_layout(k, v), getattr(tm.adam, which)[k].numpy()), k
    for k in ("mean", "var"):
        assert np.array_equal(np.asarray(loaded._uncertainty.bn_state[k]),
                              tm._uncertainty.bn_state[k].numpy()), k
    resumed = WildGaussians(checkpoint=str(tmp_path), train_dataset=tds, device="cpu")
    for k, v in resumed._trainable().items():
        assert np.array_equal(v.detach().numpy(), tm._trainable()[k].detach().numpy()), k
    assert resumed.uparams["conv_w"].requires_grad
    assert torch.equal(resumed._uncertainty.bn_state["var"], tm._uncertainty.bn_state["var"])
    served = WildGaussians(checkpoint=str(tmp_path), device="cpu")
    assert served._uncertainty is None
    t_one = dict(tds, cameras=tds["cameras"][2:3], images=[tds["images"][2]],
                 masks=[tds["masks"][2]], image_paths=[tds["image_paths"][2]])
    assert torch.equal(served._embed_opt_inputs(t_one)[-1], tm._embed_opt_inputs(t_one)[-1])
