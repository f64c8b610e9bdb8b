"""The port's uncertainty model against the JAX package's, on seeded numpy
inputs (the random-init DINOv2, whose features test_torch_dinov2.py holds):

- `resize_valid`, `content_mask` (pixel and patch level) and
  `resize_to_valid`, letterboxed and squashed, on a 45x70 valid region of a
  48x80 canvas whose padding holds junk (the resize reads the whole padded
  axis, as the JAX one does), within 1e-5 of the largest value; the masks
  exactly;
- `msssim` (at min_size 80: 336 -> 168 -> 84 -> 42), `ssim_down` and
  `dssim_go` within 1e-4;
- the head in train mode, with the JAX package's channel-dropout mask
  (drawn here by `jax.random.bernoulli`) passed in, and in eval mode: u and
  the new batch-norm statistics within 1e-5 relative;
- `compute_loss` in the four modes (dino, dino+mssim, l2reg, l1reg), train
  mode, dropout on, a letterbox and patch mask: the loss, every metric
  (rtol 1e-4), `loss_mult` (1e-4 of its largest value), the batch-norm
  statistics (rtol 1e-5), and the head's gradients against `jax.grad`
  within 1e-3 of each one's largest |g|. The JAX side's DINO features of
  the prediction are computed once and handed to its loss; the port runs
  its own backbone;
- `loss_mult_for_image` on the padded image (eval mode, the running
  statistics of a train-mode call): within 1e-4 of the largest value, and
  its threshold at 1 equal but where a value lies within 1e-4 of 1;
- `init_params` with WG_ADE20K_HEAD naming a fabricated ADE20k linear-head
  checkpoint (the public key names): the same head and batch-norm
  statistics as the JAX package's;
- `device.full_f32` sets full-f32 matmuls and convolutions inside and gives
  the caller's flags back, also when the block raises.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.uncertainty as jun
import wildgaussians_tpu.ops.ssim as jssim
import wildgaussians_torch.models.uncertainty as tun
import wildgaussians_torch.ops.ssim as tssim
from wildgaussians_tpu.config import Config as JConfig
from wildgaussians_torch.config import Config as TConfig
from wildgaussians_torch.device import full_f32

RESIZE_ATOL = 1e-5
SSIM_ATOL = 1e-4
HEAD_RTOL = 1e-5
METRIC_RTOL = 1e-4
MULT_ATOL = 1e-4
GRAD_ATOL = 1e-3
BN_RTOL = 1e-5
# the padded canvas and its valid region (neither a multiple of the other)
PAD_H, PAD_W, VALID_H, VALID_W = 48, 80, 45, 70
S = tun.DINO_SIZE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol_rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol_rel * (np.abs(want).max() + 1e-30), err_msg=what)


def _check_resize(rng):
    img = rng.uniform(0, 1, (PAD_H, PAD_W, 3)).astype(np.float32)
    img[VALID_H:] = rng.uniform(5, 9, img[VALID_H:].shape)      # junk in the padding
    img[:, VALID_W:] = rng.uniform(5, 9, img[:, VALID_W:].shape)
    vh, vw = jnp.float32(VALID_H), jnp.float32(VALID_W)
    for lb in (True, False):
        want = jun.resize_valid(jnp.asarray(img), S, S, vh, vw, letterbox=lb)
        got = tun.resize_valid(_t(img), S, S, VALID_H, VALID_W, letterbox=lb)
        _close(got, want, RESIZE_ATOL, f"resize_valid letterbox={lb}")
        for g in (1, 14):
            jm = jun.content_mask(S, S, vh, vw, lb, granularity=g)
            tm = tun.content_mask(S, S, VALID_H, VALID_W, lb, granularity=g)
            assert np.array_equal(tm.numpy(), np.asarray(jm)), (lb, g)
        assert np.asarray(jm).min() == (0.0 if lb else 1.0)
        # an [H,W] map back, as the trainer maps loss_mult
        back_j = jun.resize_to_valid(want[..., 0], PAD_H, PAD_W, vh, vw, letterbox=lb)
        back_t = tun.resize_to_valid(got[..., 0], PAD_H, PAD_W, VALID_H, VALID_W, letterbox=lb)
        _close(back_t, back_j, RESIZE_ATOL, f"resize_to_valid letterbox={lb}")


def _check_ssim(rng):
    x = rng.uniform(0, 1, (S, S, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    # a batch of odd sizes: the area resize, then pools that drop a column
    xs = rng.uniform(0, 1, (2, 75, 99, 3)).astype(np.float32)
    ys = np.clip(xs + rng.normal(0, 0.2, xs.shape), 0, 1).astype(np.float32)
    for name, a, b, kw in (("msssim", x, y, dict(max_size=None, min_size=80)),
                           ("msssim", xs, ys, dict(max_size=60, min_size=20)),
                           ("ssim_down", x, y, dict(max_size=400)),
                           ("dssim_go", x, y, dict(size_average=False))):
        want = getattr(jssim, name)(jnp.asarray(a), jnp.asarray(b), **kw)
        got = getattr(tssim, name)(_t(a), _t(b), **kw)
        assert tuple(got.shape) == np.shape(want), (name, kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSIM_ATOL, rtol=0,
                                   err_msg=f"{name} {kw}")


def _models(mode):
    jc = JConfig(uncertainty_mode=mode)
    tc = TConfig(uncertainty_mode=mode)
    return jun.UncertaintyModel(jc), tun.UncertaintyModel(tc)


def _head_params(junc, tunc):
    """Both heads from one draw, away from their init (so that the batch
    norm's affine and bias get gradient)."""
    rng = np.random.default_rng(7)
    jp = junc.init_params(np.random.default_rng(3))
    tp = tunc.init_params(np.random.default_rng(3))
    for k in jp:
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), f"init {k}"
    d = jp["conv_w"].shape[0]
    arrays = {"conv_w": rng.normal(0, 0.05, (d, 1)), "conv_b": rng.normal(0, 0.1, (1,)),
              "bn_scale": rng.uniform(0.8, 1.2, (d,)), "bn_bias": rng.normal(0, 0.1, (d,))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v).clone().requires_grad_(True) for k, v in arrays.items()})


def _check_head(junc, tunc, feats, pmask):
    jp, tp = _head_params(junc, tunc)
    bn = {"mean": np.full((384,), 0.1, np.float32), "var": np.full((384,), 1.5, np.float32)}
    jbn = {k: jnp.asarray(v) for k, v in bn.items()}
    tbn = {k: _t(v) for k, v in bn.items()}
    key = jax.random.PRNGKey(11)
    p = junc.config.uncertainty_dropout
    keep = np.asarray(jax.random.bernoulli(key, 1 - p, (1, 1, 384))).astype(np.float32)
    assert 0 < keep.mean() < 1
    for train in (True, False):
        ju, jnew = junc.head_uncertainty(jp, jbn, jnp.asarray(feats), train=train, key=key,
                                         patch_mask=jnp.asarray(pmask))
        with torch.no_grad():
            tu, tnew = tunc.head_uncertainty(tp, tbn, _t(feats), train=train, keep=_t(keep),
                                             patch_mask=_t(pmask))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=HEAD_RTOL, atol=0,
                                   err_msg=f"head u train={train}")
        for k in bn:
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), rtol=HEAD_RTOL,
                                       atol=1e-7, err_msg=f"head bn {k} train={train}")
        assert train or tnew is tbn
    return keep


def _check_losses(rng, feats_gt, jfeats_pred, gt336, pred336, keep, mask336, pmask):
    """compute_loss in every mode, train mode with dropout, against the JAX
    package's value and jax.grad. The JAX model's DINO features of the
    prediction are `jfeats_pred` (computed once); the port's backbone runs."""
    key = jax.random.PRNGKey(11)
    bn = {"mean": rng.normal(0, 0.1, (384,)).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, (384,)).astype(np.float32)}
    for mode in ("dino", "dino+mssim", "l2reg", "l1reg"):
        junc, tunc = _models(mode)
        junc._dino_features = lambda img: jnp.asarray(jfeats_pred)
        jp, tp = _head_params(junc, tunc)
        jbn = {k: jnp.asarray(v) for k, v in bn.items()}

        def jloss(params):
            loss, metrics, lm, new_bn = junc.compute_loss(
                params, jbn, jnp.asarray(feats_gt), jnp.asarray(gt336), jnp.asarray(pred336),
                jnp.asarray(mask336), key, train=True, patch_mask=jnp.asarray(pmask))
            return loss, (metrics, lm, new_bn)
        (jl, (jmet, jlm, jbn_new)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
        tl, tmet, tlm, tbn_new = tunc.compute_loss(
            tp, {k: _t(v) for k, v in bn.items()}, _t(feats_gt), _t(gt336), _t(pred336),
            _t(mask336), train=True, keep=_t(keep), patch_mask=_t(pmask))
        tg = torch.autograd.grad(tl, list(tp.values()))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=METRIC_RTOL, err_msg=mode)
        assert set(tmet) == set(jmet), mode
        for k, v in tmet.items():
            np.testing.assert_allclose(float(v), float(jmet[k]), rtol=METRIC_RTOL,
                                       err_msg=f"{mode} {k}")
        assert not tlm.requires_grad
        _close(tlm, jlm, MULT_ATOL, f"{mode} loss_mult")
        for k in bn:
            np.testing.assert_allclose(tbn_new[k].numpy(), np.asarray(jbn_new[k]), rtol=BN_RTOL,
                                       atol=1e-7, err_msg=f"{mode} bn {k}")
        for (k, g) in zip(tp, tg):
            want = np.asarray(jg[k])
            assert np.abs(want).max() > 0, f"{mode}: no gradient of {k}"
            _close(g, want, GRAD_ATOL, f"{mode} gradient of {k}")
    return jp, tp, jbn_new, tbn_new


def _check_loss_mult_for_image(img, junc, tunc, jfeats_gt336):
    """loss_mult_for_image on the padded image `img` (the JAX side's DINO
    features of its letterbox, `jfeats_gt336`, computed once)."""
    pixmask = np.zeros((PAD_H, PAD_W), np.float32)
    pixmask[:VALID_H, :VALID_W] = 1.0
    jp, tp = _head_params(junc, tunc)
    # eval mode reads the running statistics: those of a train-mode call
    feats = tunc.dino_features(tun.resize_valid(_t(img), S, S, VALID_H, VALID_W, letterbox=True))
    with torch.no_grad():
        _u, tunc.bn_state = tunc.head_uncertainty(tp, tunc.bn_state, feats, train=True,
                                                  keep=torch.ones((1, 1, 384)))
    junc.bn_state = {k: jnp.asarray(v.numpy()) for k, v in tunc.bn_state.items()}
    junc._dino_features = lambda img336: jnp.asarray(jfeats_gt336)
    want = np.asarray(junc.loss_mult_for_image(jp, jnp.asarray(img), jnp.asarray(pixmask),
                                               jnp.float32(VALID_H), jnp.float32(VALID_W)))
    got = tunc.loss_mult_for_image(tp, _t(img), _t(pixmask), VALID_H, VALID_W).numpy()
    _close(got, want, MULT_ATOL, "loss_mult_for_image")
    assert want.max() > 1.0 and want[VALID_H:].max() == 0.0
    near = np.abs(want - 1.0) <= MULT_ATOL * want.max()
    assert np.array_equal((got > 1)[~near], (want > 1)[~near])


def _check_ade20k(monkeypatch, path):
    rng = np.random.default_rng(9)

    def r(*shape, low=-1.0):
        return torch.tensor(rng.uniform(low, 1.0, shape).astype(np.float32))
    state = {"decode_head.conv_seg.weight": r(150, 384, 1, 1), "decode_head.conv_seg.bias": r(150),
             "decode_head.bn.weight": r(384, low=0.5), "decode_head.bn.bias": r(384),
             "decode_head.bn.running_mean": r(384), "decode_head.bn.running_var": r(384, low=0.5)}
    torch.save({"state_dict": state, "meta": {"classes": 150}}, path)
    monkeypatch.setenv("WG_ADE20K_HEAD", str(path))
    junc, tunc = _models("dino")
    jp = junc.init_params(np.random.default_rng(4))
    tp = tunc.init_params(np.random.default_rng(4))
    for k, v in jp.items():
        assert np.array_equal(tp[k].numpy(), np.asarray(v)), f"ADE20k head {k}"
    for k in ("mean", "var"):
        assert np.array_equal(tunc.bn_state[k].numpy(), np.asarray(junc.bn_state[k])), k
    assert np.array_equal(tp["bn_scale"].numpy(), state["decode_head.bn.weight"].numpy())
    monkeypatch.delenv("WG_ADE20K_HEAD")


def _check_full_f32():
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with full_f32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
        with pytest.raises(KeyError), full_f32():
            raise KeyError("inside")
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
        assert full_f32()(lambda: torch.get_float32_matmul_precision())() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


def test_uncertainty_matches_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("WG_DINOV2_WEIGHTS", raising=False)
    monkeypatch.delenv("WG_ADE20K_HEAD", raising=False)
    rng = np.random.default_rng(0)
    _check_full_f32()
    _check_ade20k(monkeypatch, tmp_path / "ade20k_linear_head.pth")
    _check_resize(rng)
    _check_ssim(rng)

    # one ground truth and prediction at DINO_SIZE, letterboxed from the
    # padded canvas (junk in its padding), with their JAX features
    img = rng.uniform(0, 1, (PAD_H, PAD_W, 3)).astype(np.float32)
    img[VALID_H:] = 7.0
    img[:, VALID_W:] = -3.0
    vh, vw = jnp.float32(VALID_H), jnp.float32(VALID_W)
    gt336 = np.asarray(jun.resize_valid(jnp.asarray(img), S, S, vh, vw, letterbox=True))
    pred336 = np.clip(gt336 + rng.normal(0, 0.15, gt336.shape), 0, 1).astype(np.float32)
    pred336 *= np.asarray(jun.content_mask(S, S, vh, vw, True))[..., None]
    mask336 = np.asarray(jun.content_mask(S, S, vh, vw, True))
    pmask = np.asarray(jun.content_mask(S, S, vh, vw, True, granularity=14))
    junc, tunc = _models("dino")
    jfeats_gt = np.asarray(junc._dino_features(jnp.asarray(gt336)))
    jfeats_pred = np.asarray(junc._dino_features(jnp.asarray(pred336)))
    _close(tunc.dino_features(_t(gt336)), jfeats_gt, 1e-4, "features of gt336")

    keep = _check_head(junc, tunc, jfeats_gt, pmask)
    _check_losses(rng, jfeats_gt, jfeats_pred, gt336, pred336, keep, mask336, pmask)
    _check_loss_mult_for_image(img, junc, tunc, jfeats_gt)
