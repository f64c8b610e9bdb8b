"""The port's evaluation, export and logging helpers against the JAX
package's, on seeded images and arrays:

- `dmpix_ssim` (batched and single) and `compute_metrics` (reduced and per image)
  within rtol 1e-6;
- one predictions archive, written by the port's `save_predictions`, scored
  by both packages' `evaluate` under the default and the NeRF-W protocol:
  the results JSONs equal except for their datetimes;
- `save_ply`: the same bytes for the same arrays, and each package's
  `load_ply` reads the other's file;
- the JSONL logger: the same records (scalars, text, an image, a histogram,
  hparams, some through `add_event`) except for their `time` field, and
  the same PNG; both packages' `ConcatLogger`s hand scalars, text and
  images on to their loggers and drop histograms and hparams;
- `Indices` and `MetricsAccumulator`: the same schedule membership and
  windows;
- LPIPS: both packages' `LPIPS` modules (alex) from one random set of
  weight files within 1e-6; without weight files the port's `lpips` is NaN,
  and a shape mismatch still raises.

One test (see test_torch_isolation.py)."""
import json
import math

import numpy as np
import pytest
import torch

import wildgaussians_tpu.evaluation as jev
import wildgaussians_tpu.logging as jlog
import wildgaussians_tpu.metrics_lpips as jlp
import wildgaussians_tpu.utils as jutils
import wildgaussians_torch.evaluation as tev
import wildgaussians_torch.logging as tlog
import wildgaussians_torch.metrics_lpips as tlp
import wildgaussians_torch.utils as tutils
from wildgaussians_tpu.datasets.phototourism import NerfWEvaluationProtocol as JNerfW
from wildgaussians_tpu.io.ply import load_ply as jload_ply
from wildgaussians_tpu.io.ply import save_ply as jsave_ply
from wildgaussians_torch.datasets import new_dataset
from wildgaussians_torch.datasets.phototourism import NerfWEvaluationProtocol as TNerfW
from wildgaussians_torch.io.ply import load_ply as tload_ply
from wildgaussians_torch.io.ply import save_ply as tsave_ply
from wildgaussians_torch.types import new_cameras

METRIC_RTOL = 1e-6
LPIPS_ATOL = 1e-6


def _images(rng, n=3, h=40, w=52):
    gt = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), -0.1, 1.1).astype(np.float32)
    return pred, gt


def _check_metrics(rng):
    pred, gt = _images(rng)
    np.testing.assert_allclose(tev.dmpix_ssim(pred, gt), jev.dmpix_ssim(pred, gt),
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(tev.dmpix_ssim(pred[0], gt[0]), jev.dmpix_ssim(pred[0], gt[0]),
                               rtol=METRIC_RTOL)
    for reduce in (True, False):
        t = tev.compute_metrics(pred, gt, reduce=reduce)
        j = jev.compute_metrics(pred, gt, reduce=reduce)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_allclose(t[k], j[k], rtol=METRIC_RTOL, err_msg=k)
    u8 = (gt[0] * 255).astype(np.uint8)
    assert tev.compute_metrics(u8, u8)["psnr"] == math.inf


def _predictions(tmp_path, rng):
    """A predictions archive of three images (two sizes) from the port."""
    sizes = [(52, 40), (52, 40), (36, 40)]
    cams = new_cameras(
        poses=np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1)),
        intrinsics=np.array([[40, 40, w / 2, h / 2] for w, h in sizes], np.float32),
        camera_models=np.zeros((3,), np.int32),
        distortion_parameters=np.zeros((3, 6), np.float32),
        image_sizes=np.array(sizes, np.int32))
    gts = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for w, h in sizes]
    preds = [{"color": np.clip(g / 255.0 + rng.normal(0, 0.05, g.shape), 0, 1).astype(np.float32)}
             for g in gts]
    ds = new_dataset(cameras=cams, image_paths=[f"/data/images/{i:02d}.png" for i in range(3)],
                     images=gts, metadata={"color_space": "srgb", "name": "synthetic"})
    path = str(tmp_path / "predictions.tar.gz")
    for _ in tev.save_predictions(path, preds, ds, nb_info={"method": "test"}):
        pass
    return path


def _without_datetimes(results):
    out = {k: v for k, v in results.items() if not k.endswith("datetime")}
    return json.dumps(out, sort_keys=True)


def _check_evaluate(tmp_path, rng):
    preds = _predictions(tmp_path, rng)
    for name, jproto, tproto in (("default", jev.DefaultEvaluationProtocol(),
                                  tev.DefaultEvaluationProtocol()),
                                 ("nerfw", JNerfW(), TNerfW())):
        jres = jev.evaluate(preds, str(tmp_path / f"j-{name}.json"), evaluation_protocol=jproto)
        tres = tev.evaluate(preds, str(tmp_path / f"t-{name}.json"), evaluation_protocol=tproto)
        assert tres["evaluation_protocol"] == name and np.isfinite(tres["metrics"]["psnr"])
        for res, f in ((jres, "j"), (tres, "t")):
            with open(tmp_path / f"{f}-{name}.json", encoding="utf8") as fh:
                assert _without_datetimes(json.load(fh)) == _without_datetimes(
                    json.loads(json.dumps(res)))
        assert _without_datetimes(tres) == _without_datetimes(jres), name
    with pytest.raises(FileExistsError):
        tev.evaluate(preds, str(tmp_path / "t-default.json"),
                     evaluation_protocol=tev.DefaultEvaluationProtocol())


def _check_ply(tmp_path, rng):
    n = 37
    arrays = dict(xyz=rng.normal(size=(n, 3)).astype(np.float32),
                  features_dc=rng.normal(size=(n, 3)).astype(np.float32),
                  opacities=rng.uniform(0, 1, (n, 1)).astype(np.float32),
                  scales=rng.uniform(1e-3, 1, (n, 3)).astype(np.float32),
                  rotations=rng.normal(size=(n, 4)).astype(np.float32))
    tsave_ply(str(tmp_path / "t.ply"), **arrays)
    jsave_ply(str(tmp_path / "j.ply"), **arrays)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for got, want in ((jload_ply(str(tmp_path / "t.ply")), tload_ply(str(tmp_path / "j.ply"))),
                      (tload_ply(str(tmp_path / "t.ply")), arrays)):
        if "opacity_logit" in want:
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got["xyz"], want["xyz"])
            np.testing.assert_allclose(got["log_scales"], np.log(want["scales"]), rtol=1e-6)


def _log_some(lg, image):
    with lg.add_event(3) as event:
        event.add_scalar("train/psnr", 12.5)
        event.add_text("note", "hello")
        event.add_image("eval/color", image, description="gt | render")
        event.add_histogram("hist", np.arange(10.0), num_bins=4)
    lg.add_scalar("train/loss", np.float32(0.25), 7)
    lg.add_hparams({"a": 1, "b": [1, 2]})


def _check_logger(tmp_path, rng):
    image = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    records = {}
    for name, make in (("j", jlog.JsonlLogger), ("t", tlog.JsonlLogger),
                       ("j-concat", lambda p: jlog.ConcatLogger([jlog.JsonlLogger(p)])),
                       ("t-concat", lambda p: tlog.ConcatLogger([tlog.JsonlLogger(p)]))):
        lg = make(str(tmp_path / f"logs-{name}"))
        _log_some(lg, image)
        if name.startswith("t"):
            lg.close()
        with open(tmp_path / f"logs-{name}" / "events.jsonl", encoding="utf8") as f:
            records[name] = [{k: v for k, v in json.loads(line).items() if k != "time"}
                             for line in f]
    assert records["t"] == records["j"] and len(records["t"]) == 6
    # the fan-out passes scalars, text and images on, and drops the rest
    assert records["t-concat"] == records["j-concat"] == [
        r for r in records["t"] if r["type"] in ("scalar", "text", "image")]
    rel = records["t"][2]["path"]
    assert (tmp_path / "logs-t" / rel).read_bytes() == (tmp_path / "logs-j" / rel).read_bytes()


def _check_schedules():
    for spec, total in ((slice(None, None, 7), 40), (slice(-10, None, 3), 40), ([3, 5, -1], 20),
                        (slice(2, 30, 5), None)):
        j, t = jutils.Indices(spec), tutils.Indices(spec)
        j.total = t.total = total
        assert [s for s in range(45) if s in t] == [s for s in range(45) if s in j]
        assert str(t) == str(j)
    assert [s for s in range(9) if s in tutils.Indices.every_iters(4, zero=True)] == [4, 8]
    stream = [{"loss": 0.5, "psnr": 10.0, "n": 3}, {"loss": 0.25, "psnr": 12.0, "n": 5},
              {"loss": 0.125, "psnr": 11.0, "n": 4}]
    options = {"psnr": "max", "n": "sum"}
    j, t = jutils.MetricsAccumulator(options), tutils.MetricsAccumulator(options)
    for row in stream:
        j.update(row)
        t.update(row)
    assert t.pop() == j.pop() == {"loss": 0.875 / 3, "psnr": 12.0, "n": 12}
    assert t.pop() == {}
    with pytest.raises(ValueError):
        tutils.MetricsAccumulator({"loss": "median"}).update({"loss": 1.0})


def _check_lpips(tmp_path, rng, monkeypatch):
    """One random set of LPIPS weight files (alex) for both packages."""
    weights = tmp_path / "lpips-weights"
    weights.mkdir()
    g = torch.Generator().manual_seed(0)
    trunk = {}
    for i, (o, c, k) in zip((0, 3, 6, 8, 10), ((64, 3, 11), (192, 64, 5), (384, 192, 3),
                                                (256, 384, 3), (256, 256, 3))):
        trunk[f"features.{i}.weight"] = torch.randn((o, c, k, k), generator=g) / math.sqrt(c * k * k)
        trunk[f"features.{i}.bias"] = torch.randn((o,), generator=g) * 0.01
    torch.save(trunk, weights / "alexnet-owt-7be5be79.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
                for i, c in enumerate((64, 192, 384, 256, 256))}, weights / "lpips_alex_0.1.pth")
    a = torch.as_tensor(rng.uniform(-1, 1, (2, 3, 64, 80)).astype(np.float32))
    b = torch.as_tensor(rng.uniform(-1, 1, (2, 3, 64, 80)).astype(np.float32))
    outs = []
    for mod in (jlp, tlp):
        monkeypatch.setattr(mod, "_WEIGHT_DIRS", [str(weights)])
        with torch.no_grad():
            outs.append(mod.LPIPS(net="alex")(a, b).numpy())
    assert outs[1].shape == (2,) and np.all(outs[1] > 0)
    np.testing.assert_allclose(outs[1], outs[0], atol=LPIPS_ATOL, rtol=0)

    monkeypatch.setattr(tlp, "_WEIGHT_DIRS", [str(tmp_path / "no-weights")])
    monkeypatch.setattr(tev, "_LPIPS_CACHE", {})
    monkeypatch.setattr(tev, "_LPIPS_UNAVAILABLE_WARNED", False)
    pred, gt = _images(rng, n=2)
    with pytest.warns(UserWarning, match="LPIPS unavailable"):
        assert np.isnan(tev.lpips(pred, gt)).all()
    with pytest.raises(AssertionError):
        tev.lpips(pred, gt[:, :-1])


def test_evaluation_matches_jax(tmp_path, rng, monkeypatch):
    _check_metrics(rng)
    _check_evaluate(tmp_path, rng)
    _check_ply(tmp_path, rng)
    _check_logger(tmp_path, rng)
    _check_schedules()
    _check_lpips(tmp_path, rng, monkeypatch)
