"""The port's parity driver, `python -m wildgaussians_torch.parity_reference`,
on a fabricated reference checkpoint and predictions archive.

  - without --checkpoint, the module run as a program (`runpy`, as
    `python -m` runs it) prints the JAX tool's skip line
    (`tools/parity_reference.py` on the same arguments) and exits 0;
  - on a checkpoint fabricated as `tests/test_reference_import.py`
    fabricates one and a predictions .tar.gz of two cameras (color/,
    gt-color/ PNGs and cameras/ npz, the reference's layout), each report
    row's three PSNR pairs equal the JAX package's `evaluation.psnr` (numpy)
    of the port's own render of that camera and the archive's PNGs, and
    the summary line their means; with --optimize-embedding (the NeRF-W
    left-half fit, 8 iterations: the fabricated config's
    `appearance_embedding_optim_iters`) the row's render is the one after
    the fit, which moves it. Running the JAX tool itself on the archive
    would add the JAX model's compiles; the PSNR it reports is the same
    numpy function.

One test (see test_torch_isolation.py)."""
import io
import json
import runpy
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from helpers import make_camera
from test_reference_import import _make_reference_state, _write_reference_checkpoint
from wildgaussians_tpu.evaluation import psnr as jpsnr
from wildgaussians_torch import WildGaussians
from wildgaussians_torch import parity_reference as tpr
from wildgaussians_torch.io.reference_import import import_reference_checkpoint

ROOT = Path(__file__).resolve().parent.parent


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _archive(path, rng, names):
    with tarfile.open(path, "w:gz") as tar:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        for i, name in enumerate(names):
            pose = np.eye(4, dtype=np.float32)[:3]
            pose[0, 3] = 0.1 * i
            cam = make_camera(width=64, height=48, pose=pose)
            buf = io.BytesIO()
            np.savez(buf, poses=cam.poses[0], intrinsics=cam.intrinsics[0],
                     camera_models=cam.camera_models[0],
                     distortion_parameters=cam.distortion_parameters[0],
                     image_sizes=cam.image_sizes[0])
            add(f"cameras/{name}.npz", buf.getvalue())
            for sub in ("color", "gt-color"):
                add(f"{sub}/{name}.png", _png(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)))


def _run(argv, capsys):
    assert tpr.main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return lines[:-1], lines[-1]


def test_parity_driver(rng, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["parity_reference.py"])
    # run afresh as __main__ (the import above stays as it is)
    monkeypatch.delitem(sys.modules, "wildgaussians_torch.parity_reference")
    with pytest.raises(SystemExit) as done:
        runpy.run_module("wildgaussians_torch.parity_reference", run_name="__main__")
    assert done.value.code == 0
    ours = capsys.readouterr().out
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import parity_reference as jpr
    finally:
        sys.path.remove(str(ROOT / "tools"))
    assert jpr.main() == 0
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["skipped"] is True

    src = _write_reference_checkpoint(str(tmp_path / "ref"), _make_reference_state(rng),
                                      step=7000, appearance_embedding_optim_iters=8)
    names = ["a", "b"]
    _archive(tmp_path / "pred.tar.gz", rng, names)
    rows, agg = _run(["--checkpoint", src, "--predictions", str(tmp_path / "pred.tar.gz"),
                      "--device", "cpu"], capsys)
    assert agg["skipped"] is False and agg["n_images"] == 2 and [r["name"] for r in rows] == names

    method = WildGaussians(checkpoint=import_reference_checkpoint(src, str(tmp_path / "ckpt")),
                           device="cpu")
    with tarfile.open(tmp_path / "pred.tar.gz") as tar:
        for row in rows:
            def img(n):
                data = tar.extractfile(n).read()
                return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                                  np.float32) / 255.0
            cam = tpr.load_camera(tar.extractfile(f"cameras/{row['name']}.npz").read())
            ours = np.clip(method.render(cam)["color"], 0, 1)
            pub, gt = img(f"color/{row['name']}.png"), img(f"gt-color/{row['name']}.png")
            assert row["psnr_ours_vs_published"] == float(jpsnr(ours, pub))
            assert row["psnr_ours_vs_gt"] == float(jpsnr(ours, gt))
            assert row["psnr_published_vs_gt"] == float(jpsnr(pub, gt))
    for key in ("psnr_ours_vs_published", "psnr_ours_vs_gt", "psnr_published_vs_gt"):
        assert agg["mean_" + key] == float(np.mean([r[key] for r in rows]))

    fitted, _ = _run(["--checkpoint", src, "--predictions", str(tmp_path / "pred.tar.gz"),
                      "--device", "cpu", "--optimize-embedding", "--limit", "1",
                      "--out", str(tmp_path / "out.json")], capsys)
    assert len(fitted) == 1 and fitted[0]["psnr_published_vs_gt"] == rows[0]["psnr_published_vs_gt"]
    assert fitted[0]["psnr_ours_vs_gt"] != rows[0]["psnr_ours_vs_gt"]
    assert json.loads((tmp_path / "out.json").read_text())["images"] == fitted
