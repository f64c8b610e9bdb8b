"""The port's training CLI (`wildgaussians_torch.train.main`) end to end with
`--device cpu`, in process, on tiny scenes written to disk by
`make_colmap_scene` (tests/test_datasets_cli.py): 9 images at 64x48.

- A COLMAP scene under the default protocol (`--set iterations=4
  --eval-few-iters 2,4 --logger jsonl`): it writes the files the JAX CLI
  writes for the same arguments; the JAX package loads the port's
  checkpoint (every array equal to the port's) and the JAX `load_ply` reads
  its `point_cloud.ply` (one vertex a live Gaussian); the results JSON has
  finite metrics; `--resume` with the checkpoint's config raised to 6
  iterations trains steps 4 and 5 and writes `checkpoint-6`.
- The same scene as a Photo Tourism capture (`--dataset-type
  phototourism`, `--set appearance_embedding_optim_iters=2`): the NeRF-W
  protocol's files (`-trainsubset`) and results.
- `--debug` with a `train_iteration` patched to return a NaN loss at step 2:
  `debug-snapshot-2.npz` (the pre-step state) and `.json` are written and
  the run raises, as tests/test_datasets_cli.py checks for the JAX CLI.
- Without `--device cpu` and without a card, the CLI exits with code 2 and
  `resolve_device`'s message.

The JAX CLI's file sets are written out here (its `_outputs_for_split`,
`save_checkpoint` and JsonlLogger): running it on these scenes takes ~18 s.

One test (see test_torch_isolation.py)."""
import json
import logging
import shutil

import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.wildgaussians as jwg
from test_datasets_cli import make_colmap_scene
from wildgaussians_tpu.io.ply import load_ply as jload_ply
from wildgaussians_torch import train as ttrain
from wildgaussians_torch.models.wildgaussians import WildGaussians

TINY = ["--set", "uncertainty_mode=disabled", "--set", "num_sky_gaussians=200",
        "--logger", "jsonl", "--device", "cpu"]
CHECKPOINT_FILES = ["chkpnt-{s}.npz", "chkpnt-{s}.npz.sha256", "config.yaml", "nb-info.json",
                    "point_cloud.ply"]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_logging():
    """The CLI sets up the root logger for the process (as a CLI does); put
    it back as it was, so no handler outlives the test's captured streams."""
    handlers, level = logging.root.handlers[:], logging.root.level
    yield
    logging.root.handlers[:] = handlers
    logging.root.setLevel(level)
    logging.captureWarnings(False)


def _jax_cli_files(step, eval_few, train_split):
    """The files `python -m wildgaussians_tpu.train` writes with
    `--logger jsonl` for a run that ends at `step`."""
    files = {f"checkpoint-{step}/" + f.format(s=step) for f in CHECKPOINT_FILES}
    files |= {"logs/events.jsonl", f"predictions-{step}.tar.gz", f"results-{step}.json",
              f"predictions-{step}-{train_split}.tar.gz", f"results-{step}-{train_split}.json",
              f"logs/images/eval-all-test_color-{step}.png",
              f"logs/images/eval-all-{train_split}_color-{step}.png"}
    files |= {f"logs/images/eval-few-{split}_color-{s}.png"
              for s in eval_few for split in ("train", "test")}
    return files


def _files(root):
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _results(out, step):
    with open(out / f"results-{step}.json", encoding="utf8") as f:
        res = json.load(f)
    for k in ("psnr", "ssim", "mae", "mse"):
        assert np.isfinite(res["metrics"][k]), k
    return res


def _check_checkpoint_in_jax(ckpt, step, tmp_path):
    """The JAX package loads the port's checkpoint and its point cloud; the
    JAX `save` of that checkpoint writes the same point cloud: the same
    header, the values within f32 rounding of the activations (the opacity
    compared activated: its stored logit magnifies an ulp near 1)."""
    jm = jwg.WildGaussians(checkpoint=str(ckpt))
    assert jm.step == step
    with np.load(ckpt / f"chkpnt-{step}.npz") as npz:
        flat = dict(npz.items())
    for k, v in jm._state_dict().items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    ply = jload_ply(str(ckpt / "point_cloud.ply"))
    alive = flat["aux/alive"]
    assert ply["xyz"].shape == (int(alive.sum()), 3)
    np.testing.assert_array_equal(ply["xyz"], flat["params/xyz"][alive])
    jm.save(str(tmp_path / "jax-save"))
    ours, theirs = (p.read_bytes() for p in (ckpt / "point_cloud.ply",
                                              tmp_path / "jax-save" / "point_cloud.ply"))
    head = ours.index(b"end_header\n") + len(b"end_header\n")
    assert len(ours) == len(theirs) and ours[:head] == theirs[:head]
    ours, theirs = (np.frombuffer(b[head:], "<f4").reshape(-1, 17) for b in (ours, theirs))
    rest = np.arange(17) != 9                              # column 9: the opacity logit
    np.testing.assert_allclose(ours[:, rest], theirs[:, rest], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(1 / (1 + np.exp(-ours[:, 9])), 1 / (1 + np.exp(-theirs[:, 9])),
                               rtol=0, atol=1e-6)


def _check_resume(data, out):
    cfg = out / "checkpoint-4" / "config.yaml"
    cfg.write_text(cfg.read_text() + "iterations: 6\n")     # the last key wins
    assert ttrain.main(["--data", str(data), "--output", str(out), "--resume", *TINY]) == 0
    with np.load(out / "checkpoint-4" / "chkpnt-4.npz") as a, \
            np.load(out / "checkpoint-6" / "chkpnt-6.npz") as b:
        assert int(b["adam/step"]) > int(a["adam/step"]) > 0
        assert not np.array_equal(a["params/xyz"], b["params/xyz"])
    _results(out, 6)


def _check_debug_snapshot(data, out, monkeypatch):
    orig = WildGaussians.train_iteration

    def poisoned(self, step, camera_id=None):
        metrics = orig(self, step, camera_id)
        if step == 2:
            metrics["loss"] = float("nan")
        return metrics
    monkeypatch.setattr(WildGaussians, "train_iteration", poisoned)
    with pytest.raises(RuntimeError, match="non-finite loss at step 2"):
        ttrain.main(["--data", str(data), "--output", str(out), "--debug", *TINY])
    monkeypatch.setattr(WildGaussians, "train_iteration", orig)
    state = np.load(str(out / "debug-snapshot-2.npz"))
    assert "params/xyz" in state and int(state["adam/step"]) == 2
    with open(out / "debug-snapshot-2.json", encoding="utf8") as f:
        info = json.load(f)
    assert info["step"] == 2 and info["camera_id"] is not None


def _phototourism(data, root):
    """`data` as a Photo Tourism capture with a NeRF-W split (2 test images)."""
    scene = root / "phototourism" / "brandenburg-gate"
    shutil.copytree(data, scene)
    names = sorted(p.name for p in (scene / "images").iterdir())
    rows = ["filename\tid\tsplit\tdataset"] + [
        f"{n}\t{i}\t{'test' if i in (3, 7) else 'train'}\tbrandenburg"
        for i, n in enumerate(names)]
    (scene / "nerfw_split.csv").write_text("\n".join(rows) + "\n")
    return scene


def test_cli_on_cpu(tmp_path, rng, monkeypatch, capsys):
    data = make_colmap_scene(tmp_path / "data", rng, n_cams=9, n_points=150)
    out = tmp_path / "out"
    assert ttrain.main(["--data", str(data), "--output", str(out), "--set", "iterations=4",
                        "--eval-few-iters", "2,4", *TINY]) == 0
    assert _files(out) == _jax_cli_files(4, (2, 4), "train")
    assert _results(out, 4)["evaluation_protocol"] == "default"
    with open(out / "checkpoint-4" / "nb-info.json", encoding="utf8") as f:
        assert json.load(f) == {"method": "wild-gaussians-torch"}
    _check_checkpoint_in_jax(out / "checkpoint-4", 4, tmp_path)
    _check_resume(data, out)

    pt = _phototourism(data, tmp_path / "cache")
    out_pt = tmp_path / "out-pt"
    assert ttrain.main(["--data", str(pt), "--output", str(out_pt), "--dataset-type",
                        "phototourism", "--set", "iterations=4", "--set",
                        "appearance_embedding_optim_iters=2", "--eval-few-iters", "4",
                        *TINY]) == 0
    assert _files(out_pt) == _jax_cli_files(4, (4,), "trainsubset")
    assert _results(out_pt, 4)["evaluation_protocol"] == "nerfw"
    with open(out_pt / "logs" / "events.jsonl", encoding="utf8") as f:
        tags = {json.loads(line).get("tag") for line in f}
    assert {"eval-few-test/psnr", "eval-few-test/psnr-nopt", "eval-all-test/psnr"} <= tags

    _check_debug_snapshot(data, tmp_path / "out-debug", monkeypatch)

    if not torch.cuda.is_available():
        capsys.readouterr()
        with pytest.raises(SystemExit) as exit_info:
            ttrain.main(["--data", str(data), "--output", str(tmp_path / "out-card")])
        assert exit_info.value.code == 2
        assert "no CUDA device is available" in capsys.readouterr().err
        assert not (tmp_path / "out-card").exists()
