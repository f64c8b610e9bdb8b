"""Render published reference checkpoints and compare them with the published
predictions: the port's copy of `tools/parity_reference.py`.

The reference publishes, per scene, a checkpoint directory (config.yaml +
chkpnt-<step>.pth) and a test-set predictions archive (a .tar.gz or a
directory with color/*.png, gt-color/*.png and cameras/*.npz, reference
evaluation.py:676-761). This driver:

  1. imports the PyTorch checkpoint into the JAX package's checkpoint
     format, which the port loads (`io/reference_import.py`);
  2. renders every camera of the predictions archive, optionally after the
     NeRF-W test-time embedding fit on the left half of the published
     ground truth (reference phototourism.py:215-251, the protocol the
     published predictions were made with);
  3. reports, per image and on average, the PSNR (and SSIM) of the port's
     render against the published prediction and against the ground
     truth, and of the published prediction against the ground truth.

Nothing is downloaded: without a --checkpoint and --predictions on disk it
prints a skip line and exits 0.

Usage:
  python -m wildgaussians_torch.parity_reference \\
      --checkpoint /path/to/scene/checkpoint \\
      --predictions /path/to/scene/predictions.tar.gz \\
      [--optimize-embedding] [--limit N] [--out parity_reference.json] [--device cpu]
"""
import argparse
import io
import json
import os
import sys
import tarfile
import tempfile

import numpy as np


def iter_predictions(path):
    """Yield (name, cameras npz bytes, color png, gt png) per image."""
    if os.path.isdir(path):
        camdir = os.path.join(path, "cameras")
        for fn in sorted(os.listdir(camdir)):
            name = os.path.splitext(fn)[0]
            with open(os.path.join(camdir, fn), "rb") as f:
                cam = f.read()

            def rd(sub):
                with open(os.path.join(path, sub, name + ".png"), "rb") as f:
                    return f.read()
            yield name, cam, rd("color"), rd("gt-color")
    else:
        with tarfile.open(path, "r:*") as tar:
            members = {m.name: m for m in tar.getmembers()}
            for cn in sorted(n for n in members if n.startswith("cameras/")):
                name = os.path.splitext(os.path.basename(cn))[0]

                def rd(n):
                    f = tar.extractfile(members[n])
                    if f is None:
                        raise ValueError(f"{path}: {n} is not a file")
                    return f.read()
                yield name, rd(cn), rd(f"color/{name}.png"), rd(f"gt-color/{name}.png")


def load_camera(npz_bytes):
    from .types import new_cameras

    d = dict(np.load(io.BytesIO(npz_bytes), allow_pickle=True))

    def b(x, nd):
        x = np.asarray(x)
        return x[None] if x.ndim == nd else x
    nears_fars = d.get("nears_fars")
    return new_cameras(
        poses=b(d["poses"], 2).astype(np.float32),
        intrinsics=b(d["intrinsics"], 1).astype(np.float32),
        camera_models=np.atleast_1d(d["camera_models"]).astype(np.int32),
        distortion_parameters=b(d["distortion_parameters"], 1).astype(np.float32),
        image_sizes=b(d["image_sizes"], 1).astype(np.int32),
        nears_fars=(b(nears_fars, 1).astype(np.float32)
                    if nears_fars is not None and np.asarray(nears_fars).dtype != object
                    else None),
    )


def decode_png(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m wildgaussians_torch.parity_reference")
    ap.add_argument("--checkpoint", default=None,
                    help="reference checkpoint dir (config.yaml + chkpnt-*.pth)")
    ap.add_argument("--predictions", default=None, help="published predictions tar.gz or dir")
    ap.add_argument("--optimize-embedding", action="store_true",
                    help="fit the appearance embedding on the left half of the ground truth "
                         "before rendering (the NeRF-W protocol, reference "
                         "phototourism.py:215-251)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)

    if not args.checkpoint or not os.path.exists(args.checkpoint) \
            or not args.predictions or not os.path.exists(args.predictions):
        print(json.dumps({
            "skipped": True,
            "reason": "no reference checkpoint/predictions available "
                      "(zero-egress environment; provision the published "
                      "artifacts from huggingface.co/jkulhanek/wild-gaussians "
                      "and re-run)"}))
        return 0

    from .datasets.phototourism import NerfWEvaluationProtocol
    from .evaluation import dmpix_ssim, psnr
    from .io.reference_import import import_reference_checkpoint
    from .models.wildgaussians import WildGaussians

    with tempfile.TemporaryDirectory() as tmp:
        dst = import_reference_checkpoint(args.checkpoint, os.path.join(tmp, "ckpt"))
        method = WildGaussians(checkpoint=dst, device=args.device)
        rows = []
        for i, (name, camb, colorb, gtb) in enumerate(iter_predictions(args.predictions)):
            if args.limit and i >= args.limit:
                break
            cam = load_camera(camb)
            published = decode_png(colorb).astype(np.float32) / 255.0
            gt = decode_png(gtb).astype(np.float32) / 255.0
            if args.optimize_embedding:
                ds = dict(cameras=cam, images=[gt], masks=None,
                          metadata={"color_space": "srgb"})
                out = NerfWEvaluationProtocol().render(method, ds)
            else:
                out = method.render(cam)
            ours = np.clip(np.asarray(out["color"], np.float32), 0, 1)
            row = {
                "name": name,
                "psnr_ours_vs_published": float(psnr(ours, published)),
                "psnr_ours_vs_gt": float(psnr(ours, gt)),
                "psnr_published_vs_gt": float(psnr(published, gt)),
                "ssim_ours_vs_published": float(dmpix_ssim(ours, published)),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

        agg = {
            "skipped": False,
            "n_images": len(rows),
            "mean_psnr_ours_vs_published": float(np.mean(
                [r["psnr_ours_vs_published"] for r in rows])),
            "mean_psnr_ours_vs_gt": float(np.mean([r["psnr_ours_vs_gt"] for r in rows])),
            "mean_psnr_published_vs_gt": float(np.mean(
                [r["psnr_published_vs_gt"] for r in rows])),
            "images": rows,
        }
        print(json.dumps({k: v for k, v in agg.items() if k != "images"}))
        if args.out:
            with open(args.out, "w", encoding="utf8") as f:
                json.dump(agg, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
