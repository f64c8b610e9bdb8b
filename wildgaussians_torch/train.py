"""Training CLI: train, evaluate, log and checkpoint one scene.

    python -m wildgaussians_torch.train --data <scene> --output <dir>
        [--dataset-type {default,nerfonthego,phototourism}] [--set key=value ...]
        [--device cpu]

The port's counterpart of `wildgaussians_tpu/train.py`, with the same
options and defaults, plus `--device` (the card unless `--device cpu`;
without a card the CLI exits non-zero). A COLMAP scene is scored under the
default protocol; `--dataset-type phototourism` loads a Photo Tourism scene
and scores it under the NeRF-W protocol (each test image's appearance
embedding is fitted on its left half, the right half is scored). Progress
goes through `logging`. `main(argv)` runs the CLI in process and returns its
exit code.
"""
import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, cast

import numpy as np

from . import datasets
from .datasets.colmap import load_colmap_dataset
from .datasets.phototourism import (NerfWEvaluationProtocol, horizontal_half_dataset,
                                    load_phototourism_dataset)
from .device import resolve_device
from .evaluation import DefaultEvaluationProtocol, compute_metrics, evaluate, render_all_images
from .logging import ConcatLogger, JsonlLogger, TensorboardLogger
from .models.wildgaussians import WildGaussians
from .spans import span
from .types import Dataset, EvaluationProtocol, Logger
from .utils import Indices, MetricsAccumulator, image_to_srgb, make_image_grid, setup_logging

logger_py = logging.getLogger(__name__)

# the steps `--profile` traces
PROFILE_STEPS = (20, 40)


def parse_indices(value: str) -> Indices:
    """A schedule: `a:b:c` (a slice) or `1,2,3` (a list of steps)."""
    if ":" in value:
        parts = [int(x) if x else None for x in value.split(":")]
        if len(parts) > 3:
            raise argparse.ArgumentTypeError(f"expected start:stop:step, got {value}")
        return Indices(slice(*parts))
    return Indices([int(x) for x in value.split(",")])


def parse_key_value(value: str):
    if "=" not in value:
        raise argparse.ArgumentTypeError(f"expected key=value, got {value}")
    k, v = value.split("=", 1)
    return k, v


def _outputs_for_split(output: str, step: int, split: str):
    """(predictions archive, results json) paths; stale ones are removed."""
    suffix = "" if split == "test" else f"-{split}"
    preds = os.path.join(output, f"predictions-{step}{suffix}.tar.gz")
    results = os.path.join(output, f"results-{step}{suffix}.json")
    for path in (preds, results):
        if os.path.exists(path):
            (os.unlink if os.path.isfile(path) else shutil.rmtree)(path)
            logger_py.warning("removed existing %s", path)
    return preds, results


def eval_all(method, logger: Logger, dataset: Dataset, *, output: str, step: int,
             evaluation_protocol: EvaluationProtocol, split: str, nb_info):
    """Render and archive every camera of `dataset` through the protocol,
    score the archive into the results JSON, and log the summary and a
    grid of the first 16 (gt, render) pairs."""
    preds_path, results_path = _outputs_for_split(output, step, split)
    meta = dataset["metadata"]
    sizes = dataset["cameras"].image_sizes

    grid_pairs = []          # first 16 (gt, prediction) sRGB pairs
    total_rays = 0
    start = time.perf_counter()
    renders = render_all_images(
        method, dataset, output=preds_path,
        description=f"rendering all images at step={step}",
        nb_info=nb_info, evaluation_protocol=evaluation_protocol)
    for i, pred in enumerate(renders):
        w, h = sizes[i]
        total_rays += int(w) * int(h)
        if len(grid_pairs) < 16:
            def to_srgb(img):
                return image_to_srgb(img, np.uint8, color_space=meta.get("color_space", "srgb"),
                                     background_color=meta.get("background_color"))
            grid_pairs.append((to_srgb(dataset["images"][i][:h, :w]), to_srgb(pred["color"])))
    elapsed = time.perf_counter() - start

    info = evaluate(preds_path, results_path, evaluation_protocol=evaluation_protocol,
                    description=f"evaluating all images at step={step}")
    logger_py.info("eval-all-%s at step %d: %s", split, step,
                   {k: round(v, 5) for k, v in info["metrics"].items()})
    if not logger:
        return
    metrics = dict(info["metrics"])
    metrics["fps"] = len(dataset["cameras"]) / elapsed
    metrics["rays-per-second"] = total_rays / elapsed
    metrics["time"] = elapsed
    with logger.add_event(step) as event:
        for k, v in metrics.items():
            if v == v:  # NaN-valued metrics (lpips without its weights) are skipped
                event.add_scalar(f"eval-all-{split}/{k}", v)
    ncol = max(int(math.sqrt(len(grid_pairs))), 1)
    side_by_side = make_image_grid(
        make_image_grid(*[gt for gt, _ in grid_pairs], ncol=ncol),
        make_image_grid(*[render for _, render in grid_pairs], ncol=ncol))
    logger.add_image(f"eval-all-{split}/color", side_by_side, step=step,
                     display_name="color", description="left: gt, right: prediction")


def _slice_dataset(dataset: Dataset):
    for i in range(len(dataset["cameras"])):
        yield datasets.dataset_index_select(dataset, [i])


def eval_few_custom(method: WildGaussians, logger: Logger, dataset: Dataset,
                    split: str, step: int, evaluation_protocol: EvaluationProtocol):
    """Quick periodic evaluation on a handful of cameras.

    Under the NeRF-W protocol each camera's appearance embedding is first
    optimized on the LEFT image half and scoring happens on the RIGHT half,
    with an extra render without the fitted embedding for comparison."""
    nerfw = evaluation_protocol.get_name() == "nerfw"
    metrics = MetricsAccumulator()
    optim_curves = None
    embeddings = None
    rows: List[list] = [[] for _ in dataset["cameras"]]     # image-grid row per camera

    if nerfw:
        left = horizontal_half_dataset(dataset, left=True)
        embeddings = []
        for dataslice in _slice_dataset(left):
            optim = method.optimize_embedding(dataslice)
            embeddings.append(optim["embedding"])
            if optim_curves is None and "metrics" in optim:
                optim_curves = optim["metrics"]
        dataset = horizontal_half_dataset(dataset, left=False)

    gt_f = [image_to_srgb(img, dtype=np.float32) for img in dataset["images"]]
    for i, cam in enumerate(dataset["cameras"]):
        rows[i].append(dataset["images"][i])
        if nerfw:
            plain = method.render(cam)["color"]
            metrics.update({f"{k}-nopt": v for k, v in compute_metrics(
                image_to_srgb(plain, dtype=np.float32), gt_f[i]).items()})
            rows[i].append(image_to_srgb(plain, dtype=np.uint8))

    renders = []
    for i, cam in enumerate(dataset["cameras"]):
        opts = {"embedding": embeddings[i] if embeddings is not None else None}
        color = method.render(cam, options=opts)["color"]
        metrics.update(compute_metrics(image_to_srgb(color, dtype=np.float32), gt_f[i]))
        renders.append(image_to_srgb(color, dtype=np.uint8))
        rows[i].append(renders[-1])
    cast(Dict, dataset)["renders"] = renders

    window = metrics.pop()
    logger_py.info("eval-few-%s at step %d: psnr %.4f", split, step, window.get("psnr", math.nan))
    with logger.add_event(step) as event:
        for k, v in window.items():
            if v == v:
                event.add_scalar(f"eval-few-{split}/{k}", v)
        event.add_image(
            f"eval-few-{split}/color",
            make_image_grid(*[img for row in rows for img in row], ncol=len(rows[0])),
            description="left: gt, then renders")
        if optim_curves is not None:
            for k in ("psnr", "mse"):
                curve = optim_curves[k]
                event.add_plot(f"eval-few-{split}/optimization-{k}",
                               np.stack((np.arange(len(curve)), curve), -1),
                               axes_labels=("iteration", k),
                               title=f"Optimization of {k} over iterations")


_CONFIG_OVERRIDES = {
    "nerfonthego": {"config": "nerfonthego.yml"},
    "phototourism": {"config": "phototourism.yml"},
    "default": {},
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m wildgaussians_torch.train",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--output", type=str, default=".")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--dataset-type", choices=["default", "nerfonthego", "phototourism"],
                        default="default")
    parser.add_argument("--eval-few-iters", type=parse_indices,
                        default=Indices.every_iters(2_000),
                        help="When to evaluate on few images")
    parser.add_argument("--logger", dest="logger_backend",
                        choices=["jsonl", "tensorboard", "both"], default="both")
    parser.add_argument("--set", dest="config_overrides", type=parse_key_value,
                        action="append", default=None, metavar="KEY=VALUE",
                        help="Override a parameter in the method.")
    parser.add_argument("--profile", dest="profile_dir", type=str, default=None,
                        help="Trace steps 20-40 with torch.profiler into this directory "
                             "(a Chrome trace).")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint-* in --output.")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))
    train(args.data, args.output, device=device, verbose=args.verbose, debug=args.debug,
          dataset_type=args.dataset_type, eval_few_iters=args.eval_few_iters,
          logger_backend=args.logger_backend, config_overrides=args.config_overrides,
          profile_dir=args.profile_dir, resume=args.resume)
    return 0


def train(data, output, *, device, verbose=False, debug=False, dataset_type="default",
          eval_few_iters: Optional[Indices] = None, logger_backend="both",
          config_overrides=None, profile_dir=None, resume=False):
    """The CLI's work: load the scene, train, evaluate, log, checkpoint."""
    if eval_few_iters is None:
        eval_few_iters = Indices.every_iters(2_000)
    if debug:
        config_overrides = list(config_overrides or ()) + [("iterations", "100")]
        eval_few_iters = Indices.every_iters(70)
    setup_logging(verbose or debug)
    config_overrides = {**_CONFIG_OVERRIDES[dataset_type], **dict(config_overrides or ())}

    features = frozenset({"color", "points3D_xyz", "points3D_rgb"})
    if dataset_type == "phototourism":
        evaluation_protocol: EvaluationProtocol = NerfWEvaluationProtocol()

        def load_dataset_fn(path, split):
            return load_phototourism_dataset(path, split=split, features=features)
    else:
        evaluation_protocol = DefaultEvaluationProtocol()

        def load_dataset_fn(path, split):
            return load_colmap_dataset(path, split=split, features=features)

    with span("dataset_load"):
        test_dataset = load_dataset_fn(data, "test")
        train_dataset = load_dataset_fn(data, "train")
    if dataset_type == "nerfonthego":
        dataset_not_official = "Please use the dataset provided for the WG paper"
        info_path = os.path.join(data, "nb-info.json")
        if not os.path.exists(info_path):
            raise RuntimeError(dataset_not_official)
        with open(info_path, "r", encoding="utf8") as f:
            info = json.load(f)
        info_name = info.get("id", info.get("name"))
        if info.pop("loader", None) != "colmap" or info_name != "nerfonthego-undistorted":
            raise RuntimeError(dataset_not_official)
        info.pop("loader_kwargs", None)
        info["id"] = info_name
        test_dataset["metadata"].update(info)
        train_dataset["metadata"].update(info)
    if debug:
        train_dataset = datasets.dataset_index_select(train_dataset, slice(None, 8))
        test_dataset = datasets.dataset_index_select(test_dataset, slice(None, 8))

    with span("image_decode"):
        train_dataset = datasets.dataset_load_features(train_dataset)
        test_dataset = datasets.dataset_load_features(test_dataset)
    train_dataset["images"] = [x[..., :3] for x in train_dataset["images"]]
    test_dataset["images"] = [x[..., :3] for x in test_dataset["images"]]
    train_images_thumbnails = [img[::8, ::8].copy() for img in train_dataset["images"]]

    output_path = Path(output)
    n_few = min(4, len(train_dataset["cameras"]), len(test_dataset["cameras"]))
    train_dataset_eval_few = datasets.dataset_index_select(train_dataset, list(range(n_few)))
    test_dataset_eval_few = datasets.dataset_index_select(test_dataset, list(range(n_few)))

    checkpoint = None
    if resume:
        found = sorted(output_path.glob("checkpoint-*"), key=lambda p: int(p.name.split("-")[1]))
        if found:
            checkpoint = str(found[-1])
            logger_py.info("Resuming from %s", checkpoint)
        else:
            logger_py.warning("--resume given but no checkpoint-* in %s", output)
    with span("setup"):
        method = WildGaussians(checkpoint=checkpoint, train_dataset=train_dataset,
                               config_overrides=None if checkpoint else config_overrides,
                               device=device)
    info = method.get_info()

    loggers = []
    if logger_backend in ("jsonl", "both"):
        loggers.append(JsonlLogger(str(output_path / "logs")))
    if logger_backend in ("tensorboard", "both"):
        loggers.append(TensorboardLogger(str(output_path / "tensorboard")))
    logger = ConcatLogger(loggers)
    for lg in loggers:
        lg.add_hparams(dataclasses.asdict(method.config))

    def save_checkpoint(at_step: int):
        path = output_path / f"checkpoint-{at_step}"
        if path.exists():
            shutil.rmtree(path)
            logger_py.warning("removed existing checkpoint at %s", path)
        method.save(str(path))
        with open(path / "nb-info.json", "w", encoding="utf8") as f:
            json.dump({"method": method.get_method_info()["method_id"]}, f)
        logger_py.info("checkpoint saved at step=%d", at_step)

    def dump_appearance_embeddings(at_step: int):
        labels = [{"name": os.path.relpath(x, train_dataset["image_paths_root"]), "id": i}
                  for i, x in enumerate(train_dataset["image_paths"])]
        logger.add_embedding("train/appearance-embeddings",
                             method.params["appearance_embeddings"].detach().cpu().numpy(),
                             images=train_images_thumbnails, labels=labels, step=at_step)

    with contextlib.ExitStack() as stack:
        stack.callback(logger.close)
        profiling: Dict = {}     # the running profiler, under "prof"
        stack.callback(_stop_profiler, profiling, profile_dir)
        acc_metrics = MetricsAccumulator()
        num_iterations = info["num_iterations"]
        step = start_step = info.get("loaded_step") or 0
        logger_py.info("training steps %d to %d", start_step, num_iterations)
        pre_state = None
        for step in range(start_step, num_iterations):
            if debug:
                # rolling PRE-step snapshot: the whole trainer state before
                # the step, so a step that goes non-finite can be replayed
                pre_state = method.state_dict()
            if profile_dir is not None and step == PROFILE_STEPS[0]:
                profiling["prof"] = _start_profiler(method.device)
            metrics = method.train_iteration(step)
            if debug and not np.isfinite(metrics.get("loss", float("nan"))):
                snap = output_path / f"debug-snapshot-{step}.npz"
                output_path.mkdir(parents=True, exist_ok=True)
                np.savez(str(snap), **pre_state)
                with open(output_path / f"debug-snapshot-{step}.json", "w",
                          encoding="utf8") as f:
                    json.dump({"step": step,
                               "camera_id": getattr(method, "_last_camera_id", None),
                               "metrics": {k: float(v) for k, v in metrics.items()}}, f)
                raise RuntimeError(
                    f"non-finite loss at step {step}; pre-step state dumped to "
                    f"{snap} (reload with WildGaussians 'checkpoint' npz format)")
            if step == PROFILE_STEPS[1]:
                _stop_profiler(profiling, profile_dir)
            step += 1
            acc_metrics.update(metrics)

            if step % 100 == 0:
                window = acc_metrics.pop()
                with logger.add_event(step) as event:
                    for k, val in window.items():
                        event.add_scalar(f"train/{k}", val)
                logger_py.info("step %d/%d: train/loss %.4f, psnr %.4f", step, num_iterations,
                               window["loss"], window["psnr"])
            if step % 10_000 == 0:
                save_checkpoint(step)
                if method.config.appearance_enabled:
                    dump_appearance_embeddings(step)
            if step in eval_few_iters:
                for split, few in (("train", train_dataset_eval_few),
                                   ("test", test_dataset_eval_few)):
                    eval_few_custom(method, logger, few, split=split, step=step,
                                    evaluation_protocol=evaluation_protocol)
        _stop_profiler(profiling, profile_dir)   # the run ended inside the traced steps

        eval_all(method, logger, test_dataset, split="test", step=step,
                 output=str(output_path), evaluation_protocol=evaluation_protocol, nb_info={})
        # the NeRF-W protocol optimizes an embedding per camera; scoring the
        # whole train split that way is too slow, so only its eval-few subset
        # is used
        train_eval = ((train_dataset_eval_few, "trainsubset")
                      if evaluation_protocol.get_name() == "nerfw" else (train_dataset, "train"))
        eval_all(method, logger, train_eval[0], split=train_eval[1], step=step,
                 output=str(output_path), evaluation_protocol=evaluation_protocol, nb_info={})
        if step % 10_000 != 0:
            save_checkpoint(step)


def _start_profiler(device):
    """A running torch.profiler window over the CPU and, on the card, CUDA."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(profiling: Dict, profile_dir: Optional[str]):
    """Stop the profiler in `profiling`, if one runs, and write its Chrome
    trace into `profile_dir`."""
    prof = profiling.pop("prof", None)
    if prof is None:
        return
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace-steps-{PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}.json")
    prof.export_chrome_trace(path)
    logger_py.info("profiler trace written to %s", path)


if __name__ == "__main__":
    sys.exit(main())
