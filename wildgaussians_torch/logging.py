"""Logger backends implementing the types.Logger protocol.

The port's copy of `wildgaussians_tpu/logging.py`: a dependency-free JSONL
logger, a Tensorboard logger through torch.utils.tensorboard, an optional
Weights & Biases logger and the fan-out ConcatLogger. Tensorboard,
matplotlib and wandb are imported only by the backend that uses them.
"""
import contextlib
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .types import Logger


class _BaseEvent:
    def __init__(self, logger, step: int):
        self._logger = logger
        self._step = step

    def add_scalar(self, tag, value):
        self._logger.add_scalar(tag, value, self._step)

    def add_text(self, tag, text):
        self._logger.add_text(tag, text, self._step)

    def add_image(self, tag, image, display_name=None, description=None, **kwargs):
        self._logger.add_image(tag, image, self._step, display_name=display_name,
                               description=description)

    def add_embedding(self, tag, embeddings, *, images=None, labels=None):
        self._logger.add_embedding(tag, embeddings, self._step, images=images,
                                   labels=labels)

    def add_plot(self, tag, *data, axes_labels=None, title=None, **kwargs):
        self._logger.add_plot(tag, *data, step=self._step, axes_labels=axes_labels,
                              title=title, **kwargs)

    def add_histogram(self, tag, values, *, num_bins=None):
        self._logger.add_histogram(tag, values, self._step, num_bins=num_bins)


class BaseLogger:
    @contextlib.contextmanager
    def add_event(self, step: int):
        yield _BaseEvent(self, step)

    def add_scalar(self, tag, value, step):
        raise NotImplementedError()

    def add_text(self, tag, text, step):
        raise NotImplementedError()

    def add_image(self, tag, image, step, *, display_name=None, description=None):
        pass

    def add_embedding(self, tag, embeddings, step, *, images=None, labels=None):
        pass

    def add_plot(self, tag, *data, step=None, axes_labels=None, title=None, **kwargs):
        pass

    def add_histogram(self, tag, values, step, *, num_bins=None):
        pass

    def add_hparams(self, hparams: Dict, metrics: Optional[Dict] = None):
        pass

    def close(self):
        """Release what the logger holds open (files, writers)."""


class JsonlLogger(BaseLogger):
    """Append-only JSONL event log; images saved next to it as PNG."""

    def __init__(self, output: str):
        os.makedirs(output, exist_ok=True)
        self._dir = output
        self._f = open(os.path.join(output, "events.jsonl"), "a", encoding="utf8")

    def _write(self, record):
        record["time"] = time.time()
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def add_scalar(self, tag, value, step):
        self._write({"type": "scalar", "tag": tag, "value": float(value), "step": step})

    def add_text(self, tag, text, step):
        self._write({"type": "text", "tag": tag, "text": text, "step": step})

    def add_image(self, tag, image, step, *, display_name=None, description=None):
        from .utils import convert_image_dtype, save_image
        rel = f"images/{tag.replace('/', '_')}-{step}.png"
        path = os.path.join(self._dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_image(path, convert_image_dtype(np.asarray(image), np.uint8))
        self._write({"type": "image", "tag": tag, "path": rel, "step": step,
                     "display_name": display_name, "description": description})

    def add_histogram(self, tag, values, step, *, num_bins=None):
        values = np.asarray(values)
        hist, edges = np.histogram(values, bins=num_bins or 64)
        self._write({"type": "histogram", "tag": tag, "step": step,
                     "hist": hist.tolist(), "edges": edges.tolist()})

    def add_hparams(self, hparams, metrics=None):
        self._write({"type": "hparams", "hparams": {k: str(v) for k, v in hparams.items()},
                     "metrics": metrics})


class TensorboardLogger(BaseLogger):
    """Tensorboard event files via torch.utils.tensorboard
    (capability parity with reference logging.py:691-727)."""

    def __init__(self, output: str):
        from torch.utils.tensorboard import SummaryWriter
        self._writer = SummaryWriter(log_dir=str(output))

    def close(self):
        self._writer.close()

    def add_scalar(self, tag, value, step):
        self._writer.add_scalar(tag, value, step)

    def add_text(self, tag, text, step):
        self._writer.add_text(tag, text, step)

    def add_image(self, tag, image, step, *, display_name=None, description=None):
        from .utils import convert_image_dtype
        img = convert_image_dtype(np.asarray(image), np.uint8)
        self._writer.add_image(tag, img, step, dataformats="HWC")

    def add_embedding(self, tag, embeddings, step, *, images=None, labels=None):
        import torch
        label_img = None
        if images is not None:
            from .utils import convert_image_dtype
            sizes = {im.shape for im in images}
            if len(sizes) == 1:
                label_img = torch.from_numpy(np.stack([
                    np.moveaxis(convert_image_dtype(im, np.float32), -1, 0)
                    for im in images]))
        metadata = None
        if labels is not None:
            metadata = [json.dumps(x) if isinstance(x, dict) else str(x) for x in labels]
        self._writer.add_embedding(np.asarray(embeddings), metadata=metadata,
                                   label_img=label_img, global_step=step, tag=tag)

    def add_histogram(self, tag, values, step, *, num_bins=None):
        self._writer.add_histogram(tag, np.asarray(values), step,
                                   max_bins=num_bins)

    def add_plot(self, tag, *data, step=None, axes_labels=None, title=None, **kwargs):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for series in data:
            series = np.asarray(series)
            if series.ndim == 1:
                ax.plot(series)
            else:
                ax.plot(series[:, 0], series[:, 1])
        if axes_labels:
            ax.set_xlabel(axes_labels[0])
            if len(axes_labels) > 1:
                ax.set_ylabel(axes_labels[1])
        if title:
            ax.set_title(title)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        self._writer.add_image(tag, buf, step, dataformats="HWC")

    def add_hparams(self, hparams, metrics=None):
        self._writer.add_hparams({k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                                  for k, v in hparams.items()}, metrics or {})


class WandbLogger(BaseLogger):
    """Weights & Biases backend (reference logging.py:209-235); requires the
    optional wandb package."""

    def __init__(self, output: str, **kwargs):
        import wandb  # type: ignore
        self._wandb = wandb
        self._run = wandb.init(dir=output, **kwargs)

    def add_scalar(self, tag, value, step):
        self._run.log({tag: value}, step=step)

    def add_text(self, tag, text, step):
        self._run.log({tag: self._wandb.Html(text)}, step=step)

    def add_image(self, tag, image, step, *, display_name=None, description=None):
        self._run.log({tag: self._wandb.Image(np.asarray(image),
                                              caption=description or display_name)},
                      step=step)

    def add_histogram(self, tag, values, step, *, num_bins=None):
        self._run.log({tag: self._wandb.Histogram(np.asarray(values),
                                                  num_bins=num_bins or 64)}, step=step)


class ConcatLogger(BaseLogger):
    """Fan-out to multiple loggers (reference logging.py:258-282) of scalars,
    text and images, as the JAX package's does: histograms, embeddings,
    plots and hparams stop at the base class's no-ops."""

    def __init__(self, loggers: Sequence[Logger]):
        self._loggers = list(loggers)

    @contextlib.contextmanager
    def add_event(self, step: int):
        yield _BaseEvent(self, step)

    def close(self):
        for lg in self._loggers:
            lg.close()

    def add_scalar(self, tag, value, step):
        for lg in self._loggers:
            lg.add_scalar(tag, value, step)

    def add_text(self, tag, text, step):
        for lg in self._loggers:
            lg.add_text(tag, text, step)

    def add_image(self, tag, image, step, **kwargs):
        for lg in self._loggers:
            lg.add_image(tag, image, step, **kwargs)
