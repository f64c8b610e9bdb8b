"""Host utilities: image dtype conversion, step schedules, sRGB, image I/O,
depth visualization, grids, metric accumulation, archive access, logging
setup and the nb-info serialisation.

The port's copy of `wildgaussians_tpu/utils.py` (host numpy, never on the
device path), except that nothing is fetched over a network: `open_any`
and `open_any_directory` read local files and members of local zip and tar
archives, and raise for a URL.
"""
import contextlib
import io
import logging
import os
import struct
import tarfile
import tempfile
import zipfile
from pathlib import Path
from typing import Optional, Union

import numpy as np


def convert_image_dtype(image: np.ndarray, dtype) -> np.ndarray:
    """reference method.py:44-53 / utils.py image conversion."""
    if image.dtype == dtype:
        return image
    if image.dtype != np.uint8 and dtype != np.uint8:
        return image.astype(dtype)
    if image.dtype == np.uint8 and dtype != np.uint8:
        return image.astype(dtype) / 255.0
    if image.dtype != np.uint8 and dtype == np.uint8:
        return np.clip(image * 255.0, 0, 255).astype(np.uint8)
    raise ValueError(f"cannot convert image from {image.dtype} to {dtype}")


class Indices:
    """Step schedule: an explicit step list or a [start:stop:step] range.

    Capability mirror of the reference schedule helper (utils.py:64-105),
    written from its observable contract: `step in schedule` membership,
    negative values resolved against the run length (set `.total` first),
    and `every_iters(n)` for periodic schedules. Unlike the reference,
    negative slice starts resolve as total+start (the reference computes
    total-start, which points past the end of the run).
    """

    def __init__(self, steps):
        self._spec = steps
        self.total: Optional[int] = None

    def _resolve(self, v: Optional[int]) -> Optional[int]:
        if v is None or v >= 0:
            return v
        if self.total is None:
            raise ValueError("negative schedule values need a known total")
        return self.total + v

    def __contains__(self, step: int) -> bool:
        if isinstance(self._spec, slice):
            lo = self._resolve(self._spec.start) or 0
            hi = self._resolve(self._spec.stop)
            if hi is None:
                hi = self.total
            stride = self._spec.step or 1
            in_range = step >= lo and (hi is None or step < hi)
            return in_range and (step - lo) % stride == 0
        return step in {self._resolve(v) for v in self._spec}

    @classmethod
    def every_iters(cls, iters: int, zero: bool = False):
        # note the reference's quirk (utils.py:89-91): zero=True STARTS the
        # range at `iters` — kept for schedule-for-schedule compatibility
        return cls(slice(iters if zero else 0, None, iters))

    def __repr__(self):
        if isinstance(self._spec, slice):
            parts = [self._spec.start, self._spec.stop, self._spec.step]
            return ":".join("" if p is None else str(p) for p in parts)
        return ",".join(str(v) for v in self._spec)

    __str__ = __repr__


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """reference method.py:770-779."""
    limit = 0.04045
    return np.where(img > limit, np.power((img + 0.055) / 1.055, 2.4), img / 12.92)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """reference method.py:782-791."""
    limit = 0.0031308
    return np.where(img > limit, 1.055 * np.power(np.clip(img, limit, None), 1.0 / 2.4) - 0.055,
                    12.92 * img)


def image_to_srgb(tensor, dtype, color_space: Optional[str] = None,
                  allow_alpha: bool = False, background_color: Optional[np.ndarray] = None):
    """Convert rendered tensor to sRGB (reference utils.py:120-151)."""
    if color_space is None:
        color_space = "srgb"
    if tensor.shape[-1] == 4 and not allow_alpha:
        alpha = tensor[..., -1:]
        tensor = tensor[..., :3]
        if tensor.dtype == np.uint8:
            tensor = convert_image_dtype(tensor, np.float32)
            alpha = convert_image_dtype(alpha, np.float32)
        if background_color is None:
            background_color = np.array([1.0, 1.0, 1.0], np.float32)
        bg = convert_image_dtype(np.asarray(background_color), np.float32)
        tensor = tensor * alpha + bg * (1 - alpha)
    if color_space == "linear":
        tensor = convert_image_dtype(tensor, np.float32)
        tensor = linear_to_srgb(tensor)
    tensor = convert_image_dtype(tensor, dtype)
    return tensor


def save_image(file, tensor: np.ndarray):
    """PNG for uint8, float16 .bin for float (reference utils.py:154-177)."""
    path = getattr(file, "name", None) if hasattr(file, "write") else str(file)
    if path is not None and str(path).endswith(".bin"):
        fp = file if hasattr(file, "write") else open(file, "wb")
        try:
            if tensor.shape[2] < 4:
                tensor = np.dstack(
                    (tensor, np.ones([tensor.shape[0], tensor.shape[1],
                                      4 - tensor.shape[2]], tensor.dtype)))
            fp.write(struct.pack("ii", tensor.shape[0], tensor.shape[1]))
            fp.write(tensor.astype(np.float16).tobytes())
        finally:
            if not hasattr(file, "write"):
                fp.close()
    else:
        from PIL import Image
        img = Image.fromarray(convert_image_dtype(tensor, np.uint8))
        if hasattr(file, "write"):
            img.save(file, format="png")
        else:
            img.save(str(file), format="png")


def read_image(file) -> np.ndarray:
    """Inverse of save_image (reference utils.py:180-197)."""
    path = str(getattr(file, "name", file))
    if path.endswith(".bin"):
        fp = file if hasattr(file, "read") else open(file, "rb")
        try:
            h, w = struct.unpack("ii", fp.read(8))
            itemsize = 2
            data = np.frombuffer(fp.read(h * w * 4 * itemsize), dtype=np.float16,
                                 count=h * w * 4).astype(np.float32).reshape(h, w, 4)
            return data
        finally:
            if not hasattr(file, "read"):
                fp.close()
    from PIL import Image
    return np.asarray(Image.open(file))


def visualize_depth(depth: np.ndarray, expected_scale: Optional[float] = None,
                    near_far: Optional[np.ndarray] = None) -> np.ndarray:
    """Depth -> turbo colormap uint8 (reference utils.py:204-245, incl. the
    ZipNeRF power transform)."""
    import matplotlib
    depth = depth.squeeze()
    assert depth.ndim == 2
    if near_far is not None:
        xnear, xfar = near_far
    elif expected_scale is not None:
        xnear, xfar = expected_scale / 16, expected_scale * 2
    else:
        xnear, xfar = np.percentile(depth, 3), np.percentile(depth, 97)
    # power transform (ZipNeRF)
    p = -1.5
    s = ((xfar ** (p + 1) - xnear ** (p + 1)) / (p + 1)) / (xfar - xnear)

    def pow_fn(x):
        return np.power(np.clip(x, 1e-10, None), p + 1) / (p + 1) / s
    vmin, vmax = pow_fn(xnear), pow_fn(xfar)
    depth_t = (pow_fn(depth) - vmin) / max(vmax - vmin, 1e-10)
    cmap = matplotlib.colormaps["turbo"]
    out = cmap(np.clip(1.0 - depth_t, 0, 1))[..., :3]
    return convert_image_dtype(out, np.uint8)


def make_image_grid(*images: np.ndarray, ncol=None, padding=2, max_width=1920,
                    background: float = 1.0):
    """reference utils.py:248-291."""
    if ncol is None:
        ncol = len(images)
    dtype = images[0].dtype
    imgs = []
    for img in images:
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        imgs.append(convert_image_dtype(img, dtype))
    images = imgs
    nrow = (len(images) + ncol - 1) // ncol
    scale_factor = 1.0
    height, width = images[0].shape[:2]
    if max_width is not None:
        scale_factor = min(1, (max_width - padding * (ncol - 1)) / (ncol * width))
        height = int(height * scale_factor)
        width = int(width * scale_factor)

    def interpolate(image):
        if image.shape[:2] != (height, width):
            from PIL import Image
            pil = Image.fromarray(convert_image_dtype(image, np.uint8))
            pil = pil.resize((width, height), Image.BILINEAR)
            image = convert_image_dtype(np.asarray(pil), dtype)
        return image
    images = [interpolate(img) for img in images]
    bg_value = convert_image_dtype(np.array(background, np.float32), dtype)
    grid = np.full((nrow * height + (nrow - 1) * padding,
                    ncol * width + (ncol - 1) * padding, 3),
                   bg_value, dtype=dtype)
    for i, img in enumerate(images):
        r, c = i // ncol, i % ncol
        grid[r * (height + padding):r * (height + padding) + height,
             c * (width + padding):c * (width + padding) + width] = img
    return grid


class MetricsAccumulator:
    """Windowed metric reduction between logger flushes.

    Per-key reduction mode via `options` (default "average"); `pop()`
    returns the reduced window and resets. Same contract as the reference
    accumulator (utils.py:327-360), reimplemented with explicit
    value/count maps and a reducer table.
    """

    _REDUCERS = {
        "average": lambda old, new, n: old + (new - old) / n,
        "last": lambda old, new, n: new,
        "max": lambda old, new, n: new if new > old else old,
        "sum": lambda old, new, n: old + new,
    }

    def __init__(self, options=None):
        self.options = dict(options or {})
        self._values: dict = {}
        self._counts: dict = {}

    def update(self, metrics):
        for key, value in metrics.items():
            mode = self.options.get(key, "average")
            try:
                reduce = self._REDUCERS[mode]
            except KeyError:
                raise ValueError(f"Unknown accumulator {mode}") from None
            n = self._counts[key] = self._counts.get(key, 0) + 1
            self._values[key] = reduce(self._values.get(key, 0), value, n)

    def pop(self):
        out = self._values
        self._values, self._counts = {}, {}
        return out


_ARCHIVE_EXTS = (".zip", ".tar.gz", ".tgz", ".tar")
# where users put pretrained weights and scenes by hand (the JAX package's)
LOCAL_CACHE = os.path.expanduser("~/.cache/wild-gaussians-tpu")


def _is_url(path: str) -> bool:
    return "://" in path and path.split("://", 1)[0] in ("http", "https", "ftp", "s3", "gs")


def _refuse_url(path: str):
    raise FileNotFoundError(
        f"{path} is a URL and nothing is downloaded: fetch it by hand into the local cache "
        f"({LOCAL_CACHE}) or a local path, and pass that path instead")


@contextlib.contextmanager
def open_any(path: Union[str, Path], mode: str = "r"):
    """Open a file by path, or a path THROUGH zip/tar archives
    (segments split on archive extensions, nesting allowed); file objects
    pass through. A URL raises: nothing is downloaded."""
    if not isinstance(path, (str, Path)):
        yield path
        return
    path = str(path)
    components = path.split("/")
    arch = [i for i, c in enumerate(components[:-1])
            if c.endswith(_ARCHIVE_EXTS)]
    if arch:
        i = arch[-1]
        prefix = "/".join(components[:i + 1])
        rest = "/".join(components[i + 1:])
        if "r" in mode:
            # the archive itself may live inside another archive
            with open_any(prefix, mode) as outer:
                if components[i].endswith(".zip"):
                    with zipfile.ZipFile(outer) as zf, zf.open(rest, "r") as f:
                        yield io.BytesIO(f.read())
                else:
                    with tarfile.open(fileobj=outer, mode="r:*") as tf:
                        f = tf.extractfile(tf.getmember(rest))
                        assert f is not None
                        yield io.BytesIO(f.read())
        else:
            assert components[i].endswith(".zip"), \
                "writing through archives is only supported for .zip"
            buf = io.BytesIO()
            yield buf
            with zipfile.ZipFile(prefix, "a") as zf:
                zf.writestr(rest, buf.getvalue())
        return
    if _is_url(path):
        _refuse_url(path)
    if "w" in mode:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, mode if "b" in mode else mode + "b") as f:
        yield f


@contextlib.contextmanager
def open_any_directory(path: Union[str, Path], mode: str = "r"):
    """Expose a directory or a local .zip/.tar.gz archive of one as a real
    directory (reference utils.py:438-541); a URL raises."""
    path = str(path)
    if _is_url(path):
        _refuse_url(path)
    if not path.endswith((".zip", ".tar.gz", ".tgz")):
        os.makedirs(path, exist_ok=True)
        yield path
        return
    with tempfile.TemporaryDirectory() as tmp:
        if "r" in mode and os.path.exists(path):
            with open_any(path, "r") as f:
                if path.endswith(".zip"):
                    with zipfile.ZipFile(f) as zf:
                        zf.extractall(tmp)
                else:
                    with tarfile.open(fileobj=f, mode="r:*") as tf:
                        tf.extractall(tmp, filter="data")
        yield tmp
        if "w" in mode or "a" in mode:
            if path.endswith(".zip"):
                with zipfile.ZipFile(path, "w") as zf:
                    for root, _dirs, files in os.walk(tmp):
                        for fn in files:
                            full = os.path.join(root, fn)
                            zf.write(full, os.path.relpath(full, tmp))
            else:
                with tarfile.open(path, "w:gz") as tf:
                    tf.add(tmp, arcname="")


_LOG_STYLES = {
    logging.DEBUG: "\033[0;36mdebug:\033[0m {}",
    logging.INFO: "\033[1;36minfo:\033[0m {}",
    logging.WARNING: "\033[0;1;33mwarning: {}\033[0m",
    logging.ERROR: "\033[0;1;31merror: {}\033[0m",
}


def setup_logging(verbose: bool = False):
    """Root-logger setup with level-colored prefixes (capability parity with
    reference utils.py:32-59); quiets PIL's debug chatter under -v."""
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO, force=True)
    fmt = type("_Fmt", (logging.Formatter,), {
        "format": lambda self, r: _LOG_STYLES.get(
            r.levelno, "{}").format(r.getMessage())})()
    for handler in logging.root.handlers:
        handler.setFormatter(fmt)
    logging.getLogger("PIL").setLevel(logging.WARNING)
    logging.captureWarnings(True)


def save_depth(file, tensor: np.ndarray):
    """float16 .bin depth format (reference utils.py:189-196)."""
    if isinstance(file, (str, Path)):
        with open(file, "wb") as f:
            return save_depth(f, tensor)
    file.write(struct.pack("ii", tensor.shape[0], tensor.shape[1]))
    file.write(tensor.astype(np.float16).tobytes())


def serialize_nb_info(info: dict) -> dict:
    """JSON-safe nb-info (reference utils.py:544-578)."""
    info = info.copy()

    def fix_dm(dm):
        if dm is None:
            return None
        dm = dm.copy()
        if isinstance(dm.get("background_color"), np.ndarray):
            dm["background_color"] = dm["background_color"].tolist()
        if "viewer_initial_pose" in dm and isinstance(dm["viewer_initial_pose"], np.ndarray):
            dm["viewer_initial_pose"] = np.round(
                dm["viewer_initial_pose"][:3, :4].astype(np.float64), 6).tolist()
        if "viewer_transform" in dm and isinstance(dm["viewer_transform"], np.ndarray):
            dm["viewer_transform"] = np.round(
                dm["viewer_transform"][:3, :4].astype(np.float64), 6).tolist()
        if dm.get("expected_scene_scale") is not None:
            dm["expected_scene_scale"] = round(float(dm["expected_scene_scale"]), 6)
        return dm

    if "dataset_metadata" in info:
        info["dataset_metadata"] = fix_dm(info["dataset_metadata"])
    if "render_dataset_metadata" in info:
        info["render_dataset_metadata"] = fix_dm(info["render_dataset_metadata"])
    return info


def deserialize_nb_info(info: dict) -> dict:
    """reference utils.py:581-598."""
    info = info.copy()

    def fix_dm(dm):
        if dm is None:
            return None
        dm = dm.copy()
        if dm.get("background_color") is not None:
            dm["background_color"] = np.array(dm["background_color"], dtype=np.uint8)
        if "viewer_initial_pose" in dm:
            dm["viewer_initial_pose"] = np.array(dm["viewer_initial_pose"], dtype=np.float32)
        if "viewer_transform" in dm:
            dm["viewer_transform"] = np.array(dm["viewer_transform"], dtype=np.float32)
        return dm
    if "dataset_metadata" in info:
        info["dataset_metadata"] = fix_dm(info["dataset_metadata"])
    if "render_dataset_metadata" in info:
        info["render_dataset_metadata"] = fix_dm(info["render_dataset_metadata"])
    return info
