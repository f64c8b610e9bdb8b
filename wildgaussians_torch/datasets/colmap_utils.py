"""COLMAP sparse-model readers and writers (.bin and .txt).

The port's copy of `wildgaussians_tpu/datasets/colmap_utils.py` (the
standard COLMAP format, https://colmap.github.io/format.html). The binary
points reader parses point by point, as the JAX package's does.
"""
import collections
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def qvec2rotmat(qvec):
    """Quaternion (w,x,y,z) to rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(f, f"<{model.num_params}d"))
            cameras[cam_id] = Camera(cam_id, model.model_name, int(width), int(height), params)
    return cameras


def read_cameras_text(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * num_pts), dtype=np.dtype(
                [("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            xys = np.stack([data["x"], data["y"]], -1)
            pt_ids = data["id"].astype(np.int64)
            images[img_id] = Image(img_id, qvec, tvec, cam_id, name.decode("utf8"),
                                   xys, pt_ids)
    return images


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    with open(path, "r", encoding="utf8") as f:
        # keep empty lines: an image with no 2D points has an empty track line
        lines = [ln.strip() for ln in f if not ln.strip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(elems[j]), float(elems[j + 1])]
                        for j in range(0, len(elems), 3)]).reshape(-1, 2)
        pt_ids = np.array([int(elems[j + 2]) for j in range(0, len(elems), 3)], np.int64)
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name, xys, pt_ids)
    return images


def read_points3D_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            pt_id, x, y, z, r, g, b, err = _read(f, "<Q3d3Bd")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.dtype(
                [("image_id", "<i4"), ("p2d", "<i4")]))
            points[pt_id] = Point3D(pt_id, np.array([x, y, z]),
                                    np.array([r, g, b], np.uint8), err,
                                    track["image_id"].copy(), track["p2d"].copy())
    return points


def read_points3D_text(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pt_id = int(parts[0])
            xyz = np.array([float(x) for x in parts[1:4]])
            rgb = np.array([int(x) for x in parts[4:7]], np.uint8)
            err = float(parts[7])
            track = parts[8:]
            image_ids = np.array([int(track[j]) for j in range(0, len(track), 2)], np.int32)
            p2d = np.array([int(track[j + 1]) for j in range(0, len(track), 2)], np.int32)
            points[pt_id] = Point3D(pt_id, xyz, rgb, err, image_ids, p2d)
    return points


def write_cameras_binary(cameras: Dict[int, Camera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model.model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{model.num_params}d", *cam.params))


def write_images_binary(images: Dict[int, Image], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i", img.id))
            f.write(struct.pack("<4d", *img.qvec))
            f.write(struct.pack("<3d", *img.tvec))
            f.write(struct.pack("<i", img.camera_id))
            f.write(img.name.encode("utf8") + b"\x00")
            f.write(struct.pack("<Q", len(img.point3D_ids)))
            for (x, y), pid in zip(img.xys, img.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_points3D_binary(points: Dict[int, Point3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<Q3d3Bd", pt.id, *pt.xyz, *pt.rgb, pt.error))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for img_id, p2d in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", img_id, p2d))


def write_points3D_arrays_binary(xyz: np.ndarray, rgb: np.ndarray, path):
    """points3D.bin for points without tracks (ids 1..N, error 0) in one
    write: the bytes of `write_points3D_binary` for those points, at a
    fraction of its time for millions of points."""
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                       ("error", "<f8"), ("track_length", "<u8")])
    table = np.zeros(len(xyz), record)
    table["id"] = np.arange(1, len(xyz) + 1)
    table["xyz"] = xyz
    table["rgb"] = rgb
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(table.tobytes())


def write_cameras_text(cameras: Dict[int, Camera], path):
    """COLMAP cameras.txt (reference _colmap_utils.py write_cameras_text)."""
    with open(path, "w", encoding="utf8") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path):
    """COLMAP images.txt: two lines per image (pose; 2D-point track)."""
    mean_obs = (sum(len(i.point3D_ids) for i in images.values())
                / max(len(images), 1))
    with open(path, "w", encoding="utf8") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}, "
                f"mean observations per image: {mean_obs}\n")
        for img in images.values():
            pose = " ".join(repr(float(v)) for v in (*img.qvec, *img.tvec))
            f.write(f"{img.id} {pose} {img.camera_id} {img.name}\n")
            track = " ".join(f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                             for (x, y), pid in zip(img.xys, img.point3D_ids))
            f.write(track + "\n")


def write_points3D_text(points: Dict[int, Point3D], path):
    """COLMAP points3D.txt."""
    mean_track = (sum(len(p.image_ids) for p in points.values())
                  / max(len(points), 1))
    with open(path, "w", encoding="utf8") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}, "
                f"mean track length: {mean_track}\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {repr(float(pt.error))} {track}\n")


def detect_model_format(path, ext: str) -> bool:
    """True when cameras/images/points3D with the given extension exist under
    path (reference _colmap_utils.py detect_model_format)."""
    import os
    return all(os.path.isfile(os.path.join(str(path), f + ext))
               for f in ("cameras", "images", "points3D"))


def read_model(path, ext: str = ""):
    """Read a sparse model directory in .bin or .txt format; auto-detects the
    extension when not given (reference _colmap_utils.py read_model)."""
    import os
    if ext == "":
        if detect_model_format(path, ".bin"):
            ext = ".bin"
        elif detect_model_format(path, ".txt"):
            ext = ".txt"
        else:
            raise FileNotFoundError(f"no COLMAP model found under {path}")
    join = lambda name: os.path.join(str(path), name + ext)  # noqa: E731
    if ext == ".txt":
        return (read_cameras_text(join("cameras")),
                read_images_text(join("images")),
                read_points3D_text(join("points3D")))
    return (read_cameras_binary(join("cameras")),
            read_images_binary(join("images")),
            read_points3D_binary(join("points3D")))


def write_model(cameras, images, points3D, path, ext: str = ".bin"):
    """Write a sparse model directory in .bin or .txt format."""
    import os
    join = lambda name: os.path.join(str(path), name + ext)  # noqa: E731
    if ext == ".txt":
        write_cameras_text(cameras, join("cameras"))
        write_images_text(images, join("images"))
        write_points3D_text(points3D, join("points3D"))
    else:
        write_cameras_binary(cameras, join("cameras"))
        write_images_binary(images, join("images"))
        write_points3D_binary(points3D, join("points3D"))
