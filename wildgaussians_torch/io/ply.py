"""Binary PLY export and import of a 3DGS point cloud.

The port's copy of `wildgaussians_tpu/io/ply.py`: the same header and bytes
for the same arrays, so external 3DGS viewers and the JAX package read it.
Field layout: x,y,z, nx,ny,nz, f_dc_0..2, opacity, scale_0..2, rot_0..3,
all float32, binary_little_endian 1.0. Opacities and scales arrive
activated (with the 3D filter fused) and are stored as logit and log.
"""
from typing import Dict

import numpy as np


def save_ply(path: str, *, xyz: np.ndarray, features_dc: np.ndarray,
             opacities: np.ndarray, scales: np.ndarray, rotations: np.ndarray):
    """opacities: activated+filtered [N,1]; scales: activated+filtered [N,3]."""
    import os
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    n = xyz.shape[0]
    op = np.clip(opacities.reshape(n, 1), 1e-7, 1 - 1e-7)
    op_logit = np.log(op / (1 - op)).astype(np.float32)
    log_scales = np.log(np.clip(scales, 1e-30, None)).astype(np.float32)
    normals = np.zeros_like(xyz, dtype=np.float32)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(features_dc.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(log_scales.shape[1])]
             + [f"rot_{i}" for i in range(rotations.shape[1])])
    data = np.concatenate([xyz.astype(np.float32), normals,
                           features_dc.astype(np.float32), op_logit,
                           log_scales, rotations.astype(np.float32)], axis=1)
    assert data.shape[1] == len(names)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Reads a 3DGS-style float PLY into named arrays."""
    with open(path, "rb") as f:
        names = []
        n = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, dtype, name = line.split()
                assert dtype in ("float", "float32"), f"unsupported dtype {dtype}"
                names.append(name)
            elif line == "end_header":
                break
            elif line.startswith("format"):
                assert "binary_little_endian" in line
        assert n is not None
        data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4").reshape(n, len(names))
    cols = {name: data[:, i] for i, name in enumerate(names)}
    out = {
        "xyz": np.stack([cols["x"], cols["y"], cols["z"]], -1),
        "features_dc": np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1),
        "opacity_logit": cols["opacity"],
        "log_scales": np.stack([cols[k] for k in sorted(c for c in cols if c.startswith("scale_"))], -1),
        "rotations": np.stack([cols[k] for k in sorted(c for c in cols if c.startswith("rot_"))], -1),
    }
    return out
