"""P1: how much of each tile's entry list the blend needs.

    python -m wildgaussians_torch.profiles.probe_cfin [--scene random|surfel] [--n N]

The blend kernels stop a tile once every pixel's transmittance has fallen
below 1e-4; the entries after that point get exactly zero gradient. If the
live fraction f = sum(c_fin 256) / sum(count) is small, the backward's
un-sort could work on a compacted table of about f R entries. The probe
runs the forward walk only (K1's, csrc/probe_cfin.cu) on the sort engine's
table at d_max 10, d_small 4, big fraction 0.16 (the JAX probe's settings)
and prints, per frame: R covered, the live entries and f, the chunks walked
of all chunks, and the c_fin and n_chunks percentiles.

Counterpart of `tools/profiles/probe_cfin.py` (its kernel `_probe_kernel`
:27, called at :95). One kernel, with its plain version beside it:

  P1 `probe_cfin`  csrc/probe_cfin.cu  per tile [c_fin, n_chunks, walked]

The wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error).
"""
import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from ..cameras import make_camera_params
from ..ops import _build
from ..ops.blend import _check_tiles, blend_walked_plain, tile_order
from ..ops.gaussians import compute_cov3d, preprocess
from ..ops.rasterize_tiled import TileGrid, make_grid
from ..ops.sort_engine import _build_sorted_table
from ..scenes import make_random_scene, make_surfel_scene
from ..types import new_cameras

K = 256                       # the blend's entry chunk
D_MAX, D_SMALL, BIG_FRACTION = 10, 4, 0.16


def probe_cfin_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                     tile_counts: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Plain PyTorch P1 from the blend's batched walk (K1's walked counts):
    a tile needs the 256-entry chunks up to the one that holds its last
    needed entry, so c_fin = ceil(walked / 256). Returns int32 [T, 3]."""
    walked = blend_walked_plain(table, tile_starts, tile_counts, grid)
    n_chunks = (tile_counts + (K - 1)) // K
    c_fin = (walked + (K - 1)) // K
    return torch.stack([c_fin, n_chunks, walked], dim=1).to(torch.int32)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _kernel():
    fn = _build.load("probe_cfin").wg_probe_cfin
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def probe_cfin(table: torch.Tensor, tile_starts: torch.Tensor, tile_counts: torch.Tensor,
               grid: TileGrid) -> torch.Tensor:
    """P1 on the blend table [>= 6, N] f32 (rows x, y, conic a, b, c,
    opacity first; further rows are not read): per tile int32 [T, 3] =
    (c_fin: the 256-entry chunks the tile needs, ceil(walked / 256), counted
    from the tile's start; n_chunks; walked: K1's needed entries). A CPU
    table runs the plain version; a CUDA table launches the kernel in
    `csrc/probe_cfin.cu` and adds one to `probe_cfin.launches`."""
    if table.device.type == "cpu":
        return probe_cfin_plain(table, tile_starts, tile_counts, grid)
    if table.device.type != "cuda":
        raise ValueError(f"probe_cfin: unsupported device {table.device}")
    T = grid.num_tiles
    if grid.tile_size != 16:
        raise ValueError("probe_cfin works on 16x16 tiles")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] < 6 \
            or table.stride(1) != 1:
        raise ValueError(f"table must be f32 [>= 6, N] with contiguous rows, got {table.dtype} "
                         f"{tuple(table.shape)}")
    _check_tiles("probe_cfin", table, tile_starts, tile_counts, None, T)
    # the kernel takes the tiles longest list first, as K1 does
    order = tile_order(tile_counts, T)
    out = torch.empty((T, 3), dtype=torch.int32, device=table.device)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), tile_starts.data_ptr(),
                 tile_counts.data_ptr(), order.data_ptr(), T, grid.grid_x, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"probe_cfin kernel launch failed with CUDA error {err}")
    probe_cfin.launches += 1
    return out


probe_cfin.launches = 0


def make_inputs(n: int, width: int, height: int, device, scene: str = "random"):
    """The probe's frame: `scene` ("random": `scenes.make_random_scene`, the
    JAX probe's `sweep_r3.make_inputs`; "surfel": `scenes.make_surfel_scene`)
    of n Gaussians from seed 0, seen by an identity camera with focal
    length width / 1.4. Returns ((xyz, scales, rotations, opacities,
    colors) on `device`, camera params, width, height)."""
    rng = np.random.default_rng(0)
    f = width / 1.4
    cam = new_cameras(poses=np.eye(4, dtype=np.float32)[:3][None],
                      intrinsics=np.array([[f, f, width / 2, height / 2]], np.float32),
                      camera_models=np.zeros((1,), np.int32),
                      distortion_parameters=np.zeros((1, 6), np.float32),
                      image_sizes=np.array([[width, height]], np.int32))
    params, w, h = make_camera_params(cam, device=device)
    make = make_random_scene if scene == "random" else make_surfel_scene
    arrays = make(rng, n, width, height, f)
    return tuple(torch.as_tensor(a, device=device) for a in arrays), params, w, h


def probe_table(scene_arrays, params, w: int, h: int):
    """The sort engine's blend table of one frame at the probe's settings:
    (table, tile_starts, tile_counts, grid)."""
    xyz, scales, rots, opac, colors = scene_arrays
    n = xyz.shape[0]
    grid = make_grid(w, h, 16)
    pre = preprocess(xyz, compute_cov3d(scales, rots, 1.0), opac, params, w, h, 0.1)
    st = _build_sorted_table(grid, n, D_MAX, 1, D_SMALL, BIG_FRACTION, pre.mean2d, pre.conic,
                             pre.opacity, colors[None], pre.depth, pre.rect_min, pre.rect_max,
                             torch.clamp_max(pre.tiles_touched, D_MAX), pre.valid)
    return st.table, st.tile_starts, st.tile_counts, grid


def cfin_summary(out: torch.Tensor, tile_counts: torch.Tensor) -> dict:
    """What the JAX probe prints, from P1's [T, 3] and the tile counts: R
    covered (the binned entries), the live entries (c_fin 256) and f = live /
    R, the chunks walked of all chunks, and the c_fin and n_chunks
    percentiles (10, 50, 90, 99); beside them the entries K1 needed."""
    cf = out.cpu().numpy().astype(np.int64)
    c_fin, n_chunks, walked = cf[:, 0], cf[:, 1], cf[:, 2]
    total = int(tile_counts.sum())
    live = int(c_fin.sum()) * K
    return {"R_covered": total, "live_entries": live, "f": live / max(total, 1),
            "chunks_walked": int(c_fin.sum()), "chunks": int(n_chunks.sum()),
            "chunk_fraction": float(c_fin.sum() / max(n_chunks.sum(), 1)),
            "walked_entries": int(walked.sum()),
            "c_fin_percentiles": np.percentile(c_fin, [10, 50, 90, 99]).tolist(),
            "n_chunks_percentiles": np.percentile(n_chunks, [10, 50, 90, 99]).tolist()}


def print_summary(s: dict):
    """The JAX probe's three lines."""
    print(f"R_covered={s['R_covered']}  live_entries<={s['live_entries']}  f<={s['f']:.3f}")
    print(f"chunks: run={s['chunks_walked']} of {s['chunks']} ({s['chunk_fraction']:.3f})")
    print("c_fin percentiles:", s["c_fin_percentiles"])
    print("n_chunks percentiles:", s["n_chunks_percentiles"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("random", "surfel"), default="random")
    ap.add_argument("--n", type=int, default=1_500_000)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_cfin: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    arrays, params, w, h = make_inputs(args.n, args.width, args.height, dev, args.scene)
    table, starts, counts, grid = probe_table(arrays, params, w, h)
    out = probe_cfin(table, starts, counts, grid)
    torch.cuda.synchronize()
    summary = cfin_summary(out, counts)
    print_summary(summary)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        probe_cfin(table, starts, counts, grid)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"scene": args.scene, "n": args.n, "probe_ms": start.elapsed_time(end) / 5,
                      "card": torch.cuda.get_device_name(0), **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
