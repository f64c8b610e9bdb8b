"""Plain PyTorch render of a WildGaussians scene: the benchmark's reference.

Written from the method's equations (3D Gaussian splatting with the
mip-splatting 3D filter and 2D dilation, degree-3 spherical harmonics, the
WildGaussians appearance MLP) and imports nothing of the program under
test. Every step is a whole-tensor torch operation in float32; the blend
walks each 16x16 tile's depth-ordered entries for all 256 pixels at once
and is differentiated by autograd (recomputed per tile batch in the
backward, so that it fits).

What the method leaves to the implementation and the program fixes, the
reference states here:
- a Gaussian is binned into the tiles of its 3-sigma rect (the rect of
  radius ceil(3 sqrt(lambda_max))), minus the tiles where its alpha cannot
  reach 1/255 at any pixel centre of the tile box, at most `d_max` rect
  cells;
- entries are ordered by the top `depth_bits` bits of the float depth, ties
  by the cell's rank among the Gaussian's kept cells and then by the
  Gaussian's slot;
- a pixel blends front to back: alpha = min(0.99, o exp(power)), skipped
  when power > 0 or alpha < 1/255, and stops before the first entry that
  would take its transmittance under 1e-4. The gradient of a capped alpha
  is zero.
"""
import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.utils.checkpoint

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
# pair elements of one [tiles, 256, entries] intermediate of the blend
BATCH_ELEMS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Camera(NamedTuple):
    view: torch.Tensor      # [4, 4] world to camera
    campos: torch.Tensor    # [3] the camera centre
    fx: float
    fy: float
    cx: float
    cy: float
    width: int              # the canvas the image is rendered on
    height: int
    actual_w: float         # the image inside it
    actual_h: float


def camera(pose: torch.Tensor, intr, canvas, actual) -> Camera:
    """pose [3, 4] camera to world (x right, y down, z forward); intr (fx,
    fy, cx, cy); canvas and actual (w, h)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=pose.device)
    view = torch.linalg.inv(torch.cat([pose.to(torch.float32), bottom], 0))
    fx, fy, cx, cy = (float(v) for v in intr)
    return Camera(view, pose[:3, 3].to(torch.float32), fx, fy, cx, cy, int(canvas[0]),
                  int(canvas[1]), float(actual[0]), float(actual[1]))


def filter_3d(xyz: torch.Tensor, cams: List[Camera]) -> torch.Tensor:
    """The mip-splatting 3D filter [n, 1]: sqrt(0.2) times the nearest depth
    (> 0.2) at which a training camera sees the point within 15 % outside
    its image, over the largest focal length; points no camera sees take
    the largest such depth."""
    dist = torch.full((xyz.shape[0],), math.inf, device=xyz.device)
    for cam in cams:
        t = xyz @ cam.view[:3, :3].T + cam.view[:3, 3]
        z = torch.clamp_min(t[:, 2], 0.001)
        x = t[:, 0] / z * cam.fx + cam.actual_w / 2
        y = t[:, 1] / z * cam.fy + cam.actual_h / 2
        seen = ((t[:, 2] > 0.2) & (x >= -0.15 * cam.actual_w) & (x <= 1.15 * cam.actual_w)
                & (y >= -0.15 * cam.actual_h) & (y <= 1.15 * cam.actual_h))
        dist = torch.where(seen, torch.minimum(dist, z), dist)
    finite = torch.isfinite(dist)
    far = dist[finite].max() if bool(finite.any()) else torch.tensor(1e5, device=xyz.device)
    dist = torch.where(finite, dist, far)
    focal = max(c.fx for c in cams)
    return (dist / focal * math.sqrt(0.2))[:, None]


def activate(p: Dict[str, torch.Tensor], filt: torch.Tensor):
    """(xyz, opacity [n], scales [n, 3], unit quaternions [n, 4], SH features
    [n, 48]) from the raw parameters, with the 3D filter folded into the
    scales and the opacity."""
    s2 = torch.exp(p["scales"]) ** 2
    s2f = s2 + filt ** 2
    opacity = torch.sigmoid(p["opacities"][:, 0]) * torch.sqrt(s2.prod(-1) / s2f.prod(-1))
    quat = p["rotations"] / torch.clamp_min(p["rotations"].norm(dim=-1, keepdim=True), 1e-12)
    feats = p["features_dc"]
    if "features_rest" in p:
        feats = torch.cat([feats, p["features_rest"]], -1)
    return p["xyz"], opacity, torch.sqrt(s2f), quat, feats


def rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    ).reshape(*q.shape[:-1], 3, 3)


def eval_sh3(sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-3 SH: sh [n, 16, 3] coefficients, d [n, 3] unit directions."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz,
             SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
             SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    return (torch.cat(basis, -1)[:, :, None] * sh).sum(1)


def sh_colors(feats: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """RGB of each Gaussian: SH (coefficients capped at 1) + 0.5, floored at 0."""
    sh = torch.clamp_max(feats, 1.0).reshape(feats.shape[0], -1, 3)
    return torch.clamp_min(eval_sh3(sh, dirs) + 0.5, 0.0)


def appearance(mlp: Dict[str, torch.Tensor], gemb: torch.Tensor, aemb: torch.Tensor,
               feats: torch.Tensor) -> torch.Tensor:
    """WildGaussians' appearance MLP: (DC colour, Gaussian embedding, image
    embedding) -> 128 -> 128 -> 6, times 0.01, an affine map of the SH
    coefficients (offset / C0 on the DC terms, a per-channel scale on
    all). Weights are [in, out]."""
    x = torch.cat([feats[:, :3], gemb, aemb[None].expand(feats.shape[0], -1)], -1)
    x = torch.relu(x @ mlp["w0"] + mlp["b0"])
    x = torch.relu(x @ mlp["w1"] + mlp["b1"])
    x = (x @ mlp["w2"] + mlp["b2"]) * 0.01
    offset = torch.cat([x[:, :3] / SH_C0, torch.zeros_like(feats[:, 3:])], -1)
    scale = x[:, 3:].repeat(1, feats.shape[1] // 3)
    return feats * scale + offset


class Projected(NamedTuple):
    mean2d: torch.Tensor     # [n, 2] pixels
    depth: torch.Tensor      # [n]
    conic: torch.Tensor      # [n, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor    # [n] with the 2D dilation's factor
    rect_min: torch.Tensor   # [n, 2] tiles, inclusive
    rect_max: torch.Tensor   # [n, 2] tiles, exclusive
    valid: torch.Tensor      # [n]


def project(xyz, opacity, scales, quat, cam: Camera, kernel_size: float) -> Projected:
    """EWA projection with the 2D dilation `kernel_size` and its opacity
    factor sqrt(det / det_dilated); pixel centres at integer coordinates."""
    R = cam.view[:3, :3]
    t = xyz @ R.T + cam.view[:3, 3]
    tz = t[:, 2]
    w, h = cam.width, cam.height
    # the OpenGL-style projection the rasterizer divides by (w + 1e-7)
    inv = 1.0 / (tz + 1e-7)
    ndc_x = (2 * cam.fx / w * t[:, 0] + (2 * cam.cx - w) / w * tz) * inv
    ndc_y = (2 * cam.fy / h * t[:, 1] + (2 * cam.cy - h) / h * tz) * inv
    mean2d = torch.stack([((ndc_x + 1) * w - 1) * 0.5, ((ndc_y + 1) * h - 1) * 0.5], -1)

    M = rotation(quat) * scales[:, None, :]
    cov3 = M @ M.transpose(1, 2)
    limx = 1.3 * cam.actual_w / (2 * cam.fx)
    limy = 1.3 * cam.actual_h / (2 * cam.fy)
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([cam.fx / tz, zero, -cam.fx * tx / tz ** 2,
                     zero, cam.fy / tz, -cam.fy * ty / tz ** 2], -1).reshape(-1, 2, 3)
    T = J @ R
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a, b, c = cov2[:, 0, 0], cov2[:, 0, 1], cov2[:, 1, 1]
    det0 = a * c - b * b
    a, c = a + kernel_size, c + kernel_size
    det = a * c - b * b
    coef = torch.sqrt(torch.clamp_min(det0, 1e-6) / (torch.clamp_min(det, 1e-6) + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det <= 1e-6), 0.0, coef)
    det_ok = det != 0
    det_safe = torch.where(det_ok, det, 1.0)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    conic = torch.where(det_ok[:, None], conic, 0.0)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0))).detach()
    gx, gy = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    m = mean2d.detach()

    def to_tile(v, hi):
        v = torch.nan_to_num(v, nan=0.0)
        return torch.clamp(torch.clamp(v, -1.0, float(hi)).to(torch.int64), 0, hi)
    rect_min = torch.stack([to_tile((m[:, 0] - radius) / TILE, gx),
                            to_tile((m[:, 1] - radius) / TILE, gy)], -1)
    rect_max = torch.stack([to_tile((m[:, 0] + radius + TILE - 1) / TILE, gx),
                            to_tile((m[:, 1] + radius + TILE - 1) / TILE, gy)], -1)
    area = (rect_max - rect_min).prod(-1)
    valid = (tz > 0.2) & det_ok & (area > 0)
    return Projected(mean2d, tz, conic, opacity * coef, rect_min, rect_max, valid)


class Bins(NamedTuple):
    gauss: torch.Tensor      # [E] Gaussian of each entry, tile by tile, front to back
    starts: torch.Tensor     # [tiles + 1]
    overflow: int            # Gaussians whose rect has more than d_max cells


def bin_entries(pr: Projected, slots: torch.Tensor, grid, d_max: int) -> Bins:
    """The (tile, Gaussian) entries of the blend, in blend order. `slots`
    [n] are the Gaussians' store slots (the tie order); grid (gx, gy)."""
    gx, gy = grid
    n_tiles = gx * gy
    depth_bits = 32 - (n_tiles + 1).bit_length()
    idx = torch.nonzero(pr.valid).flatten()
    rmin, rmax = pr.rect_min[idx], pr.rect_max[idx]
    rw = torch.clamp_min(rmax[:, 0] - rmin[:, 0], 1)
    area = (rmax - rmin).prod(-1)
    m = pr.mean2d.detach()[idx]
    con = pr.conic.detach()[idx]
    op = pr.opacity.detach()[idx]
    thr = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * 255.0)
    dq = torch.clamp_max(torch.clamp_min(pr.depth.detach()[idx], 0.0).view(torch.int32)
                         .to(torch.int64) >> (31 - depth_bits), (1 << depth_bits) - 1)
    rank = torch.zeros_like(idx)
    keys, gauss = [], []
    rank_bits = max(d_max, 1).bit_length()
    slot_bits = max(int(slots.max()) + 1, 2).bit_length()
    for j in range(d_max):
        tile_y = rmin[:, 1] + j // rw
        tile_x = rmin[:, 0] + j % rw
        keep = (j < area) & _tile_reached(tile_x, tile_y, m, con, thr)
        tile = tile_y * gx + tile_x
        key = ((((tile << depth_bits) | dq) << rank_bits | rank) << slot_bits) | slots[idx]
        keys.append(key[keep])
        gauss.append(idx[keep])
        rank = rank + keep.to(rank.dtype)
    keys, gauss = torch.cat(keys), torch.cat(gauss)
    order = torch.argsort(keys)
    tiles = keys[order] >> (depth_bits + rank_bits + slot_bits)
    starts = torch.searchsorted(tiles, torch.arange(n_tiles + 1, device=tiles.device))
    return Bins(gauss[order], starts, int((area > d_max).sum()))


def _tile_reached(tile_x, tile_y, mean, con, thr) -> torch.Tensor:
    """Whether min over the tile's pixel-centre box of d^T C d is <= thr:
    the Gaussian can reach alpha 1/255 somewhere in the tile. The minimum
    of the quadratic is 0 at its centre if the centre lies in the box,
    else on an edge, where the free coordinate is clipped to the box."""
    a, b, c = con[:, 0], con[:, 1], con[:, 2]
    x_hi = mean[:, 0] - (tile_x * TILE).to(torch.float32)
    x_lo = x_hi - (TILE - 1)
    y_hi = mean[:, 1] - (tile_y * TILE).to(torch.float32)
    y_lo = y_hi - (TILE - 1)

    def q(dx, dy):
        return a * dx * dx + 2 * b * dx * dy + c * dy * dy
    inside = (x_lo <= 0) & (x_hi >= 0) & (y_lo <= 0) & (y_hi >= 0)
    best = torch.where(inside, 0.0, math.inf)
    for dx in (x_lo, x_hi):
        dy = torch.minimum(torch.maximum(-b * dx / torch.clamp_min(c, 1e-12), y_lo), y_hi)
        best = torch.minimum(best, q(dx, dy))
    for dy in (y_lo, y_hi):
        dx = torch.minimum(torch.maximum(-b * dy / torch.clamp_min(a, 1e-12), x_lo), x_hi)
        best = torch.minimum(best, q(dx, dy))
    return best <= thr


def _tile_batches(counts: List[int]):
    """Tile ids in batches of similar entry counts: [(tiles, longest)]."""
    order = sorted(range(len(counts)), key=lambda t: counts[t])
    out, cur, longest = [], [], 0
    for t in order:
        c = counts[t]
        if c == 0:
            continue
        if cur and (len(cur) + 1) * 256 * max(longest, c) > BATCH_ELEMS:
            out.append((cur, longest))
            cur, longest = [], 0
        cur.append(t)
        longest = max(longest, c)
    if cur:
        out.append((cur, longest))
    return out


def _blend_batch(px, py, ent_xy, ent_con, ent_op, ent_col, em):
    """One batch of tiles: pixels px, py [B, 256]; entries [B, L, ...] with
    the real-entry mask em [B, L]. Returns (colour [B, 256, 3 passes],
    final T [B, 256], the pairs each pixel needs [B, 256], whether a pixel
    of the tile needs each entry [B, L])."""
    dx = ent_xy[:, None, :, 0] - px[:, :, None]
    dy = ent_xy[:, None, :, 1] - py[:, :, None]
    a, b, c = (ent_con[:, None, :, k] for k in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(ent_op[:, None, :] * torch.exp(power), ALPHA_MAX)
    use = em[:, None, :] & (power <= 0) & (alpha >= ALPHA_MIN)
    keep = torch.where(use, 1.0 - alpha, 1.0)
    t_after = torch.cumprod(keep, -1)
    contrib = use & (t_after.detach() >= T_STOP)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]), t_after[..., :-1]], -1)
    w = torch.where(contrib, alpha * t_before, 0.0)
    colour = torch.einsum("bpl,blc->bpc", w, ent_col)
    final_t = torch.where(contrib, keep, 1.0).prod(-1)
    return colour, final_t, contrib.sum(-1), contrib.any(1)


def blend(pr: Projected, colours: torch.Tensor, bins: Bins, grid, count_pairs: bool = False):
    """Composite `colours` [n, 3 k] (k passes side by side) over the tiles.
    Returns (images [H_canvas, W_canvas, 3 k], final T [H, W]) and, with
    `count_pairs`, the needed (pixel, entry) pairs and the entries at least
    one pixel of their tile needs."""
    gx, gy = grid
    dev = colours.device
    starts = bins.starts
    counts = (starts[1:] - starts[:-1]).tolist()
    local = torch.arange(256, device=dev)
    n_tiles = gx * gy
    k3 = colours.shape[1]
    out_col = torch.zeros((n_tiles, 256, k3), device=dev)
    out_t = torch.ones((n_tiles, 256), device=dev)
    pieces_c, pieces_t, rows = [], [], []
    pairs = entries = 0
    for tiles, longest in _tile_batches(counts):
        tb = torch.tensor(tiles, device=dev)
        pos = torch.arange(longest, device=dev)
        em = pos[None, :] < (starts[tb + 1] - starts[tb])[:, None]
        g = bins.gauss[torch.where(em, starts[tb][:, None] + pos[None, :], 0)]
        px = ((tb % gx) * TILE)[:, None] + local[None] % TILE
        py = ((tb // gx) * TILE)[:, None] + local[None] // TILE
        args = (px.to(torch.float32), py.to(torch.float32), pr.mean2d[g], pr.conic[g],
                pr.opacity[g], colours[g], em)
        if torch.is_grad_enabled():
            c, t, need, used = torch.utils.checkpoint.checkpoint(_blend_batch, *args,
                                                                 use_reentrant=False)
        else:
            c, t, need, used = _blend_batch(*args)
        if count_pairs:
            pairs += int(need.sum())
            entries += int(used.sum())
        pieces_c.append(c)
        pieces_t.append(t)
        rows.append(tb)
    if rows:
        rows_all = torch.cat(rows)
        out_col = out_col.index_put((rows_all,), torch.cat(pieces_c))
        out_t = out_t.index_put((rows_all,), torch.cat(pieces_t))
    img = out_col.reshape(gy, gx, TILE, TILE, k3).permute(0, 2, 1, 3, 4).reshape(
        gy * TILE, gx * TILE, k3)
    fin = out_t.reshape(gy, gx, TILE, TILE).permute(0, 2, 1, 3).reshape(gy * TILE, gx * TILE)
    if count_pairs:
        return img, fin, pairs, entries
    return img, fin


class Frame(NamedTuple):
    toned: torch.Tensor            # [H, W, 3] canvas
    raw: torch.Tensor              # [H, W, 3] (the toned image without appearance)
    projected: Projected
    bins: Bins
    pairs: Optional[int] = None    # needed (pixel, entry) pairs, when counted
    entries: Optional[int] = None  # entries a pixel needs, when counted


def render(state: Dict[str, torch.Tensor], mlp: Optional[Dict[str, torch.Tensor]],
           filt: torch.Tensor, slots: torch.Tensor, cam: Camera, cfg: dict,
           embedding: Optional[torch.Tensor], count_pairs: bool = False) -> Frame:
    """One camera's images on its canvas. `state` holds the live
    Gaussians' raw parameters; with appearance on, the raw pass and the
    toned pass (the MLP's SH) are blended together."""
    xyz, opacity, scales, quat, feats = activate(state, filt)
    dirs = xyz - cam.campos
    dirs = dirs / torch.clamp_min(dirs.norm(dim=-1, keepdim=True), 1e-12)
    raw = sh_colors(feats, dirs)
    colours = [raw]
    if cfg["appearance_enabled"]:
        toned_feats = torch.clamp_max(appearance(mlp, state["embeddings"], embedding,
                                                 torch.clamp_max(feats, 1.0)), 1.0)
        colours.append(sh_colors(toned_feats, dirs))
    pr = project(xyz, opacity, scales, quat, cam, cfg["kernel_size"])
    grid = ((cam.width + TILE - 1) // TILE, (cam.height + TILE - 1) // TILE)
    bins = bin_entries(pr, slots, grid, cfg["max_tiles_per_gaussian"])
    out = blend(pr, torch.cat(colours, -1), bins, grid, count_pairs)
    img = out[0][:cam.height, :cam.width]
    toned = img[..., -3:]
    return Frame(toned, img[..., :3], pr, bins, *(out[2:] if count_pairs else ()))
