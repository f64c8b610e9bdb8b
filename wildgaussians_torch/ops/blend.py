"""The fused multi-pass tile blend (kernel K1) and the sort-engine rasterizer.

Counterpart of the forward half of `_make_pallas_blend_vjp` and of
`rasterize_pallas_multi` in `wildgaussians_tpu/ops/rasterize_pallas.py`
(single chip, sort engine, exact f32 table: the JAX package's pack16 f16 /
rgb10 table and its per-pass color scale exist only for TPU packing).

`blend_forward` is K1's wrapper. It dispatches on the device of the table
it is given: a CPU tensor goes to `blend_forward_plain`, a CUDA tensor to
the kernel in `csrc/blend_fwd.cu` (or an error). There is no fallback from
one to the other.
"""
import ctypes
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..spans import span
from . import _build
from .rasterize_tiled import ALPHA_MAX, ALPHA_MIN, T_EPS, TileGrid, tiles_to_image
from .sort_engine import _build_sorted_table

P_PIX = 256  # 16x16 tile

# elements of one [tiles, 256, entries] intermediate of the plain version;
# tiles are blended in batches that stay under it
_PLAIN_BATCH_ELEMS = 1 << 24


class _PlainBatch(NamedTuple):
    t0: int                 # tiles [t0, t1) of the batch
    t1: int
    ent: torch.Tensor       # [W, B, L] the tiles' entries, padded to the longest
    em: torch.Tensor        # [B, L] a real entry, not padding
    power_ok: torch.Tensor  # [B, P, L] a real entry with power <= 0
    use: torch.Tensor       # [B, P, L] power_ok and alpha >= 1/255
    alpha: torch.Tensor     # [B, P, L]
    lg: torch.Tensor        # [B, P, L] log1p(-alpha) where used, else 0
    t_inc: torch.Tensor     # [B, P, L] T after the entry, exp(inclusive cumsum of lg)


def _plain_batches(table, tile_starts, tile_counts, grid: TileGrid):
    """K1's per-(pixel, entry) quantities in the JAX kernel's log-space form,
    tile batch by tile batch: each tile's entries [start, start+count) are
    padded to the longest list of the batch, and a batch stays under
    _PLAIN_BATCH_ELEMS elements per intermediate."""
    if grid.tile_size * grid.tile_size != P_PIX:
        raise ValueError("the blend works on 16x16 tiles")
    dev = table.device
    T = grid.num_tiles
    ts = grid.tile_size
    ii = torch.arange(P_PIX, device=dev)
    lx, ly = ii % ts, ii // ts
    counts_host = tile_counts.tolist()
    starts = tile_starts[:T].long()
    counts = tile_counts.long()

    t0 = 0
    while t0 < T:
        t1, longest = t0 + 1, counts_host[t0]
        while t1 < T and (t1 - t0 + 1) * P_PIX * max(longest, counts_host[t1]) <= _PLAIN_BATCH_ELEMS:
            longest = max(longest, counts_host[t1])
            t1 += 1
        if longest > 0:
            tb = torch.arange(t0, t1, device=dev)
            pos = torch.arange(longest, device=dev)
            em = pos[None, :] < counts[t0:t1, None]                     # [B, L]
            idx = torch.where(em, starts[t0:t1, None] + pos[None, :], 0)
            ent = table[:, idx]                                          # [W, B, L]
            px = ((tb % grid.grid_x) * ts)[:, None] + lx[None, :]
            py = ((tb // grid.grid_x) * ts)[:, None] + ly[None, :]
            dx = ent[0][:, None, :] - px.to(torch.float32)[..., None]   # [B, P, L]
            dy = ent[1][:, None, :] - py.to(torch.float32)[..., None]
            ca, cb, cc, op = (ent[r][:, None, :] for r in (2, 3, 4, 5))
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
            power_ok = em[:, None, :] & (power <= 0.0)
            use = power_ok & (alpha >= ALPHA_MIN)
            lg = torch.where(use, torch.log1p(-torch.where(use, alpha, 0.0)), 0.0)
            t_inc = torch.exp(torch.cumsum(lg, dim=-1))
            yield _PlainBatch(t0, t1, ent, em, power_ok, use, alpha, lg, t_inc)
        t0 = t1


def blend_forward_plain(table: torch.Tensor, tile_starts: torch.Tensor,
                        tile_counts: torch.Tensor, grid: TileGrid, n_passes: int):
    """Plain PyTorch K1, in the JAX kernel's log-space form.

    Per (pixel, entry): use = power <= 0 and alpha >= 1/255; l = log1p(-alpha)
    where used; S = inclusive cumsum of l; T_incl = exp(S); an entry
    contributes alpha * T_incl / (1 - alpha) if used and T_incl >= 1e-4
    (monotone in the entry, so this is the sequential stop). Returns
    (colors [n_passes, T, 256, 3], final_t [T, 256], walked [T] int32), as
    the kernel does.
    """
    dev = table.device
    T = grid.num_tiles
    colors = torch.zeros((n_passes, T, P_PIX, 3), dtype=torch.float32, device=dev)
    final_t = torch.ones((T, P_PIX), dtype=torch.float32, device=dev)
    walked = torch.zeros((T,), dtype=torch.int32, device=dev)
    counts = tile_counts.long()
    for b in _plain_batches(table, tile_starts, tile_counts, grid):
        t0, t1 = b.t0, b.t1
        t_at = b.t_inc * (1.0 / torch.where(b.use, 1.0 - b.alpha, 1.0))
        alive = b.t_inc >= T_EPS
        contrib = b.use & alive
        w = torch.where(contrib, b.alpha * t_at, 0.0)
        for i in range(n_passes):
            col = b.ent[6 + 3 * i:9 + 3 * i]                             # [3, B, L]
            # an f32 matmul; TF32 stays off (torch's default for matmul)
            colors[i, t0:t1] = torch.einsum("bpl,cbl->bpc", w, col)
        final_t[t0:t1] = torch.exp(torch.where(contrib, b.lg, 0.0).sum(-1))
        stop = b.use & ~alive
        all_stopped = stop.any(-1).all(-1)
        first_stop = torch.argmax(stop.to(torch.uint8), dim=-1)          # [B, P]
        walked[t0:t1] = torch.where(all_stopped, first_stop.max(-1).values + 1,
                                    counts[t0:t1]).to(torch.int32)
    return colors, final_t, walked


def blend_pair_counts(table: torch.Tensor, tile_starts: torch.Tensor,
                      tile_counts: torch.Tensor, grid: TileGrid) -> Dict[str, int]:
    """The (pixel, entry) pairs K1's function needs on these inputs, by the
    work each needs (from the plain version's masks):

      evaluated    entries up to and including the pixel's own crossing (or
                   all of the tile's): the power and its test;
      exp          evaluated with power <= 0: exp, alpha and its test;
      used         alpha >= 1/255 as well: the T (1 - alpha) test;
      contributing used before the crossing: the weight and each pass's
                   color FMAs.
    """
    out = dict(evaluated=0, exp=0, used=0, contributing=0)
    for b in _plain_batches(table, tile_starts, tile_counts, grid):
        # T before the entry; T only falls, so T_before >= 1e-4 holds up to
        # and including the pixel's crossing entry
        t_before = torch.cat([torch.ones_like(b.t_inc[..., :1]), b.t_inc[..., :-1]], -1)
        ev = b.em[:, None, :] & (t_before >= T_EPS)
        out["evaluated"] += int(ev.sum())
        out["exp"] += int((ev & b.power_ok).sum())
        out["used"] += int((ev & b.use).sum())
        out["contributing"] += int((b.use & (b.t_inc >= T_EPS)).sum())
    return out


_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _kernel():
    lib = _build.load("blend_fwd")
    fn = lib.wg_blend_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def blend_forward(table: torch.Tensor, tile_starts: torch.Tensor,
                  tile_counts: torch.Tensor, grid: TileGrid, n_passes: int):
    """K1: blend every tile's depth-sorted entries for 1-3 color passes.

    table [6 + 3 n_passes, N] f32 (rows x, y, conic a/b/c, opacity, then
    r, g, b per pass); tile_starts [T(+1)] and tile_counts [T] int32.
    Returns (colors [n_passes, T, 256, 3], final_t [T, 256], walked [T]).
    A CPU table runs the plain version; a CUDA table launches the kernel and
    adds one to `blend_forward.launches`.
    """
    if table.device.type == "cpu":
        return blend_forward_plain(table, tile_starts, tile_counts, grid, n_passes)
    if table.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {table.device}")
    T = grid.num_tiles
    if not 1 <= n_passes <= 3:
        raise ValueError(f"blend_forward takes 1-3 color passes, got {n_passes}")
    if grid.tile_size != 16:
        raise ValueError("blend_forward works on 16x16 tiles")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 6 + 3 * n_passes:
        raise ValueError(f"table must be f32 [{6 + 3 * n_passes}, N], got {table.dtype} {tuple(table.shape)}")
    if table.stride(1) != 1:
        raise ValueError("table rows must be contiguous")
    for name, x in (("tile_starts", tile_starts), ("tile_counts", tile_counts)):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.shape[0] < T or x.device != table.device:
            raise ValueError(f"{name} must be a contiguous int32 tensor of >= {T} tiles on {table.device}")
    colors = torch.empty((n_passes, T, P_PIX, 3), dtype=torch.float32, device=table.device)
    final_t = torch.empty((T, P_PIX), dtype=torch.float32, device=table.device)
    walked = torch.empty((T,), dtype=torch.int32, device=table.device)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), tile_starts.data_ptr(),
                 tile_counts.data_ptr(), T, grid.grid_x, n_passes,
                 colors.data_ptr(), final_t.data_ptr(), walked.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {err}")
    blend_forward.launches += 1
    return colors, final_t, walked


blend_forward.launches = 0


def rasterize_multi(mean2d, conic, opacity, colors_list: List[torch.Tensor],
                    pre_depth, pre_rect_min, pre_rect_max, pre_tiles_touched,
                    pre_valid, bg, *, grid: TileGrid,
                    max_tiles_per_gaussian: int = 16, d_small: int = 4,
                    big_fraction: float = 0.16
                    ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Render several color sets over one shared sorted geometry.

    Returns ([(color [H,W,3], final_T [H,W]) per color set], aux): aux
    holds the blend's inputs (`table`, `tile_starts`, `tile_counts`), its
    per-tile `walked` counts and the sort engine's per-Gaussian `vis_count`."""
    n = mean2d.shape[0]
    with span("sort_engine"):
        stack = torch.stack(colors_list)
        st = _build_sorted_table(
            grid, n, max_tiles_per_gaussian, len(colors_list), d_small, big_fraction,
            mean2d, conic, opacity, stack, pre_depth, pre_rect_min, pre_rect_max,
            torch.clamp_max(pre_tiles_touched, max_tiles_per_gaussian), pre_valid)
    with span("blend_kernel"):
        colors, final_t, walked = blend_forward(st.table, st.tile_starts, st.tile_counts,
                                                grid, len(colors_list))
    with span("compose"):
        T_img = tiles_to_image(final_t, grid)
        images = [(tiles_to_image(colors[i] + final_t[..., None] * bg, grid), T_img)
                  for i in range(len(colors_list))]
    aux = {"table": st.table, "tile_starts": st.tile_starts,
           "tile_counts": st.tile_counts, "walked": walked, "vis_count": st.vis_count}
    return images, aux
