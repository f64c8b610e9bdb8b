"""The tiled differentiable blend (plain torch forward, hand-derived
backward), its blend constants and the 16x16 tile grid helpers.

Counterpart of `wildgaussians_tpu/ops/rasterize_tiled.py`, the JAX package's
XLA path: plain torch is its port. Alpha compositing is associative in
(log T, premultiplied color) form, so each tile's depth-sorted list is
processed in chunks of K entries where

    l_k      = log(1 - alpha_k)                   (0 for skipped entries)
    S_k      = cumsum(l)
    T_k      = T_in exp(S_k - l_k)                 (exclusive transmittance)
    contrib  = alpha >= 1/255 & power <= 0 & T_in exp(S_k) >= 1e-4 & ~done
    color   += (alpha T_k contrib)^T colors

the reference loop's skip, cap and stop semantics. The backward
(`_TileBlend.backward`) runs the forward recurrence again and forms the
suffix terms from the saved output, accumulating per-Gaussian gradients
with index_add_; the GOF abs-gradient channels (sum|dx|, sum|dy| of the
per-pixel mean gradients) are the cotangent of a zero `absgrad_hook`
input. Tiles go in batches, chunks in a loop that ends once every pixel of
the batch has stopped.
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class TileGrid(NamedTuple):
    width: int
    height: int
    tile_size: int
    grid_x: int
    grid_y: int

    @property
    def num_tiles(self):
        return self.grid_x * self.grid_y

    @property
    def pixels_per_tile(self):
        return self.tile_size * self.tile_size


def make_grid(width: int, height: int, tile_size: int = 16) -> TileGrid:
    return TileGrid(width, height, tile_size,
                    (width + tile_size - 1) // tile_size,
                    (height + tile_size - 1) // tile_size)


def tiles_to_image(tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[T, P(, C)] -> [H, W(, C)] crop."""
    ts = grid.tile_size
    ch = tiles.shape[2:]
    x = tiles.reshape(grid.grid_y, grid.grid_x, ts, ts, *ch)
    x = torch.movedim(x, 2, 1).reshape(grid.grid_y * ts, grid.grid_x * ts, *ch)
    return x[:grid.height, :grid.width]


def image_to_tiles(img: torch.Tensor, grid: TileGrid, fill=0.0) -> torch.Tensor:
    """[H, W(, C)] -> [T, P(, C)] with padding."""
    ts = grid.tile_size
    ch = img.shape[2:]
    ph, pw = grid.grid_y * ts, grid.grid_x * ts
    # F.pad takes (last dim lo, hi, ..., first dim lo, hi)
    pad = [0, 0] * len(ch) + [0, pw - img.shape[1], 0, ph - img.shape[0]]
    img = F.pad(img, pad, value=fill)
    x = img.reshape(grid.grid_y, ts, grid.grid_x, ts, *ch)
    x = torch.movedim(x, 1, 2).reshape(grid.num_tiles, ts * ts, *ch)
    return x


def _tile_pixel_coords(grid: TileGrid, tile_ids: torch.Tensor):
    """Pixel coordinates of a batch of tiles: x, y [B, P] f32."""
    ts = grid.tile_size
    oy = (tile_ids // grid.grid_x) * ts
    ox = (tile_ids % grid.grid_x) * ts
    ii = torch.arange(ts * ts, dtype=torch.int64, device=tile_ids.device)
    px = ox[:, None] + (ii % ts)[None, :]
    py = oy[:, None] + (ii // ts)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _chunk_alpha(xy, con, op, em, px, py):
    """Per-chunk alpha and use [B, K, P] (and dx, dy). xy [B,K,2], con
    [B,K,3], op [B,K], em [B,K] entry mask, px/py [B,P]."""
    dx = xy[..., 0][:, :, None] - px[:, None, :]
    dy = xy[..., 1][:, :, None] - py[:, None, :]
    a = con[..., 0][:, :, None]
    b = con[..., 1][:, :, None]
    c = con[..., 2][:, :, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(op[:, :, None] * torch.exp(power), ALPHA_MAX)
    use = em[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    return alpha, use, dx, dy


def _gather_chunk(mean2d, conic, opacity, colors, sorted_gidx, starts, counts, c: int, K: int):
    """Chunk c of each tile's entry list: the attributes, the mask [B,K] and
    the Gaussian of each entry."""
    R = sorted_gidx.shape[0]
    offs = c * K + torch.arange(K, dtype=torch.int64, device=starts.device)[None, :]
    e = starts[:, None].long() + offs
    em = offs < counts[:, None]
    g = sorted_gidx[torch.clamp(e, 0, R - 1)].long()
    return mean2d[g], conic[g], opacity[g], colors[g], em, g


def _chunk_weights(alpha, use, T, done):
    """The chunk's compositing terms: l, T_at, alive, contrib, w [B,K,P]."""
    l = torch.where(use, torch.log1p(-torch.where(use, alpha, 0.0)), 0.0)
    S = torch.cumsum(l, dim=1)
    T_at = T[:, None, :] * torch.exp(S - l)
    alive = T[:, None, :] * torch.exp(S) >= T_EPS
    contrib = use & alive & ~done[:, None, :]
    w = torch.where(contrib, alpha * T_at, 0.0)
    return l, T_at, alive, contrib, w


def _max_chunks(counts: torch.Tensor, K: int) -> int:
    return (int(counts.max()) + K - 1) // K if counts.numel() else 0


def _blend_fwd_batch(mean2d, conic, opacity, colors, sorted_gidx, starts, counts, px, py, K):
    """Forward compositing of one batch of tiles: C [B,P,3], T [B,P]."""
    B, P = px.shape
    dev = px.device
    C = torch.zeros((B, P, 3), dtype=torch.float32, device=dev)
    T = torch.ones((B, P), dtype=torch.float32, device=dev)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for c in range(_max_chunks(counts, K)):
        if bool(done.all()):
            break
        xy, con, op, col, em, _g = _gather_chunk(mean2d, conic, opacity, colors, sorted_gidx,
                                                 starts, counts, c, K)
        alpha, use, _dx, _dy = _chunk_alpha(xy, con, op, em, px, py)
        l, _T_at, alive, contrib, w = _chunk_weights(alpha, use, T, done)
        C = C + torch.einsum("bkp,bkc->bpc", w, col)
        T = T * torch.exp(torch.where(contrib, l, 0.0).sum(1))
        done = done | (~alive & use).any(1)
    return C, T


def _blend_bwd_batch(mean2d, conic, opacity, colors, sorted_gidx, starts, counts, px, py, K,
                     out_nobg, final_T, gC, gT_eff, grads):
    """Backward of one tile batch, accumulated into `grads` (dmean2d,
    dconic, dopacity, dcolors, dabs, each with one extra dropped row).
    gC [B,P,3] is the cotangent of the color without the background,
    gT_eff [B,P] that of final_T plus gC . bg."""
    B, P = px.shape
    dev = px.device
    n = mean2d.shape[0]
    dmean2d, dconic, dopacity, dcolors, dabs = grads
    out_dot_g = (out_nobg * gC).sum(-1)
    T = torch.ones((B, P), dtype=torch.float32, device=dev)
    acc_dot = torch.zeros((B, P), dtype=torch.float32, device=dev)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for c in range(_max_chunks(counts, K)):
        if bool(done.all()):
            break
        xy, con, op, col, em, g = _gather_chunk(mean2d, conic, opacity, colors, sorted_gidx,
                                                starts, counts, c, K)
        alpha, use, dx, dy = _chunk_alpha(xy, con, op, em, px, py)
        l, T_at, alive, contrib, w = _chunk_weights(alpha, use, T, done)

        cg = torch.einsum("bkc,bpc->bkp", col, gC)          # c_k . g_p
        wcg = w * cg
        prefix = torch.cumsum(wcg, dim=1) + acc_dot[:, None, :]
        suffix = out_dot_g[:, None, :] - prefix             # sum_{j>k} w_j c_j . g
        one_m_a = torch.where(use, 1.0 - alpha, 1.0)
        dalpha = torch.where(
            contrib, T_at * cg - (suffix + gT_eff[:, None, :] * final_T[:, None, :]) / one_m_a,
            0.0)
        dcol_e = torch.einsum("bkp,bpc->bkc", w, gC)

        dalpha_eff = torch.where(alpha >= ALPHA_MAX, 0.0, dalpha)   # the cap holds alpha
        epow = torch.where(use, alpha / torch.where(use, op[:, :, None], 1.0), 0.0)
        dop_e = (dalpha_eff * epow).sum(2)
        dpower = dalpha_eff * alpha
        A = con[..., 0][:, :, None]
        Bc = con[..., 1][:, :, None]
        Cc = con[..., 2][:, :, None]
        dmx_pix = dpower * (-(A * dx + Bc * dy))
        dmy_pix = dpower * (-(Cc * dy + Bc * dx))
        # per-axis |grad| channels: the caller applies the NDC factors
        dabs_e = torch.stack([dmx_pix.abs().sum(2), dmy_pix.abs().sum(2)], -1)
        da = (dpower * (-0.5 * dx * dx)).sum(2)
        db = (dpower * (-dx * dy)).sum(2)
        dc = (dpower * (-0.5 * dy * dy)).sum(2)

        gm = torch.where(em, g, n).reshape(-1)               # row n is dropped
        dmean2d.index_add_(0, gm, torch.stack([dmx_pix.sum(2), dmy_pix.sum(2)], -1).reshape(-1, 2))
        dconic.index_add_(0, gm, torch.stack([da, db, dc], -1).reshape(-1, 3))
        dopacity.index_add_(0, gm, dop_e.reshape(-1))
        dcolors.index_add_(0, gm, torch.where(em[..., None], dcol_e, 0.0).reshape(-1, 3))
        dabs.index_add_(0, gm, torch.where(em[..., None], dabs_e, 0.0).reshape(-1, 2))

        T = T * torch.exp(torch.where(contrib, l, 0.0).sum(1))
        acc_dot = acc_dot + wcg.sum(1)
        done = done | (~alive & use).any(1)


class _TileBlend(torch.autograd.Function):
    """The tile blend with its hand-derived backward (the JAX package's
    custom_vjp of `_make_tile_blend`). Returns C [T,P,3] with the
    background and final_T [T,P]."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors, absgrad_hook, bg, sorted_gidx,
                tile_starts, tile_counts, grid: TileGrid, K: int, batch_tiles: int):
        del absgrad_hook   # its gradient is the abs channels
        T_tiles = grid.num_tiles
        C = torch.empty((T_tiles, grid.pixels_per_tile, 3), dtype=torch.float32,
                        device=mean2d.device)
        T = torch.empty((T_tiles, grid.pixels_per_tile), dtype=torch.float32,
                        device=mean2d.device)
        for t0 in range(0, T_tiles, batch_tiles):
            ids = torch.arange(t0, min(t0 + batch_tiles, T_tiles), device=mean2d.device)
            px, py = _tile_pixel_coords(grid, ids)
            C[ids], T[ids] = _blend_fwd_batch(mean2d, conic, opacity, colors, sorted_gidx,
                                              tile_starts[ids], tile_counts[ids], px, py, K)
        C = C + T[..., None] * bg[None, None, :]
        ctx.save_for_backward(mean2d, conic, opacity, colors, sorted_gidx, tile_starts,
                              tile_counts, bg, C, T)
        ctx.grid, ctx.K, ctx.batch_tiles = grid, K, batch_tiles
        return C, T

    @staticmethod
    def backward(ctx, gC, gT):
        (mean2d, conic, opacity, colors, sorted_gidx, tile_starts, tile_counts, bg, C_out,
         final_T) = ctx.saved_tensors
        grid, K = ctx.grid, ctx.K
        n = mean2d.shape[0]
        dev = mean2d.device
        out_nobg = C_out - final_T[..., None] * bg[None, None, :]
        # the final_T cotangent with the background's path
        gT_eff = gT + torch.einsum("tpc,c->tp", gC, bg)
        grads = (torch.zeros((n + 1, 2), device=dev), torch.zeros((n + 1, 3), device=dev),
                 torch.zeros((n + 1,), device=dev), torch.zeros((n + 1, 3), device=dev),
                 torch.zeros((n + 1, 2), device=dev))
        for t0 in range(0, grid.num_tiles, ctx.batch_tiles):
            ids = torch.arange(t0, min(t0 + ctx.batch_tiles, grid.num_tiles), device=dev)
            px, py = _tile_pixel_coords(grid, ids)
            _blend_bwd_batch(mean2d, conic, opacity, colors, sorted_gidx, tile_starts[ids],
                             tile_counts[ids], px, py, K, out_nobg[ids], final_T[ids], gC[ids],
                             gT_eff[ids], grads)
        dmean2d, dconic, dopacity, dcolors, dabs = (x[:n] for x in grads)
        dbg = torch.einsum("tpc,tp->c", gC, final_T)
        return (dmean2d, dconic, dopacity, dcolors, dabs, dbg,
                None, None, None, None, None, None)


def _make_tile_blend(grid: TileGrid, K: int, batch_tiles: int):
    """The tile blend for one grid and chunking: blend(mean2d, conic,
    opacity, colors, absgrad_hook, sorted_gidx, tile_starts, tile_counts,
    bg) -> (C [T,P,3] with the background, final_T [T,P])."""
    def tile_blend(mean2d, conic, opacity, colors, absgrad_hook, sorted_gidx, tile_starts,
                   tile_counts, bg):
        return _TileBlend.apply(mean2d, conic, opacity, colors, absgrad_hook, bg, sorted_gidx,
                                tile_starts, tile_counts, grid, K, batch_tiles)
    return tile_blend


def rasterize_tiled(mean2d, conic, opacity, colors, absgrad_hook, sorted_gidx, tile_starts,
                    tile_counts, bg, *, grid: TileGrid, chunk: int = 256, batch_tiles: int = 64):
    """Blend pre-binned Gaussians into an image: (color [H,W,3] with the
    background, final_T [H,W]). Gradients reach mean2d, conic, opacity,
    colors and bg; `absgrad_hook` ([N,2] zeros) receives the GOF
    abs-gradient channels (sum|d/dx|, sum|d/dy|) as its gradient."""
    blend = _make_tile_blend(grid, chunk, batch_tiles)
    C, T = blend(mean2d, conic, opacity, colors, absgrad_hook, sorted_gidx, tile_starts,
                 tile_counts, bg)
    return tiles_to_image(C, grid), tiles_to_image(T, grid)
