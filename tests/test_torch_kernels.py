"""The CUDA kernels against their plain versions on the card: K1 (the blend
forward, its walked counts and its saturation vote; also on a hand-made table of edge cases, with K4 and P1 held
against it and against their plain versions), K2 (its backward, per gradient row within 2e-3 of the row's
largest value: the kernel sums each entry over 256 pixels in another order;
with and without its two abs rows, whose summed rows stay bit for bit
those without them; on a surfel table and on a hand-made one with a long
tile, a mid-chunk exit and the alpha cap), K3 (the tier-2 merge, exactly;
also on hand-made pools with padding, odd lengths, strided rows and no slot),
K4 (the planar static blend: as K1 against its plain version, and equal to
K1 bit for bit with bg = 0), K1 and K2 on bands of the grid at a tile base
(each band's outputs the whole grid's for its tiles, bit for bit, and within
their tolerances of the plain versions at that tile base), K5 and K6 (a radix pass and its inverse: they
only move values, so exactly, pass by pass, also at B = 2, 4, 16, 32 on
key patterns that set K5's runs), P1 (the early-exit probe: its walked counts
equal to K1's, its chunk counts exactly) and P2 (the run scatter, exactly,
on the probe's five configurations, scaled down, and on runs of 1 and 3
columns, runs longer than a block's span and unaligned starts). This file
imports neither JAX nor the test helpers, so that it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py

The test decides in its body whether a card exists and skips without one (a
CUDA kernel has no CPU mode). The wrappers' CPU behaviour is tested in
test_torch_blend_wrapper.py."""
import numpy as np
import pytest
import torch

from wildgaussians_torch.cameras import make_camera_params_torch
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import partition as tpart
from wildgaussians_torch.ops import static_blend as tstatic
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid
from wildgaussians_torch.ops.sort_engine import _build_sorted_table
from wildgaussians_torch.profiles import probe_cfin as tcfin
from wildgaussians_torch.profiles import probe_sortdesign as tsort
from wildgaussians_torch.scenes import make_surfel_scene


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _surfel_table(device, n, width, height, n_passes, seed=0):
    rng = np.random.default_rng(seed)
    f = width / 1.4
    xyz, scales, rots, opac, colors = make_surfel_scene(rng, n, width, height, f)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    pose = torch.eye(4, device=device)[:3]
    cam = make_camera_params_torch(pose, t([f, f, width / 2, height / 2]), width, height)
    pre = preprocess(t(xyz), compute_cov3d(t(scales), t(rots)), t(opac), cam,
                     width, height, 0.1)
    stack = torch.stack([t(colors)] + [t(rng.uniform(0, 1, (n, 3))) for _ in range(n_passes - 1)])
    grid = make_grid(width, height, 16)
    st = _build_sorted_table(grid, n, 16, n_passes, 4, 0.16, pre.mean2d, pre.conic,
                             pre.opacity, stack, pre.depth, pre.rect_min, pre.rect_max,
                             torch.clamp_max(pre.tiles_touched, 16), pre.valid)
    return st, grid


def _check_backward(st, grid, n_passes, dev):
    """K2 on random cotangents and K1's outputs, then K3 on the slot sums."""
    rows = _check_k2(st.table, st.tile_starts, st.tile_counts, grid, n_passes, dev)
    g = torch.Generator(device=dev).manual_seed(n_passes)
    n = st.vis_count.shape[0]
    sums = torch.randn((rows.shape[0], n), generator=g, device=dev)
    bigs = torch.randn((rows.shape[0], st.big_list.shape[0]), generator=g, device=dev)
    before = tblend.tier2_merge.launches
    got = tblend.tier2_merge(sums.clone(), st.big_list, bigs)
    torch.cuda.synchronize()
    assert tblend.tier2_merge.launches == before + 1
    assert int((st.big_list < n).sum()) > 0
    assert torch.equal(got, tblend.tier2_merge_plain(sums.clone(), st.big_list, bigs))


def _check_k3_edges(dev):
    """K3 exactly on hand-made pools: padding indices >= n among the last
    slots, a pool whose length is no multiple of a block's slots, rows that
    lie apart in a wider table (a strided view, as the slot sums are), one
    row, 9 to 15 rows, and an empty pool (sums unchanged)."""
    rng = np.random.default_rng(7)
    for rows, n, m, width in ((13, 5000, 1003, 5000), (15, 7919, 1300, 9000), (1, 300, 37, 300),
                              (9, 4096, 4096, 4100), (4, 100, 0, 100)):
        valid = np.sort(rng.choice(n, size=min(m, n) * 3 // 4, replace=False))
        big_list = np.full(m, n, np.int32)
        big_list[:len(valid)] = valid
        big_list[len(valid):] += np.arange(m - len(valid), dtype=np.int32)   # n, n+1, ...
        table = torch.tensor(rng.normal(size=(rows, width)).astype(np.float32), device=dev)
        sums = table[:, :n]
        bigs = torch.tensor(rng.normal(size=(rows, m)).astype(np.float32), device=dev)
        bl = torch.tensor(big_list, device=dev)
        want = tblend.tier2_merge_plain(sums.clone(), bl, bigs)
        before = tblend.tier2_merge.launches
        got = tblend.tier2_merge(sums, bl, bigs)
        torch.cuda.synchronize()
        # an empty pool merges nothing and launches nothing
        assert got.data_ptr() == table.data_ptr()
        assert tblend.tier2_merge.launches == before + (m > 0)
        assert torch.equal(got, want), (rows, n, m, width)


def _check_k2(table, tile_starts, tile_counts, grid, n_passes, dev):
    """K2 against its plain version on random cotangents and K1's outputs,
    per row within 2e-3 of the row's largest value; with each pass's own
    gt_eff (summing to gte) its two abs rows as well, and its summed rows
    bit for bit those without them. Returns the rows without them."""
    g = torch.Generator(device=dev).manual_seed(n_passes)
    colors, final_t = tblend.blend_forward(table, tile_starts, tile_counts, grid, n_passes)[:2]
    gcol = torch.randn(colors.shape, generator=g, device=dev) * 1e-3
    gte = torch.randn(final_t.shape, generator=g, device=dev) * 1e-3
    args = (table, tile_starts, tile_counts, grid, n_passes, gcol, gte, colors,
            final_t, (0.5 * grid.width, 0.5 * grid.height))
    before = tblend.blend_backward.launches
    rows = tblend.blend_backward(*args)
    torch.cuda.synchronize()
    assert tblend.blend_backward.launches == before + 1 and rows.device.type == "cuda"
    plain = tblend.blend_backward_plain(*args)
    rel = (rows - plain).abs().amax(1) / torch.clamp_min(plain.abs().amax(1), 1e-30)
    assert torch.isfinite(rows).all() and rel.max().item() <= 2e-3, f"{n_passes} passes: {rel}"
    gte_pass = torch.randn((n_passes,) + final_t.shape, generator=g, device=dev) * 1e-3
    gte_pass[-1] = gte - gte_pass[:-1].sum(0)
    with_abs = tblend.blend_backward(*args, gte_pass.contiguous())
    plain_abs = tblend.blend_backward_plain(*args, gte_pass)
    torch.cuda.synchronize()
    assert with_abs.shape[0] == tblend.grad_rows(n_passes, True) == rows.shape[0] + 2
    assert torch.equal(with_abs[:rows.shape[0]], rows), "the summed rows must not move"
    rel = (with_abs - plain_abs).abs().amax(1) / torch.clamp_min(plain_abs.abs().amax(1), 1e-30)
    assert rel.max().item() <= 2e-3, f"{n_passes} passes, abs rows: {rel}"
    return rows


def _check_k2_edges(dev):
    """K2 on a hand-made 32x32 table of four tiles: tile 0 holds 200 entries
    (over three of K2's 64-entry chunks), among them one at the 0.99 alpha
    cap on the pixels around (7, 7), and all its pixels stop inside its
    third chunk (a mid-chunk early exit); tile 1 holds 30, tile 2 none and
    tile 3 100 faint entries that never stop a pixel."""
    rng = np.random.default_rng(11)
    grid = make_grid(32, 32, 16)
    counts = [200, 30, 0, 100]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols = []
    for t, (n, op, sigma) in enumerate(zip(counts, (0.065, 0.3, 0.0, 0.02), (100, 4, 1, 3))):
        ox, oy = 16 * (t % 2), 16 * (t // 2)
        x, y = ox + rng.uniform(0, 16, n), oy + rng.uniform(0, 16, n)
        a = np.full(n, 1.0 / sigma ** 2)
        opac = np.full(n, op)
        if t == 0:
            x[:4], y[:4] = 7.5, 7.5
            opac[:3], a[:4] = 0.1, 1.0 / 64
            x[3], y[3], opac[3] = 7.0, 7.0, 1.0        # alpha = min(0.99, 1.0) at (7, 7)
        cols.append(np.stack([x, y, a, np.zeros(n), a, opac]))
    geo = np.concatenate(cols, 1).astype(np.float32)
    st = torch.tensor(starts, device=dev)
    ct = torch.tensor(np.asarray(counts, np.int32), device=dev)
    for n_passes in (1, 2, 3):
        rgb = rng.uniform(0, 1, (3 * n_passes, geo.shape[1])).astype(np.float32)
        table = torch.tensor(np.concatenate([geo, rgb]), device=dev)
        walked = tblend.blend_forward(table, st, ct, grid, n_passes)[2].tolist()
        assert 128 < walked[0] < 192 and walked[0] % 64, walked    # exits in its third chunk
        assert walked[3] == counts[3], walked
        _check_k2(table, st, ct, grid, n_passes, dev)


def _check_fwd_edges(dev):
    """K1, K4 and P1 on a hand-made 48x32 table of six tiles, against their
    plain versions and each other (K4 at bg 0 is K1 bit for bit, P1's
    walked counts are K1's), and K2 on it against its plain version. Tile 0
    holds 200 entries that stop every pixel inside the forward walk's first
    256-entry chunk (a mid-chunk exit), and early in its list three edge
    entries: one whose alpha reaches 1/255 on warp 0's 8x4 block only at
    its border pixel (7, 2), 5 % above the floor; one with a degenerate
    conic (ca <= 0); one with a NaN opacity (never used). Tile 1 holds 30
    entries, tile 2 none, tile 3 400 that stop every pixel in the second
    chunk, tile 4 5, tile 5 300 faint ones that never stop a pixel: the
    longest-first order (3, 5, 0, 1, 4, 2) is not raster order. K2 runs on
    the table with the NaN opacity set to 0 (its plain version's rows are
    NaN there: dalpha 0 times alpha NaN)."""
    rng = np.random.default_rng(12)
    grid = make_grid(48, 32, 16)
    counts = [200, 30, 0, 400, 5, 300]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols = []
    for t, (n, op, sigma) in enumerate(zip(counts, (0.065, 0.3, 0.0, 0.03, 0.5, 0.01),
                                           (100, 4, 1, 100, 3, 50))):
        ox, oy = 16 * (t % 3), 16 * (t // 3)
        x, y = ox + rng.uniform(0, 16, n), oy + rng.uniform(0, 16, n)
        a, b, c = np.full(n, 1.0 / sigma ** 2), np.zeros(n), np.full(n, 1.0 / sigma ** 2)
        opac = np.full(n, op)
        if t == 0:
            # alpha = op exp(-0.5 * 1.4^2 / 0.25) = 1.05 / 255 at (7, 2), below
            # the floor at every other pixel of warp 0
            x[1], y[1], a[1], c[1] = 8.4, 2.0, 4.0, 4.0
            opac[1] = 1.05 / 255.0 * np.exp(0.5 * 1.96 * 4.0)
            x[2], y[2], a[2], b[2], c[2], opac[2] = 5.0, 9.0, -0.1, 0.02, 0.5, 0.6
            x[3], y[3], opac[3] = 4.0, 4.0, np.nan
        cols.append(np.stack([x, y, a, b, c, opac]))
    geo = np.concatenate(cols, 1).astype(np.float32)
    st = torch.tensor(starts, device=dev)
    ct = torch.tensor(np.asarray(counts, np.int32), device=dev)
    assert tblend.tile_order(ct, grid.num_tiles).tolist() == [3, 5, 0, 1, 4, 2]
    for n_passes in (1, 2, 3):
        rgb = rng.uniform(0, 1, (3 * n_passes, geo.shape[1])).astype(np.float32)
        table = torch.tensor(np.concatenate([geo, rgb]), device=dev)
        kc, kt, kw, ks = tblend.blend_forward(table, st, ct, grid, n_passes)
        pc, pt, pw, ps = tblend.blend_forward_plain(table, st, ct, grid, n_passes)
        zero = tstatic.blend_forward_planar(table, st, ct, grid, n_passes,
                                            torch.zeros(3, device=dev))
        bg = torch.tensor([0.3, 0.6, 0.9], device=dev)
        planar = tstatic.blend_forward_planar(table, st, ct, grid, n_passes, bg)
        probe = tcfin.probe_cfin(table, st, ct, grid)
        torch.cuda.synchronize()
        err = torch.maximum((kc - pc).abs().amax(dim=(0, 3)), (kt - pt).abs())
        assert err.max().item() <= 1e-4, (n_passes, err.max().item())
        walked = kw.tolist()
        assert walked == pw.tolist(), (walked, pw.tolist())
        assert 3 < walked[0] < 200 and 256 < walked[3] < 400, walked
        assert walked[1:3] + walked[4:] == [30, 0, 5, 300], walked
        # the saturation vote: tiles 0 and 3 stop every pixel; tile 2 has no
        # entries, and tiles 4 and 5 stop none
        sat = ks.tolist()
        assert sat == ps.tolist() and sat[0] == sat[3] == 1 and sat[2] == sat[4] == sat[5] == 0, \
            (sat, ps.tolist())
        assert (kt[2] == 1.0).all() and (kc[:, 2] == 0).all()           # no entries
        plain_planar = tstatic.blend_forward_planar_plain(table, st, ct, grid, n_passes, bg)
        assert (planar - plain_planar).abs().max().item() <= 1e-4
        assert torch.equal(zero[:, :3], kc.permute(0, 3, 1, 2))
        assert torch.equal(zero[:, 3], kt[None].expand(n_passes, -1, -1))
        assert torch.equal(probe[:, 2], kw)
        assert torch.equal(probe, tcfin.probe_cfin_plain(table, st, ct, grid))
        finite = table.clone()
        finite[5, 3] = 0.0
        _check_k2(finite, st, ct, grid, n_passes, dev)
    # the border entry alone: K1 uses it at (7, 2) and at no other pixel of
    # warp 0 (nor elsewhere in the tile), as the plain version does
    one = torch.tensor(np.concatenate([geo[:, 1:2], np.ones((3, 1), np.float32)]), device=dev)
    one_st = torch.tensor([0, 1, 1, 1, 1, 1, 1], dtype=torch.int32, device=dev)
    one_ct = torch.tensor([1, 0, 0, 0, 0, 0], dtype=torch.int32, device=dev)
    kc, kt = tblend.blend_forward(one, one_st, one_ct, grid, 1)[:2]
    pc, pt = tblend.blend_forward_plain(one, one_st, one_ct, grid, 1)[:2]
    torch.cuda.synchronize()
    used = (kt[0] < 1.0).nonzero().flatten().tolist()
    assert used == (pt[0] < 1.0).nonzero().flatten().tolist() and 2 * 16 + 7 in used, used
    assert all(p % 16 >= 7 for p in used) and (kc - pc).abs().max().item() <= 1e-6


def _check_radix(dev):
    """K5 and K6 against their plain versions, pass by pass, on tables with
    invalid keys and a pure-sentinel stretch: a small base, the engine's
    tile partition (key row 1, a tail) and its depth presort; then on the
    key patterns of _radix_patterns at B = 2, 4, 16 and 32."""
    rng = np.random.default_rng(3)
    for nb, B, E, R, rows, key_row, tail in ((37, 4, 32, 5_024, 8, 0, 0),
                                             (3_601, 16, 256, 300_032, 14, 1, 512),
                                             ((1 << 24) - 1, 16, 256, 70_144, 18, 0, 0)):
        keys = rng.integers(0, nb, R).astype(np.float32)
        keys[rng.random(R) < 0.2] = nb + 2
        keys[R // 3:R // 3 + 3 * E] = nb + 5
        _check_radix_case(dev, rng, nb, B, E, keys, rows, key_row, tail)
    for B in (2, 4, 16, 32):
        nb = B * B - 1                               # two passes
        for R in (9_000, 1_000):                     # not a multiple of a chunk; under one
            for name, keys in _radix_patterns(rng, nb, B, R):
                _check_radix_case(dev, rng, nb, B, 8, keys, 20, 1, 16, (B, R, name))


def _radix_patterns(rng, nb, B, R):
    """Key patterns that set K5's runs: random keys; one key (every digit
    one run per block); alternating digits (runs of one column); and keys
    that are mostly the sentinel."""
    mostly = rng.integers(0, nb, R).astype(np.float32)
    mostly[rng.random(R) < 0.9] = nb + 3
    return (("random", rng.integers(0, nb, R).astype(np.float32)),
            ("one digit", np.full(R, nb // 2, np.float32)),
            ("alternating", (np.arange(R) % B).astype(np.float32)),
            ("mostly sentinel", mostly))


def _check_radix_case(dev, rng, nb, B, E, keys, rows, key_row, tail, label=None):
    """One table of `rows` rows (more than the kernel stages at once) keyed
    by `keys` in row `key_row`: K5 bit for bit against its plain version
    pass by pass (output and bases) and K6 on each pass; then the whole
    partition on the card and its round trip."""
    label = label or nb
    R = keys.shape[0]
    table = torch.tensor(rng.uniform(-5, 5, (rows, R)).astype(np.float32), device=dev)
    table[key_row] = torch.tensor(keys, device=dev)
    L = tpart.num_passes(nb, B)
    sentinel = B ** L - 1
    cur = table
    k = torch.where(cur[key_row] >= nb, float(sentinel), cur[key_row])
    for p in range(L):
        r_out = cur.shape[1] + B * E + (tail if p == L - 1 else 0)
        kw = dict(B=B, E=E, key_row=key_row, sentinel=sentinel, R_out=r_out)
        before = (tpart.radix_pass.launches, tpart.radix_unpass.launches)
        out, bases = tpart.radix_pass(cur, k, p, **kw)
        want, want_bases = tpart.radix_pass_plain(cur, k, p, **kw)
        gin = torch.randn((13, r_out), device=dev)
        back = tpart.radix_unpass(gin, k, p, bases, B=B, E=E, sentinel=sentinel)
        torch.cuda.synchronize()
        assert (tpart.radix_pass.launches, tpart.radix_unpass.launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(bases, want_bases) and torch.equal(out, want), (label, p)
        assert torch.equal(back, tpart.radix_unpass_plain(gin, k, p, bases, B=B, E=E,
                                                          sentinel=sentinel)), (label, p)
        cur, k = out, out[key_row].clone()
    # the whole partition on the card and its round trip
    out, meta = tpart.radix_partition(table, nb, B=B, E=E, key_row=key_row, tail_pad=tail)
    starts, counts = tpart.bucket_ranges(meta)
    assert int(counts.sum()) == int((table[key_row] < nb).sum())
    back = tpart.radix_unpartition(out, meta)
    valid = table[key_row] < nb
    assert torch.equal(back[:, valid], table[:, valid])


@pytest.mark.gpu
def test_blend_kernel_matches_plain_on_card():
    dev = _card()
    for n_passes in (1, 2, 3):
        st, grid = _surfel_table(dev, 100_000, 256, 192, n_passes)   # ~2 Gaussians per pixel
        before = tblend.blend_forward.launches
        kc, kt, kw, ks = tblend.blend_forward(st.table, st.tile_starts, st.tile_counts, grid,
                                              n_passes)
        torch.cuda.synchronize()
        assert tblend.blend_forward.launches == before + 1
        assert kc.device.type == "cuda"
        pc, pt, pw, ps = tblend.blend_forward_plain(st.table, st.tile_starts, st.tile_counts,
                                                    grid, n_passes)
        err = torch.maximum((kc - pc).abs().amax(dim=(0, 3)), (kt - pt).abs())
        assert err.max().item() <= 5e-3, f"{n_passes} passes"
        assert (err > 1e-4).float().mean().item() <= 1e-4, f"{n_passes} passes"
        assert torch.all(kw <= st.tile_counts) and int((kw != pw).sum()) <= 2
        # the saturation vote: equal wherever the walked counts are
        assert torch.equal(ks[kw == pw], ps[kw == pw])
        assert int((kw < st.tile_counts).sum()) > 0    # some tiles exit early
        _check_planar(st, grid, n_passes, dev, (kc, kt))
        _check_backward(st, grid, n_passes, dev)
        _check_tile_base(st, grid, n_passes, dev, (kc, kt, kw, ks))
        if n_passes == 1:
            _check_probe(st, grid, kw)
    _check_k2_edges(dev)
    _check_fwd_edges(dev)
    _check_radix(dev)
    _check_k3_edges(dev)
    _check_run_scatter(dev)


def _check_tile_base(st, grid, n_passes, dev, k1_out):
    """K1 and K2 on bands of the grid at a tile base (the sharded engines'
    calls, 3 bands of 64 tiles): each band's outputs are the whole grid's
    for its tiles, bit for bit (each tile's work is the same), and within
    K1's and K2's tolerances of their plain versions at that tile base."""
    T, D = grid.num_tiles, 3
    T_band = -(-T // D)
    g = torch.Generator(device=dev).manual_seed(11)
    gcol = torch.randn(k1_out[0].shape, generator=g, device=dev) * 1e-3
    gte = torch.randn(k1_out[1].shape, generator=g, device=dev) * 1e-3
    ndc = (0.5 * grid.width, 0.5 * grid.height)
    whole = tblend.blend_backward(st.table, st.tile_starts, st.tile_counts, grid, n_passes, gcol,
                                  gte, k1_out[0], k1_out[1], ndc)
    for t0 in range(T_band, T, T_band):          # the bands after the first
        t1 = min(t0 + T_band, T)
        nt = t1 - t0
        starts = st.tile_starts[t0:t1 + 1].contiguous()
        counts = st.tile_counts[t0:t1].contiguous()
        before = (tblend.blend_forward.launches, tblend.blend_backward.launches)
        band = tblend.blend_forward(st.table, starts, counts, grid, n_passes, tile_base=t0,
                                    num_tiles=nt)
        for got, want in zip(band, k1_out):
            assert torch.equal(got, want[:, t0:t1] if got.dim() == 4 else want[t0:t1]), t0
        plain = tblend.blend_forward_plain(st.table, starts, counts, grid, n_passes,
                                           tile_base=t0, num_tiles=nt)
        err = torch.maximum((band[0] - plain[0]).abs().amax(dim=(0, 3)),
                            (band[1] - plain[1]).abs())
        assert err.max().item() <= 5e-3 and (err > 1e-4).float().mean().item() <= 1e-4, t0
        args = (st.table, starts, counts, grid, n_passes, gcol[:, t0:t1].contiguous(),
                gte[t0:t1].contiguous(), band[0], band[1], ndc)
        rows = tblend.blend_backward(*args, tile_base=t0, num_tiles=nt)
        torch.cuda.synchronize()
        assert (tblend.blend_forward.launches, tblend.blend_backward.launches) == \
            (before[0] + 1, before[1] + 1)
        lo, hi = int(starts[0]), int(starts[-1])
        assert torch.equal(rows[:, lo:hi], whole[:, lo:hi]), t0
        assert int(rows[:, :lo].abs().sum() + rows[:, hi:].abs().sum()) == 0
        plain_rows = tblend.blend_backward_plain(*args, tile_base=t0)
        rel = (rows - plain_rows).abs().amax(1) / torch.clamp_min(
            plain_rows.abs().amax(1), 1e-30)
        assert rel.max().item() <= 2e-3, f"band at {t0}: {rel}"


def _check_planar(st, grid, n_passes, dev, k1_out):
    """K4 against its plain version, as K1; with bg = 0 its planes are K1's
    colors and final T bit for bit."""
    bg = torch.tensor([0.3, 0.6, 0.9], device=dev)
    before = tstatic.blend_forward_planar.launches
    out = tstatic.blend_forward_planar(st.table, st.tile_starts, st.tile_counts, grid, n_passes,
                                       bg)
    zero = tstatic.blend_forward_planar(st.table, st.tile_starts, st.tile_counts, grid,
                                        n_passes, torch.zeros(3, device=dev))
    torch.cuda.synchronize()
    assert tstatic.blend_forward_planar.launches == before + 2
    plain = tstatic.blend_forward_planar_plain(st.table, st.tile_starts, st.tile_counts, grid,
                                               n_passes, bg)
    err = (out - plain).abs().amax(dim=(0, 1))
    assert err.max().item() <= 5e-3 and (err > 1e-4).float().mean().item() <= 1e-4
    kc, kt = k1_out
    assert torch.equal(zero[:, :3], kc.permute(0, 3, 1, 2))
    assert torch.equal(zero[:, 3], kt[None].expand(n_passes, -1, -1))


def _check_probe(st, grid, k1_walked):
    """P1: K1's walked counts, and the chunk counts they imply."""
    before = tcfin.probe_cfin.launches
    out = tcfin.probe_cfin(st.table, st.tile_starts, st.tile_counts, grid)
    torch.cuda.synchronize()
    assert tcfin.probe_cfin.launches == before + 1
    assert torch.equal(out[:, 2], k1_walked)
    assert torch.equal(out[:, 1], (st.tile_counts + 255) // 256)
    assert torch.equal(out[:, 0], (k1_walked + 255) // 256)
    plain = tcfin.probe_cfin_plain(st.table, st.tile_starts, st.tile_counts, grid)
    assert (out != plain).any(dim=1).float().mean().item() <= 1e-3


def _check_run_scatter(dev):
    """P2 on the probe's five configurations with C cut by 16, exactly; a
    misaligned start takes the word path."""
    for C, K, E, run in tsort.SCATTER_CONFIGS:
        C = max(C // 16, 2)
        src, starts = tsort.scatter_inputs(C, K, E, run, dev)
        if E > 1:
            starts[1] += 3
        before = tsort.run_scatter.launches
        got = tsort.run_scatter(src, starts, E, run)
        torch.cuda.synchronize()
        assert tsort.run_scatter.launches == before + 1
        assert torch.equal(got, tsort.run_scatter_plain(src, starts, E, run)), (C, E, run)
    # runs shorter than 4 columns, runs longer than a block's 4,096 columns
    # per pass, starts at every residue mod 4, an odd run length (no row of
    # dst 16-byte aligned after the first)
    rng = np.random.default_rng(3)
    for C, K, E, run in ((64, 8, 2, 3), (5, 40_000, 2, 10_001), (16, 600, 3, 150),
                         (4, 64, 8, 1)):
        src, _ = tsort.scatter_inputs(C, K, E, run, dev)
        starts = torch.tensor(rng.integers(0, C * K + K - run, C * E).astype(np.int32), device=dev)
        got = tsort.run_scatter(src, starts, E, run)
        torch.cuda.synchronize()
        assert torch.equal(got, tsort.run_scatter_plain(src, starts, E, run)), (C, E, run)
