"""The blend's needed pairs and entries, as the reference's vectorised walk
counts them, against a pixel-by-pixel walk of the same entries; and the
operation counts built on them."""
import math

import torch

import work
from reference import render as R


def tiny_scene(n=300, seed=3):
    g = torch.Generator().manual_seed(seed)
    z = torch.rand(n, generator=g) * 6 + 2
    xyz = torch.stack([(torch.rand(n, generator=g) - 0.5) * z * 0.9,
                       (torch.rand(n, generator=g) - 0.5) * z * 0.6, z], 1)
    state = {"xyz": xyz, "features_dc": torch.randn(n, 3, generator=g) * 0.5,
             "features_rest": torch.randn(n, 45, generator=g) * 0.02,
             "scales": torch.log(z[:, None] / 50 * (torch.rand(n, 3, generator=g) * 3 + 0.5)),
             "rotations": torch.randn(n, 4, generator=g),
             "opacities": torch.randn(n, 1, generator=g) * 2 + 1}
    cam = R.camera(torch.eye(4)[:3], (40.0, 40.0, 24.0, 16.0), (48, 32), (48, 32))
    return state, cam


def brute_force(pr, colours, bins, grid):
    gx, _gy = grid
    pairs, entries, img = 0, 0, {}
    for t in range(len(bins.starts) - 1):
        ent = bins.gauss[bins.starts[t]:bins.starts[t + 1]].tolist()
        needed = set()
        for p in range(256):
            x = (t % gx) * 16 + p % 16
            y = (t // gx) * 16 + p // 16
            T, c = 1.0, torch.zeros(3)
            for k, gi in enumerate(ent):
                dx = float(pr.mean2d[gi, 0]) - x
                dy = float(pr.mean2d[gi, 1]) - y
                a, b, cc = (float(v) for v in pr.conic[gi])
                power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
                alpha = min(0.99, float(pr.opacity[gi]) * math.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                c += colours[gi] * alpha * T
                T *= 1 - alpha
                pairs += 1
                needed.add(k)
            img[(x, y)] = c
        entries += len(needed)
    return pairs, entries, img


def test_needed_pairs_and_entries_match_a_pixel_walk():
    state, cam = tiny_scene()
    filt = torch.full((state["xyz"].shape[0], 1), 1e-3)
    cfg = {"appearance_enabled": False, "kernel_size": 0.1, "max_tiles_per_gaussian": 16}
    with torch.no_grad():
        f = R.render(state, None, filt, torch.arange(state["xyz"].shape[0]), cam, cfg, None,
                     count_pairs=True)
        xyz, op, sc, q, feats = R.activate(state, filt)
        d = xyz - cam.campos
        colours = R.sh_colors(feats, d / d.norm(dim=-1, keepdim=True))
    pairs, entries, img = brute_force(f.projected, colours, f.bins, (3, 2))
    assert f.pairs == pairs > 1000
    assert f.entries == entries
    worst = max(float((f.toned[y, x] - c).abs().max()) for (x, y), c in img.items())
    assert worst < 1e-5


def test_operation_counts():
    w = {"pairs": 1e8, "entries": 2e6, "pixels": 1280 * 720, "gaussians": 1.5e6, "passes": 2,
         "appearance": True, "uncertainty": True}
    ops, nbytes = work.blend_fwd(w, 2)
    assert ops == 1e8 * (work.PAIR_FWD + 2 * work.PAIR_FWD_PER_PASS)
    assert nbytes == 4 * (2e6 * 12 + 1280 * 720 * 7)
    assert 15e9 < work.VIT < 17e9
    assert work.MLP == 49408 + 100
    assert work.step_ops(w, True, True) > work.step_ops(w, False, False) + work.VIT
