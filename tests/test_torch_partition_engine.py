"""The port's partition engine (`pallas_binning: partition`) on the CPU, with
the plain K1, K2, K3, K5 and K6, against the JAX package's
`rasterize_pallas_multi(..., binning="partition", pack16=False)`, whose
kernels run in Pallas interpret mode off the TPU. The same preprocess
arrays (the port's) go to both.

The scene is tie-free (geometric depths, as tools/tpu_parity.py builds one)
with 2 color passes, inflated Gaussians that need tier 2 and the rank-merge
chain, one behind the camera, and more big Gaussians than the big pool
holds. Compared:
  - the presort table, the duplicated slot table, the final entry table
    (key rows everywhere, attribute rows where an entry is real), the tile
    starts and counts and `big_list`: exactly (the tables only move values);
  - images and final T within 1e-5;
  - the per-Gaussian gradients of mean2d, conic, opacity and colors, and
    dbg, each within 1e-4 of its largest |g| (the JAX rows are f32 here; the
    sums run in another order);
  - the two abs-gradient channels (per axis, each pass's own abs sums
    summed over the passes, scaled by ndc_scale; PartitionBlend's
    docstring), to the same tolerance, from a cotangent that reaches both
    passes and from one that reaches only the first.

Marked slow (~200 s in one process on a CPU): the JAX side traces and
interprets each of its radix passes and their inverses, about 30 distinct
kernels. Run it with `python -m pytest -m slow -n 0
tests/test_torch_partition_engine.py`. One test (see
test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_camera, make_scene
from wildgaussians_tpu.ops import partition as jpart
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops import blend as tblend
from wildgaussians_torch.ops import partition_engine as teng
from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
from wildgaussians_torch.ops.rasterize_tiled import make_grid

N, W, H = 100, 80, 48             # 15 tiles
D_MAX, D_SMALL, BIG_FRACTION = 16, 4, 0.02   # d1 = 6 (the engine's floor), m_cap = 8
NDC = (40.0, 24.0)
TOL_IMG, TOL_GRAD = 1e-5, 1e-4
_GEO = ("mean2d", "conic", "opacity")
_REST = ("depth", "rect_min", "rect_max", "tiles_touched", "valid")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed):
    """The port's preprocess of a tie-free scene: depths spaced
    geometrically, a fifth of the Gaussians scaled up (rects of up to 15
    tiles) and one moved behind the camera."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n=N)
    zs = 2.0 * np.exp(np.linspace(0.0, 1.4, N))
    scene["xyz"][:, 2] = rng.permutation(zs).astype(np.float32)
    scene["scales"][:20] *= 10.0
    scene["xyz"][20, 2] = -3.0
    cam, w, h = make_camera_params(make_camera(width=W, height=H))
    pre = preprocess(torch.tensor(scene["xyz"]),
                     compute_cov3d(torch.tensor(scene["scales"]), torch.tensor(scene["rotations"])),
                     torch.tensor(scene["opacities"]), cam, w, h, 0.1)
    arrays = {k: v.numpy() for k, v in pre._asdict().items()}
    colors = np.stack([scene["colors"], rng.uniform(0, 1, (N, 3)).astype(np.float32)])
    return arrays, colors, rng


def _recorder(module, calls, monkeypatch):
    """Record the table, bucket count, key row, output and sentinel of every
    radix_partition the engine of `module` makes."""
    orig = module.radix_partition

    def record(table, num_buckets, **kw):
        out, meta = orig(table, num_buckets, **kw)
        calls.append((np.asarray(table), num_buckets, kw.get("key_row", 0), np.asarray(out),
                      meta.keyspace - 1))
        return out, meta
    monkeypatch.setattr(module, "radix_partition", record)


def _jax_run(arrays, colors, bg, cots, monkeypatch):
    calls, ranges = [], []
    _recorder(jpart, calls, monkeypatch)
    orig_ranges = jpart.bucket_ranges

    def record_ranges(meta):
        out = orig_ranges(meta)
        ranges.append([np.asarray(x) for x in out])
        return out
    monkeypatch.setattr(jpart, "bucket_ranges", record_ranges)
    jpal._make_partition_blend_vjp.cache_clear()   # rebuild it on the recorders

    def f(mean2d, conic, opacity, cols, hook, bg):
        out = rasterize_pallas_multi(mean2d, conic, opacity, list(cols), hook, bg)
        return [x for pair in out for x in pair]

    def rasterize_pallas_multi(mean2d, conic, opacity, cols, hook, bg):
        return jpal.rasterize_pallas_multi(
            mean2d, conic, opacity, cols, hook, *[jnp.asarray(arrays[k]) for k in _REST], bg,
            grid=jmake_grid(W, H, 16), max_tiles_per_gaussian=D_MAX, d_small=D_SMALL,
            big_fraction=BIG_FRACTION, binning="partition", pack16=False,
            ndc_scale=jnp.asarray(NDC))

    args = ([jnp.asarray(arrays[k]) for k in _GEO]
            + [tuple(jnp.asarray(c) for c in colors), jnp.zeros((N, 2), jnp.float32),
               jnp.asarray(bg)])
    outs, f_vjp = jax.vjp(f, *args)
    grads = []
    for cot in cots:
        g = f_vjp([jnp.asarray(c) for c in cot])
        grads.append([np.asarray(x) for x in g[:3]]
                     + [np.stack([np.asarray(c) for c in g[3]]), np.asarray(g[4]),
                        np.asarray(g[5])])
    jpal._make_partition_blend_vjp.cache_clear()
    return [np.asarray(o) for o in outs], grads, calls, ranges[-1]


def _port_run(arrays, colors, bg, cots, monkeypatch):
    calls = []
    _recorder(teng, calls, monkeypatch)
    geo = [torch.tensor(arrays[k], requires_grad=True) for k in _GEO]
    cols = [torch.tensor(c, requires_grad=True) for c in colors]
    hook = torch.zeros((N, 2), requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    images, aux = tblend.rasterize_multi(
        *geo, cols, *[torch.tensor(arrays[k]) for k in _REST], bg_t, grid=make_grid(W, H, 16),
        max_tiles_per_gaussian=D_MAX, d_small=D_SMALL, big_fraction=BIG_FRACTION,
        binning="partition", absgrad_hook=hook, ndc_scale=NDC)
    (c0, t0), (c1, t1) = images
    grads = []
    for cot in cots:
        # each pass has its own final_T image, as in the JAX engine
        g = torch.autograd.grad([c0, t0, c1, t1],
                                [*geo, *cols, hook, bg_t],
                                grad_outputs=[torch.tensor(c) for c in cot],
                                retain_graph=True)
        grads.append([x.numpy() for x in g[:3]] + [torch.stack(g[3:5]).numpy(),
                                                   g[5].numpy(), g[6].numpy()])
    outs = [c0, t0, c1, t1]
    return [o.detach().numpy() for o in outs], grads, calls, aux


def _compare_tables(j_calls, t_calls, aux, j_ranges):
    """The presort, the rank merge and the tile partition, in and out: key
    rows everywhere, attribute rows where the entry is real (the JAX pass
    zeroes the attributes of chunks that hold only sentinel keys, the port
    keeps them; the JAX tables' rows are padded to multiples of 8)."""
    assert len(j_calls) == len(t_calls) == 3, "the scene must need tier 2"
    for j, t in zip(j_calls, t_calls):
        assert j[1:3] + (j[3].shape[1], j[4]) == t[1:3] + (t[3].shape[1], t[4])
        np.testing.assert_array_equal(t[0][t[2]], j[0][j[2]])
        np.testing.assert_array_equal(t[3][t[2]], j[3][j[2]])
    (jp, nb, _, jpo, ps), (tp, _, _, tpo, _) = j_calls[0], t_calls[0]
    (jd, n1, _, jdo, rs), (td, _, _, tdo, _) = j_calls[1], t_calls[1]
    (_, _, _, jfo, _), (_, _, _, tfo, _) = j_calls[2], t_calls[2]
    for got, want, real in ((tp, jp, jp[0] < nb), (tpo, jpo, jpo[0] != ps),
                            (td, jd, jd[0] < n1), (tdo, jdo, jdo[0] != rs)):
        assert real.any()
        np.testing.assert_array_equal(got[:, real], want[:got.shape[0], real])
    # the final table at every entry of a live tile segment
    starts, counts = aux["tile_starts"].numpy(), aux["tile_counts"].numpy()
    np.testing.assert_array_equal(starts, j_ranges[0][1:])
    np.testing.assert_array_equal(counts, j_ranges[1][1:])
    assert counts.sum() > 0
    live = np.zeros(tfo.shape[1], bool)
    for s, c in zip(starts, counts):
        live[s:s + c] = True
    np.testing.assert_array_equal(tfo[:, live], jfo[:tfo.shape[0], live])
    np.testing.assert_array_equal(aux["entry_table"].numpy(), tfo)
    # big_list: the JAX slot table's rank key of each pool slot's first deep cell
    sz = teng.partition_engine_sizes(make_grid(W, H, 16), N, D_MAX, teng.engine_d_small(D_SMALL),
                                     BIG_FRACTION)
    j_big = jd[0, sz.slots1::sz.d2_extra][:sz.m_cap].astype(np.int32)
    np.testing.assert_array_equal(aux["big_list"].numpy(), j_big)
    assert int((aux["big_list"] < sz.n1).sum()) == sz.m_cap, "the big pool must overflow"


@pytest.mark.slow
def test_partition_engine_matches_jax(monkeypatch):
    arrays, colors, rng = _scene(11)
    assert not arrays["valid"][20]
    sz = teng.partition_engine_sizes(make_grid(W, H, 16), N, D_MAX, teng.engine_d_small(D_SMALL),
                                     BIG_FRACTION)
    assert int(np.sum((arrays["tiles_touched"] > sz.d1) & arrays["valid"])) > sz.m_cap
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    shapes = [(H, W, 3), (H, W), (H, W, 3), (H, W)]
    full = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
    first_only = [full[0], full[1], np.zeros(shapes[2], np.float32),
                  np.zeros(shapes[3], np.float32)]
    cots = [full, first_only]
    j_out, j_grads, j_calls, j_ranges = _jax_run(arrays, colors, bg, cots, monkeypatch)
    t_out, t_grads, t_calls, aux = _port_run(arrays, colors, bg, cots, monkeypatch)

    _compare_tables(j_calls, t_calls, aux, j_ranges)
    for name, jo, to in zip(("color 0", "T", "color 1", "T"), j_out, t_out):
        np.testing.assert_allclose(to, jo, atol=TOL_IMG, rtol=0, err_msg=name)
    names = ("dmean2d", "dconic", "dopacity", "dcolors", "dabs", "dbg")
    for k, (want, got) in enumerate(zip(j_grads, t_grads)):
        for name, gw, gp in zip(names, want, got):
            assert gp.shape == gw.shape, name
            scale = np.abs(gw).max()
            assert scale > 0, f"{name} has no gradient"
            np.testing.assert_allclose(gp, gw, atol=TOL_GRAD * scale, rtol=0,
                                       err_msg=f"{name}, cotangent {k}")
