"""`wildgaussians_torch/parallel/` and the trainer on a sharded store, on
gloo ranks.

  - `init_multihost` is a no-op that returns False in one process with no
    torchrun environment;
  - `step_camera_id` equals the JAX package's for 500 steps;
  - `host_tile_rows` equals the JAX package's for D in {1, 2, 4} (its
    process index and count patched in);
  - `shard_store` keeps each rank's block of the [capacity, ...] tensors;
  - the trainer with `shard_gaussian_store` (and, for 3 steps, without:
    the store replicated, each rank binning its block of it) on 2 ranks
    against the port's
    one-process run of the same camera picks: the synthetic set of
    `tests/test_parallel.py:176-199` (3 cameras at 64x48, 150 points
    rendered through the tiled backend as the photos; here the port's,
    `test_training._make_synthetic_dataset` renders through the JAX
    package's), with its schedule (big_fraction 1.0, densify from
    iteration 2 every 6, opacity reset at 12) for 13 steps, so that
    iteration 12 densifies and resets, with appearance on, and the first 4
    of those steps with the uncertainty model too (warm-up from step 0, no
    protected window), so that the step has replicated tensors of both
    kinds: the MLP and the image embeddings, whose gradients sum over the
    Gaussians, and the uncertainty head, whose gradient comes from the loss
    alone. The capacity starts at 256 and grows at both densifies (256 ->
    512 -> 768 slots), so each rank holds 128, 256, then 384. The
    one-process trainer runs each step from the state the ranks began it
    with (gathered by `state_dict`), its Adam given their gradients.
    Held: the two ranks' losses are identical; each step's metrics within
    `test_torch_train_step.py`'s METRIC_RTOL (1e-4) of the one-process
    step's; every gradient Adam receives (the whole store's and every
    replicated tensor's) within its GRAD_ATOL (5e-3 max|g|) and GRAD_RTOL
    (5e-2); after every step the whole store within its STORE_RTOL (1e-6)
    and STORE_ATOL (1e-7) over the live slots, its alive mask exactly. A sum
    over the ranks missing from a gradient, or one too many, moves it by a
    factor of 2. After the steps, a step outside the mesh on the sharded
    store raises (it would see 1/D of the Gaussians).

One test (see test_torch_isolation.py)."""
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
import wildgaussians_tpu.parallel.multihost as jmh
from helpers import make_scene
from wildgaussians_torch import WildGaussians
from wildgaussians_torch.cameras import make_camera_params
from wildgaussians_torch.ops.rasterize import rasterize_gaussians
from wildgaussians_torch.parallel import multihost as mh
from wildgaussians_torch.parallel.mesh import shard_store
from wildgaussians_torch.types import new_cameras

METRIC_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-3, 5e-2
STORE_RTOL, STORE_ATOL = 1e-6, 1e-7
OVERRIDES = dict(appearance_enabled=True, num_sky_gaussians=0, sh_degree=1, iterations=30,
                 rasterizer_backend="pallas", pallas_binning="sort", pallas_big_fraction=1.0,
                 densify_from_iter=2, densification_interval=6, densify_until_iter=25,
                 opacity_reset_interval=12, position_lr_max_steps=400, initial_capacity=256,
                 uncertainty_mode="disabled")
# (prefix, overrides, steps): the schedule's 13 steps, and 4 with the
# uncertainty model (its ViT is most of a step's time on a CPU)
RUNS = (("sched_", {}, 13),
        ("unc_", dict(uncertainty_mode="dino", uncertainty_warmup_start=0,
                      uncertainty_protected_iters=0), 4),
        ("repl_", dict(shard_gaussian_store=False), 3))
# the store's capacity at each step: both densifies grow it
SLOTS = [256] * 5 + [512] * 6 + [768] * 2


def _synthetic_inputs(path):
    rng = np.random.default_rng(0)
    n_cams, width, height = 3, 64, 48
    scene = make_scene(rng, n=150, spread=1.5, z_range=(3.0, 7.0))
    poses = []
    for i in range(n_cams):
        angle = (i - n_cams / 2) * 0.08
        pose = np.eye(4, dtype=np.float32)[:3]
        pose[0, 3] = np.sin(angle) * 4.0
        pose[2, 3] = 5.0 - np.cos(angle) * 5.0
        c, s = np.cos(angle * 0.5), np.sin(angle * 0.5)
        pose[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        poses.append(pose)
    f = width / (2 * np.tan(np.radians(50.0) / 2))
    intr = np.array([[f, f, width / 2, height / 2]] * n_cams, np.float32)
    sizes = np.array([[width, height]] * n_cams, np.int32)
    cams = new_cameras(poses=np.stack(poses), intrinsics=intr,
                       camera_models=np.zeros((n_cams,), np.int32),
                       distortion_parameters=np.zeros((n_cams, 6), np.float32),
                       image_sizes=sizes)
    images = []
    with torch.no_grad():
        for i in range(n_cams):
            cam, w, h = make_camera_params(cams[i])
            out = rasterize_gaussians(*[torch.tensor(scene[k]) for k in (
                "xyz", "scales", "rotations", "opacities", "colors")], cam, w, h,
                kernel_size=0.1, backend="tiled")
            images.append(np.clip(out.color.numpy(), 0, 1))
    noisy = scene["xyz"] + rng.normal(0, 0.05, scene["xyz"].shape).astype(np.float32)
    np.savez(path / "inputs.npz", poses=np.stack(poses), intrinsics=intr, image_sizes=sizes,
             images=np.stack(images), points3D_xyz=noisy,
             points3D_rgb=(scene["colors"] * 255).astype(np.uint8))


def _check_shard_store():
    """shard_store keeps rank r's contiguous block of every [capacity, ...]
    tensor of a dict or NamedTuple, and every other leaf as it is."""
    from wildgaussians_torch.models.gaussian_store import AuxState, init_aux
    params = {"xyz": torch.arange(24.0).reshape(8, 3).requires_grad_(),
              "appearance_embeddings": torch.ones((3, 4))}
    for r in range(4):
        mesh = mh.TileMesh(None, r, 4, torch.device("cpu"))
        got = shard_store(params, 8, mesh)
        assert torch.equal(got["xyz"], params["xyz"][2 * r:2 * r + 2]) and got["xyz"].requires_grad
        assert got["appearance_embeddings"] is params["appearance_embeddings"]
        aux = shard_store(init_aux(8), 8, mesh)
        assert isinstance(aux, AuxState) and aux.alive.shape == (2,)
        assert aux.active_sh_degree.shape == ()
    assert shard_store(params, 8) is params      # no mesh


def _rows_of_jax(height, D, monkeypatch):
    out = []
    for r in range(D):
        monkeypatch.setattr(jmh.jax, "process_count", lambda: D)
        monkeypatch.setattr(jmh.jax, "process_index", lambda r=r: r)
        out.append(jmh.host_tile_rows(height))
    return out


def test_multihost_and_sharded_training(tmp_path, monkeypatch):
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.init_multihost() is False
    assert not torch.distributed.is_initialized()
    assert [mh.step_camera_id(s, 7) for s in range(500)] == \
        [jmh.step_camera_id(s, 7) for s in range(500)]
    assert [mh.step_camera_id(s, 3, seed=5) for s in range(30)] == \
        [jmh.step_camera_id(s, 3, seed=5) for s in range(30)]
    for D in (1, 2, 4):
        for height in (96, 100, 48):
            want = _rows_of_jax(height, D, monkeypatch)
            got = [mh.host_tile_rows(height, mesh=mh.TileMesh(None, r, D, torch.device("cpu")))
                   for r in range(D)]
            assert got == want, (D, height)
    monkeypatch.undo()
    _check_shard_store()

    _synthetic_inputs(tmp_path)
    runs = [(name, dict(overrides=dict(OVERRIDES, **dict(dict(shard_gaussian_store=True),
                                                          **extra)),
                        steps=steps)) for name, extra, steps in RUNS]
    outs = W.spawn(W.train_runs, 2, str(tmp_path), runs)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for prefix, arg in runs:
            r0, r1 = (W.state_of(o, prefix) for o in outs)
            _hold_run(prefix, arg, r0, r1, tmp_path)
    finally:
        torch.set_num_threads(n_threads)


def _hold_run(prefix, arg, r0, r1, tmp_path):
    steps = arg["steps"]
    np.testing.assert_array_equal(r0["m_loss"], r1["m_loss"])
    slots = SLOTS[:steps]
    held = 1 if prefix == "repl_" else 2       # a replicated store: every slot on every rank
    for r in (r0, r1):
        assert list(r["slots"]) == [s // held for s in slots], prefix
        assert ("outside_mesh_raised" in r) == (held == 2), prefix
        assert held == 1 or bool(r["outside_mesh_raised"]), prefix
    assert r0["m_send_drops"].max() == 0
    given = [W.state_of(r0, f"g{step}_") for step in range(steps)]
    replicated = {k.split("/")[0] for k in given[0] if "/" in k or k == "appearance_embeddings"}
    assert replicated == ({"appearance_embeddings", "appearance_mlp", "uncertainty"}
                          if prefix == "unc_" else {"appearance_embeddings", "appearance_mlp"})

    # the one-process trainer, each step from the state the ranks began it
    # with (its generator draws the same sequence as theirs); its Adam is
    # given the ranks' gradients, and its own are held against theirs
    # below (an update of Adam divides by the root of the squared
    # gradients' average: where a gradient is rounding noise, so is the
    # update's direction)
    m = WildGaussians(train_dataset=W._train_dataset(str(tmp_path)),
                      config_overrides=dict(arg["overrides"]), device="cpu")
    _hold_store(m.state_dict(), W.state_of(r0, "s0_"), f"{prefix} the initial store")
    with W.GradRecorder(replace=given) as rec:
        for step in range(steps):
            W.load_state(m, W.state_of(r0, f"s{step}_"))
            metrics = m.train_iteration(step, camera_id=mh.step_camera_id(step, 3))
            for k, v in metrics.items():
                np.testing.assert_allclose(r0[f"m_{k}"][step], v, rtol=METRIC_RTOL,
                                           err_msg=f"{prefix}{k} at step {step}")
            assert m.aux.alive.shape[0] == slots[step]
            _hold_store(W.state_of(r0, f"s{step + 1}_"), m.state_dict(), f"{prefix}step {step}")
    ref = rec.arrays()
    for step in range(steps):
        alive = W.state_of(r0, f"s{step}_")["aux/alive"]
        own = W.state_of(ref, f"g{step}_")
        assert own.keys() == given[step].keys()
        for k, gw in own.items():
            gp = given[step][k]
            if "/" not in k and k != "appearance_embeddings":
                gp, gw = gp[alive], gw[alive]     # a dead slot's gradient may be NaN
            np.testing.assert_allclose(gp, gw, atol=GRAD_ATOL * (np.abs(gw).max() + 1e-12),
                                       rtol=GRAD_RTOL, err_msg=f"{prefix}{k} at step {step}")


def _hold_store(got, want, what):
    """The ranks' gathered store against the one-process one: the alive
    mask exactly, every other buffer over the live slots."""
    alive = want["aux/alive"]
    np.testing.assert_array_equal(got["aux/alive"], alive, err_msg=what)
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, what)
        if w.ndim and w.shape[0] == alive.shape[0] and w.dtype.kind == "f":
            w, g = w[alive], g[alive]
        np.testing.assert_allclose(g, w, rtol=STORE_RTOL, atol=STORE_ATOL,
                                   err_msg=f"{k} after {what}")
