"""Rank processes for the port's multi-rank tests (`tests/test_torch_mesh_*.py`,
`tests/test_torch_multihost.py`).

`spawn(case, world, tmpdir)` starts `world` processes with
torch.multiprocessing; each joins a gloo group on a free loopback port,
runs `case(mesh, tmpdir)` on one torch thread and writes what it returns
(a dict of arrays) to `<tmpdir>/rank<r>.npz`. This module imports only
numpy, torch and the port, never JAX: the tests compute their JAX
references in the parent process and hand the ranks their inputs as
`<tmpdir>/inputs.npz`.
"""
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Ranks still running this many seconds after spawn started them are stopped.
SPAWN_DEADLINE_S = 600.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, case, tmpdir, arg):
    torch.set_num_threads(1)
    from wildgaussians_torch.parallel.multihost import init_multihost
    from wildgaussians_torch.parallel.mesh import make_tile_mesh
    init_multihost(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        out = case(make_tile_mesh(), tmpdir, arg)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(case, world: int, tmpdir: str, arg=None, meanwhile=None):
    """Run case(mesh, tmpdir, arg) on `world` gloo ranks, and `meanwhile()`
    in this process while they run; returns (each rank's dict of arrays,
    what meanwhile returned) with `meanwhile`, else the former. A rank that
    fails raises at once. Ranks still running `SPAWN_DEADLINE_S` seconds
    after the start are stopped and spawn raises TimeoutError: a rank stuck
    in a gloo collective would otherwise hold its test until gloo's own
    30-minute timeout."""
    deadline = SPAWN_DEADLINE_S
    end = time.monotonic() + deadline
    ctx = mp.spawn(_rank_main, args=(world, free_port(), case, tmpdir, arg), nprocs=world,
                   join=False)
    try:
        got = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() < end:
                continue
            alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            raise TimeoutError(f"{case.__name__}: ranks {alive} of {world} still running "
                               f"after the {deadline:g} s deadline")
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmpdir, f"rank{r}.npz")) as f:
            outs.append(dict(f.items()))
    return (outs, got) if meanwhile is not None else outs


def load_inputs(tmpdir):
    with np.load(os.path.join(tmpdir, "inputs.npz")) as f:
        return dict(f.items())


# ------------------------------------------------------------------ the cases

GEO = ("mean2d", "conic", "opacity")
REST = ("depth", "rect_min", "rect_max", "tiles_touched", "valid")


def f16_rows(fn):
    """The blend backward with its per-entry rows rounded to f16, as the JAX
    package's exact mode rounds them (saturating at 65504)."""
    def call(*a, **k):
        rows = fn(*a, **k)
        return torch.clamp(rows, -65504.0, 65504.0).half().float()
    return call


def rasterize(mesh, x, binning, grads_sharded, send_beta, f16=False, grad=True):
    """rasterize_multi on the inputs x under the mesh: the gathered image,
    the loss mean((img - target)^2) and its gradients g0-g4 with respect to
    mean2d, conic, opacity, colors and bg (this rank's block of the first
    four with `grads_sharded`), and aux's send_drops. With f16, the blend
    backward's per-entry rows are rounded to f16 as in the JAX package."""
    from wildgaussians_torch.ops import blend as tblend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    n = x["valid"].shape[0]
    block = slice(None)
    if grads_sharded:
        k = n // mesh.size
        block = slice(mesh.rank * k, (mesh.rank + 1) * k)
    geo = [torch.tensor(x[k][block], requires_grad=grad) for k in GEO]
    col = torch.tensor(x["colors"][block], requires_grad=grad)
    bg = torch.tensor(x["bg"], requires_grad=grad)
    h, w = x["target"].shape[:2]
    plain_bwd = tblend.blend_backward
    if f16:
        tblend.blend_backward = f16_rows(plain_bwd)
    try:
        ((img, _t),), aux = tblend.rasterize_multi(
            *geo, [col], *[torch.tensor(x[k][block]) for k in REST], bg,
            grid=make_grid(w, h, 16), max_tiles_per_gaussian=int(x["d_max"]),
            d_small=int(x["d_small"]), big_fraction=float(x["big_fraction"]), binning=binning,
            mesh=mesh, send_beta=send_beta, grads_sharded=grads_sharded)
        loss = torch.mean((img - torch.tensor(x["target"])) ** 2)
        out = {"img": img.detach().numpy(), "loss": loss.detach().numpy(),
               "send_drops": aux["send_drops"].numpy()}
        if grad:
            grads = torch.autograd.grad(loss, [*geo, col, bg])
            out.update({f"g{i}": g.numpy() for i, g in enumerate(grads)})
    finally:
        tblend.blend_backward = plain_bwd
    return out


def _prefixed(prefix, d):
    return {prefix + k: v for k, v in d.items()}


def mesh_sort_case(mesh, tmpdir, arg):
    """The sharded sort engine on 4 ranks: scene "a" at D = 4 with the store
    sharded and at D = 2 (ranks {0, 1} and {2, 3}) with it replicated, each
    with the JAX package's f16 rows; scene "b" forward at send_beta 0.01
    and 2 and scene "c" forward at send_beta 0.05 and D * 1.1, at D = 4
    with the store sharded."""
    from wildgaussians_torch.parallel.mesh import make_tile_mesh
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    mesh2 = make_tile_mesh(pairs[mesh.rank // 2])
    x = load_inputs(tmpdir)
    b, c = ({k[2:]: v for k, v in x.items() if k.startswith(p)} for p in ("b_", "c_"))
    a = {k: v for k, v in x.items() if k[:2] not in ("b_", "c_")}
    out = _prefixed("d4_", rasterize(mesh, a, "sort", True, 2.0, f16=True))
    out.update(_prefixed("d2_", rasterize(mesh2, a, "sort", False, 2.0, f16=True)))
    for tag, scene, beta in (("tight_", b, 0.01), ("default_", b, 2.0),
                             ("skew_tight_", c, 0.05), ("skew_", c, mesh.size * 1.1)):
        out.update(_prefixed(tag, rasterize(mesh, scene, "sort", True, beta, grad=False)))
    return out


def mesh_partition_case(mesh, tmpdir, arg):
    """The tile-sharded partition path on the inputs, replicated store;
    with arg, the blend backward's rows rounded to f16."""
    return rasterize(mesh, load_inputs(tmpdir), "partition", False, 2.0, f16=arg)


def _train_dataset(tmpdir):
    from wildgaussians_torch.types import new_cameras
    x = load_inputs(tmpdir)
    n_cams = x["poses"].shape[0]
    cams = new_cameras(poses=x["poses"], intrinsics=x["intrinsics"],
                       camera_models=np.zeros((n_cams,), np.int32),
                       distortion_parameters=np.zeros((n_cams, 6), np.float32),
                       image_sizes=x["image_sizes"])
    return dict(cameras=cams, images=list(x["images"]), points3D_xyz=x["points3D_xyz"],
                points3D_rgb=x["points3D_rgb"], image_paths=[f"{i:03d}.png" for i in range(n_cams)],
                image_paths_root=".", mask_paths=None, mask_paths_root=None, metadata={},
                images_points3D_indices=None)


def _flat(state, prefix):
    """A copy of a state_dict (whose arrays may share the CPU tensors'
    memory) under npz keys (no "/")."""
    return {prefix + k.replace("/", "|"): np.array(v, copy=True) for k, v in state.items()}


def state_of(out, prefix):
    """The state_dict saved under `prefix` in a rank's results."""
    return {k[len(prefix):].replace("|", "/"): v for k, v in out.items() if k.startswith(prefix)}


def load_state(m, state):
    """Put a state_dict into the trainer m in place of its store, MLP, Adam
    state and uncertainty head (m trains on one process)."""
    from wildgaussians_torch.io.convert import train_state_from_numpy
    st = train_state_from_numpy(state, m.config, m.device)
    m.params, m.mlp, m.aux = st.model
    m.adam, m.spatial_lr_scale, m.uparams = st.adam, st.spatial_lr_scale, st.uncertainty
    if st.uncertainty_bn is not None:
        m._uncertainty.bn_state = st.uncertainty_bn
    for t in m._trainable().values():
        t.requires_grad_(True)


class GradRecorder:
    """Records, at each Adam update, the gradients Adam receives (on a
    sharded store, the per-Gaussian ones gathered over `mesh`'s ranks).
    With `replace` (a list, per update, of gradient arrays by key), Adam
    receives those instead, so that two trainers fed the same state and
    the same gradients must reach the same state."""

    def __init__(self, mesh=None, replace=None):
        self.mesh, self.replace = mesh, replace

    def __enter__(self):
        from wildgaussians_torch.models import gaussian_store as gs
        from wildgaussians_torch.parallel.mesh import all_gather_cat
        self.gs, self.plain, self.seen = gs, gs.adam_update, []

        def recording(params, grads, *a, **k):
            # the store's own keys hold no "/" (the MLP's and the head's do)
            per_gaussian = set(gs.per_gaussian_keys({key: v for key, v in params.items()
                                                     if "/" not in key}))
            self.seen.append({key: (all_gather_cat(g, self.mesh)
                                    if self.mesh is not None and key in per_gaussian
                                    else g).detach().clone() for key, g in grads.items()})
            if self.replace is not None:
                given = self.replace[len(self.seen) - 1]
                grads = {key: torch.as_tensor(given[key]).reshape(g.shape)
                         for key, g in grads.items()}
            return self.plain(params, grads, *a, **k)
        gs.adam_update = recording
        return self

    def __exit__(self, *exc):
        self.gs.adam_update = self.plain

    def arrays(self):
        """g<update>_<key> (npz keys: "|" for "/")."""
        return {f"g{i}_{k}".replace("/", "|"): g.numpy()
                for i, grads in enumerate(self.seen) for k, g in grads.items()}


def train_runs(mesh, tmpdir, runs):
    """train_case for each (prefix, arg) of `runs`, its results prefixed."""
    out = {}
    for prefix, arg in runs:
        out.update(_prefixed(prefix, train_case(mesh, tmpdir, arg)))
    return out


def train_case(mesh, tmpdir, arg):
    """The port's trainer on the dataset of inputs.npz under
    arg["overrides"], under the mesh, for arg["steps"] steps on the cameras
    `step_camera_id` picks. Returns the per-step metrics (m_<name>
    [steps]), each step's gradients as Adam receives them (g<step>_<key>), the slots this rank held at each
    step, and the whole store (`state_dict`, gathered) before the first
    step and after each (s<k>_<key>: k = 0 before the first step). The
    gradients are the whole store's (gathered over the ranks). On a sharded
    store, `outside_mesh_raised`: a step outside the mesh raised."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.parallel.mesh import use_mesh
    from wildgaussians_torch.parallel.multihost import step_camera_id
    ds = _train_dataset(tmpdir)
    m = WildGaussians(train_dataset=ds, config_overrides=dict(arg["overrides"]), device="cpu")
    metrics, slots = [], []
    sharded = mesh is not None and m.config.shard_gaussian_store
    with GradRecorder(mesh if sharded else None) as rec, use_mesh(mesh):
        out = _flat(m.state_dict(), "s0_")
        for step in range(arg["steps"]):
            metrics.append(m.train_iteration(step, camera_id=step_camera_id(step, len(ds["images"]))))
            slots.append(m.aux.alive.shape[0])
            out.update(_flat(m.state_dict(), f"s{step + 1}_"))
    if sharded:
        # outside its mesh a sharded store (1/D of the Gaussians) refuses to train
        try:
            m.train_iteration(arg["steps"], camera_id=0)
            out["outside_mesh_raised"] = np.array(False)
        except RuntimeError:
            out["outside_mesh_raised"] = np.array(True)
    out.update({f"m_{k}": np.array([d[k] for d in metrics], np.float64) for k in metrics[0]})
    out.update(rec.arrays())
    out["slots"] = np.array(slots)
    return out
