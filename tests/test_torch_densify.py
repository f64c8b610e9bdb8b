"""The port's densify/prune, opacity reset and capacity growth
(`wildgaussians_torch/models/gaussian_store.py`) against the JAX package's
(`wildgaussians_tpu/models/gaussian_store.py`) on the CPU, on seeded stores
of 2,048 slots (numpy draws handed to both sides).

Four densify cases: the abs-gradient quantile rule on and off, size pruning
on and off, and a store whose free slots run out (selections dropped). The
split children's normals are the JAX draws (`jax.random.normal(key, (c, 3))`
and of `fold_in(key, 1)`), handed to the port by replacing its
`split_normals`. Held: the alive mask and the stats exactly; the live
slots' parameters within rtol 1e-6, atol 1e-7; Adam's moments and the aux
buffers exactly. XLA's exp, log and vector norm round unlike PyTorch's in
the last bit (a quarter to a half of f32 inputs), so a split child's
offset, the parent's rotation times (normal draw x scale), may differ by an
ulp of itself: the positions lie in [3, 7] (a scene in front of its
cameras), where rtol 1e-6 covers that; at a coordinate that the offset
cancels to near 0 an ulp of the offset would exceed atol 1e-7. Every deciding value (mean gradient, mean abs gradient, max scale,
activated opacity after densify) is asserted to lie more than 1e-6
(relative) from its threshold, so that a disagreement is a fault, not a
rounding. `reset_opacity` (live opacities rtol 1e-6, moments zeroed) and
`grow_capacity` (exactly; the per-image embeddings and the MLP's moments
unpadded) on the same store.

One test (see test_torch_isolation.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wildgaussians_tpu.models.gaussian_store as jgs
from wildgaussians_tpu.config import Config as JConfig
import wildgaussians_torch.models.gaussian_store as gs
from wildgaussians_torch.config import Config

C, N_IMAGES, EXTENT = 2048, 5, 4.0
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7
MARGIN = 1e-6      # no deciding value this close (relative) to its threshold
SHAPES = {"xyz": 3, "features_dc": 3, "features_rest": 45, "scales": 3, "rotations": 4,
          "opacities": 1, "embeddings": 24}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(seed, n_alive):
    """A store of C slots, n_alive of them (at random) alive, as numpy:
    (params, mlp, mu, nu, aux). Gradient statistics log-uniform around the
    densify threshold, scales on both sides of percent_dense * extent and of
    the size-pruning bound, opacities partly below the prune floor."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    params = {k: f(C, w) for k, w in SHAPES.items()}
    params["xyz"] = rng.uniform(3.0, 7.0, (C, 3)).astype(np.float32)
    params["scales"] = rng.uniform(np.log(0.004), np.log(0.6), (C, 3)).astype(np.float32)
    u = rng.uniform(0.002, 0.95, (C, 1))
    params["opacities"] = np.log(u / (1 - u)).astype(np.float32)
    params["appearance_embeddings"] = f(N_IMAGES, 32)
    mlp = {"w0": f(59, 128), "b0": f(128)}
    alive = np.zeros(C, bool)
    alive[rng.permutation(C)[:n_alive]] = True
    denom = rng.integers(0, 6, (C, 1)).astype(np.float32)
    aux = dict(alive=alive, filter_3D=np.abs(f(C, 1)) * 0.01,
               max_radii2D=rng.uniform(0, 50, C).astype(np.float32),
               xyz_grad=(denom * 2e-4 * np.exp(rng.normal(0, 1.0, (C, 1)))).astype(np.float32),
               xyz_gradient_accum_abs=(denom * 3e-4 * np.exp(rng.normal(0, 1.0, (C, 1))))
               .astype(np.float32),
               xyz_gradient_accum_abs_max=np.abs(f(C, 1)) * 1e-3, denom=denom,
               active_sh_degree=np.asarray(3, np.int32))
    for k in aux:
        if k not in ("alive", "active_sh_degree"):
            aux[k] = np.where(alive.reshape(-1, *([1] * (aux[k].ndim - 1))), aux[k], 0)
    mu = {k: f(*v.shape) for k, v in params.items()}
    nu = {k: np.abs(f(*v.shape)) for k, v in params.items()}
    mu["appearance_mlp/w0"], nu["appearance_mlp/w0"] = f(128, 59), np.abs(f(128, 59))
    return params, mlp, mu, nu, aux


def _jax_side(params, mlp, mu, nu, aux):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp["appearance_mlp"] = {k: jnp.asarray(v) for k, v in mlp.items()}

    def moments(m):
        out = {k: jnp.asarray(v) for k, v in m.items() if "/" not in k}
        out["appearance_mlp"] = {"w0": jnp.asarray(m["appearance_mlp/w0"].T)}
        return out
    adam = jgs.AdamState(moments(mu), moments(nu), jnp.asarray(7, jnp.int32))
    return jp, adam, jgs.AuxState(**{k: jnp.asarray(v) for k, v in aux.items()})


def _port_side(params, mu, nu, aux):
    tp = {k: torch.tensor(v).requires_grad_(True) for k, v in params.items()}
    adam = gs.AdamState({k: torch.tensor(v) for k, v in mu.items()},
                        {k: torch.tensor(v) for k, v in nu.items()}, torch.tensor(7))
    return tp, adam, gs.AuxState(**{k: torch.tensor(v) for k, v in aux.items()})


def _assert_apart(values, threshold, what):
    values, threshold = np.asarray(values, np.float64), float(threshold)
    gap = np.abs(values - threshold) / max(abs(threshold), 1e-30)
    assert gap.min() > MARGIN, f"{what}: a deciding value within {MARGIN} of {threshold}"


def _check_margins(params, aux, jout, use_abs, size_pruning):
    """Every deciding value of the case apart from its threshold."""
    alive = aux["alive"]
    denom = np.maximum(aux["denom"], 1e-12)
    grads = np.nan_to_num(aux["xyz_grad"] / denom)[:, 0]
    _assert_apart(grads[alive], 0.0002, "mean gradient")
    sel = (grads >= np.float32(0.0002)) & alive
    if use_abs:
        ratio = jnp.sum(sel) / jnp.maximum(jnp.sum(alive), 1)
        gabs = np.nan_to_num(aux["xyz_gradient_accum_abs"] / denom)[:, 0]
        q = jgs._masked_quantile(jnp.asarray(gabs), jnp.asarray(alive), 1.0 - ratio)
        _assert_apart(gabs[alive], q, "mean abs gradient")
        sel = sel | (gabs >= q)
    max_scale = np.exp(params["scales"]).max(1)
    _assert_apart(max_scale[sel], np.float32(0.01) * np.float32(EXTENT), "max scale")
    # after densify: every slot (dead slots hold random values too)
    new_params = jout[0]
    _assert_apart(np.asarray(jax.nn.sigmoid(new_params["opacities"])), np.float32(0.005),
                  "opacity")
    if size_pruning:
        _assert_apart(np.exp(np.asarray(new_params["scales"])).max(1),
                      np.float32(0.1) * np.float32(EXTENT), "size")


def _densify_case(monkeypatch, seed, n_alive, use_abs, size_pruning):
    params, mlp, mu, nu, aux = _store(seed, n_alive)
    key = jax.random.PRNGKey(seed)
    jcfg = JConfig(use_gof_abs_gradient=use_abs)
    jout = jgs.densify_and_prune(key, *_jax_side(params, mlp, mu, nu, aux), jcfg,
                                 jnp.float32(EXTENT), size_pruning)
    _check_margins(params, aux, jout, use_abs, size_pruning)
    normals = tuple(torch.tensor(np.asarray(jax.random.normal(k, (C, 3))))
                    for k in (key, jax.random.fold_in(key, 1)))
    monkeypatch.setattr(gs, "split_normals", lambda c, generator: normals)
    tp, tadam, taux = _port_side(params, mu, nu, aux)
    tp_out, tadam_out, taux_out, tstats = gs.densify_and_prune(
        tp, tadam, taux, Config(use_gof_abs_gradient=use_abs), EXTENT, size_pruning,
        torch.Generator())
    jp, jadam, jaux, jstats = jout
    label = f"seed {seed}, alive {n_alive}, abs {use_abs}, size pruning {size_pruning}"
    assert {k: int(v) for k, v in tstats.items()} == {k: int(v) for k, v in jstats.items()}, label
    alive = np.asarray(jaux.alive)
    assert np.array_equal(taux_out.alive.numpy(), alive), label
    for field in jgs.AuxState._fields:
        assert np.array_equal(getattr(taux_out, field).numpy(),
                              np.asarray(getattr(jaux, field))), f"{label}: aux {field}"
    for k in SHAPES:
        np.testing.assert_allclose(tp_out[k].detach().numpy()[alive], np.asarray(jp[k])[alive],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{label}: {k}")
    assert np.array_equal(tp_out["appearance_embeddings"].detach().numpy(),
                          params["appearance_embeddings"])
    for which, jm in (("mu", jadam.mu), ("nu", jadam.nu)):
        for k in SHAPES:
            assert np.array_equal(getattr(tadam_out, which)[k].numpy(), np.asarray(jm[k])), \
                f"{label}: adam {which} {k}"
        assert np.array_equal(getattr(tadam_out, which)["appearance_mlp/w0"].numpy(),
                              np.asarray(jm["appearance_mlp"]["w0"]).T)
    return jstats, (tp_out, tadam_out, taux_out), (jp, jadam, jaux)


def _check_reset(port, jax_store):
    tp, tadam, taux = port
    jp, jadam, jaux = jax_store
    jp, jadam = jgs.reset_opacity(jp, jadam, jaux, JConfig())
    tp, tadam = gs.reset_opacity(tp, tadam, taux)
    alive = taux.alive.numpy()
    np.testing.assert_allclose(tp["opacities"].detach().numpy()[alive],
                               np.asarray(jp["opacities"])[alive], rtol=PARAM_RTOL,
                               atol=PARAM_ATOL)
    # what the reset caps: the activated opacity times the coefficient it
    # divides by (the filtered scales' against the filter, as in JAX)
    assert gs.reset_capped_opacity(tp, taux)[alive].max() <= 0.01 * (1 + 1e-5)
    assert not tadam.mu["opacities"].any() and not tadam.nu["opacities"].any()
    assert np.array_equal(tadam.mu["xyz"].numpy(), np.asarray(jadam.mu["xyz"]))


def _check_grow(store):
    params, mlp, mu, nu, aux = store
    tp, tadam, taux = _port_side(params, mu, nu, aux)
    jp, jadam, jaux = jgs.grow_capacity(*_jax_side(*store), C + 512)
    gp, gadam, gaux = gs.grow_capacity(tp, tadam, taux, C + 512)
    for k, v in gp.items():
        want = np.asarray(jp[k])
        assert v.shape == want.shape and np.array_equal(v.detach().numpy(), want), k
        # new leaves for the per-Gaussian tensors; the embeddings as they were
        assert v.requires_grad and (v is tp[k]) == (k == "appearance_embeddings"), k
    assert gp["appearance_embeddings"].shape[0] == N_IMAGES
    for which, jm in (("mu", jadam.mu), ("nu", jadam.nu)):
        for k in SHAPES:
            assert np.array_equal(getattr(gadam, which)[k].numpy(), np.asarray(jm[k])), k
        assert getattr(gadam, which)["appearance_mlp/w0"].shape == (128, 59)
    for field in jgs.AuxState._fields:
        assert np.array_equal(getattr(gaux, field).numpy(), np.asarray(getattr(jaux, field))), field
    assert gaux.alive.shape == (C + 512,) and not gaux.alive[C:].any()


def test_densify_reset_grow_match_jax(monkeypatch):
    port = jax_store = None
    for seed, n_alive, use_abs, size_pruning in ((0, 1000, True, True), (1, 1000, False, False),
                                                 (2, 1000, False, True), (3, 1960, True, False)):
        stats, p, j = _densify_case(monkeypatch, seed, n_alive, use_abs, size_pruning)
        assert stats["clones"] > 0 and stats["pruned"] > 0
        if n_alive > 1900:
            # out of free slots: clones take them first, the rest is dropped
            assert stats["clones"] + stats["splits"] == C - n_alive
            assert stats["dropped_for_capacity"] > 0
        else:
            assert stats["splits"] > 0 and stats["dropped_for_capacity"] == 0
        if seed == 0:
            port, jax_store = p, j
    _check_reset(port, jax_store)
    _check_grow(_store(4, 1000))
