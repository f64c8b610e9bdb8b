"""The port's radix partition (ops/partition.py, the plain K5 and K6 on the
CPU) against the JAX package's `radix_partition` / `radix_unpartition` in
Pallas interpret mode, on seeded [8, R] tables with invalid keys and a
pure-sentinel stretch, at a small base (B=4, E=32, 37 buckets: 3 passes) so
that the JAX side stays cheap: once by key row 0, once by key row 1 with a
tail, as the engine's tile partition runs with tier 2. Exact: key rows
everywhere, attribute rows wherever the key is not the sentinel (the JAX
pass zeroes the attributes of chunks that hold only sentinels), the bases
and saved keys of every pass, the bucket ranges, the inverse of a random
gradient table, and the round trip of every real column.

Also the partition engine's sizes against the locals of the JAX
`_make_partition_blend_vjp` for a few (n, canvas, d_max) cases.

One test (see test_torch_isolation.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgaussians_tpu.ops import partition as jpart
from wildgaussians_tpu.ops import rasterize_pallas as jpal
from wildgaussians_tpu.ops.rasterize_tiled import make_grid as jmake_grid
from wildgaussians_torch.ops import partition as tpart
from wildgaussians_torch.ops import partition_engine as teng
from wildgaussians_torch.ops.rasterize_tiled import make_grid


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six worker processes on a few
    cores, where a full torch thread pool mostly waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, R, num_buckets, key_row, E):
    keys = rng.integers(0, num_buckets, R).astype(np.float32)
    inv = rng.random(R) < 0.2
    keys[inv] = num_buckets + rng.integers(0, 5, inv.sum())
    keys[R // 2:R // 2 + 5 * E] = num_buckets + 3     # whole chunks of sentinels
    table = rng.uniform(-5, 5, (8, R)).astype(np.float32)
    table[key_row] = keys
    return table


def _check_partition(rng, num_buckets, B, E, R, key_row, tail):
    table = _table(rng, R, num_buckets, key_row, E)
    j_out, j_meta = jpart.radix_partition(jnp.asarray(table), num_buckets, B=B, E=E,
                                          key_row=key_row, tail_pad=tail, interpret=True)
    j_out = np.asarray(j_out)
    t_out, t_meta = tpart.radix_partition(torch.tensor(table), num_buckets, B=B, E=E,
                                          key_row=key_row, tail_pad=tail)
    t_out = t_out.numpy()
    assert t_out.shape == j_out.shape and t_meta.L == j_meta.L == 3
    assert t_meta.keyspace == j_meta.keyspace
    np.testing.assert_array_equal(t_out[key_row], j_out[key_row])
    real = j_out[key_row] != j_meta.keyspace - 1
    np.testing.assert_array_equal(t_out[:, real], j_out[:, real])
    for p in range(j_meta.L):
        np.testing.assert_array_equal(t_meta.bases[p].numpy(), np.asarray(j_meta.bases[p]))
        np.testing.assert_array_equal(t_meta.saved_keys[p].numpy(),
                                      np.asarray(j_meta.saved_keys[p]))
    for got, want in zip(tpart.bucket_ranges(t_meta), jpart.bucket_ranges(j_meta)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the inverse of an arbitrary gradient table, and the round trip
    g = rng.standard_normal((8, t_out.shape[1])).astype(np.float32)
    want = np.asarray(jpart.radix_unpartition(jnp.asarray(g), j_meta, interpret=True))
    np.testing.assert_array_equal(tpart.radix_unpartition(torch.tensor(g), t_meta).numpy(), want)
    back = tpart.radix_unpartition(torch.tensor(t_out), t_meta).numpy()
    valid = table[key_row] < num_buckets
    np.testing.assert_array_equal(back[:, valid], table[:, valid])


def _jax_locals(*args):
    """Every non-function value the JAX engine's closures hold."""
    blend = jpal._make_partition_blend_vjp(*args)
    found, stack, seen = {}, [blend.fun, blend.fwd, blend.bwd], set()
    while stack:
        f = stack.pop()
        if id(f) in seen or getattr(f, "__closure__", None) is None:
            continue
        seen.add(id(f))
        for name, cell in zip(f.__code__.co_freevars, f.__closure__):
            v = cell.cell_contents
            if callable(v) and hasattr(v, "__code__"):
                stack.append(v)
            else:
                found[name] = v
    return found


def _check_sizes():
    for n, (w, h), d_max, d_small in ((100, (80, 48), 16, 6), (1000, (256, 192), 16, 6),
                                      (5000, (1280, 720), 24, 6), (300, (64, 48), 4, 6)):
        got = teng.partition_engine_sizes(make_grid(w, h, 16), n, d_max, d_small, 0.16)
        want = _jax_locals(jmake_grid(w, h, 16), teng.K_CHUNK, n, d_max, 2, d_small, 0.16)
        for name, value in got._asdict().items():
            if name == "nkey" and "nkey" not in want:
                continue
            assert want[name] == value, (name, n, w, h, d_max)
        assert (got.m_cap > 0) == (d_max > d_small)


def test_radix_partition_matches_jax():
    rng = np.random.default_rng(0)
    _check_partition(rng, 37, 4, 32, 512, 0, 0)
    _check_partition(rng, 37, 4, 32, 512, 1, 64)
    _check_sizes()
