"""Stable radix partition of an f32 table by an integer key row, and its
inverse for gradient tables.

Counterpart of `wildgaussians_tpu/ops/partition.py`. A table [rows, R] f32
carries an exact integer key (< 2^24) in its row `key_row`; each pass moves
every column, stably, into one of B buckets by one base-B digit of its key
(LSB first). Bucket d of a pass starts at `bases[d]`, the exclusive prefix
of the digit counts rounded up to E; the gap after each bucket's entries
and the tail [bases[B], R + B E) hold sentinel entries (key keyspace - 1,
every other row 0), so every pass adds exactly B E columns. Keys at or
above `num_buckets` are remapped to the sentinel before the first pass and
end up after every real key.

Two kernels, each with a plain PyTorch version beside it:

  K5 `radix_pass`    csrc/radix_pass.cu    one pass
  K6 `radix_unpass`  csrc/radix_unpass.cu  its inverse for a gradient table

Each wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error). The digit counts, the aligned bases, the histogram and the bucket
ranges are plain torch, as the JAX package ran them in XLA.
"""
import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build


class PartitionMeta(NamedTuple):
    """What radix_unpartition and bucket_ranges need of a partition."""
    E: int
    B: int
    L: int                      # number of passes
    R0: int                     # input length
    num_buckets: int
    keyspace: int               # B**L; the sentinel key is keyspace - 1
    bases: tuple                # per pass: [B+1] int32 aligned bucket bases
    saved_keys: tuple           # per pass: [R_p] f32 key row of the pass input


def num_passes(num_buckets: int, B: int = 16) -> int:
    """Passes needed; key keyspace-1 is reserved for sentinel entries."""
    L = 1
    while B ** L < num_buckets + 1:
        L += 1
    return L


def digits(keys: torch.Tensor, p: int, B: int) -> torch.Tensor:
    """Digit p of f32 integer keys, in the JAX package's f32 arithmetic
    (floor(k / B^p) mod B), as int64."""
    d = torch.floor(keys * (1.0 / float(B ** p)))
    return (d - torch.floor(d / B) * B).long()


def aligned_bases(counts: torch.Tensor, E: int) -> torch.Tensor:
    """[B+1] int32 exclusive prefix of the counts rounded up to E."""
    sizes = ((counts.long() + (E - 1)) // E) * E
    return torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)]).to(torch.int32)


def histogram(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """[num_buckets] int32 histogram of f32 integer keys; keys at or above
    num_buckets are not counted (the JAX package's factorised one-hot
    matmul counts the same)."""
    return torch.bincount(keys[keys < num_buckets].long(), minlength=num_buckets).to(torch.int32)


def _check_pass_args(B: int, E: int, R_in: int, R_out: int):
    if not 2 <= B <= 32:
        raise ValueError(f"B must be in [2, 32], got {B}")
    if R_out < R_in + B * E:
        raise ValueError(f"R_out {R_out} < R_in {R_in} + B*E {B * E}")


def _destinations(keys: torch.Tensor, p: int, bases: torch.Tensor, B: int) -> torch.Tensor:
    """K5's destination of every column of a pass input: bases[d] + (earlier
    columns with digit d), from a stable argsort of the digits."""
    d = digits(keys, p, B)
    counts = torch.bincount(d, minlength=B)
    order = torch.argsort(d, stable=True)
    d_sorted = d[order]
    first = torch.cumsum(counts, 0) - counts              # first sorted position of each digit
    pos = torch.arange(d.shape[0], device=d.device)
    dest = torch.empty_like(d)
    dest[order] = bases.long()[d_sorted] + (pos - first[d_sorted])
    return dest


def radix_pass_plain(table: torch.Tensor, keys: torch.Tensor, p: int, *, B: int, E: int,
                     key_row: int, sentinel: int, R_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5: one stable pass by digit p of `keys` (the key row of
    the pass input, [R]). Column i of `table` [rows, R], with its key row
    replaced by keys[i], moves to bases[d] + (earlier columns with digit d);
    every other column of the output [rows, R_out] is a sentinel entry.
    Returns (out, bases [B+1] int32)."""
    _check_pass_args(B, E, table.shape[1], R_out)
    bases = aligned_bases(torch.bincount(digits(keys, p, B), minlength=B), E)
    dest = _destinations(keys, p, bases, B)
    out = torch.zeros((table.shape[0], R_out), dtype=table.dtype, device=table.device)
    out[key_row] = float(sentinel)
    out[:, dest] = table
    out[key_row, dest] = keys
    return out, bases


def radix_unpass_plain(gin: torch.Tensor, keys: torch.Tensor, p: int, bases: torch.Tensor,
                       *, B: int, E: int, sentinel: int) -> torch.Tensor:
    """Plain PyTorch K6: out[:, i] = gin[:, dest(i)] for the pass whose input
    key row was `keys` [R] and whose bases were `bases`; a column whose key
    is the sentinel gets zeros (its gradient is a hole's). gin is
    [grows, >= R + B E] in the pass's output order; returns [grows, R]."""
    if gin.shape[1] < keys.shape[0] + B * E:
        raise ValueError(f"gin has {gin.shape[1]} columns for a pass of {keys.shape[0]} entries")
    dest = _destinations(keys, p, bases, B)
    out = gin[:, dest]
    out[:, keys >= float(sentinel)] = 0.0
    return out


_PASS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p]
_UNPASS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _kernel(lib: str, entry: str, argtypes):
    """(the entry point, the library's block count for R columns)."""
    so = _build.load(lib)
    fn = getattr(so, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    blocks = so.wg_radix_blocks
    blocks.argtypes = [ctypes.c_int]
    blocks.restype = ctypes.c_int
    return fn, blocks


def _check_rows(name: str, x: torch.Tensor, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.stride(1) != 1 or x.device != device:
        raise ValueError(f"{name} must be a 2-D f32 tensor with contiguous rows on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")


def _check_keys(keys: torch.Tensor, R: int, device):
    if keys.dtype != torch.float32 or tuple(keys.shape) != (R,) or not keys.is_contiguous() \
            or keys.device != device:
        raise ValueError(f"keys must be a contiguous f32 tensor of shape ({R},) on {device}, "
                         f"got {keys.dtype} {tuple(keys.shape)} on {keys.device}")


def radix_pass(table: torch.Tensor, keys: torch.Tensor, p: int, *, B: int, E: int,
               key_row: int, sentinel: int, R_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: one stable radix pass (see radix_pass_plain for the function).
    A CPU table runs the plain version; a CUDA table launches the kernels of
    `csrc/radix_pass.cu` (digit counts per block, their scan into bucket
    bases and block offsets, the stable scatter of every row staged in
    shared memory by digit, the sentinel fill) and adds one to
    `radix_pass.launches`."""
    if table.device.type == "cpu":
        return radix_pass_plain(table, keys, p, B=B, E=E, key_row=key_row,
                                sentinel=sentinel, R_out=R_out)
    if table.device.type != "cuda":
        raise ValueError(f"radix_pass: unsupported device {table.device}")
    rows, R = table.shape
    _check_pass_args(B, E, R, R_out)
    _check_rows("table", table, table.device)
    _check_keys(keys, R, table.device)
    if not 0 <= key_row < rows:
        raise ValueError(f"key_row {key_row} outside the table's {rows} rows")
    dev = table.device
    fn, blocks = _kernel("radix_pass", "wg_radix_pass", _PASS_ARGTYPES)
    nblk = blocks(R)
    out = torch.empty((rows, R_out), dtype=torch.float32, device=dev)
    bases = torch.empty((B + 1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * nblk * B + B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), rows, R, keys.data_ptr(), key_row, p, B, E,
                 float(sentinel), out.data_ptr(), out.stride(0), R_out, bases.data_ptr(),
                 scratch.data_ptr(), scratch[nblk * B:].data_ptr(),
                 scratch[2 * nblk * B:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix_pass kernel launch failed with CUDA error {err}")
    radix_pass.launches += 1
    return out, bases


radix_pass.launches = 0


def radix_unpass(gin: torch.Tensor, keys: torch.Tensor, p: int, bases: torch.Tensor, *,
                 B: int, E: int, sentinel: int) -> torch.Tensor:
    """K6: the inverse of one pass for a gradient table (see
    radix_unpass_plain). A CPU table runs the plain version; a CUDA table
    launches the kernels of `csrc/radix_unpass.cu` (the same digit counts
    and scan as K5, recomputed from the saved keys, then the stable gather)
    and adds one to `radix_unpass.launches`."""
    if gin.device.type == "cpu":
        return radix_unpass_plain(gin, keys, p, bases, B=B, E=E, sentinel=sentinel)
    if gin.device.type != "cuda":
        raise ValueError(f"radix_unpass: unsupported device {gin.device}")
    dev = gin.device
    R = keys.shape[0]
    grows = gin.shape[0]
    if not 2 <= B <= 32:
        raise ValueError(f"B must be in [2, 32], got {B}")
    _check_rows("gin", gin, dev)
    _check_keys(keys, R, dev)
    if gin.shape[1] < R + B * E:
        raise ValueError(f"gin has {gin.shape[1]} columns for a pass of {R} entries")
    if bases.dtype != torch.int32 or tuple(bases.shape) != (B + 1,) or bases.device != dev \
            or not bases.is_contiguous():
        raise ValueError(f"bases must be a contiguous int32 tensor of shape ({B + 1},) on {dev}")
    fn, blocks = _kernel("radix_unpass", "wg_radix_unpass", _UNPASS_ARGTYPES)
    nblk = blocks(R)
    out = torch.empty((grows, R), dtype=torch.float32, device=dev)
    scratch = torch.empty((2 * nblk * B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gin.data_ptr(), gin.stride(0), grows, keys.data_ptr(), R, p, B,
                 float(sentinel), bases.data_ptr(), out.data_ptr(), out.stride(0),
                 scratch.data_ptr(), scratch[nblk * B:].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix_unpass kernel launch failed with CUDA error {err}")
    radix_unpass.launches += 1
    return out


radix_unpass.launches = 0


def radix_partition(table: torch.Tensor, num_buckets: int, *, B: int = 16, E: int = 256,
                    tail_pad: int = 0, key_row: int = 0
                    ) -> Tuple[torch.Tensor, PartitionMeta]:
    """Stably partition the columns of table [rows, R] (f32, R % E == 0) by
    the integer key in row `key_row`; keys >= num_buckets are remapped to
    the sentinel. `table` is not modified.

    Returns (out [rows, R + L B E + tail_pad], meta). Bucket k's entries sit
    at [starts[k], starts[k] + counts[k]) of `out` (bucket_ranges); every
    other position holds a sentinel entry. `tail_pad` (a multiple of E)
    adds sentinel columns after the last pass."""
    rows, R0 = table.shape
    if R0 % E or tail_pad % E:
        raise ValueError(f"R ({R0}) and tail_pad ({tail_pad}) must be multiples of E ({E})")
    L = num_passes(num_buckets, B)
    keyspace = B ** L
    if keyspace > 1 << 24:
        raise ValueError("keys must stay exact in f32: B**L > 2^24")
    sentinel = keyspace - 1
    keys = table[key_row]
    keys = torch.where(keys >= num_buckets, torch.full_like(keys, float(sentinel)), keys)
    cur = table
    bases_list, saved = [], []
    R = R0
    for p in range(L):
        R_out = R + B * E + (tail_pad if p == L - 1 else 0)
        cur, bases = radix_pass(cur, keys, p, B=B, E=E, key_row=key_row, sentinel=sentinel,
                                R_out=R_out)
        saved.append(keys)
        bases_list.append(bases)
        # a copy, so that the saved key row does not keep the whole table alive
        keys = cur[key_row].clone()
        R = R_out
    meta = PartitionMeta(E=E, B=B, L=L, R0=R0, num_buckets=num_buckets, keyspace=keyspace,
                         bases=tuple(bases_list), saved_keys=tuple(saved))
    return cur, meta


def bucket_ranges(meta: PartitionMeta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per bucket (starts [num_buckets] int32, counts [num_buckets] int32)
    in the final layout, with the aligned gaps between the last pass's
    digit groups."""
    B, L, nb = meta.B, meta.L, meta.num_buckets
    hist = histogram(meta.saved_keys[0], nb)
    group_w = B ** (L - 1)
    pad = (-nb) % group_w
    h2 = torch.cat([hist, hist.new_zeros(pad)]).reshape(-1, group_w)
    offs = torch.cumsum(h2, 1) - h2
    starts = meta.bases[L - 1][:h2.shape[0], None] + offs
    return starts.reshape(-1)[:nb].to(torch.int32), hist


def radix_unpartition(gtable: torch.Tensor, meta: PartitionMeta) -> torch.Tensor:
    """Send a gradient table [grows, >= R0 + L B E] in the partitioned
    layout back to the original column order: [grows, R0]. Columns of
    sentinel entries are never read; a column whose key was remapped to
    the sentinel gets zeros."""
    if gtable.shape[1] < meta.R0 + meta.L * meta.B * meta.E:
        raise ValueError(f"gtable has {gtable.shape[1]} columns, the partition "
                         f"{meta.R0 + meta.L * meta.B * meta.E}")
    cur = gtable
    for p in reversed(range(meta.L)):
        cur = radix_unpass(cur, meta.saved_keys[p], p, meta.bases[p], B=meta.B, E=meta.E,
                           sentinel=meta.keyspace - 1)
    return cur
