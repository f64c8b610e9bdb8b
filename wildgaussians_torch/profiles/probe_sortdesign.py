"""The primitives a counting-scatter or sample-sort redesign of the binning
would be built from, timed on the card.

    python -m wildgaussians_torch.profiles.probe_sortdesign

Counterpart of `tools/profiles/probe_sortdesign.py`. Sections 1-4 time
`torch.sort` and the gathers of its payload rows at the JAX probe's sizes
(R = 7.44M entries, the same key types and payload counts); section 5 is
P2, the run scatter. Times are CUDA events around `ITERS` calls after one
warm-up. The JAX probe folded every sort output into its timing chain by
XOR, because XLA drops a sort's unused payload outputs from a jitted
program; eager PyTorch computes every output it is asked for, so that
control is left out.

Keys and payloads keep their widths: a u32 key is held as int32 with its
top bit flipped (the same order), a u16 payload as int16, and a sort on two
u32 keys becomes one sort on the combined 64-bit key (first key in the high
half). One kernel, with its plain version beside it:

  P2 `run_scatter`  csrc/run_scatter.cu  dst[:, e, c RUN:(c+1) RUN] =
                                         src[:, starts[c E + e] : + RUN]

The wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel (or an
error).
"""
import ctypes
import json
import sys
from typing import Callable, List

import torch

from ..ops import _build

R = 7_440_000
ITERS = 3
W = 8                        # rows of the run-scatter table
# (C, K, E, RUN) of the JAX probe's five run-scatter calls
# (probe_sortdesign.py:177-181): the first is the pure-bandwidth control
SCATTER_CONFIGS = ((8, 929_792, 1, 929_792), (454, 16_384, 8, 2_048), (454, 16_384, 32, 512),
                   (1_816, 4_096, 32, 128), (3_632, 2_048, 64, 32))
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 (NVIDIA data sheet)


def run_scatter_plain(src: torch.Tensor, starts: torch.Tensor, E: int, run: int) -> torch.Tensor:
    """Plain PyTorch P2, an index gather: dst [W, E, C run] with
    dst[:, e, c run + r] = src[:, starts[c E + e] + r]."""
    return src[:, scatter_index(starts, E, run)].view(src.shape[0], E, -1)


def scatter_index(starts: torch.Tensor, E: int, run: int) -> torch.Tensor:
    """The source column of every destination column, [E C run] int64."""
    C = starts.shape[0] // E
    first = starts.view(C, E).T.long()                                   # [E, C]
    return (first[..., None] + torch.arange(run, device=starts.device)).reshape(-1)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def _kernel():
    fn = _build.load("run_scatter").wg_run_scatter
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def run_scatter(src: torch.Tensor, starts: torch.Tensor, E: int, run: int) -> torch.Tensor:
    """P2: copy C E runs of `run` columns of the 32-bit table src [W, L]
    (int32 or float32; the bits move as they are) from the columns
    starts [C E] int32 to dst [W, E, C run], run (c, e) at
    dst[:, e, c run:(c + 1) run]. Every run must lie inside src. A CPU
    table runs the plain version; a CUDA table launches the kernel in
    `csrc/run_scatter.cu` and adds one to `run_scatter.launches`."""
    if src.device.type == "cpu":
        return run_scatter_plain(src, starts, E, run)
    if src.device.type != "cuda":
        raise ValueError(f"run_scatter: unsupported device {src.device}")
    if src.dim() != 2 or src.element_size() != 4 or src.stride(1) != 1 \
            or src.data_ptr() % 16 != 0:
        raise ValueError(f"src must be a 16-byte aligned 32-bit [W, L] table with contiguous "
                         f"rows, got {src.dtype} {tuple(src.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.is_contiguous() \
            or starts.shape[0] % E != 0 or starts.device != src.device:
        raise ValueError(f"starts must be a contiguous int32 [C {E}] on {src.device}")
    C = starts.shape[0] // E
    rows = src.shape[0]
    if rows * C * E * ((run + 3) // 4) >= 2 ** 31:
        raise ValueError(f"run_scatter: {rows} rows of {C * E} runs of {run} columns are "
                         "2^31 or more 4-column groups")
    dst = torch.empty((rows, E, C * run), dtype=src.dtype, device=src.device)
    fn = _kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), src.stride(0), starts.data_ptr(), rows, E, C, run,
                 dst.data_ptr(), dst.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"run_scatter kernel launch failed with CUDA error {err}")
    run_scatter.launches += 1
    return dst


run_scatter.launches = 0


def time_ms(fn: Callable[[], object], iters: int = ITERS) -> float:
    """CUDA-event time of one call, over `iters` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _u32(gen, shape, device, dtype=torch.int32):
    """Uniform random 32-bit (or, for int16, 16-bit) words."""
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen, dtype=dtype, device=device)


def _combined(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One int64 key ordered as the u32 pair (k1, k2), from their
    order-preserving int32 forms: k1 signed in the high half, k2 shifted to
    [0, 2^32) in the low half."""
    return (k1.long() << 32) | (k2.long() + 2 ** 31)


def sort_measurements(device, log=print) -> List[dict]:
    """Sections 1-4 of the JAX probe: flat key-only sorts, sorts with
    payload rows gathered after them, batched chunk sorts and bucket sorts,
    each timed on `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []

    def record(label, ms, **kw):
        rows.append({"section": label, "ms": ms, **kw})
        log(f"{label}: {ms:6.3f} ms")

    key = _u32(gen, (R,), device)
    prime = torch.tensor(-1640531535, dtype=torch.int32, device=device)   # 2654435761 as int32
    record("mix-only (multiply)", time_ms(lambda: key * prime))
    # 1. flat scaling (key-only)
    for r in (930_000, R):
        k0 = _u32(gen, (r,), device)
        record(f"flat unstable key-only R={r:,}", time_ms(lambda: torch.sort(k0, stable=False)),
               R=r)
    # 2. payload marginals: the sort, then every payload row gathered
    for nk, stable, n_rows, dt in ((1, False, 2, torch.int32), (1, False, 6, torch.int32),
                                   (2, False, 6, torch.int32), (1, True, 6, torch.int32),
                                   (1, False, 6, torch.int16), (2, False, 4, torch.int32),
                                   (2, False, 8, torch.int32)):
        pays = [_u32(gen, (R,), device, dt) for _ in range(n_rows)]
        if nk == 2:
            # the JAX probe's second key takes the place of the first payload
            k = _combined(key, key * prime)
            pays = pays[1:]
        else:
            k = key

        def step(k=k, pays=pays, stable=stable):
            _v, idx = torch.sort(k, stable=stable)
            return [p.index_select(0, idx) for p in pays]
        record(f"flat {'stable' if stable else 'unstable'} nk={nk} key+{n_rows}x"
               f"{'u16' if dt == torch.int16 else 'u32'}", time_ms(step), nk=nk, stable=stable,
               payload_rows=n_rows)
    # 3. batched chunk sorts
    for K in (2048, 16384):
        C = R // K
        kb = _u32(gen, (C, K), device)
        for n_rows in (0, 6):
            pays = [_u32(gen, (C, K), device) for _ in range(n_rows)]

            def step(kb=kb, pays=pays):
                _v, idx = torch.sort(kb, dim=1, stable=False)
                return [torch.gather(p, 1, idx) for p in pays]
            record(f"batched [{C},{K}] key+{n_rows}p", time_ms(step), C=C, K=K,
                   payload_rows=n_rows)
    # 4. final bucket sorts [E, L]
    for E, L in ((32, 291_000), (256, 36_500), (1024, 9_088)):
        Lp = ((L + 127) // 128) * 128
        kb = _u32(gen, (E, Lp), device)
        pays = [_u32(gen, (E, Lp), device) for _ in range(6)]

        def step(kb=kb, pays=pays):
            _v, idx = torch.sort(kb, dim=1, stable=False)
            return [torch.gather(p, 1, idx) for p in pays]
        record(f"bucket [{E},{Lp}] key+6p", time_ms(step), E=E, L=Lp, payload_rows=6)
    return rows


def scatter_inputs(C: int, K: int, E: int, run: int, device, seed: int = 0):
    """The JAX probe's run-scatter inputs: src [W, C K + K] random words,
    starts[c E + e] = c K + e run."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src = _u32(gen, (W, C * K + K), device)
    starts = (torch.arange(C, device=device)[:, None] * K
              + torch.arange(E, device=device)[None, :] * run).to(torch.int32).reshape(-1)
    return src, starts


def scatter_bound_ms(E: int, C: int, run: int) -> float:
    """Each run read once and written once over the memory rate."""
    return 2 * W * C * E * run * 4 / PEAK_BYTES * 1e3


def scatter_measurements(device, log=print) -> List[dict]:
    """Section 5, P2: each configuration's run scatter timed on `device`,
    with its bound and the time of the same gather as one index_select."""
    rows = []
    for C, K, E, run in SCATTER_CONFIGS:
        src, starts = scatter_inputs(C, K, E, run, device)
        ms = time_ms(lambda: run_scatter(src, starts, E, run))
        idx = scatter_index(starts, E, run)
        library_ms = time_ms(lambda: src.index_select(1, idx))
        copies = C * E
        row = {"C": C, "K": K, "E": E, "RUN": run, "copies": copies,
               "mb_read_written": 2 * W * copies * run * 4 / 1e6, "ms": ms,
               "us_per_copy": ms * 1e3 / copies, "bound_ms": scatter_bound_ms(E, C, run),
               "library_ms": library_ms}
        row["bandwidth_tb_s"] = row["mb_read_written"] * 1e6 / (ms * 1e-3) / 1e12
        rows.append(row)
        log(f"run-scatter C={C} E={E} RUN={run} ({copies} copies, "
            f"{row['mb_read_written']:.0f} MB r+w): {ms:6.3f} ms "
            f"({row['us_per_copy']:.3f} us/copy incl BW, {row['bandwidth_tb_s']:.2f} TB/s)")
    return rows


def main():
    if not torch.cuda.is_available():
        print("probe_sortdesign: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = {"card": torch.cuda.get_device_name(0), "sorts": sort_measurements(dev),
           "run_scatter": scatter_measurements(dev)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
