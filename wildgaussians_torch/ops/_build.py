"""Builds the port's CUDA sources (`csrc/*.cu`) with nvcc and loads them with
ctypes.

Each source exposes a plain C interface, so it compiles in seconds without
PyTorch's headers. A library is built at its first use into `_build/` beside
`csrc/` (listed in .gitignore), named by a hash of its source, the headers
of `csrc/` and the flags, and reused while none of them changes. Nothing
here runs at import: the CPU tests import every module on machines without
nvcc.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildLog(NamedTuple):
    name: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output, with the -Xptxas -v resource lines


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return cand


def _lib_path(name: str) -> Path:
    # the source, every header of csrc/ it may include, and the flags
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, BuildLog]:
    """Compile the named sources that are not built yet, one nvcc process
    per source, all started together. Raises with nvcc's output on failure."""
    logs, running = {}, []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log_file = out.with_suffix(".log")
            logs[name] = BuildLog(name, 0.0, log_file.read_text() if log_file.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out, time.perf_counter()))
    for name, proc, tmp, out, t0 in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)   # atomic: a half-written library is never loaded
        out.with_suffix(".log").write_text(text)
        logs[name] = BuildLog(name, time.perf_counter() - t0, text)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib
