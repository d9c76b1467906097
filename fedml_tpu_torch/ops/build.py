"""Build and load the port's CUDA kernels.

The sources under ``fedml_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, at
first use, and loaded with ``ctypes``.  The library goes into
``fedml_tpu_torch/_build/`` under a name keyed on a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the build.  Each
source compiles in its own ``nvcc`` process, all started together.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside the library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is only called when a wrapper launches a kernel on the card.

A build that compiles counts once in ``kernel_build_total`` and
``kernel_build_seconds_total`` (``obs.note_kernel_build``), attributed to
the program family that triggered it; a reused build counts nothing.

Clients may train in threads on one card (the message-driven FedAvg of
``comm/fedavg_messaging.py``): ``library()`` builds and loads under a
lock, once, and ``count_launch`` adds to a wrapper's launch count under
another, so that no increment is lost between threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from fedml_tpu_torch import obs

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argtypes of every C entry; each returns a cudaError_t as int
SIGNATURES = {
    # x, gamma, beta, y, mean, rstd, N, S, C, G, eps, dtype, param_dtype,
    # then the launch plan (vec, K, threads, rows, smem, resident), stream
    "fedml_gn_fwd": [_P] * 6 + [_I] * 4 + [_F] + [_I] * 8 + [_P],
    # x, dy, gamma, mean, rstd, dx, dgamma, dbeta, part, counter, N, S, C,
    # G, dtype, param_dtype, then the launch plan as above, stream
    "fedml_gn_bwd": [_P] * 10 + [_I] * 12 + [_P],
    # out, V, w, k, P, ld, finalize, dtype, vec, stream
    "fedml_wsum": [_P, _P, _P, _I, _L, _L, _I, _I, _I, _P],
    # k * this many floats of partials for fedml_sqnorm
    "fedml_sqnorm_max_blocks": [],
    # out, partial, V, g, k, P, ld, dtype, vec, stream
    "fedml_sqnorm": [_P, _P, _P, _P, _I, _L, _L, _I, _I, _P],
    # out, V, g, cf, base_ptr, base_const, k, P, ld, accumulate, dtype, vec,
    # stream
    "fedml_clip_agg": [_P, _P, _P, _P, _P, _F, _I, _L, _L, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _sources() -> tuple[list[Path], str]:
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists;
    returns the library's path.  Raises with the compiler's output when a
    source does not compile."""
    sources, key = _sources()
    target = BUILD_DIR / f"libfedml_kernels_{key}.so"
    if target.exists():
        return target
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so, target)
    obs.note_kernel_build(time.perf_counter() - t0, "kernels")
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, by one thread: the
    others wait for it)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fedml_error_string.argtypes = [ctypes.c_int]
            lib.fedml_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def count_launch(wrapper) -> None:
    """One more launch of `wrapper`'s kernel (its ``launches``), safe
    across threads."""
    with _count_lock:
        wrapper.launches += 1


def reset_counts(wrappers) -> None:
    with _count_lock:
        for fn in wrappers:
            fn.launches = 0


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc:
        msg = library().fedml_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_card(t) -> bool:
    """True for a CUDA tensor (kernel path), False for a CPU tensor (plain
    path); any other device has no path and raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def vector_width(elem_size: int, run: int, *ptrs: int, limit: int = 16) -> int:
    """Largest power-of-two element count per load, at most `limit` bytes,
    that divides `run` (the contiguous elements a thread walks) and keeps
    every pointer aligned."""
    vec = limit // elem_size
    while vec > 1:
        if run % vec == 0 and all(p % (vec * elem_size) == 0 for p in ptrs):
            return vec
        vec //= 2
    return 1
