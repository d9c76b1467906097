"""Native (C++) components — build + ctypes loading (port of
fedml_tpu/native/__init__.py; ``fedml_host.cpp`` is the same source).

`load_library()` returns the ctypes handle for libfedml_host.so, compiling
it with g++ on first use into ``fedml_tpu_torch/_build/`` (beside the CUDA
kernels' library, git-ignored), under a name keyed on the source's hash.
Returns None when no toolchain is available; the caller decides what that
means (an explicit NATIVE_TCP backend raises, "TCP" stays on the Python
transport).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "fedml_host.cpp"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")


def _so_path() -> Path:
    # keyed on the source content and the flags: two checkouts at different
    # versions can never load each other's symbols, and an edit rebuilds
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    try:
        digest.update(_SRC.read_bytes())
    except OSError:
        digest.update(b"nosrc")
    return BUILD_DIR / f"libfedml_host-{digest.hexdigest()[:16]}.so"


_SO = _so_path()
_lock = threading.Lock()
_lib = None
_tried = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fh_server_create.restype = ctypes.c_void_p
    lib.fh_server_create.argtypes = [ctypes.c_int]
    lib.fh_recv.restype = ctypes.c_int
    lib.fh_recv.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
    lib.fh_buf_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    lib.fh_connect.restype = ctypes.c_void_p
    lib.fh_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fh_send.restype = ctypes.c_int
    lib.fh_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.fh_conn_close.argtypes = [ctypes.c_void_p]
    lib.fh_server_close.argtypes = [ctypes.c_void_p]
    return lib


def library_built() -> bool:
    """True iff the .so already exists — cheap check, never compiles."""
    return _SO.exists()


def load_library():
    """Build (once) and load the native transport; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.exists():
            # build to a unique temp path + atomic rename, so concurrent
            # builds (parallel test sessions) never load a half-written
            # file
            tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                               check=True, capture_output=True, text=True,
                               timeout=120)
                os.replace(tmp, _SO)
                log.info("built %s", _SO)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                log.warning("native transport build failed: %s", detail)
                return None
            finally:
                if tmp.exists():
                    tmp.unlink()
        try:
            _lib = _configure(ctypes.CDLL(str(_SO)))
        except (OSError, AttributeError) as e:
            # AttributeError = symbol mismatch in _configure
            log.warning("native transport load failed: %s", e)
            _lib = None
        return _lib
