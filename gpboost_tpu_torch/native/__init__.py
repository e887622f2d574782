"""ctypes bindings of the shared native library native/gpb_native.cpp.

Both packages load the same source, built on demand with g++ into the same
content-hashed path (native/build/libgpb_native-<hash>.so), so they bin
features and search Vecchia neighbours alike. Every entry point keeps the
reference's numpy fallback for hosts without a compiler.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "gpb_native.cpp")


def _lib_path():
    """Build artifact keyed on a content hash of the source."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(_REPO_ROOT, "native", "build")
    os.makedirs(build_dir, exist_ok=True)
    return os.path.join(build_dir, f"libgpb_native-{h}.so")


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None when it cannot be built here."""
    try:
        path = _lib_path()
        if not os.path.exists(path):
            # build beside the target and rename: another process may be
            # loading the same path concurrently
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                                _SRC], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.gpb_bin_column.restype = None
    lib.gpb_bin_column.argtypes = [
        np.ctypeslib.ndpointer(np.float64), ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32)]
    lib.gpb_nn_preceding_2d.restype = None
    lib.gpb_nn_preceding_2d.argtypes = [
        np.ctypeslib.ndpointer(np.float64), ctypes.c_longlong,
        ctypes.c_int, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.uint8)]
    return lib


def bin_column(values, upper_bounds, nan_bin=-1):
    """Quantize one feature column against its bin upper bounds."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float64)
    uppers = np.ascontiguousarray(upper_bounds, dtype=np.float64)
    if lib is None:
        bins = np.searchsorted(uppers[:-1], values, side="left").astype(np.int32)
        if nan_bin >= 0:
            bins = np.where(np.isfinite(values), bins, nan_bin).astype(np.int32)
        return bins
    out = np.empty(len(values), dtype=np.int32)
    lib.gpb_bin_column(values, len(values), uppers, len(uppers), nan_bin, out)
    return out


def nn_preceding_2d(coords, m):
    """Nearest preceding neighbours for 2-D coords (Vecchia), by the native
    cell-bucketed search; (idx (n, m) int64, mask (n, m) bool), or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    n = len(coords)
    idx = np.empty((n, m), dtype=np.int64)
    mask = np.empty((n, m), dtype=np.uint8)
    lib.gpb_nn_preceding_2d(coords, n, m, idx, mask)
    return idx, mask.astype(bool)
