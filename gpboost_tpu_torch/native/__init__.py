"""ctypes bindings of the shared native library native/gpb_native.cpp.

Both packages load the same source, built on demand with g++ into the same
content-hashed path (native/build/libgpb_native-<hash>.so), so they bin
features, search Vecchia neighbours and take TreeSHAP values alike. Every
entry point keeps the reference's numpy fallback for hosts without a
compiler.
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
    lib.gpb_tree_shap.restype = None
    lib.gpb_tree_shap.argtypes = [
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.float64), ctypes.c_longlong, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64)]
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


def tree_shap(tree, X, phi):
    """Add one tree's exact TreeSHAP attributions (Lundberg et al. 2018)
    to phi (n, p + 1), the tree's expected value to its last column: the
    native gpb_tree_shap, or the same algorithm in Python without a
    compiler. tree: split_feature, threshold_real, left, right, is_leaf,
    leaf_value, cover and default_left arrays and num_nodes; a row goes
    left where x <= threshold, a missing x where default_left."""
    nn = tree.num_nodes
    sf = np.ascontiguousarray(tree.split_feature[:nn], dtype=np.int32)
    thr = np.ascontiguousarray(tree.threshold_real[:nn], dtype=np.float64)
    lc = np.ascontiguousarray(tree.left[:nn], dtype=np.int32)
    rc = np.ascontiguousarray(tree.right[:nn], dtype=np.int32)
    il = np.ascontiguousarray(tree.is_leaf[:nn], dtype=np.uint8)
    lv = np.ascontiguousarray(tree.leaf_value[:nn], dtype=np.float64)
    cov = np.ascontiguousarray(tree.cover[:nn], dtype=np.float64)
    dl = np.ascontiguousarray(tree.default_left[:nn], dtype=np.uint8)
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, p = X.shape
    if phi.shape != (n, p + 1) or phi.dtype != np.float64 \
            or not phi.flags.c_contiguous:
        raise ValueError("phi must be a C-contiguous float64 (n, p + 1)")
    lib = _load()
    if lib is not None:
        lib.gpb_tree_shap(sf, thr, lc, rc, il, lv, cov, dl, X, n, p, phi)
        return

    def expected(j):
        if il[j]:
            return lv[j]
        return (cov[lc[j]] * expected(lc[j])
                + cov[rc[j]] * expected(rc[j])) / cov[j]

    def extend(path, zf, of, fi):
        path = path + [[fi, zf, of, 1.0 if not path else 0.0]]
        ud = len(path) - 1
        for i in range(ud - 1, -1, -1):
            path[i + 1][3] += of * path[i][3] * (i + 1) / (ud + 1)
            path[i][3] = zf * path[i][3] * (ud - i) / (ud + 1)
        return path

    def unwind(path, pi):
        ud = len(path) - 1
        of, zf = path[pi][2], path[pi][1]
        next_one = path[ud][3]
        path = [list(e) for e in path]
        for i in range(ud - 1, -1, -1):
            if of != 0:
                tmp = path[i][3]
                path[i][3] = next_one * (ud + 1) / ((i + 1) * of)
                next_one = tmp - path[i][3] * zf * (ud - i) / (ud + 1)
            else:
                path[i][3] = path[i][3] * (ud + 1) / (zf * (ud - i))
        for i in range(pi, ud):
            path[i][:3] = path[i + 1][:3]
        return path[:-1]

    def unwound_sum(path, pi):
        ud = len(path) - 1
        of, zf = path[pi][2], path[pi][1]
        next_one = path[ud][3]
        total = 0.0
        for i in range(ud - 1, -1, -1):
            if of != 0:
                tmp = next_one * (ud + 1) / ((i + 1) * of)
                total += tmp
                next_one = path[i][3] - tmp * zf * (ud - i) / (ud + 1)
            else:
                total += path[i][3] / zf / ((ud - i) / (ud + 1))
        return total

    def recurse(j, x, phi_row, path, pzf, pof, pfi):
        path = extend([list(e) for e in path], pzf, pof, pfi)
        if il[j]:
            ud = len(path) - 1
            for i in range(1, ud + 1):
                w = unwound_sum(path, i)
                phi_row[path[i][0]] += w * (path[i][2] - path[i][1]) * lv[j]
            return
        f = sf[j]
        xv = x[f]
        go_left = (xv <= thr[j]) if np.isfinite(xv) else bool(dl[j])
        hot, cold = (lc[j], rc[j]) if go_left else (rc[j], lc[j])
        izf = iof = 1.0
        pi = next((i for i, e in enumerate(path) if e[0] == f), None)
        if pi is not None:
            izf, iof = path[pi][1], path[pi][2]
            path = unwind(path, pi)
        recurse(hot, x, phi_row, path, cov[hot] / cov[j] * izf, iof, f)
        recurse(cold, x, phi_row, path, cov[cold] / cov[j] * izf, 0.0, f)

    ev = expected(0)
    for i in range(n):
        phi[i, p] += ev
        recurse(0, X[i], phi[i], [], 1.0, 1.0, -1)
