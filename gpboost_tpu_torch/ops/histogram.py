"""Gradient / hessian / count histograms for tree learning.

`hist_segment` is the port of the Pallas TPU kernel
`hist_block_rows_pallas` (gpboost_tpu/ops/histogram.py:85) as the tree
learner drives it (tree_learner.py:664-681): the (p, 3, B) histogram of the
rows at positions [s0, s0 + cnt) of the physically partitioned bin matrix.

`hist_masked` is the port of `hist_pallas` (histogram.py:155), the kernel
of the masked full-scan (parallel) tree learners: the (p, 3, B) histogram of
the rows whose leaf id equals a target, over feature-major bins (p, n).
`hist_block`, the port of `hist_block_pallas` (histogram.py:129), is the
same kernel source with the mask compiled out: the histogram of every row.

On a CUDA tensor each wrapper launches its hand-written kernel (csrc/*.cu,
built with nvcc for sm_90a at first use, loaded with ctypes) or raises;
there is no fallback. On a CPU tensor it runs the plain version, the
reference's one-hot einsum in float32.
"""

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel library name -> its CUDA source; one nvcc each, run together
KERNEL_SOURCES = {
    "hist_segment": os.path.join(_PKG_ROOT, "csrc", "histogram.cu"),
    "hist_masked": os.path.join(_PKG_ROOT, "csrc", "hist_masked.cu"),
}
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# rows per block of the plain versions (the reference's non-TPU row block)
_PLAIN_ROW_BLOCK = 8192


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the histogram kernels are built "
                           "with the CUDA toolkit at first use on the card")
    return path


def _library_path(name):
    with open(KERNEL_SOURCES[name], "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libgpb_{name}-{h.hexdigest()[:16]}.so")


def build():
    """Compile every kernel source into _build/ (keyed by a content hash of
    the source) unless it is there already, one nvcc per source, all
    started together. Returns {name: (library path, seconds spent
    compiling, compiler output)}."""
    done, todo, running = {}, {}, {}
    for name in KERNEL_SOURCES:
        path = _library_path(name)
        if os.path.exists(path):
            done[name] = (path, 0.0, "")
        else:
            todo[name] = path
    if not todo:
        return done
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        for name, path in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                                     KERNEL_SOURCES[name]],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, path, time.perf_counter())
        for name, (proc, tmp, path, t0) in running.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {KERNEL_SOURCES[name]} "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, path)
            done[name] = (path, time.perf_counter() - t0, log)
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return done


_c = ctypes
# each library's C entry points and their argument types; all return int
_ENTRY_POINTS = {
    "hist_segment": {
        "gpb_hist_chunk_rows": [],
        "gpb_hist_segment": [
            _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_void_p,
            _c.c_longlong, _c.c_longlong, _c.c_longlong, _c.c_longlong,
            _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p]},
    "hist_masked": {
        "gpb_hist_masked_chunk_rows": [],
        "gpb_hist_masked": [
            _c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_int, _c.c_int,
            _c.c_longlong, _c.c_void_p, _c.c_void_p, _c.c_void_p]},
}


@functools.lru_cache(maxsize=None)
def _library(name):
    lib = ctypes.CDLL(build()[name][0])
    for fn, argtypes in _ENTRY_POINTS[name].items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    return lib


def _device_index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def hist_segment_plain(bins_pos, stats_pos, s0, cnt, num_bins):
    """Plain PyTorch version: the one-hot einsum of tree_learner.py:659-662
    in float32, over row blocks of the segment. (p, 3, num_bins) f32."""
    s0, cnt = int(s0), int(cnt)
    p = bins_pos.shape[1]
    bvals = torch.arange(num_bins, dtype=torch.int32, device=bins_pos.device)
    acc = torch.zeros((p, 3, num_bins), dtype=torch.float32,
                      device=bins_pos.device)
    for start in range(s0, s0 + cnt, _PLAIN_ROW_BLOCK):
        stop = min(start + _PLAIN_ROW_BLOCK, s0 + cnt)
        onehot = (bins_pos[start:stop].to(torch.int32)[:, :, None]
                  == bvals[None, None, :]).to(torch.float32)
        acc = acc + torch.einsum("rc,rfb->fcb", stats_pos[start:stop], onehot)
    return acc


def _check(bins_pos, stats_pos, num_bins):
    if bins_pos.dim() != 2 or stats_pos.dim() != 2 \
            or stats_pos.shape != (bins_pos.shape[0], 3):
        raise ValueError("hist_segment needs bins (n, p) and stats (n, 3), "
                         f"got {tuple(bins_pos.shape)} and "
                         f"{tuple(stats_pos.shape)}")
    if bins_pos.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins must be uint8 or int32, got {bins_pos.dtype}")
    if bins_pos.dtype == torch.uint8 and num_bins > 256:
        raise ValueError("uint8 bins hold at most 256 bins")
    if stats_pos.dtype != torch.float32:
        raise TypeError(f"stats must be float32, got {stats_pos.dtype}")
    if stats_pos.device != bins_pos.device:
        raise ValueError("bins and stats must be on the same device")
    if not (bins_pos.is_contiguous() and stats_pos.is_contiguous()):
        raise ValueError("bins and stats must be contiguous")
    if num_bins < 1 or bins_pos.shape[1] < 1:
        raise ValueError("hist_segment needs num_bins >= 1 and p >= 1")


def hist_segment(bins_pos, stats_pos, s0, cnt, num_bins):
    """(p, 3, num_bins) f32 histogram of positions [s0, s0 + cnt).

    bins_pos (n, p) uint8/int32, stats_pos (n, 3) f32 [grad, hess, count].
    s0 and cnt are host ints, or 0-dim integer tensors on the bins' device
    (then the kernel reads them on the device and the call needs no host
    sync). A CUDA tensor launches the kernel, a CPU tensor runs
    `hist_segment_plain`; any other device raises.
    """
    _check(bins_pos, stats_pos, num_bins)
    dev = bins_pos.device
    if dev.type == "cpu":
        return hist_segment_plain(bins_pos, stats_pos, s0, cnt, num_bins)
    if dev.type != "cuda":
        raise ValueError(f"hist_segment runs on cuda or cpu, not {dev.type}")
    lib = _library("hist_segment")
    chunk = lib.gpb_hist_chunk_rows()
    n, p = bins_pos.shape
    if isinstance(s0, torch.Tensor):
        seg = torch.stack([s0.reshape(()), cnt.reshape(())]).to(
            device=dev, dtype=torch.int32)
        s0_h = cnt_h = chunk0 = 0
        nchunks = max(1, math.ceil(n / chunk))
        seg_ptr = seg.data_ptr()
    else:
        seg = None
        s0_h, cnt_h = int(s0), int(cnt)
        if s0_h < 0 or cnt_h < 0 or s0_h + cnt_h > n:
            raise ValueError(f"segment [{s0_h}, {s0_h + cnt_h}) outside "
                             f"[0, {n})")
        chunk0 = s0_h // chunk
        nchunks = max(1, math.ceil((s0_h + cnt_h) / chunk) - chunk0)
        seg_ptr = None
    partial = torch.empty((nchunks, p, 3, num_bins), dtype=torch.float32,
                          device=dev)
    out = torch.empty((p, 3, num_bins), dtype=torch.float32, device=dev)
    rc = lib.gpb_hist_segment(
        _device_index(dev),
        bins_pos.data_ptr(), int(bins_pos.dtype == torch.uint8),
        stats_pos.data_ptr(), seg_ptr, s0_h, cnt_h, chunk0, nchunks, p,
        num_bins, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hist_segment kernel launch failed: CUDA error "
                           f"{rc}")
    hist_segment.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path went through the kernel)
hist_segment.launches = 0


def _onehot_hist_T(bins_T, stats_T, weight, num_bins):
    """The blocked one-hot einsum of _hist_einsum (tree_learner.py:33-64) in
    float32: (p, 3, num_bins) of stats_T (3, n) times the optional 0/1 row
    weight (n,), by bins_T (p, n)."""
    p, n = bins_T.shape
    bvals = torch.arange(num_bins, dtype=torch.int32, device=bins_T.device)
    acc = torch.zeros((p, 3, num_bins), dtype=torch.float32,
                      device=bins_T.device)
    for start in range(0, n, _PLAIN_ROW_BLOCK):
        stop = min(start + _PLAIN_ROW_BLOCK, n)
        s = stats_T[:, start:stop]
        if weight is not None:
            s = s * weight[None, start:stop]
        onehot = (bins_T[:, start:stop].to(torch.int32)[:, :, None]
                  == bvals[None, None, :]).to(torch.float32)
        acc = acc + torch.einsum("cr,prb->pcb", s, onehot)
    return acc


def hist_masked_plain(bins_T, node, stats_T, target, num_bins):
    """Plain PyTorch version of `hist_masked`. (p, 3, num_bins) f32."""
    if isinstance(target, torch.Tensor):
        target = target.reshape(()).to(device=node.device)
    w = (node == target).to(torch.float32)
    return _onehot_hist_T(bins_T, stats_T, w, num_bins)


def hist_block_plain(bins_T, stats_T, num_bins):
    """Plain PyTorch version of `hist_block`. (p, 3, num_bins) f32."""
    return _onehot_hist_T(bins_T, stats_T, None, num_bins)


def _check_T(name, bins_T, stats_T, num_bins, node=None):
    if bins_T.dim() != 2 or stats_T.dim() != 2 \
            or stats_T.shape != (3, bins_T.shape[1]):
        raise ValueError(f"{name} needs bins_T (p, n) and stats_T (3, n), "
                         f"got {tuple(bins_T.shape)} and "
                         f"{tuple(stats_T.shape)}")
    if bins_T.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins must be uint8 or int32, got {bins_T.dtype}")
    if bins_T.dtype == torch.uint8 and num_bins > 256:
        raise ValueError("uint8 bins hold at most 256 bins")
    if stats_T.dtype != torch.float32:
        raise TypeError(f"stats must be float32, got {stats_T.dtype}")
    tensors = [bins_T, stats_T]
    if node is not None:
        if node.shape != (bins_T.shape[1],):
            raise ValueError(f"{name} needs node ({bins_T.shape[1]},), got "
                             f"{tuple(node.shape)}")
        if node.dtype != torch.int32:
            raise TypeError(f"node must be int32, got {node.dtype}")
        tensors.append(node)
    if any(t.device != bins_T.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if num_bins < 1 or not 1 <= bins_T.shape[0] <= 65535:
        raise ValueError(f"{name} needs num_bins >= 1 and 1 <= p <= 65535")
    if bins_T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not "
                         f"{bins_T.device.type}")


def _launch_masked(bins_T, node, stats_T, target, num_bins):
    """Both passes of csrc/hist_masked.cu; node None is the unmasked
    variant."""
    dev = bins_T.device
    lib = _library("hist_masked")
    p, n = bins_T.shape
    nchunks = max(1, math.ceil(n / lib.gpb_hist_masked_chunk_rows()))
    tgt = None
    target_host = 0
    if isinstance(target, torch.Tensor):
        if target.numel() != 1 or target.device != dev \
                or target.dtype.is_floating_point:
            raise ValueError("a tensor target must be one integer on the "
                             "bins' device")
        tgt = target.reshape(()).to(torch.int32)
    elif target is not None:
        target_host = int(target)
    partial = torch.empty((nchunks, p, 3, num_bins), dtype=torch.float32,
                          device=dev)
    out = torch.empty((p, 3, num_bins), dtype=torch.float32, device=dev)
    rc = lib.gpb_hist_masked(
        _device_index(dev), bins_T.data_ptr(),
        int(bins_T.dtype == torch.uint8),
        None if node is None else node.data_ptr(), stats_T.data_ptr(),
        None if tgt is None else tgt.data_ptr(), target_host, n, p, num_bins,
        nchunks, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hist_masked kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def hist_masked(bins_T, node, stats_T, target, num_bins):
    """(p, 3, num_bins) f32 histogram of the rows r with node[r] == target.

    bins_T (p, n) uint8/int32 feature-major, node (n,) int32, stats_T (3, n)
    f32 [grad, hess, count]; n needs no padding. target is a host int or a
    0-dim integer tensor on the bins' device (then the launch needs no host
    sync). A CUDA tensor launches the kernel, a CPU tensor runs
    `hist_masked_plain`; any other device raises.
    """
    _check_T("hist_masked", bins_T, stats_T, num_bins, node)
    if bins_T.device.type == "cpu":
        return hist_masked_plain(bins_T, node, stats_T, target, num_bins)
    out = _launch_masked(bins_T, node, stats_T, target, num_bins)
    hist_masked.launches += 1
    return out


def hist_block(bins_T, stats_T, num_bins):
    """(p, 3, num_bins) f32 histogram of every row: bins_T (p, n)
    uint8/int32, stats_T (3, n) f32 whose rows outside the block the caller
    has already zeroed. A CUDA tensor launches the unmasked variant of the
    hist_masked kernel, a CPU tensor runs `hist_block_plain`; any other
    device raises."""
    _check_T("hist_block", bins_T, stats_T, num_bins)
    if bins_T.device.type == "cpu":
        return hist_block_plain(bins_T, stats_T, num_bins)
    out = _launch_masked(bins_T, None, stats_T, None, num_bins)
    hist_block.launches += 1
    return out


hist_masked.launches = 0
hist_block.launches = 0
