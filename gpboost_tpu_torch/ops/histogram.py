"""Gradient / hessian / count histograms for tree learning.

`hist_segment` is the port of the Pallas TPU kernel
`hist_block_rows_pallas` (gpboost_tpu/ops/histogram.py:85) as the tree
learner drives it (tree_learner.py:664-681): the (p, 3, B) histogram of the
rows at positions [s0, s0 + cnt) of the physically partitioned bin matrix.

On a CUDA tensor it launches the hand-written kernel in
csrc/histogram.cu (built with nvcc for sm_90a at first use, loaded with
ctypes) or raises; there is no fallback. On a CPU tensor it runs the plain
version, the reference's one-hot einsum (tree_learner.py:659-662) in float32.
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
KERNEL_SOURCE = os.path.join(_PKG_ROOT, "csrc", "histogram.cu")
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# rows per block of the plain version (the reference's non-TPU row block)
_PLAIN_ROW_BLOCK = 8192


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the histogram kernel is built "
                           "with the CUDA toolkit at first use on the card")
    return path


def build():
    """Compile csrc/histogram.cu into _build/ (keyed by a content hash of
    the source) unless it is there already. Returns (library path, seconds
    spent compiling, compiler output)."""
    with open(KERNEL_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(_BUILD_DIR, f"libgpb_hist-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0, r.stdout + r.stderr


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build()[0])
    lib.gpb_hist_chunk_rows.restype = ctypes.c_int
    lib.gpb_hist_chunk_rows.argtypes = []
    lib.gpb_hist_segment.restype = ctypes.c_int
    lib.gpb_hist_segment.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


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
    lib = _library()
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
        dev.index if dev.index is not None else torch.cuda.current_device(),
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
