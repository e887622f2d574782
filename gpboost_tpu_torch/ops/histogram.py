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

On a CUDA tensor each wrapper launches its hand-written kernel (csrc/*.cu
around the shared core csrc/hist_common.cuh, built with nvcc for sm_90a at
first use, loaded with ctypes) or raises; there is no fallback. Each is
one launch that sums in fixed point (int64), so its result is the same bits
for any order of the rows and any grid; `hist_*_fixed_point_reference`
repeat that arithmetic in plain torch. On a CPU tensor a wrapper runs the
plain version, the reference's one-hot einsum in float32.
"""

import collections
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
# the header both sources include
KERNEL_HEADERS = [os.path.join(_PKG_ROOT, "csrc", "hist_common.cuh")]
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# rows per block of the plain versions (the reference's non-TPU row block);
# where a block's one-hot would pass _PLAIN_BLOCK_ELEMENTS (p * B > 16,384,
# an EFB bundle of thousands of bins) they scatter-add instead
_PLAIN_ROW_BLOCK = 8192
_PLAIN_BLOCK_ELEMENTS = 2 ** 27
# what the kernels take (row offsets and node ids are int32 on the
# learners' side). hist_masked: one feature's shared histogram, at most
# csrc/hist_common.cuh kMaxBins. hist_segment: any bin count that int32
# codes hold, in windows of WINDOW_BINS (kWindowBins), up to
# MAX_KERNEL_BINS (kMaxSegmentBins): 2^20 bins, a histogram and its int64
# scratch of 12 bytes a (feature, channel, bin), 36 MB a feature
MAX_MASKED_BINS = 4096
WINDOW_BINS = 4096
MAX_KERNEL_BINS = 2 ** 20
MAX_ROWS = 2 ** 31 - 1


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the histogram kernels are built "
                           "with the CUDA toolkit at first use on the card")
    return path


def _library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [KERNEL_SOURCES[name], *KERNEL_HEADERS]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libgpb_{name}-{h.hexdigest()[:16]}.so")


def build():
    """Compile every kernel source into _build/ (keyed by a content hash of
    the source, the shared header and the flags) unless it is there already, one nvcc per source, all
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
_P = _c.c_void_p
# each library's C entry point and its argument types; both return int
_ENTRY_POINTS = {
    "hist_segment": ("gpb_hist_segment", [
        _c.c_int, _P, _c.c_int, _P, _P, _c.c_int, _P, _c.c_longlong,
        _c.c_longlong, _c.c_longlong, _c.c_int, _c.c_int, _P, _P, _P, _P]),
    "hist_masked": ("gpb_hist_masked", [
        _c.c_int, _P, _c.c_int, _P, _P, _P, _c.c_int, _P, _c.c_int,
        _c.c_longlong, _c.c_int, _c.c_int, _P, _P, _P, _P]),
}


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn_name, argtypes = _ENTRY_POINTS[name]
    fn = getattr(ctypes.CDLL(build()[name][0]), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _device_index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


# (device index, p, num_bins) -> (int64 accumulator (p * 3 * num_bins,),
# int32 ticket counters (p * bin windows,)): zero at rest; every launch
# leaves them zero again, so one pair serves every launch of that shape on
# the device's stream (launches on one device run in stream order)
_SCRATCH = {}


def bin_windows(num_bins):
    """The bin windows of a hist_segment launch (hist_common.cuh
    plan_windows): 1 up to WINDOW_BINS bins."""
    return -(-int(num_bins) // WINDOW_BINS)


def _scratch(dev, p, num_bins):
    key = (_device_index(dev), p, num_bins)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.zeros(p * 3 * num_bins, dtype=torch.int64, device=dev),
            torch.zeros(p * bin_windows(num_bins), dtype=torch.int32,
                        device=dev))
    return _SCRATCH[key]


def _launch(name, *args):
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# --- fixed point (csrc/hist_common.cuh) ---------------------------------

def _log2_rows(n):
    """The least L with n <= 2^L."""
    return max(int(n) - 1, 0).bit_length()


def stat_amax(stats, dim):
    """(3,) f32 max |stats| of each channel; stats hold the channels along
    `dim` (stats_T (3, n): dim=1; stats_pos (n, 3): dim=0). Zeros when
    there are no rows; NaN or inf where a channel holds one."""
    if stats.shape[dim] == 0:
        return torch.zeros(3, dtype=torch.float32, device=stats.device)
    return torch.amax(torch.abs(stats), dim=dim).to(torch.float32)


def _pow2(k):
    """2.0 ** k in float64, exactly, from the exponent bits (|k| < 1000)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_point_scale(amax, n):
    """(up, down, finite), each (3,): 2^k_c, 2^-k_c in float64 and whether
    max|v_c| is finite, with k_c = 62 - L - e_c, n <= 2^L and
    max|v_c| < 2^e_c (frexp's exponent): the kernels' scale."""
    a = torch.abs(amax.to(torch.float64))
    finite = torch.isfinite(a)
    _, e = torch.frexp(torch.where(finite, a, torch.zeros_like(a)))
    k = 62 - _log2_rows(n) - e.to(torch.int64)
    return _pow2(k), _pow2(-k), finite


def _quantize(stats_T, up, finite):
    """(3, m) int64 round-half-even(v * 2^k_c); channels that are not
    finite quantise to 0."""
    v = torch.where(finite[:, None], stats_T.to(torch.float64),
                    torch.zeros((), dtype=torch.float64, device=up.device))
    return torch.round(v * up[:, None]).to(torch.int64)


def _fixed_point_hist(codes, q, num_bins, down, finite):
    """The kernels' arithmetic in plain torch: codes (p, m) of the rows,
    q (3, m) their quantised stats; integer index_add_ (deterministic on
    every device), then f32(double(sum) * 2^-k_c), NaN where a channel is
    not finite. (p, 3, num_bins) f32."""
    p, m = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    valid = (codes >= 0) & (codes < num_bins)
    idx = torch.where(valid, codes + num_bins * torch.arange(
        p, device=dev)[:, None], torch.full_like(codes, p * num_bins))
    acc = torch.zeros((3, p * num_bins + 1), dtype=torch.int64, device=dev)
    for c in range(3):
        acc[c].index_add_(0, idx.reshape(-1), q[c].expand(p, m).reshape(-1))
    out = acc[:, :-1].to(torch.float64) * down[:, None]
    out = torch.where(finite[:, None], out, torch.full_like(out, math.nan))
    return out.to(torch.float32).reshape(3, p, num_bins).permute(1, 0, 2) \
        .contiguous()


def hist_segment_fixed_point_reference(bins_pos, stats_pos, s0, cnt,
                                       num_bins, amax=None):
    """`hist_segment`'s kernel arithmetic in plain torch, on any device;
    its result equals the kernel's bit for bit. The scale is set by n,
    the rows of bins_pos, and amax (default: that of stats_pos)."""
    s0, cnt = _segment_ints(s0, cnt)
    if amax is None:
        amax = stat_amax(stats_pos, 0)
    up, down, finite = fixed_point_scale(amax, bins_pos.shape[0])
    rows = slice(s0, s0 + cnt)
    return _fixed_point_hist(bins_pos[rows].T, _quantize(
        stats_pos[rows].T, up, finite), num_bins, down, finite)


def hist_masked_fixed_point_reference(bins_T, node, stats_T, target,
                                      num_bins, amax=None):
    """`hist_masked`'s kernel arithmetic in plain torch, bit for bit."""
    if isinstance(target, torch.Tensor):
        target = target.reshape(()).to(device=node.device)
    if amax is None:
        amax = stat_amax(stats_T, 1)
    up, down, finite = fixed_point_scale(amax, bins_T.shape[1])
    sel = node == target
    return _fixed_point_hist(bins_T[:, sel], _quantize(
        stats_T[:, sel], up, finite), num_bins, down, finite)


def hist_block_fixed_point_reference(bins_T, stats_T, num_bins, amax=None):
    """`hist_block`'s kernel arithmetic in plain torch, bit for bit."""
    if amax is None:
        amax = stat_amax(stats_T, 1)
    up, down, finite = fixed_point_scale(amax, bins_T.shape[1])
    return _fixed_point_hist(bins_T, _quantize(stats_T, up, finite),
                             num_bins, down, finite)


def _one_hot_fits(p, num_bins):
    return _PLAIN_ROW_BLOCK * p * num_bins <= _PLAIN_BLOCK_ELEMENTS


def _scatter_hist(codes, stats, num_bins):
    """(p, 3, num_bins) f32 sums of stats (m, 3) by codes (m, p), codes
    outside [0, num_bins) nowhere: one float32 index_add_, the plain
    versions' form where a one-hot would not fit."""
    m, p = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    valid = (codes >= 0) & (codes < num_bins)
    key = torch.where(valid, codes + num_bins * torch.arange(p, device=dev),
                      torch.full_like(codes, p * num_bins))
    acc = torch.zeros((p * num_bins + 1, 3), dtype=torch.float32, device=dev)
    acc.index_add_(0, key.reshape(-1),
                   stats[:, None, :].expand(m, p, 3).reshape(-1, 3))
    return acc[:-1].reshape(p, num_bins, 3).permute(0, 2, 1).contiguous()


def hist_segment_plain(bins_pos, stats_pos, s0, cnt, num_bins):
    """Plain PyTorch version: the one-hot einsum of tree_learner.py:659-662
    in float32, over row blocks of the segment (a float32 index_add_ where
    p * num_bins passes 16,384). (p, 3, num_bins) f32."""
    s0, cnt = int(s0), int(cnt)
    p = bins_pos.shape[1]
    if not _one_hot_fits(p, num_bins):
        return _scatter_hist(bins_pos[s0:s0 + cnt],
                             stats_pos[s0:s0 + cnt], num_bins)
    bvals = torch.arange(num_bins, dtype=torch.int32, device=bins_pos.device)
    acc = torch.zeros((p, 3, num_bins), dtype=torch.float32,
                      device=bins_pos.device)
    for start in range(s0, s0 + cnt, _PLAIN_ROW_BLOCK):
        stop = min(start + _PLAIN_ROW_BLOCK, s0 + cnt)
        onehot = (bins_pos[start:stop].to(torch.int32)[:, :, None]
                  == bvals[None, None, :]).to(torch.float32)
        acc = acc + torch.einsum("rc,rfb->fcb", stats_pos[start:stop], onehot)
    return acc


def _check_amax(name, amax, dev):
    if amax is not None and (amax.shape != (3,) or amax.device != dev
                             or amax.dtype != torch.float32):
        raise ValueError(f"{name}: amax must be (3,) float32 on {dev}")


def _check_kernel_size(name, n, num_bins, max_bins):
    if n > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} rows, got {n}")
    if num_bins > max_bins:
        raise ValueError(f"{name}'s kernel holds at most {max_bins} bins, "
                         f"got {num_bins}")


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


def _segment_ints(s0, cnt):
    """Host ints (s0, cnt) of a segment given as ints, 0-dim tensors, or
    one (2,) tensor [s0, cnt] with cnt None."""
    if cnt is None:
        s0, cnt = s0.tolist()
    return int(s0), int(cnt)


def hist_segment(bins_pos, stats_pos, s0, cnt, num_bins, amax=None):
    """(p, 3, num_bins) f32 histogram of positions [s0, s0 + cnt).

    bins_pos (n, p) uint8/int32, stats_pos (n, 3) f32 [grad, hess, count].
    The segment is s0 and cnt as host ints or 0-dim integer tensors, or
    one (2,) int32 tensor [s0, cnt] on the bins' device with cnt None:
    then the kernel reads it on the device and the call needs no host sync
    and no conversion. amax, (3,) f32 on the bins' device, is max |stats|
    of each channel over all n rows and sets the kernel's fixed-point
    scale; the tree learner computes it once per tree, and without it the
    wrapper does (`stat_amax`). A CUDA tensor launches the kernel, a CPU
    tensor runs `hist_segment_plain`, which ignores amax; any other device
    raises.
    """
    _check(bins_pos, stats_pos, num_bins)
    dev = bins_pos.device
    if dev.type == "cpu":
        return hist_segment_plain(bins_pos, stats_pos,
                                  *_segment_ints(s0, cnt), num_bins)
    if dev.type != "cuda":
        raise ValueError(f"hist_segment runs on cuda or cpu, not {dev.type}")
    n, p = bins_pos.shape
    _check_kernel_size("hist_segment", n, num_bins, MAX_KERNEL_BINS)
    _check_amax("hist_segment", amax, dev)
    if isinstance(s0, torch.Tensor):
        if cnt is None:
            seg = s0
            if seg.shape != (2,) or seg.dtype != torch.int32 \
                    or seg.device != dev:
                raise ValueError("a segment tensor must be (2,) int32 "
                                 "[s0, cnt] on the bins' device")
        else:
            seg = torch.stack([s0.reshape(()), cnt.reshape(())]).to(
                device=dev, dtype=torch.int32)
        s0_h = cnt_h = 0
        seg_ptr = seg.data_ptr()
    else:
        s0_h, cnt_h = int(s0), int(cnt)
        if s0_h < 0 or cnt_h < 0 or s0_h + cnt_h > n:
            raise ValueError(f"segment [{s0_h}, {s0_h + cnt_h}) outside "
                             f"[0, {n})")
        seg_ptr = None
    if amax is None:
        amax = stat_amax(stats_pos, 0)
    acc, counters = _scratch(dev, p, num_bins)
    out = torch.empty((p, 3, num_bins), dtype=torch.float32, device=dev)
    _launch("hist_segment", _device_index(dev), bins_pos.data_ptr(),
            int(bins_pos.dtype == torch.uint8), stats_pos.data_ptr(),
            amax.data_ptr(), _log2_rows(n), seg_ptr, s0_h, cnt_h, n, p,
            num_bins, acc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    hist_segment.launches += 1
    hist_segment.routes[("uint8" if bins_pos.dtype == torch.uint8
                         else "int32", bin_windows(num_bins))] += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path went through the kernel), and by route: (code type, bin
# windows)
hist_segment.launches = 0
hist_segment.routes = collections.Counter()


def _onehot_hist_T(bins_T, stats_T, weight, num_bins):
    """The blocked one-hot einsum of _hist_einsum (tree_learner.py:33-64) in
    float32: (p, 3, num_bins) of stats_T (3, n) times the optional 0/1 row
    weight (n,), by bins_T (p, n)."""
    p, n = bins_T.shape
    bvals = torch.arange(num_bins, dtype=torch.int32, device=bins_T.device)
    acc = torch.zeros((p, 3, num_bins), dtype=torch.float32,
                      device=bins_T.device)
    if not _one_hot_fits(p, num_bins):
        s = stats_T if weight is None else stats_T * weight[None, :]
        return _scatter_hist(bins_T.T, s.T, num_bins)
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


def _launch_masked(bins_T, node, stats_T, target, num_bins, amax):
    """One launch of csrc/hist_masked.cu; node None is the unmasked
    variant."""
    dev = bins_T.device
    p, n = bins_T.shape
    _check_kernel_size("hist_masked", n, num_bins, MAX_MASKED_BINS)
    _check_amax("hist_masked", amax, dev)
    tgt = None
    target_host = 0
    if isinstance(target, torch.Tensor):
        if target.numel() != 1 or target.device != dev \
                or target.dtype.is_floating_point:
            raise ValueError("a tensor target must be one integer on the "
                             "bins' device")
        tgt = target.reshape(())
        if tgt.dtype != torch.int32:
            tgt = tgt.to(torch.int32)
    elif target is not None:
        target_host = int(target)
    if amax is None:
        amax = stat_amax(stats_T, 1)
    acc, counters = _scratch(dev, p, num_bins)
    out = torch.empty((p, 3, num_bins), dtype=torch.float32, device=dev)
    _launch("hist_masked", _device_index(dev), bins_T.data_ptr(),
            int(bins_T.dtype == torch.uint8),
            None if node is None else node.data_ptr(), stats_T.data_ptr(),
            amax.data_ptr(), _log2_rows(n),
            None if tgt is None else tgt.data_ptr(), target_host, n, p,
            num_bins, acc.data_ptr(), counters.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def hist_masked(bins_T, node, stats_T, target, num_bins, amax=None):
    """(p, 3, num_bins) f32 histogram of the rows r with node[r] == target.

    bins_T (p, n) uint8/int32 feature-major, node (n,) int32, stats_T (3, n)
    f32 [grad, hess, count]; n needs no padding. target is a host int or a
    0-dim integer tensor on the bins' device (then the launch needs no host
    sync). amax, (3,) f32 on the bins' device, is max |stats| of each
    channel over all n rows and sets the kernel's fixed-point scale
    (default: `stat_amax(stats_T, 1)`). A CUDA tensor launches the kernel,
    a CPU tensor runs `hist_masked_plain`, which ignores amax; any other
    device raises.
    """
    _check_T("hist_masked", bins_T, stats_T, num_bins, node)
    if bins_T.device.type == "cpu":
        return hist_masked_plain(bins_T, node, stats_T, target, num_bins)
    out = _launch_masked(bins_T, node, stats_T, target, num_bins, amax)
    hist_masked.launches += 1
    return out


def hist_block(bins_T, stats_T, num_bins, amax=None):
    """(p, 3, num_bins) f32 histogram of every row: bins_T (p, n)
    uint8/int32, stats_T (3, n) f32 whose rows outside the block the caller
    has already zeroed; amax as for `hist_masked`. A CUDA tensor launches
    the unmasked variant of the hist_masked kernel, a CPU tensor runs
    `hist_block_plain`; any other device raises."""
    _check_T("hist_block", bins_T, stats_T, num_bins)
    if bins_T.device.type == "cpu":
        return hist_block_plain(bins_T, stats_T, num_bins)
    out = _launch_masked(bins_T, None, stats_T, None, num_bins, amax)
    hist_block.launches += 1
    return out


hist_masked.launches = 0
hist_block.launches = 0
