"""Fixed-point arithmetic of the port's histogram kernels, on the CPU.

The CUDA kernels (csrc/hist_common.cuh) sum quantised stats as int64 and
convert once; `hist_*_fixed_point_reference` in
`gpboost_tpu_torch/ops/histogram.py` repeat that arithmetic in plain torch,
and the card's kernels are checked bitwise against them by chip_smoke.py.
Here the emulations are held to the JAX package's Pallas kernels (TPU
interpret mode, n padded as `tests/test_torch_hist_masked.py` pads it) and
to the plain versions: counts exact, grad and hess to 1e-6 of the largest
entry (float32 sums in another order on the Pallas side; the fixed-point
error itself is ~1e-16 of max |v| here). The scale is checked for overflow
at the largest n the wrappers take and at extreme magnitudes.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gpboost_tpu.ops.histogram import (hist_block_pallas,
                                       hist_block_rows_pallas, hist_pallas)
from gpboost_tpu_torch.ops import histogram as H

torch.set_num_threads(1)

N, P, RB, FC = 640, 8, 256, 8
SENTINEL = -1               # node id of the JAX kernel's padding rows


def _data(num_bins, seed=0):
    rng = np.random.RandomState(seed)
    bins_T = rng.randint(0, num_bins, size=(P, N)).astype(np.int32)
    node = rng.randint(0, 3, size=N).astype(np.int32)
    stats_T = np.ones((3, N), dtype=np.float32)
    stats_T[0] = rng.randn(N)
    stats_T[1] = rng.rand(N) + 0.5
    return bins_T, node, stats_T


def _assert_close(out, ref):
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out[:, :2], ref[:, :2], rtol=0,
                               atol=1e-6 * scale)


def _pallas(kernel, bins_T, node, stats_T, num_bins, target=1, s0=0,
            cnt=N):
    """The JAX package's Pallas kernel on the same rows, interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        if kernel == "masked":
            n_pad = -(-N // RB) * RB
            b = np.zeros((P, n_pad), dtype=np.int32)
            b[:, :N] = bins_T
            nd = np.full((1, n_pad), SENTINEL, dtype=np.int32)
            nd[0, :N] = node
            s = np.zeros((3, n_pad), dtype=np.float32)
            s[:, :N] = stats_T
            return np.asarray(hist_pallas(
                jnp.asarray(b), jnp.asarray(nd), jnp.asarray(s),
                jnp.int32(target), num_bins, FC, RB))
        if kernel == "block":
            return np.asarray(hist_block_pallas(
                jnp.asarray(bins_T), jnp.asarray(stats_T), num_bins, FC))
        sb = np.zeros((N, 8), dtype=np.float32)
        sb[s0:s0 + cnt, :3] = stats_T.T[s0:s0 + cnt]
        out = hist_block_rows_pallas(jnp.asarray(bins_T.T.copy()),
                                     jnp.asarray(sb), num_bins, P)
        return np.transpose(np.asarray(out), (0, 2, 1))[:, :3, :]


def _emulation(kernel, bins_T, node, stats_T, num_bins, target=1, s0=0,
               cnt=N, amax=None):
    b, s = torch.as_tensor(bins_T), torch.as_tensor(stats_T)
    if kernel == "masked":
        out = H.hist_masked_fixed_point_reference(
            b, torch.as_tensor(node), s, target, num_bins, amax=amax)
    elif kernel == "block":
        out = H.hist_block_fixed_point_reference(b, s, num_bins, amax=amax)
    else:
        out = H.hist_segment_fixed_point_reference(
            b.T.contiguous(), s.T.contiguous(), s0, cnt, num_bins, amax=amax)
    return out.numpy()


def _plain(kernel, bins_T, node, stats_T, num_bins, target=1, s0=0, cnt=N):
    b, s = torch.as_tensor(bins_T), torch.as_tensor(stats_T)
    if kernel == "masked":
        out = H.hist_masked_plain(b, torch.as_tensor(node), s, target,
                                  num_bins)
    elif kernel == "block":
        out = H.hist_block_plain(b, s, num_bins)
    else:
        out = H.hist_segment_plain(b.T.contiguous(), s.T.contiguous(), s0,
                                   cnt, num_bins)
    return out.numpy()


# (kernel, num_bins, segment of the positional kernel)
CASES = [("masked", 16, None), ("masked", 255, None), ("block", 255, None),
         ("segment", 16, (0, N)), ("segment", 255, (37, 301))]


@pytest.mark.parametrize("kernel,num_bins,seg", CASES)
def test_emulation_matches_pallas_kernel(kernel, num_bins, seg):
    bins_T, node, stats_T = _data(num_bins)
    if kernel == "block":
        stats_T[:, node == 1] = 0.0              # rows the caller masked
    s0, cnt = seg or (0, N)
    ref = _pallas(kernel, bins_T, node, stats_T, num_bins, s0=s0, cnt=cnt)
    _assert_close(_emulation(kernel, bins_T, node, stats_T, num_bins, s0=s0,
                             cnt=cnt), ref)


@pytest.mark.parametrize("kernel,num_bins,seg", CASES)
def test_emulation_matches_plain_version(kernel, num_bins, seg):
    bins_T, node, stats_T = _data(num_bins, seed=1)
    s0, cnt = seg or (0, N)
    _assert_close(
        _emulation(kernel, bins_T, node, stats_T, num_bins, s0=s0, cnt=cnt),
        _plain(kernel, bins_T, node, stats_T, num_bins, s0=s0, cnt=cnt))


@pytest.mark.parametrize("kernel", ["masked", "block", "segment"])
def test_emulation_is_bitwise_invariant_under_a_row_permutation(kernel):
    bins_T, node, stats_T = _data(64, seed=2)
    # values of many magnitudes, so that float sums would depend on order
    stats_T[0] *= np.exp(np.random.RandomState(3).randn(N) * 6)
    perm = np.random.RandomState(4).permutation(N)
    a = _emulation(kernel, bins_T, node, stats_T, 64)
    b = _emulation(kernel, bins_T[:, perm], node[perm], stats_T[:, perm], 64)
    assert np.array_equal(a, b)


# an EFB bundle of 20 features of 255 bins and the all-default bin: int32
# codes and two bin windows of the segment kernel
WIDE_BINS = 1 + 20 * 256


@pytest.mark.parametrize("seg", [(0, N), (N // 4, N // 2)],
                         ids=["whole", "half"])
def test_wide_bins_emulation_matches_plain_version(seg):
    bins_T, node, stats_T = _data(WIDE_BINS, seed=5)
    assert H.bin_windows(WIDE_BINS) == 2
    s0, cnt = seg
    _assert_close(
        _emulation("segment", bins_T, node, stats_T, WIDE_BINS, s0=s0,
                   cnt=cnt),
        _plain("segment", bins_T, node, stats_T, WIDE_BINS, s0=s0, cnt=cnt))


def test_wide_bins_emulation_is_bitwise_invariant_under_a_row_permutation():
    bins_T, node, stats_T = _data(WIDE_BINS, seed=6)
    stats_T[0] *= np.exp(np.random.RandomState(7).randn(N) * 6)
    perm = np.random.RandomState(8).permutation(N)
    a = _emulation("segment", bins_T, node, stats_T, WIDE_BINS)
    b = _emulation("segment", bins_T[:, perm], node[perm], stats_T[:, perm],
                   WIDE_BINS)
    assert np.array_equal(a, b)


def test_no_overflow_at_the_largest_n():
    """n * max |round(v * 2^k)| stays within 2^62 < 2^63 for every channel
    at the wrappers' largest n, in exact integer arithmetic."""
    n = H.MAX_ROWS
    for a in (1.0, 0.75, 3.0e-30, 1e-30, 1e30, 3.4e38, 1.4e-45,
              float(np.nextafter(np.float32(1.0), np.float32(0.0)))):
        up, _, finite = H.fixed_point_scale(
            torch.tensor([a, a, a], dtype=torch.float32), n)
        assert bool(finite.all())
        q = round(float(np.float32(a)) * float(up[0]))   # exact in double
        assert 0 < q <= 2 ** 62 // n + 1
        assert n * q <= 2 ** 62
        # and the scale keeps ~30 bits of the largest value
        assert q >= 2 ** 30


def test_zero_channel_gives_zeros():
    bins_T, node, stats_T = _data(32, seed=5)
    stats_T[1] = 0.0
    out = _emulation("masked", bins_T, node, stats_T, 32)
    assert not out[:, 1].any()
    np.testing.assert_array_equal(
        out[:, 2], _plain("masked", bins_T, node, stats_T, 32)[:, 2])


@pytest.mark.parametrize("magnitude", [1e-30, 1e30])
def test_extreme_magnitudes_keep_their_relative_precision(magnitude):
    bins_T, node, stats_T = _data(32, seed=6)
    stats_T[:2] *= np.float32(magnitude)
    out = _emulation("masked", bins_T, node, stats_T, 32)
    # exact float64 sums of the same rows
    sel = node == 1
    ref = np.zeros((P, 2, 32))
    for f in range(P):
        for c in range(2):
            np.add.at(ref[f, c], bins_T[f, sel],
                      stats_T[c, sel].astype(np.float64))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[:, :2], ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_non_finite_stat_makes_its_channel_nan(bad):
    """The stated result: a non-finite value in a channel (so its max |v|
    is not finite) makes that channel NaN in every bin; the other channels
    are what they would be without it."""
    bins_T, node, stats_T = _data(32, seed=7)
    clean = _emulation("masked", bins_T, node, stats_T, 32)
    stats_T[0, 5] = bad
    out = _emulation("masked", bins_T, node, stats_T, 32)
    assert np.isnan(out[:, 0]).all()
    np.testing.assert_array_equal(out[:, 1:], clean[:, 1:])


def test_segment_as_one_device_pair_matches_host_ints():
    bins_T, _, stats_T = _data(64, seed=8)
    b = torch.as_tensor(bins_T.T.copy())
    s = torch.as_tensor(stats_T.T.copy())
    seg = torch.tensor([123, 400], dtype=torch.int32)
    assert torch.equal(H.hist_segment(b, s, seg, None, 64),
                       H.hist_segment(b, s, 123, 400, 64))
    assert torch.equal(
        H.hist_segment_fixed_point_reference(b, s, seg, None, 64),
        H.hist_segment_fixed_point_reference(b, s, 123, 400, 64))


def test_given_amax_sets_the_scale():
    """A larger amax than the data's is a coarser but valid scale; the
    learners pass the same amax to every call of a tree."""
    bins_T, node, stats_T = _data(64, seed=9)
    amax = H.stat_amax(torch.as_tensor(stats_T), 1)
    a = _emulation("masked", bins_T, node, stats_T, 64, amax=amax)
    assert np.array_equal(a, _emulation("masked", bins_T, node, stats_T, 64))
    b = _emulation("masked", bins_T, node, stats_T, 64, amax=amax * 1024)
    np.testing.assert_array_equal(a[:, 2], b[:, 2])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(a).max())
    assert math.isclose(float(H.stat_amax(torch.zeros((0, 3)), 0).sum()), 0)
