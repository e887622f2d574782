"""Histogram of the PyTorch port against the JAX package's Pallas kernel.

The port's `hist_segment` (plain version on CPU tensors) is held to
`hist_block_rows_pallas` run in TPU interpret mode on the CPU, summed over
the positional row blocks of a segment as the JAX tree learner does
(tree_learner.py:664-681). Counts agree exactly; grad and hess sums to 1e-6
of the histogram's largest entry (float32 sums of order-one values over up
to a few hundred rows per bin, in another order: a few ulps of that scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gpboost_tpu.ops.histogram import hist_block_rows_pallas
from gpboost_tpu_torch.ops.histogram import hist_segment, hist_segment_plain

torch.set_num_threads(1)

N, P, RB = 640, 5, 256


def _data(num_bins, bin_dtype, seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, num_bins, size=(N, P)).astype(bin_dtype)
    stats = np.ones((N, 3), dtype=np.float32)
    stats[:, :2] = rng.randn(N, 2).astype(np.float32)
    return bins, stats


def _jax_hist(bins, stats, s0, cnt, num_bins):
    """(p, 3, B) over [s0, s0+cnt) from the Pallas kernel, block by block."""
    n_pad = -(-N // RB) * RB
    bins_p = np.zeros((n_pad, P), dtype=bins.dtype)
    bins_p[:N] = bins
    acc = np.zeros((P, num_bins, 8), dtype=np.float32)
    for start in range(s0 // RB * RB, s0 + cnt, RB):
        pos = np.arange(start, start + RB)
        sb = np.zeros((RB, 8), dtype=np.float32)
        valid = (pos >= s0) & (pos < s0 + cnt) & (pos < N)
        sb[valid, :3] = stats[pos[valid]]
        with pltpu.force_tpu_interpret_mode():
            acc += np.asarray(hist_block_rows_pallas(
                jnp.asarray(bins_p[start:start + RB]), jnp.asarray(sb),
                num_bins, P))
    return np.transpose(acc, (0, 2, 1))[:, :3, :]


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("num_bins", [16, 255])
@pytest.mark.parametrize("s0,cnt", [(0, N), (37, 301), (300, 1), (5, 0)])
def test_hist_segment_matches_pallas_kernel(bin_dtype, num_bins, s0, cnt):
    bins, stats = _data(num_bins, bin_dtype)
    ref = _jax_hist(bins, stats, s0, cnt, num_bins)
    out = hist_segment(torch.as_tensor(bins), torch.as_tensor(stats), s0, cnt,
                       num_bins).numpy()
    assert out.shape == (P, 3, num_bins) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out[:, :2], ref[:, :2], rtol=0,
                               atol=1e-6 * scale)


def test_segment_as_device_tensors_matches_host_ints():
    bins, stats = _data(64, np.uint8, seed=1)
    b, s = torch.as_tensor(bins), torch.as_tensor(stats)
    a = hist_segment(b, s, 123, 400, 64)
    t = hist_segment(b, s, torch.tensor(123), torch.tensor(400), 64)
    assert torch.equal(a, t)


def test_plain_version_blocks_rows_like_one_einsum():
    bins, stats = _data(32, np.int32, seed=2)
    b, s = torch.as_tensor(bins), torch.as_tensor(stats)
    onehot = (b[:, :, None] == torch.arange(32)).to(torch.float32)
    ref = torch.einsum("rc,rfb->fcb", s, onehot)
    torch.testing.assert_close(hist_segment_plain(b, s, 0, N, 32), ref,
                               rtol=0, atol=1e-5)


def test_cpu_launch_count_stays_zero():
    """The launch counter counts kernel launches only; CPU tensors take the
    plain version."""
    before = hist_segment.launches
    bins, stats = _data(16, np.uint8)
    hist_segment(torch.as_tensor(bins), torch.as_tensor(stats), 0, N, 16)
    assert hist_segment.launches == before


@pytest.mark.parametrize("case", ["bad_dtype", "bad_stats", "too_many_bins",
                                  "f64_stats", "other_device"])
def test_hist_segment_rejects_bad_inputs(case):
    bins = torch.zeros((8, 2), dtype=torch.uint8)
    stats = torch.zeros((8, 3), dtype=torch.float32)
    num_bins = 4
    err = ValueError
    if case == "bad_dtype":
        bins, err = bins.to(torch.int16), TypeError
    elif case == "bad_stats":
        stats = torch.zeros((8, 8), dtype=torch.float32)
    elif case == "too_many_bins":
        num_bins = 300
    elif case == "f64_stats":
        stats, err = stats.to(torch.float64), TypeError
    else:
        bins, stats = bins.to("meta"), stats.to("meta")
    with pytest.raises(err):
        hist_segment(bins, stats, 0, 8, num_bins)
