"""Masked histogram of the PyTorch port against the JAX package's Pallas
kernels.

The port's `hist_masked` (plain version on CPU tensors) is held to
`hist_pallas`, and `hist_block` to `hist_block_pallas`, both run in TPU
interpret mode on the CPU. The JAX kernel needs n padded to its row block;
the padded rows carry a node id no leaf has. The port takes n as it is.
Counts agree exactly; grad and hess sums to 1e-6 of the histogram's largest
entry (float32 sums of order-one values over up to a few hundred rows per
bin, in another order: a few ulps of that scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gpboost_tpu.ops.histogram import hist_block_pallas, hist_pallas
from gpboost_tpu_torch.ops.histogram import (hist_block, hist_block_plain,
                                             hist_masked, hist_masked_plain)

torch.set_num_threads(1)

N, P, RB, FC = 640, 8, 256, 8
SENTINEL = -1               # node id of the JAX kernel's padding rows


def _data(num_bins, seed=0):
    rng = np.random.RandomState(seed)
    bins_T = rng.randint(0, num_bins, size=(P, N)).astype(np.int32)
    node = rng.randint(0, 4, size=N).astype(np.int32)
    stats_T = np.ones((3, N), dtype=np.float32)
    stats_T[:2] = rng.randn(2, N).astype(np.float32)
    return bins_T, node, stats_T


def _jax_masked(bins_T, node, stats_T, target, num_bins):
    n_pad = -(-N // RB) * RB
    b = np.zeros((P, n_pad), dtype=np.int32)
    b[:, :N] = bins_T
    nd = np.full((1, n_pad), SENTINEL, dtype=np.int32)
    nd[0, :N] = node
    s = np.zeros((3, n_pad), dtype=np.float32)
    s[:, :N] = stats_T
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(hist_pallas(jnp.asarray(b), jnp.asarray(nd),
                                      jnp.asarray(s), jnp.int32(target),
                                      num_bins, FC, RB))


def _assert_close(out, ref):
    assert out.shape == (P, 3, ref.shape[2]) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 2], ref[:, 2])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out[:, :2], ref[:, :2], rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("num_bins", [16, 255])
@pytest.mark.parametrize("target", [0, 3, 7])         # 7: no row selected
def test_hist_masked_matches_pallas_kernel(bin_dtype, num_bins, target):
    bins_T, node, stats_T = _data(num_bins)
    ref = _jax_masked(bins_T, node, stats_T, target, num_bins)
    out = hist_masked(torch.as_tensor(bins_T.astype(bin_dtype)),
                      torch.as_tensor(node), torch.as_tensor(stats_T),
                      target, num_bins).numpy()
    _assert_close(out, ref)
    if target == 7:
        assert not out.any()


def test_target_as_tensor_matches_host_int():
    bins_T, node, stats_T = _data(64, seed=1)
    args = (torch.as_tensor(bins_T), torch.as_tensor(node),
            torch.as_tensor(stats_T))
    a = hist_masked(*args, 2, 64)
    t = hist_masked(*args, torch.tensor(2, dtype=torch.int32), 64)
    assert torch.equal(a, t)


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("num_bins", [16, 255])
def test_hist_block_matches_pallas_kernel(bin_dtype, num_bins):
    bins_T, node, stats_T = _data(num_bins, seed=2)
    stats_T[:, node == 1] = 0.0                 # rows the caller masked
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(hist_block_pallas(jnp.asarray(bins_T),
                                           jnp.asarray(stats_T), num_bins,
                                           FC))
    out = hist_block(torch.as_tensor(bins_T.astype(bin_dtype)),
                     torch.as_tensor(stats_T), num_bins).numpy()
    _assert_close(out, ref)


def test_block_is_the_masked_histogram_of_every_row():
    bins_T, _, stats_T = _data(32, seed=3)
    b, s = torch.as_tensor(bins_T), torch.as_tensor(stats_T)
    zeros = torch.zeros(N, dtype=torch.int32)
    assert torch.equal(hist_block_plain(b, s, 32),
                       hist_masked_plain(b, zeros, s, 0, 32))


def test_cpu_launch_counts_stay_zero():
    """The launch counters count kernel launches only; CPU tensors take the
    plain versions."""
    before = (hist_masked.launches, hist_block.launches)
    bins_T, node, stats_T = _data(16)
    b, s = torch.as_tensor(bins_T), torch.as_tensor(stats_T)
    hist_masked(b, torch.as_tensor(node), s, 0, 16)
    hist_block(b, s, 16)
    assert (hist_masked.launches, hist_block.launches) == before


@pytest.mark.parametrize("case", ["bad_dtype", "bad_stats", "too_many_bins",
                                  "f64_stats", "i64_node", "short_node",
                                  "other_device"])
def test_hist_masked_rejects_bad_inputs(case):
    bins = torch.zeros((2, 8), dtype=torch.uint8)
    stats = torch.zeros((3, 8), dtype=torch.float32)
    node = torch.zeros(8, dtype=torch.int32)
    num_bins = 4
    err = ValueError
    if case == "bad_dtype":
        bins, err = bins.to(torch.int16), TypeError
    elif case == "bad_stats":
        stats = torch.zeros((8, 3), dtype=torch.float32)
    elif case == "too_many_bins":
        num_bins = 300
    elif case == "f64_stats":
        stats, err = stats.to(torch.float64), TypeError
    elif case == "i64_node":
        node, err = node.to(torch.int64), TypeError
    elif case == "short_node":
        node = node[:5]
    else:
        bins, stats, node = bins.to("meta"), stats.to("meta"), node.to("meta")
    with pytest.raises(err):
        hist_masked(bins, node, stats, 0, num_bins)
