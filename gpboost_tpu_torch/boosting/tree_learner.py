"""Leaf-wise histogram tree learners (counterpart of
gpboost_tpu/boosting/tree_learner.py).

Single device, physically partitioned rows (`grow_tree_partitioned`, the
reference's positional path): the data lives in position order, bins_pos
(n, p) uint8/int32 and stats_pos (n, 3) f32 [grad, hess, count], and every
leaf owns one contiguous position segment. A split partitions its parent's
segment stably (left rows first), the smaller child's histogram comes from
the kernel hist_segment over the child's segment, and the sibling's from the
parent's histogram by subtraction (serial_tree_learner.cpp:325 +
data_partition.hpp).

Over a torch.distributed group, masked full scans (`grow_tree` in data and
feature mode, `grow_tree_voting`; the reference's `_grow_tree` and
`_grow_tree_voting`): bins_T (p, n) feature-major, a leaf id per row, the
left child's histogram from the kernel hist_masked over every local row and
the right one's by subtraction; the ranks exchange only all_reduce.

The reference grows a whole tree in one compiled `fori_loop` with a `cond`
per split. Here the loop is Python on the host. The per-leaf bookkeeping
(gains, split candidates, segments, depths) lives in host numpy, the data
and the histograms on the device, and each split ends with ONE host read
(the children's best splits, and on the positional path the left count).
On the positional path the smaller child's segment start and count go to
the kernel as a device tensor, so the kernel launch needs no sync of its
own:

    host syncs per tree = 1 (root split) + 1 per split + 2 (leaf values,
    row -> leaf counts); the masked path needs 1 for the leaf values and
    counts together.

The port keeps n rows with no padding: the kernels mask their ragged edge
themselves. Numeric features only; categorical features, missing-value
bins, monotone constraints, path smoothing, CEGB, extra_trees, forced
splits and interaction constraints raise NotImplementedError. Bagging and
feature subsampling (`train`'s row_mask and feat_mask) run on the
single-device path; on the masked one they wait (ROADMAP A15).
"""

import numpy as np
import torch
import torch.distributed as dist

from .tree import Tree
from ..ops.histogram import hist_masked, hist_segment, stat_amax
from ..parallel.group import all_reduce, block
from ..utils.device import resolve_device


def _thresholded(G, l1):
    """ThresholdL1 (feature_histogram.hpp): soft-threshold the gradient sum
    for L1 regularization."""
    return torch.sign(G) * torch.clamp_min(torch.abs(G) - l1, 0.0)


def _split_gains(hist, lambda_l2, min_data, min_hess, min_gain,
                 feat_mask=None, lambda_l1=0.0):
    """(..., p, B) f32 split gains of hist (..., p, 3, B) for numeric
    features, one missing direction (tree_learner.py:116): gain =
    TL1(GL)^2/(HL+l2) + TL1(GR)^2/(HR+l2) - TL1(G)^2/(H+l2), computed in
    float32 like the reference; -inf where the split is not allowed.
    feat_mask (p,) 0/1 masks whole features."""
    G = torch.sum(hist[..., 0, :], dim=-1, keepdim=True)
    H = torch.sum(hist[..., 1, :], dim=-1, keepdim=True)
    C = torch.sum(hist[..., 2, :], dim=-1, keepdim=True)
    GL = torch.cumsum(hist[..., 0, :], dim=-1)
    HL = torch.cumsum(hist[..., 1, :], dim=-1)
    CL = torch.cumsum(hist[..., 2, :], dim=-1)
    GR = G - GL
    HR = H - HL
    gain = (_thresholded(GL, lambda_l1) ** 2 / (HL + lambda_l2)
            + _thresholded(GR, lambda_l1) ** 2 / (HR + lambda_l2)
            - _thresholded(G, lambda_l1) ** 2 / (H + lambda_l2))
    valid = ((CL >= min_data) & (C - CL >= min_data)
             & (HL >= min_hess) & (H - HL >= min_hess))
    if feat_mask is not None:
        valid = valid & (feat_mask[:, None] > 0)
    return torch.where(valid & (gain > min_gain), gain,
                       torch.full_like(gain, -float("inf")))


def _best_split_of_hist(hist, lambda_l2, min_data, min_hess, min_gain,
                        feat_mask=None, lambda_l1=0.0):
    """(best_gain, best_feat, best_bin) over all (feature, bin) pairs of
    hist (p, 3, B) f32, as 0-dim device tensors. The argmax runs over the
    flattened (feature, bin) array and takes the first maximum, as
    jnp.argmax does."""
    gain = _split_gains(hist, lambda_l2, min_data, min_hess, min_gain,
                        feat_mask, lambda_l1)
    flat = torch.argmax(gain.reshape(-1))
    B = hist.shape[2]
    # take, not gain[flat]: indexing by a 0-dim device tensor reads it back
    # to the host
    return torch.take(gain, flat), flat // B, flat % B


def _stable_partition(arr, new_pos):
    """Rows of arr moved to new_pos (a permutation): index_copy_ with unique
    indices, so deterministic on every device."""
    return torch.empty_like(arr).index_copy_(0, new_pos, arr)


def grow_tree_partitioned(bins_pos, stats_pos, num_bins, num_leaves,
                          max_depth, lambda_l2, min_data, min_hess, min_gain,
                          feat_mask=None, lambda_l1=0.0):
    """Grow one leaf-wise tree (tree_learner.py:617-962
    _grow_tree_partitioned_impl, numeric features).

    Returns (rec (L-1, 4) int64 numpy [parent slot, feature, bin, ok],
    leaf_values (L,) float64 numpy, node (n,) int64 device row -> leaf slot,
    rec_gain (L-1,) float32 numpy). Leaf slot s + 1 is the right child made
    by split s.
    """
    n, p = bins_pos.shape
    dev = bins_pos.device
    L = num_leaves

    def best_of(hist):
        return _best_split_of_hist(hist, lambda_l2, min_data, min_hess,
                                   min_gain, feat_mask, lambda_l1)

    bins_p = bins_pos.clone()
    stats_p = stats_pos.clone()
    # the kernel's fixed-point scale: the stats do not change while the
    # tree grows (partitioning only permutes them)
    amax = stat_amax(stats_pos, 0)
    row_ids = torch.arange(n, dtype=torch.int64, device=dev)
    leaf_of_pos = torch.zeros(n, dtype=torch.int64, device=dev)
    hist0 = hist_segment(bins_p, stats_p, 0, n, num_bins, amax=amax)
    leaf_hist = torch.zeros((L, p, 3, num_bins), dtype=torch.float32,
                            device=dev)
    leaf_hist[0] = hist0
    g0, f0, b0 = best_of(hist0)
    g0, f0, b0 = torch.stack([g0.to(torch.float64), f0.to(torch.float64),
                              b0.to(torch.float64)]).tolist()

    leaf_gain = np.full(L, -np.inf)
    leaf_gain[0] = g0
    leaf_feat = np.zeros(L, dtype=np.int64)
    leaf_feat[0] = int(f0)
    leaf_bin = np.zeros(L, dtype=np.int64)
    leaf_bin[0] = int(b0)
    leaf_depth = np.zeros(L, dtype=np.int64)
    seg_start = np.zeros(L, dtype=np.int64)
    seg_cnt = np.zeros(L, dtype=np.int64)
    seg_cnt[0] = n
    rec = np.full((L - 1, 4), -1, dtype=np.int64)
    rec_gain = np.zeros(L - 1, dtype=np.float32)

    for s in range(L - 1):
        l = int(np.argmax(leaf_gain))        # first maximum, as jnp.argmax
        if not np.isfinite(leaf_gain[l]):
            break
        f, b = int(leaf_feat[l]), int(leaf_bin[l])
        s0, c = int(seg_start[l]), int(seg_cnt[l])
        new_slot = s + 1
        seg = slice(s0, s0 + c)

        # stable in-segment partition: left rows first, then right
        go_right = bins_p[seg, f].to(torch.int32) > b
        go_left = ~go_right
        csl = torch.cumsum(go_left, dim=0)
        csr = torch.cumsum(go_right, dim=0)
        cL = csl[-1]
        new_pos = torch.where(go_left, csl - 1, cL + csr - 1)
        bins_p[seg] = _stable_partition(bins_p[seg], new_pos)
        stats_p[seg] = _stable_partition(stats_p[seg], new_pos)
        row_ids[seg] = _stable_partition(row_ids[seg], new_pos)
        in_right = torch.arange(c, device=dev) >= cL
        leaf_of_pos[seg] = torch.where(in_right, new_slot, leaf_of_pos[seg])

        # smaller child's histogram from the kernel, sibling by subtraction
        cR = c - cL
        left_smaller = cL <= cR
        sS = s0 + torch.where(left_smaller, torch.zeros_like(cL), cL)
        seg = torch.stack([sS, torch.minimum(cL, cR)]).to(torch.int32)
        hist_small = hist_segment(bins_p, stats_p, seg, None, num_bins,
                                  amax=amax)
        hist_big = leaf_hist[l] - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_big)
        hist_right = torch.where(left_smaller, hist_big, hist_small)
        leaf_hist[l] = hist_left
        leaf_hist[new_slot] = hist_right
        gl_g, fl, bl = best_of(hist_left)
        gr_g, fr, br = best_of(hist_right)
        # the one host read of this split
        cL, gl_g, fl, bl, gr_g, fr, br = torch.stack(
            [t.to(torch.float64) for t in (cL, gl_g, fl, bl, gr_g, fr, br)]
        ).tolist()
        cL = int(cL)

        d = leaf_depth[l] + 1
        if d >= max_depth:
            gl_g = gr_g = -np.inf
        rec[s] = (l, f, b, 1)
        rec_gain[s] = leaf_gain[l]
        leaf_gain[l], leaf_gain[new_slot] = gl_g, gr_g
        leaf_feat[l], leaf_feat[new_slot] = int(fl), int(fr)
        leaf_bin[l], leaf_bin[new_slot] = int(bl), int(br)
        leaf_depth[l] = leaf_depth[new_slot] = d
        seg_start[l], seg_start[new_slot] = s0, s0 + cL
        seg_cnt[l], seg_cnt[new_slot] = cL, c - cL

    # row -> leaf slot, back in row order (one scatter)
    node = torch.empty_like(leaf_of_pos).index_copy_(0, row_ids, leaf_of_pos)
    Gs = torch.sum(leaf_hist[:, 0, 0, :], dim=1)
    Hs = torch.sum(leaf_hist[:, 0, 1, :], dim=1)
    Cs = torch.sum(leaf_hist[:, 0, 2, :], dim=1)
    leaf_values = torch.where(
        Cs > 0, -_thresholded(Gs, lambda_l1) / (Hs + lambda_l2),
        torch.zeros_like(Gs))
    return (rec, leaf_values.cpu().numpy().astype(np.float64), node,
            rec_gain)


def _grow_masked(bins_T, stats_T, num_bins, num_leaves, max_depth,
                 lambda_l2, lambda_l1, hist_of, best_of, totals):
    """The host loop of masked full-scan growth (tree_learner.py:272-461),
    shared by the data-, feature- and voting-parallel learners. Every leaf
    is a value of `node` (n_loc,) int32; a split relabels its right rows,
    the left child's histogram comes from `hist_of(node, leaf)` (kernel
    hist_masked over every local row) and the right one's from the parent's
    by subtraction. The leaf with the largest gain splits first (first
    maximum). The mode's parts:

      hist_of(node, target) -> the leaf's histogram as this rank keeps it;
      best_of(hists (k, ...)) -> (k, 3) float64 device tensor [gain,
          feature, bin], equal on every rank;
      totals(leaf_hist) -> (L, 3) [G, H, C] of each leaf over all ranks.

    One host read per split. Returns (rec (L-1, 4) int64 numpy [parent
    slot, feature, bin, ok], leaf_values (L,) float64 numpy, node (n_loc,)
    int32 device, rec_gain (L-1,) float32 numpy, leaf counts (L,) numpy).
    """
    L = num_leaves
    node = torch.zeros(bins_T.shape[1], dtype=torch.int32,
                       device=bins_T.device)
    hist0 = hist_of(node, 0)
    leaf_hist = torch.zeros((L,) + tuple(hist0.shape), dtype=torch.float32,
                            device=hist0.device)
    leaf_hist[0] = hist0
    g0, f0, b0 = best_of(hist0[None])[0].tolist()

    leaf_gain = np.full(L, -np.inf)
    leaf_gain[0] = g0
    leaf_feat = np.zeros(L, dtype=np.int64)
    leaf_feat[0] = int(f0)
    leaf_bin = np.zeros(L, dtype=np.int64)
    leaf_bin[0] = int(b0)
    leaf_depth = np.zeros(L, dtype=np.int64)
    rec = np.full((L - 1, 4), -1, dtype=np.int64)
    rec_gain = np.zeros(L - 1, dtype=np.float32)

    for s in range(L - 1):
        l = int(np.argmax(leaf_gain))        # first maximum, as jnp.argmax
        if not np.isfinite(leaf_gain[l]):
            break
        f, b = int(leaf_feat[l]), int(leaf_bin[l])
        new_slot = s + 1
        node = node.masked_fill((node == l) & (bins_T[f] > b), new_slot)
        hist_left = hist_of(node, l)
        hist_right = leaf_hist[l] - hist_left
        leaf_hist[l] = hist_left
        leaf_hist[new_slot] = hist_right
        # the one host read of this split
        gl, fl, bl, gr, fr, br = best_of(
            torch.stack([hist_left, hist_right])).reshape(-1).tolist()

        d = leaf_depth[l] + 1
        if d >= max_depth:
            gl = gr = -np.inf
        rec[s] = (l, f, b, 1)
        rec_gain[s] = leaf_gain[l]
        leaf_gain[l], leaf_gain[new_slot] = gl, gr
        leaf_feat[l], leaf_feat[new_slot] = int(fl), int(fr)
        leaf_bin[l], leaf_bin[new_slot] = int(bl), int(br)
        leaf_depth[l] = leaf_depth[new_slot] = d

    tot = totals(leaf_hist)
    Gs, Hs, Cs = tot[:, 0], tot[:, 1], tot[:, 2]
    leaf_values = torch.where(
        Cs > 0, -_thresholded(Gs, lambda_l1) / (Hs + lambda_l2),
        torch.zeros_like(Gs))
    out = torch.stack([leaf_values, Cs]).to(torch.float64).cpu().numpy()
    return rec, out[0], node, rec_gain, out[1]


def _first_max(gain):
    """(k,) gains and flat indices of the first maximum of each row of gain
    (k, m), as jnp.argmax takes it."""
    flat = torch.argmax(gain, dim=1)
    return gain.gather(1, flat[:, None])[:, 0], flat


def grow_tree(bins_T, stats_T, num_bins, num_leaves, max_depth, lambda_l2,
              min_data, min_hess, min_gain, lambda_l1=0.0, group=None,
              mode="data", feat_range=None):
    """Grow one leaf-wise tree by masked full scans (tree_learner.py:272
    _grow_tree, numeric features) over a torch.distributed group.

    mode "data": bins_T (p, n_loc) holds this rank's block of rows and the
    (p, 3, B) histograms are summed with all_reduce; every rank then takes
    its split decisions from the same reduced bits.
    mode "feature": every rank holds all rows (bins_T (p, n)) but builds
    the histograms of its features [feat_range) only. The best split is
    merged with all_reduce(MAX) on the gain, then all_reduce(MIN) on the
    flat (feature, bin) index among the ranks that reach it: jnp.argmax's
    first maximum. Leaf values come from feature 0's totals, which the rank
    holding feature 0 contributes.
    stats_T (3, n_loc) f32 [grad, hess, count]. Returns what
    `_grow_masked` returns.
    """
    p = bins_T.shape[0]
    B = num_bins
    if mode == "data":
        f0, f1 = 0, p
    elif mode == "feature":
        f0, f1 = feat_range if feat_range is not None else (0, p)
    else:
        raise ValueError(f"grow_tree mode must be 'data' or 'feature', not "
                         f"{mode!r}")
    bins_own = bins_T[f0:f1]
    amax = stat_amax(stats_T, 1)        # the kernel's scale, once per tree

    def hist_of(node, target):
        h = hist_masked(bins_own, node, stats_T, target, B, amax=amax)
        return all_reduce(h, group) if mode == "data" else h

    def best_of(hists):
        gain, flat = _first_max(_split_gains(
            hists, lambda_l2, min_data, min_hess, min_gain,
            lambda_l1=lambda_l1).reshape(hists.shape[0], -1))
        flat = flat + f0 * B
        if mode == "feature":
            gmax = all_reduce(gain.clone(), group, dist.ReduceOp.MAX)
            flat = all_reduce(
                torch.where(gain == gmax, flat, torch.full_like(flat, p * B)),
                group, dist.ReduceOp.MIN)
            gain = gmax
        return torch.stack([gain.to(torch.float64), (flat // B).double(),
                            (flat % B).double()], dim=1)

    def totals(leaf_hist):
        tot = torch.sum(leaf_hist[:, 0], dim=-1)
        if mode == "feature":
            if f0 != 0:
                tot = torch.zeros_like(tot)
            all_reduce(tot, group)
        return tot

    return _grow_masked(bins_T, stats_T, num_bins, num_leaves, max_depth,
                        lambda_l2, lambda_l1, hist_of, best_of, totals)


def grow_tree_voting(bins_T, stats_T, num_bins, num_leaves, max_depth,
                     lambda_l2, min_data, min_hess, min_gain, top_k,
                     lambda_l1=0.0, group=None):
    """Voting-parallel (PV-tree) leaf-wise growth (tree_learner.py:464
    _grow_tree_voting; voting_parallel_tree_learner.cpp:465).

    bins_T (p, n_loc) holds this rank's block of rows, and each rank keeps
    its LOCAL leaf histograms. Per child (tree_learner.py:522-543): the
    local per-feature best gains vote for this rank's top-k features; votes
    and the summed local gains are all_reduced; the global top-2k features
    by votes * 1e14 + clip(gain sum, 0, 1e13) (in float64) are selected and
    only their (2k, 3, B) histograms are summed; the best split is the first
    maximum among them. Exact when 2 * top_k >= p. Ties in the top-k take
    the lower index first, as jax.lax.top_k does.
    """
    p = bins_T.shape[0]
    B = num_bins
    K = int(min(top_k, p))
    S = int(min(2 * top_k, p))
    amax = stat_amax(stats_T, 1)        # the kernel's scale, once per tree

    def hist_of(node, target):
        return hist_masked(bins_T, node, stats_T, target, B, amax=amax)

    def gains(hists):
        return _split_gains(hists, lambda_l2, min_data, min_hess, min_gain,
                            lambda_l1=lambda_l1)

    def best_of(hists):
        k = hists.shape[0]
        gfeat = torch.amax(gains(hists), dim=-1)                  # (k, p)
        topi = torch.sort(gfeat, dim=1, descending=True,
                          stable=True).indices[:, :K]
        votes = torch.zeros_like(gfeat).scatter_(
            1, topi, torch.isfinite(gfeat.gather(1, topi)).to(gfeat.dtype))
        vg = all_reduce(torch.stack([
            votes, torch.where(torch.isfinite(gfeat), gfeat,
                               torch.zeros_like(gfeat))]), group)
        score = vg[0].double() * 1e14 + vg[1].double().clamp(0.0, 1e13)
        sel = torch.sort(score, dim=1, descending=True,
                         stable=True).indices[:, :S]              # (k, S)
        hsel = all_reduce(torch.stack(
            [hists[i, sel[i]] for i in range(k)]), group)
        gain, flat = _first_max(gains(hsel).reshape(k, -1))
        feat = sel.gather(1, (flat // B)[:, None])[:, 0]
        return torch.stack([gain.to(torch.float64), feat.double(),
                            (flat % B).double()], dim=1)

    def totals(leaf_hist):
        return all_reduce(torch.sum(leaf_hist[:, 0], dim=-1), group)

    return _grow_masked(bins_T, stats_T, num_bins, num_leaves, max_depth,
                        lambda_l2, lambda_l1, hist_of, best_of, totals)


class SerialTreeLearner:
    """Leaf-wise growth, one tree per `train` call: on one device by
    partitioned rows (`grow_tree_partitioned`, kernel hist_segment), or,
    given a torch.distributed `group`, by masked full scans over the group
    (`grow_tree` / `grow_tree_voting`, kernel hist_masked) with
    parallel_mode "data", "feature" or "voting" and `top_k` (the
    counterparts of the reference's mesh, parallel_mode and top_k,
    tree_learner.py:1008-1073). Data and voting modes keep this rank's even
    block of rows (`self.rows`); the feature mode keeps every row and
    builds the histograms of this rank's block of features."""

    def __init__(self, dataset, num_leaves=31, max_depth=-1,
                 min_data_in_leaf=20, lambda_l2=0.0,
                 min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                 lambda_l1=0.0, device=None, parallel_mode="data", top_k=20,
                 group=None):
        dataset.construct()
        self.mappers = getattr(dataset, "learner_mappers", dataset.mappers)
        if getattr(dataset, "bundles", None):
            raise NotImplementedError("exclusive feature bundling is not "
                                      "ported yet")
        for j, m in enumerate(self.mappers):
            if getattr(m, "is_categorical", False):
                raise NotImplementedError(
                    f"feature {j} is categorical: categorical splits are not "
                    "ported yet")
            if getattr(m, "has_nan", False):
                raise NotImplementedError(
                    f"feature {j} has missing values: missing-value bins are "
                    "not ported yet")
        if parallel_mode not in ("data", "feature", "voting"):
            raise ValueError(f"unknown parallel_mode {parallel_mode!r}")
        self.device = resolve_device(device)
        n, p = dataset.bins.shape
        self.num_bins = int(dataset.num_bins)
        bdt = np.uint8 if self.num_bins <= 256 else np.int32
        self.group = group
        self.parallel_mode = parallel_mode if group is not None else "data"
        self.top_k = int(top_k)
        self.rows = slice(0, n)
        self.feat_range = (0, p)
        if group is None:
            self.bins_pos = torch.as_tensor(
                np.ascontiguousarray(dataset.bins, dtype=bdt),
                device=self.device)
        else:
            rank, world = dist.get_rank(group), dist.get_world_size(group)
            if self.parallel_mode == "feature":
                if p < world:
                    raise ValueError(f"tree_learner='feature' needs at least "
                                     f"one feature per rank ({p} < {world})")
                self.feat_range = block(p, rank, world)
            else:
                self.rows = slice(*block(n, rank, world))
            self.bins_T = torch.as_tensor(np.ascontiguousarray(
                dataset.bins[self.rows].T, dtype=bdt), device=self.device)
        self.n = self.rows.stop - self.rows.start
        self.p = p
        self.num_leaves = int(num_leaves)
        self.max_depth = max_depth if max_depth and max_depth > 0 else 10 ** 6
        self.min_data_in_leaf = float(min_data_in_leaf)
        self.lambda_l2 = float(lambda_l2)
        self.lambda_l1 = float(lambda_l1)
        self.min_sum_hessian = float(min_sum_hessian_in_leaf)
        self.min_gain = float(min_gain_to_split)

    def train(self, grad, hess, row_mask=None, feat_mask=None):
        """Grow one tree on grad/hess (numpy arrays or tensors of this
        rank's rows, `self.rows`, in row order). row_mask (n,) 0/1
        (bagging): an out-of-bag row adds nothing to the histograms (grad,
        hess and count 0) but keeps its leaf, so every row's score is
        updated (tree_learner.py:1193-1220). feat_mask (p,) 0/1 (feature
        fraction): only its features split. Returns (tree, slot_of_row
        (n,) int64 tensor on the device, leaf_value_of_slot (L + 8,)
        float64 numpy)."""
        if self.group is not None:
            if row_mask is not None or feat_mask is not None:
                raise NotImplementedError(
                    "bagging and feature_fraction on a parallel tree "
                    "learner are not ported yet (ROADMAP A15)")
            return self._train_masked(grad, hess)
        stats = torch.ones((self.n, 3), dtype=torch.float32,
                           device=self.device)
        grad = torch.as_tensor(grad, device=self.device)
        hess = torch.as_tensor(hess, device=self.device)
        if row_mask is None:
            stats[:, 0] = grad
            stats[:, 1] = hess
        else:
            rm = torch.as_tensor(row_mask, device=self.device)
            stats[:, 0] = grad * rm
            stats[:, 1] = hess * rm
            stats[:, 2] = (rm > 0).to(torch.float32)
        if feat_mask is not None:
            feat_mask = torch.as_tensor(feat_mask, device=self.device)
        rec, leaf_values, node, rec_gain = grow_tree_partitioned(
            self.bins_pos, stats, self.num_bins, self.num_leaves,
            self.max_depth, self.lambda_l2, self.min_data_in_leaf,
            self.min_sum_hessian, self.min_gain, feat_mask=feat_mask,
            lambda_l1=self.lambda_l1)
        # rows per slot; bincount would read the largest slot back first
        cnt = torch.zeros(self.num_leaves + 8, dtype=torch.int64,
                          device=node.device).index_add_(
            0, node, torch.ones_like(node)).cpu().numpy()
        tree, leaf_value_of_slot = self.build_tree(rec, leaf_values, rec_gain,
                                                   cnt)
        return tree, node, leaf_value_of_slot

    def _train_masked(self, grad, hess):
        stats_T = torch.ones((3, self.n), dtype=torch.float32,
                             device=self.device)
        stats_T[0] = torch.as_tensor(grad, device=self.device)
        stats_T[1] = torch.as_tensor(hess, device=self.device)
        args = (self.bins_T, stats_T, self.num_bins, self.num_leaves,
                self.max_depth, self.lambda_l2, self.min_data_in_leaf,
                self.min_sum_hessian, self.min_gain)
        if self.parallel_mode == "voting":
            rec, leaf_values, node, rec_gain, cnt = grow_tree_voting(
                *args, self.top_k, lambda_l1=self.lambda_l1, group=self.group)
        else:
            rec, leaf_values, node, rec_gain, cnt = grow_tree(
                *args, lambda_l1=self.lambda_l1, group=self.group,
                mode=self.parallel_mode, feat_range=self.feat_range)
        # covers from the leaves' global counts (every rank sees them)
        cnt = np.concatenate([cnt, np.zeros(8)])
        tree, leaf_value_of_slot = self.build_tree(rec, leaf_values, rec_gain,
                                                   cnt)
        return tree, node.to(torch.int64), leaf_value_of_slot

    def build_tree(self, rec, leaf_values, rec_gain, cnt):
        """Host-side tree reconstruction from the split records
        (tree_learner.py:1338, numeric splits). cnt: per-slot training row
        counts (cover, for TreeSHAP)."""
        rec_gain = np.asarray(rec_gain, dtype=np.float64)
        tree = Tree(2 * self.num_leaves)
        tree.leaf_value[0] = leaf_values[0]
        slot_to_node = {0: 0}
        for s in range(self.num_leaves - 1):
            parent_slot, f, b, ok = rec[s]
            if ok != 1:
                break
            node_id = slot_to_node[int(parent_slot)]
            thr = self.mappers[int(f)].bin_to_threshold(int(b))
            li, ri = tree.split(node_id, int(f), int(b), thr, 0.0, 0.0)
            tree.split_gain[node_id] = rec_gain[s]
            slot_to_node[int(parent_slot)] = li
            slot_to_node[s + 1] = ri
        leaf_value_of_slot = np.zeros(self.num_leaves + 8)
        for slot, node_id in slot_to_node.items():
            tree.leaf_value[node_id] = leaf_values[slot]
            leaf_value_of_slot[slot] = leaf_values[slot]
        tree.slot_to_node = dict(slot_to_node)
        for slot, node_id in slot_to_node.items():
            tree.cover[node_id] = max(float(cnt[slot]), 1e-9)
        for i in range(tree.num_nodes - 1, -1, -1):
            if not tree.is_leaf[i]:
                tree.cover[i] = tree.cover[tree.left[i]] \
                    + tree.cover[tree.right[i]]
        return tree, leaf_value_of_slot
