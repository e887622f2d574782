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
themselves. The positional path takes the reference's whole split search
(`_positional_gains`): categorical features (a sorted-prefix scan), missing
values in both directions, EFB bundles (numeric columns of up to any bin
count), monotone constraints, path smoothing, CEGB, extra trees, forced
splits and interaction constraints, and bagging and feature subsampling
(`train`'s row_mask and feat_mask). A categorical split's left bins and a
split's missing direction travel in the split's one host read. The masked
path takes numeric features without those options (ROADMAP A15).
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
    features, one missing direction (tree_learner.py:116): the masked
    (parallel) learners' search, `_positional_gains` without options."""
    return _positional_gains(hist, lambda_l2, min_data, min_hess, min_gain,
                             feat_mask, lambda_l1, _plain_options(
                                 hist.shape[-3], hist.device))[..., 0, :, :]


def _cat_order(hist_f, cat_smooth):
    """Bin order of the categorical sorted-prefix search
    (tree_learner.py:73-82; feature_histogram.hpp:384 ctr_fun): bins by
    G/(H + cat_smooth), the bins with fewer than max(cat_smooth, 1) rows
    last; a stable sort, as jnp.argsort."""
    g, h, c = hist_f[..., 0, :], hist_f[..., 1, :], hist_f[..., 2, :]
    ratio = torch.where(c >= max(cat_smooth, 1.0), g / (h + cat_smooth),
                        torch.full_like(g, float("inf")))
    return torch.argsort(ratio, dim=-1, stable=True)


def _cat_used(hist_f, cat_smooth):
    """(...,) f32 number of bins with at least max(cat_smooth, 1) rows
    (tree_learner.py:85-89)."""
    return torch.sum((hist_f[..., 2, :] >= max(cat_smooth, 1.0)).to(
        torch.float32), dim=-1)


def _tl1(G, l1):
    """_thresholded, which is G itself without L1 (the same values, and
    fewer device ops on the split search's hot path)."""
    return G if l1 == 0.0 else _thresholded(G, l1)


def _smoothed_output(G, H, C, lambda_l2, lambda_l1, path_smooth,
                     parent_out):
    """Leaf output with path smoothing (tree_learner.py:92-98;
    feature_histogram.hpp CalculateSplittedLeafOutput): the raw output
    shrunk toward the parent's by path_smooth / (C + path_smooth)."""
    raw = -_tl1(G, lambda_l1) / (H + lambda_l2)
    f = C / torch.clamp_min(C + path_smooth, 1e-10)
    return f * raw + (1.0 - f) * parent_out


def _gain_at(hist, f, b, lambda_l2, lambda_l1):
    """Split gain of the (feature, bin) pair f, b (host ints) of hist
    (p, 3, B), a forced split's recorded gain (tree_learner.py:101-113)."""
    g, h = hist[f, 0, :], hist[f, 1, :]
    G, H = torch.sum(g), torch.sum(h)
    GL, HL = torch.cumsum(g, 0)[b], torch.cumsum(h, 0)[b]
    return (_thresholded(GL, lambda_l1) ** 2 / (HL + lambda_l2)
            + _thresholded(G - GL, lambda_l1) ** 2 / (H - HL + lambda_l2)
            - _thresholded(G, lambda_l1) ** 2 / (H + lambda_l2))


class SplitOptions:
    """The positional learner's split options beyond the plain numeric
    search (tree_learner.py:116-269), as device tensors for the search and
    host numpy for the routing; None where an option is off, so its work
    is skipped.

      monotone (p,) in {-1, 0, +1}; cat_mask (p,) categorical features
      with cat_params (cat_smooth, cat_l2, max_cat_threshold,
      min_data_per_group) and cat_bins, the most bins of a categorical
      feature; nan_bin (p,) each numeric feature's missing bin
      (-1: none), searched in both missing directions; path_smooth;
      cegb_coupled (p,) and cegb_split, tradeoff-scaled; cegb_lazy (p,);
      feat_hi (p,) each feature's largest candidate bin (extra trees);
      inter_groups (K, p) 0/1 interaction-constraint sets; forced (k, 3)
      [slot, feature, bin] forced splits in parent-before-child order.
    """

    def __init__(self, p, device, monotone=None, cat_mask=None,
                 cat_params=(10.0, 10.0, 32.0, 100.0), cat_bins=0,
                 nan_bin=None,
                 path_smooth=0.0, cegb_coupled=None, cegb_split=0.0,
                 cegb_lazy=None, feat_hi=None, inter_groups=None,
                 forced=None):
        def dev(a, dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device)

        self.mono_h = None if monotone is None or not np.any(monotone) \
            else np.asarray(monotone, dtype=np.int64)
        self.cat_h = None if cat_mask is None or not np.any(cat_mask) \
            else np.asarray(cat_mask, dtype=bool)
        self.nan_h = None if nan_bin is None or not np.any(
            np.asarray(nan_bin) >= 0) else np.asarray(nan_bin, np.int64)
        self.monotone = dev(self.mono_h, torch.int64)
        self.cat_mask = dev(self.cat_h, torch.bool)
        self.nan_bin = dev(self.nan_h, torch.int64)
        self.cat_params = tuple(float(v) for v in cat_params)
        self.cat_bins = int(cat_bins)
        self.path_smooth = float(path_smooth)
        self.cegb_coupled = dev(cegb_coupled, torch.float32)
        self.cegb_split = float(cegb_split)
        self.cegb_lazy = dev(cegb_lazy, torch.float32)
        self.feat_hi = dev(feat_hi, torch.float32)
        self.inter_groups = dev(inter_groups, torch.float32)
        self.forced = None if forced is None or len(forced) == 0 \
            else np.asarray(forced, dtype=np.int64)
        self.use_cegb = self.cegb_coupled is not None \
            or self.cegb_split != 0.0
        # the split search's CUDA graphs (grow_tree_partitioned)
        self.graphs = {}


_PLAIN_OPTIONS = {}


def _plain_options(p, device):
    key = (p, str(device))
    if key not in _PLAIN_OPTIONS:
        _PLAIN_OPTIONS[key] = SplitOptions(p, device)
    return _PLAIN_OPTIONS[key]


def _positional_gains(hist, lambda_l2, min_data, min_hess, min_gain,
                      feat_mask, lambda_l1, o, parent_out=None,
                      cegb_used=None, extra_u=None, lazy_pen=None):
    """(..., D, p, B) f32 split gains of hist (..., p, 3, B), -inf where
    not allowed (tree_learner.py:116-263): D = 2 missing directions when a
    numeric feature has a missing bin (direction 1 sends it left), else 1;
    leading dims are leaves searched together. Categorical features are
    scanned as prefixes of their G/(H + cat_smooth) order; monotone
    features keep the splits whose child outputs are ordered; with path
    smoothing the gain is taken at the smoothed outputs around parent_out
    (...,); extra_u (..., p) uniforms pick one threshold per feature
    (extra trees); CEGB subtracts its coupled, split and lazy (lazy_pen
    (..., p)) penalties. The three stat channels go through each step
    together: the search is host-bound, one device op costing more than
    its work."""
    tot = torch.sum(hist, dim=-1, keepdim=True)            # (..., p, 3, 1)
    L0 = torch.cumsum(hist, dim=-1)                        # (..., p, 3, B)
    L = L0
    B = hist.shape[-1]
    f32 = dict(dtype=torch.float32, device=hist.device)
    G, H, C = tot[..., 0, :], tot[..., 1, :], tot[..., 2, :]
    l2_child = lambda_l2
    cm = cat_valid = None
    if o.cat_mask is not None:
        csm, cl2, mct, mdpg = o.cat_params
        order = _cat_order(hist, csm)                      # (..., p, B)
        cm = o.cat_mask[:, None]
        L = torch.where(cm[:, None], torch.cumsum(hist.gather(
            -1, order.unsqueeze(-2).expand(hist.shape)), dim=-1), L0)
        l2 = torch.full((), lambda_l2, **f32)
        l2_child = torch.where(cm, l2 + cl2, l2)
        used = _cat_used(hist, csm)[..., None]
        pos1 = torch.arange(B, **f32) + 1.0
        max_num_cat = torch.clamp_max(torch.floor((used + 1.0) / 2.0), mct)
        CLc = L[..., 2, :]
        cat_valid = ((pos1 < used)
                     & (torch.minimum(pos1, used - pos1) <= max_num_cat)
                     & (CLc >= mdpg) & (C - CLc >= mdpg))
    ps = o.path_smooth
    if ps > 0.0:
        parent_out = parent_out[..., None, None]
        parent_gain = -(2.0 * G * parent_out
                        + (H + lambda_l2) * parent_out * parent_out)
    else:
        parent_gain = _tl1(G, lambda_l1) ** 2 / (H + lambda_l2)

    def gain_valid(Lx, l2c):
        GLx, HLx, CLx = Lx[..., 0, :], Lx[..., 1, :], Lx[..., 2, :]
        GR = G - GLx
        HR = H - HLx
        if ps <= 0.0:
            gain = (_tl1(GLx, lambda_l1) ** 2 / (HLx + l2c)
                    + _tl1(GR, lambda_l1) ** 2 / (HR + l2c) - parent_gain)
        else:
            wl = _smoothed_output(GLx, HLx, CLx, l2c, lambda_l1, ps,
                                  parent_out)
            wr = _smoothed_output(GR, HR, C - CLx, l2c, lambda_l1, ps,
                                  parent_out)

            def leaf_gain(Gs, Hs, w, l2s):
                return -(2.0 * Gs * w + (Hs + l2s) * w * w)

            gain = (leaf_gain(GLx, HLx, wl, l2c) + leaf_gain(GR, HR, wr, l2c)
                    - parent_gain)
        valid = ((CLx >= min_data) & (C - CLx >= min_data)
                 & (HLx >= min_hess) & (H - HLx >= min_hess))
        if o.monotone is not None:
            wlm = -_tl1(GLx, lambda_l1) / (HLx + l2c)
            wrm = -_tl1(GR, lambda_l1) / (HR + l2c)
            m = o.monotone[:, None]
            valid = valid & ((m == 0) | ((m > 0) & (wlm <= wrm))
                             | ((m < 0) & (wlm >= wrm)))
        return gain, valid

    gain, valid = gain_valid(L, l2_child)
    if cat_valid is not None:
        valid = valid & torch.where(cm, cat_valid, True)
    gains, valids = [gain], [valid]
    if o.nan_bin is not None:
        # missing left (the reference's REVERSE scan, default_left): the
        # missing bin's stats join the left side of every threshold below
        # it, for the numeric features with a missing bin
        nb = o.nan_bin[:, None]
        nan = hist.gather(-1, torch.clamp_min(nb, 0)[:, None].expand(
            hist.shape[:-1] + (1,)))                       # (..., p, 3, 1)
        # a missing bin without rows adds exactly nothing: its gradient
        # and hessian sums can hold the rounding residue of a histogram
        # subtraction, which would decide a tie of the two directions
        has = nb >= 0
        take = (has & (nan[..., 2, :] > 0))[..., None, :]
        gain_l, valid_l = gain_valid(
            L0 + torch.where(take, nan, torch.zeros((), **f32)), lambda_l2)
        valid_l = valid_l & has & (torch.arange(B, device=hist.device) < nb)
        if cm is not None:
            valid_l = valid_l & ~cm
        gains.append(gain_l)
        valids.append(valid_l)
    gain = torch.stack(gains, dim=-3)
    valid = torch.stack(valids, dim=-3)
    if extra_u is not None:
        # extra trees (feature_histogram.hpp USE_RAND): one uniformly
        # random threshold per feature instead of the full scan
        t = torch.minimum((extra_u * (o.feat_hi + 1.0)).to(torch.int64),
                          o.feat_hi.to(torch.int64))
        valid = valid & (torch.arange(B, device=hist.device)
                         == t[..., None])[..., None, :, :]
    if o.use_cegb:
        # cost_effective_gradient_boosting.hpp:70-74 DetailGain: the split
        # penalty times the leaf's rows, and the coupled penalty of a
        # feature the model has not used yet
        if o.cegb_coupled is not None:
            gain = gain - (o.cegb_coupled * (1.0 - cegb_used))[:, None]
        gain = gain - o.cegb_split * C[..., None, :, :]
    if lazy_pen is not None:
        gain = gain - lazy_pen[..., None, :, None]
    if feat_mask is not None:
        valid = valid & (feat_mask[:, None] > 0)
    return gain.masked_fill(~(valid & (gain > min_gain)), -float("inf"))


def _best_split_of_hist(hist, lambda_l2, min_data, min_hess, min_gain,
                        feat_mask=None, lambda_l1=0.0, opts=None, **kw):
    """(best_gain, best_feat, best_code) over all (direction, feature, bin)
    triples of hist (..., p, 3, B) f32, device tensors of the leading
    shape; code = bin + B * default_left (tree_learner.py:264-269). The
    argmax runs over each leaf's flattened gains and takes the first
    maximum, as jnp.argmax does. kw: parent_out, cegb_used, extra_u,
    lazy_pen of `_positional_gains`."""
    o = opts if opts is not None else _plain_options(hist.shape[-3],
                                                     hist.device)
    gain = _positional_gains(hist, lambda_l2, min_data, min_hess, min_gain,
                             feat_mask, lambda_l1, o, **kw)
    p, B = gain.shape[-2:]
    flat_gain = gain.reshape(gain.shape[:-3] + (-1,))
    flat = torch.argmax(flat_gain, dim=-1)
    rem = flat % (p * B)
    # gather, not gain[flat]: indexing by a 0-dim device tensor reads it
    # back to the host
    return (flat_gain.gather(-1, flat.unsqueeze(-1)).squeeze(-1), rem // B,
            rem % B + B * (flat // (p * B)))


def _cat_left(hist, f, code, o, n_words):
    """The left-going bin sets of categorical splits (tree_learner.py:
    823-842): leaf k's split (feature f[k], code code[k], device tensors)
    of its histogram hist[k] (k, p, 3, B). Returns (k, o.cat_bins) bool on
    the device, all False for a numeric feature, and their (k, n_words)
    32-bit words. The order is taken over the first o.cat_bins bins, which
    hold every categorical feature's bins: the bins after them have no
    rows and sort last."""
    k, B, Bc = hist.shape[0], hist.shape[-1], o.cat_bins
    dev = hist.device
    hf = hist[torch.arange(k, device=dev), f][..., :Bc]       # (k, 3, Bc)
    rank = torch.argsort(_cat_order(hf, o.cat_params[0]), dim=-1)
    left = (rank <= (code % B)[:, None]) \
        & o.cat_mask.index_select(0, f)[:, None]
    bits = torch.zeros((k, n_words * 32), dtype=torch.int64, device=dev)
    bits[:, :Bc] = left.to(torch.int64)
    words = torch.sum(bits.reshape(k, n_words, 32)
                      << torch.arange(32, device=dev), dim=-1)
    return left, words


class _GraphedSearch:
    """fn(*args) of device tensors (or None) replayed as one CUDA graph:
    the args are copied into static inputs, the graph replays, and its
    static outputs come back (each call overwrites the last call's). The
    capture runs fn once on a side stream first (its lazy initialisation
    and workspaces); capturing synchronizes the device, once."""

    def __init__(self, fn, args):
        self.inputs = [None if a is None else a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *args):
        for dst, a in zip(self.inputs, args):
            if dst is not None:
                dst.copy_(a)
        self.graph.replay()
        return self.outputs


def _stable_partition(arr, new_pos):
    """Rows of arr moved to new_pos (a permutation): index_copy_ with unique
    indices, so deterministic on every device."""
    return torch.empty_like(arr).index_copy_(0, new_pos, arr)


def grow_tree_partitioned(bins_pos, stats_pos, num_bins, num_leaves,
                          max_depth, lambda_l2, min_data, min_hess, min_gain,
                          feat_mask=None, lambda_l1=0.0, opts=None,
                          cegb_used=None, extra_u=None, lazy_used=None):
    """Grow one leaf-wise tree (tree_learner.py:617-962
    _grow_tree_partitioned_impl) with the options of `opts` (SplitOptions):
    categorical and missing-value routing, monotone filtering, path
    smoothing, CEGB, extra trees (extra_u (2 L - 1, p) uniforms on the
    device: row 0 the root's, rows 2s + 1 and 2s + 2 the children of split
    s), forced splits and interaction constraints. cegb_used (p,) f32: the
    features the model has used (coupled CEGB); lazy_used (n, p) uint8:
    which rows have acquired which features in earlier trees (lazy CEGB;
    out-of-bag rows count as acquired).

    Returns (rec (L-1, 4) int64 numpy [parent slot, feature, code, ok],
    leaf_values (L,) float64 numpy, node (n,) int64 device row -> leaf slot,
    rec_gain (L-1,) float32 numpy, rec_cat (L-1, words) uint32 numpy (the
    left-bin sets of categorical splits) or None, leaf_path (L, p) f32
    device (the features on each leaf's root path; lazy CEGB) or None).
    Leaf slot s + 1 is the right child made by split s. One host read per
    split: the left child's row count, both children's best splits and
    their categorical bit words.
    """
    n, p = bins_pos.shape
    dev = bins_pos.device
    L = num_leaves
    B = num_bins
    o = opts if opts is not None else _plain_options(p, dev)
    ps = o.path_smooth
    use_cat = o.cat_mask is not None
    n_words = -(-o.cat_bins // 32)
    use_ic = o.inter_groups is not None
    use_lazy = o.cegb_lazy is not None
    forced = o.forced
    n_forced = 0 if forced is None else min(len(forced), L - 1)
    inf = float("inf")
    # elementwise with a host index, not an indexed store: one from the
    # host would read back
    feat_ids = torch.arange(p, device=dev)

    def allow_of(grp):
        allow = ((grp @ o.inter_groups) > 0).to(torch.float32)
        return allow if feat_mask is None else allow * feat_mask

    def search(hists, parent_out, fm, used, ex, pen):
        """The best splits of the leaves with histograms hists (k, p, 3, B),
        searched together, and for a categorical one its left bin set:
        ((k, 3 + words) float64 [gain, feature, code, words...] on the
        device, the (k, cat_bins) left sets or None)."""
        g, f, code = _best_split_of_hist(
            hists, lambda_l2, min_data, min_hess, min_gain, fm, lambda_l1,
            o, parent_out=parent_out, cegb_used=used, extra_u=ex,
            lazy_pen=pen)
        best = torch.stack([g.to(torch.float64), f.to(torch.float64),
                            code.to(torch.float64)], dim=1)
        left = None
        if use_cat:
            left, words = _cat_left(hists, f, code, o, n_words)
            best = torch.cat([best, words.to(torch.float64)], dim=1)
        return best, left

    def evaluate(hists, parent_out, fm, used, u_rows, lazy_pen):
        args = (hists, parent_out, fm, used,
                None if extra_u is None else extra_u[u_rows], lazy_pen)
        if dev.type != "cuda":
            return search(*args)
        # on the card, the search's ~100 small ops replay as one CUDA
        # graph, captured at a learner's first tree for each leaf count
        key = (hists.shape[0], tuple(a is None for a in args), lambda_l2,
               lambda_l1, min_data, min_hess, min_gain)
        if key not in o.graphs:
            o.graphs[key] = _GraphedSearch(search, args)
        return o.graphs[key](*args)

    def raw_out(hist):
        return -_thresholded(torch.sum(hist[0, 0, :]), lambda_l1) / (
            torch.sum(hist[0, 1, :]) + lambda_l2)

    def child_out(hist, parent_out):
        if ps <= 0.0:
            return None
        return _smoothed_output(torch.sum(hist[0, 0, :]),
                                torch.sum(hist[0, 1, :]),
                                torch.sum(hist[0, 2, :]), lambda_l2,
                                lambda_l1, ps, parent_out)

    bins_p = bins_pos.clone()
    stats_p = stats_pos.clone()
    # the kernel's fixed-point scale: the stats do not change while the
    # tree grows (partitioning only permutes them)
    amax = stat_amax(stats_pos, 0)
    row_ids = torch.arange(n, dtype=torch.int64, device=dev)
    leaf_of_pos = torch.zeros(n, dtype=torch.int64, device=dev)
    hist0 = hist_segment(bins_p, stats_p, 0, n, B, amax=amax)
    leaf_hist = torch.zeros((L, p, 3, B), dtype=torch.float32, device=dev)
    leaf_hist[0] = hist0
    leaf_out = torch.zeros(L, dtype=torch.float32, device=dev)
    leaf_out[0] = raw_out(hist0)
    used = None
    if o.cegb_coupled is not None:
        used = (cegb_used if cegb_used is not None
                else torch.zeros(p, device=dev)).to(torch.float32).clone()
    leaf_grp = None
    fm0 = feat_mask
    if use_ic:
        leaf_grp = torch.ones((L, o.inter_groups.shape[0]),
                              dtype=torch.float32, device=dev)
        fm0 = allow_of(leaf_grp[0])
    used_pos = leaf_unused = leaf_path = pen0 = None
    if use_lazy:
        used_pos = lazy_used.clone()
        leaf_unused = torch.zeros((L, p), dtype=torch.float32, device=dev)
        leaf_unused[0] = torch.sum(1.0 - used_pos.to(torch.float32), dim=0)
        leaf_path = torch.zeros((L, p), dtype=torch.float32, device=dev)
        pen0 = o.cegb_lazy * leaf_unused[0]
    leaf_left = torch.zeros((L, o.cat_bins), dtype=torch.bool, device=dev) \
        if use_cat else None
    best0, left0 = evaluate(hist0[None], leaf_out[:1], fm0, used,
                            slice(0, 1), None if pen0 is None else pen0[None])
    if use_cat:
        leaf_left[0] = left0[0]
    vals = best0[0].tolist()

    leaf_gain = np.full(L, -np.inf)
    leaf_feat = np.zeros(L, dtype=np.int64)
    leaf_bin = np.zeros(L, dtype=np.int64)
    leaf_words = np.zeros((L, n_words), dtype=np.uint32)
    leaf_gain[0], leaf_feat[0], leaf_bin[0] = vals[0], int(vals[1]), \
        int(vals[2])
    if use_cat:
        leaf_words[0] = vals[3:]
    leaf_depth = np.zeros(L, dtype=np.int64)
    seg_start = np.zeros(L, dtype=np.int64)
    seg_cnt = np.zeros(L, dtype=np.int64)
    seg_cnt[0] = n
    rec = np.full((L - 1, 4), -1, dtype=np.int64)
    rec_gain = np.zeros(L - 1, dtype=np.float32)
    rec_cat = np.zeros((L - 1, n_words), dtype=np.uint32) if use_cat \
        else None

    for s in range(L - 1):
        is_forced = s < n_forced
        if is_forced:
            # ForceSplits (serial_tree_learner.cpp:453): the first splits
            # are dictated, whatever their gain
            l, f, b = (int(v) for v in forced[s])
        else:
            l = int(np.argmax(leaf_gain))    # first maximum, as jnp.argmax
            if not np.isfinite(leaf_gain[l]):
                break
            f, b = int(leaf_feat[l]), int(leaf_bin[l])
        dl = b >= B                          # code = bin + B * default_left
        br = b - B if dl else b
        s0, c = int(seg_start[l]), int(seg_cnt[l])
        new_slot = s + 1
        seg = slice(s0, s0 + c)

        fcol = bins_p[seg, f].to(torch.int64)
        if use_cat and o.cat_h[f]:
            go_left = leaf_left[l][fcol]
            go_right = ~go_left
        else:
            go_right = fcol > br
            nbf = -1 if o.nan_h is None else int(o.nan_h[f])
            if nbf >= 0:
                # the missing bin follows the learned direction
                is_nan = fcol == nbf
                go_right = (go_right & ~is_nan) if dl else (go_right | is_nan)
            go_left = ~go_right
        if use_lazy:
            # lazy CEGB: the children's counts of rows that have not
            # acquired each feature, from the parent's rows before they move
            unused_left = torch.sum((1.0 - used_pos[seg].to(torch.float32))
                                    * go_left[:, None].to(torch.float32),
                                    dim=0)
        # stable in-segment partition: left rows first, then right
        csl = torch.cumsum(go_left, dim=0)
        csr = torch.cumsum(go_right, dim=0)
        cL = csl[-1]
        new_pos = torch.where(go_left, csl - 1, cL + csr - 1)
        bins_p[seg] = _stable_partition(bins_p[seg], new_pos)
        stats_p[seg] = _stable_partition(stats_p[seg], new_pos)
        row_ids[seg] = _stable_partition(row_ids[seg], new_pos)
        if use_lazy:
            used_pos[seg] = _stable_partition(used_pos[seg], new_pos)
        in_right = torch.arange(c, device=dev) >= cL
        leaf_of_pos[seg] = torch.where(in_right, new_slot, leaf_of_pos[seg])

        # smaller child's histogram from the kernel, sibling by subtraction
        cR = c - cL
        left_smaller = cL <= cR
        sS = s0 + torch.where(left_smaller, torch.zeros_like(cL), cL)
        seg_dev = torch.stack([sS, torch.minimum(cL, cR)]).to(torch.int32)
        hist_small = hist_segment(bins_p, stats_p, seg_dev, None, B,
                                  amax=amax)
        hist_big = leaf_hist[l] - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_big)
        hist_right = torch.where(left_smaller, hist_big, hist_small)
        gain_forced = _gain_at(leaf_hist[l], f, br, lambda_l2, lambda_l1) \
            if is_forced else None
        leaf_hist[l] = hist_left
        leaf_hist[new_slot] = hist_right

        fm_child = feat_mask
        if use_ic:
            # the children's active constraint sets: the parent's that
            # contain f; allowed features: their union
            grp_child = leaf_grp[l] * o.inter_groups[:, f]
            leaf_grp[l] = grp_child
            leaf_grp[new_slot] = grp_child
            fm_child = allow_of(grp_child)
        is_f = feat_ids == f
        if used is not None:
            used = torch.where(is_f, 1.0, used)
        pout = leaf_out[l]
        out_l = child_out(hist_left, pout)
        out_r = child_out(hist_right, pout)
        if ps > 0.0:
            leaf_out[l] = out_l
            leaf_out[new_slot] = out_r
        pen_l = pen_r = None
        if use_lazy:
            unused_right = leaf_unused[l] - unused_left
            path_child = torch.where(is_f, 1.0, leaf_path[l])
            pen_l = o.cegb_lazy * unused_left * (1.0 - path_child)
            pen_r = o.cegb_lazy * unused_right * (1.0 - path_child)
            leaf_unused[l] = unused_left
            leaf_unused[new_slot] = unused_right
            leaf_path[l] = path_child
            leaf_path[new_slot] = path_child
        best, left = evaluate(
            torch.stack([hist_left, hist_right]),
            None if ps <= 0.0 else torch.stack([out_l, out_r]), fm_child,
            used, slice(2 * s + 1, 2 * s + 3),
            None if pen_l is None else torch.stack([pen_l, pen_r]))
        if use_cat:
            leaf_left[l] = left[0]
            leaf_left[new_slot] = left[1]
        # the one host read of this split
        head = [cL.to(torch.float64)]
        if is_forced:
            head.append(gain_forced.to(torch.float64))
        vals = torch.cat([torch.stack(head), best.reshape(-1)]).tolist()
        cL = int(vals[0])
        if is_forced:
            rec_gain[s] = vals[1]
            vals = vals[2:]
        else:
            rec_gain[s] = leaf_gain[l]
            vals = vals[1:]
        k = 3 + (n_words if use_cat else 0)
        (gl_g, fl, bl), wl = vals[:3], vals[3:k]
        (gr_g, fr, br_), wr = vals[k:k + 3], vals[k + 3:]

        d = leaf_depth[l] + 1
        if d >= max_depth:
            gl_g = gr_g = -inf
        rec[s] = (l, f, b, 1)
        if use_cat:
            if not is_forced:
                rec_cat[s] = leaf_words[l]
            leaf_words[l], leaf_words[new_slot] = wl, wr
        leaf_gain[l], leaf_gain[new_slot] = gl_g, gr_g
        leaf_feat[l], leaf_feat[new_slot] = int(fl), int(fr)
        leaf_bin[l], leaf_bin[new_slot] = int(bl), int(br_)
        leaf_depth[l] = leaf_depth[new_slot] = d
        seg_start[l], seg_start[new_slot] = s0, s0 + cL
        seg_cnt[l], seg_cnt[new_slot] = cL, c - cL

    # row -> leaf slot, back in row order (one scatter)
    node = torch.empty_like(leaf_of_pos).index_copy_(0, row_ids, leaf_of_pos)
    Gs = torch.sum(leaf_hist[:, 0, 0, :], dim=1)
    Hs = torch.sum(leaf_hist[:, 0, 1, :], dim=1)
    Cs = torch.sum(leaf_hist[:, 0, 2, :], dim=1)
    if ps <= 0.0:
        leaf_values = torch.where(
            Cs > 0, -_thresholded(Gs, lambda_l1) / (Hs + lambda_l2),
            torch.zeros_like(Gs))
    else:
        leaf_values = torch.where(Cs > 0, leaf_out, torch.zeros_like(Gs))
    return (rec, leaf_values.cpu().numpy().astype(np.float64), node,
            rec_gain, rec_cat, leaf_path)


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
    tree_learner.py:1008-1191). Data and voting modes keep this rank's even
    block of rows (`self.rows`); the feature mode keeps every row and
    builds the histograms of this rank's block of features.

    The single-device learner takes the whole split breadth: categorical
    features, missing-value bins, EFB bundles (the Dataset's bundled
    columns), monotone_constraints, path_smooth, cegb (dict with
    'coupled' (p,) and 'split', tradeoff-scaled, and 'lazy' (p,) or None),
    extra_trees, forced_splits (the nested JSON of forcedsplits_filename),
    cat_params (cat_smooth, cat_l2, max_cat_threshold, min_data_per_group)
    and interaction_constraints (lists of feature indices). The masked
    learners take numeric features only (ROADMAP A15)."""

    def __init__(self, dataset, num_leaves=31, max_depth=-1,
                 min_data_in_leaf=20, lambda_l2=0.0,
                 min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                 lambda_l1=0.0, device=None, parallel_mode="data", top_k=20,
                 group=None, monotone_constraints=None, path_smooth=0.0,
                 cegb=None, extra_trees=False, forced_splits=None,
                 cat_params=(10.0, 10.0, 32.0, 100.0),
                 interaction_constraints=None):
        dataset.construct()
        self.mappers = getattr(dataset, "learner_mappers", dataset.mappers)
        if group is not None:
            self._refuse_on_group(dataset, monotone_constraints, path_smooth,
                                  cegb, extra_trees, forced_splits,
                                  interaction_constraints)
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
        self.cat_mask = np.array([bool(getattr(m, "is_categorical", False))
                                  for m in self.mappers])
        self.monotone = np.zeros(p, dtype=np.int64)
        if monotone_constraints is not None:
            mc = np.asarray(monotone_constraints, dtype=np.int64)
            self.monotone[:len(mc)] = mc[:p]
        self.cegb = cegb
        self.extra_trees = bool(extra_trees)
        # lazy CEGB: which rows have acquired which features, model-wide
        # (the reference's feature_used_in_data_ bitset), (n, p) uint8
        self._lazy_used_rows = None
        if group is None:
            self.opts = self._split_options(cat_params, path_smooth,
                                            interaction_constraints,
                                            forced_splits)

    def _refuse_on_group(self, dataset, monotone, path_smooth, cegb,
                         extra_trees, forced, inter):
        """The masked learners' refusals (ROADMAP A15)."""
        if getattr(dataset, "bundles", None):
            raise NotImplementedError("exclusive feature bundling on a "
                                      "parallel tree learner is not ported "
                                      "yet (ROADMAP A15)")
        for j, m in enumerate(self.mappers):
            if getattr(m, "is_categorical", False):
                raise NotImplementedError(
                    f"feature {j} is categorical: categorical splits on a "
                    "parallel tree learner are not ported yet (ROADMAP A15)")
            if getattr(m, "has_nan", False):
                raise NotImplementedError(
                    f"feature {j} has missing values: missing-value bins on "
                    "a parallel tree learner are not ported yet (ROADMAP "
                    "A15)")
        if (monotone is not None and np.any(monotone)) or path_smooth > 0 \
                or cegb is not None or extra_trees or forced or inter:
            raise NotImplementedError(
                "monotone constraints, path_smooth, CEGB, extra_trees, "
                "forced splits and interaction constraints on a parallel "
                "tree learner are not ported yet (ROADMAP A15)")

    def _split_options(self, cat_params, path_smooth, interaction_constraints,
                       forced_splits):
        """The SplitOptions of the single-device learner
        (tree_learner.py:1089-1191)."""
        p = self.p
        # numeric features with a missing bin: both missing directions and
        # default_left routing; a categorical feature's missing values ride
        # its overflow bin
        nan_bin = np.array([
            int(m.nan_bin) if not self.cat_mask[j]
            and getattr(m, "has_nan", False) else -1
            for j, m in enumerate(self.mappers)])
        feat_hi = np.array([max(int(m.num_bins) - 2, 0)
                            for m in self.mappers])
        inter = None
        if interaction_constraints:
            inter = np.zeros((len(interaction_constraints), p),
                             dtype=np.float32)
            for k, feats in enumerate(interaction_constraints):
                for fj in feats:
                    if not 0 <= int(fj) < p:
                        raise ValueError(
                            f"interaction_constraints feature index {fj} "
                            f"out of range [0, {p})")
                    inter[k, int(fj)] = 1.0
        forced = None
        if forced_splits is not None:
            # nested {feature, threshold, left, right}; slots in
            # parent-before-child (BFS) order
            rows, queue = [], [(forced_splits, 0)]
            while queue and len(rows) < self.num_leaves - 1:
                node, slot = queue.pop(0)
                fj = int(node["feature"])
                if self.cat_mask[fj]:
                    raise NotImplementedError(
                        "forced splits on categorical features are not "
                        "supported")
                bj = int(self.mappers[fj].transform(
                    [float(node["threshold"])])[0])
                s_idx = len(rows)
                rows.append((slot, fj, bj))
                if node.get("left"):
                    queue.append((node["left"], slot))
                if node.get("right"):
                    queue.append((node["right"], s_idx + 1))
            forced = np.asarray(rows, dtype=np.int64)
        cegb = self.cegb or {}
        return SplitOptions(
            p, self.device, monotone=self.monotone, cat_mask=self.cat_mask,
            cat_params=cat_params, cat_bins=max(
                [int(m.num_bins) for j, m in enumerate(self.mappers)
                 if self.cat_mask[j]], default=0),
            nan_bin=nan_bin, path_smooth=path_smooth,
            cegb_coupled=None if self.cegb is None
            else np.asarray(cegb["coupled"], dtype=np.float32)[:p],
            cegb_split=float(cegb.get("split", 0.0)),
            cegb_lazy=None if cegb.get("lazy") is None
            else np.asarray(cegb["lazy"], dtype=np.float32)[:p],
            feat_hi=feat_hi if self.extra_trees else None,
            inter_groups=inter, forced=forced)

    def _extra_uniforms(self, extra_seed):
        """(2 L - 1, p) f32 uniforms of one tree's extra-trees thresholds,
        drawn on a CPU generator seeded by extra_seed (so the card and the
        CPU grow the same trees) and copied to the device without a host
        sync."""
        g = torch.Generator().manual_seed(int(extra_seed))
        return _to_device(torch.rand((2 * self.num_leaves - 1, self.p),
                                     generator=g, dtype=torch.float32),
                          self.device)

    def train(self, grad, hess, row_mask=None, feat_mask=None,
              cegb_used=None, extra_seed=None):
        """Grow one tree on grad/hess (numpy arrays or tensors of this
        rank's rows, `self.rows`, in row order). row_mask (n,) 0/1
        (bagging): an out-of-bag row adds nothing to the histograms (grad,
        hess and count 0) but keeps its leaf, so every row's score is
        updated (tree_learner.py:1193-1220). feat_mask (p,) 0/1 (feature
        fraction): only its features split. cegb_used (p,): the features
        the model has split on (coupled CEGB); extra_seed seeds this tree's
        extra-trees thresholds. Returns (tree, slot_of_row (n,) int64 tensor
        on the device, leaf_value_of_slot (L + 8,) float64 numpy)."""
        if self.group is not None:
            if row_mask is not None or feat_mask is not None:
                raise NotImplementedError(
                    "bagging and feature_fraction on a parallel tree "
                    "learner are not ported yet (ROADMAP A15)")
            return self._train_masked(grad, hess)
        dev = self.device
        stats = torch.ones((self.n, 3), dtype=torch.float32, device=dev)
        grad = torch.as_tensor(grad, device=dev)
        hess = torch.as_tensor(hess, device=dev)
        rm = None
        if row_mask is None:
            stats[:, 0] = grad
            stats[:, 1] = hess
        else:
            rm = torch.as_tensor(row_mask, device=dev)
            stats[:, 0] = grad * rm
            stats[:, 1] = hess * rm
            stats[:, 2] = (rm > 0).to(torch.float32)
        if feat_mask is not None:
            feat_mask = torch.as_tensor(feat_mask, dtype=torch.float32,
                                        device=dev)
        if cegb_used is not None and not torch.is_tensor(cegb_used):
            cegb_used = _to_device(torch.as_tensor(
                np.asarray(cegb_used)[:self.p], dtype=torch.float32), dev)
        extra_u = None
        if self.extra_trees:
            extra_u = self._extra_uniforms(0 if extra_seed is None
                                           else extra_seed)
        lazy_used = None
        if self.opts.cegb_lazy is not None:
            if self._lazy_used_rows is None:
                self._lazy_used_rows = torch.zeros(
                    (self.n, self.p), dtype=torch.uint8, device=dev)
            lazy_used = self._lazy_used_rows
            if rm is not None:
                # out-of-bag rows are invisible to the penalty and to the
                # end-of-tree marks (the reference's partition holds only
                # bagged rows)
                inbag = (rm > 0).to(torch.uint8)
                lazy_used = torch.maximum(lazy_used, (1 - inbag)[:, None])
        rec, leaf_values, node, rec_gain, rec_cat, leaf_path = \
            grow_tree_partitioned(
                self.bins_pos, stats, self.num_bins, self.num_leaves,
                self.max_depth, self.lambda_l2, self.min_data_in_leaf,
                self.min_sum_hessian, self.min_gain, feat_mask=feat_mask,
                lambda_l1=self.lambda_l1, opts=self.opts,
                cegb_used=cegb_used, extra_u=extra_u, lazy_used=lazy_used)
        if leaf_path is not None:
            marks = leaf_path[torch.clamp(node, 0, self.num_leaves - 1)]
            if rm is not None:
                marks = marks * (rm > 0).to(torch.float32)[:, None]
            self._lazy_used_rows = torch.maximum(
                self._lazy_used_rows, marks.to(torch.uint8))
        # rows per slot; bincount would read the largest slot back first
        cnt = torch.zeros(self.num_leaves + 8, dtype=torch.int64,
                          device=node.device).index_add_(
            0, node, torch.ones_like(node)).cpu().numpy()
        tree, leaf_value_of_slot = self.build_tree(rec, leaf_values, rec_gain,
                                                   cnt, rec_cat)
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

    def build_tree(self, rec, leaf_values, rec_gain, cnt, rec_cat=None):
        """Host-side tree reconstruction from the split records
        (tree_learner.py:1338-1398): each code decoded into its bin and
        missing direction, a categorical split's bit words into its left
        bins and category values, the monotone constraints enforced on the
        leaf values (`_enforce_monotone`). cnt: per-slot training row
        counts (the covers of TreeSHAP)."""
        rec_gain = np.asarray(rec_gain, dtype=np.float64)
        leaf_values = np.array(leaf_values, dtype=np.float64)
        tree = Tree(2 * self.num_leaves)
        tree.leaf_value[0] = leaf_values[0]
        slot_to_node = {0: 0}
        B = self.num_bins
        for s in range(self.num_leaves - 1):
            parent_slot, f, b, ok = (int(v) for v in rec[s])
            if ok != 1:
                break
            node_id = slot_to_node[parent_slot]
            mapper = self.mappers[f]
            dl = b >= B
            b = b - B if dl else b
            is_cat = bool(self.cat_mask[f])
            mb = int(mapper.nan_bin) if not is_cat \
                and getattr(mapper, "has_nan", False) else -1
            li, ri = tree.split(node_id, f, b, mapper.bin_to_threshold(b),
                                0.0, 0.0, default_left=dl, missing_bin=mb)
            tree.split_gain[node_id] = rec_gain[s]
            if is_cat:
                bits = np.unpackbits(np.asarray(rec_cat[s], dtype="<u4")
                                     .view(np.uint8), bitorder="little")
                left_bins = np.zeros(B, dtype=bool)
                left_bins[:min(B, len(bits))] = bits[:B]
                tree.cat_left_bins[node_id] = left_bins
                tree.cat_left_values[node_id] = mapper.bins_to_values(
                    left_bins)
            slot_to_node[parent_slot] = li
            slot_to_node[s + 1] = ri
        for slot, node_id in slot_to_node.items():
            tree.leaf_value[node_id] = leaf_values[slot]
        if np.any(self.monotone != 0):
            _enforce_monotone(tree, self.monotone)
        leaf_value_of_slot = np.zeros(self.num_leaves + 8)
        for slot, node_id in slot_to_node.items():
            leaf_value_of_slot[slot] = tree.leaf_value[node_id]
        tree.slot_to_node = dict(slot_to_node)
        # per-node training covers (TreeSHAP); parents precede children in
        # the node numbering, so one reversed pass sums the internal nodes
        for slot, node_id in slot_to_node.items():
            tree.cover[node_id] = max(float(cnt[slot]), 1e-9)
        for i in range(tree.num_nodes - 1, -1, -1):
            if not tree.is_leaf[i]:
                tree.cover[i] = tree.cover[tree.left[i]] \
                    + tree.cover[tree.right[i]]
        return tree, leaf_value_of_slot


def _to_device(t, device):
    """A host tensor on `device`; to a card through pinned memory, without
    a host sync."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _enforce_monotone(tree, monotone):
    """Clip leaf values so that every monotone-constrained split satisfies
    max(left subtree) <= min(right subtree) for a +1 constraint (mirrored
    for -1), around the mean of the two subtrees' means
    (tree_learner.py:1401-1443, the 'basic' method of
    monotone_constraints.hpp)."""

    def leaves_under(node):
        stack, out = [node], []
        while stack:
            i = stack.pop()
            if tree.is_leaf[i]:
                out.append(i)
            else:
                stack.extend([int(tree.left[i]), int(tree.right[i])])
        return out

    def visit(node):
        if tree.is_leaf[node]:
            return
        f = int(tree.split_feature[node])
        li, ri = int(tree.left[node]), int(tree.right[node])
        m = int(monotone[f]) if f < len(monotone) else 0
        if m != 0:
            ll, rl = leaves_under(li), leaves_under(ri)
            lv = np.array([tree.leaf_value[i] for i in ll])
            rv = np.array([tree.leaf_value[i] for i in rl])
            mid = 0.5 * (lv.mean() + rv.mean())
            lo, hi = (min, max) if m > 0 else (max, min)
            for i in ll:
                tree.leaf_value[i] = lo(tree.leaf_value[i], mid)
            for i in rl:
                tree.leaf_value[i] = hi(tree.leaf_value[i], mid)
        visit(li)
        visit(ri)

    visit(0)
