"""Decision tree as flat arrays (reference: include/LightGBM/tree.h:721).

Nodes are stored in arrays so prediction is a fixed-depth vectorized descent
(gather chains) instead of pointer chasing — jit/vmap friendly.
"""

import numpy as np


class Tree:
    def __init__(self, max_nodes):
        self.split_feature = np.full(max_nodes, -1, dtype=np.int32)
        self.threshold_bin = np.full(max_nodes, -1, dtype=np.int32)
        self.threshold_real = np.full(max_nodes, np.inf)
        self.left = np.full(max_nodes, -1, dtype=np.int32)
        self.right = np.full(max_nodes, -1, dtype=np.int32)
        self.leaf_value = np.zeros(max_nodes)
        self.is_leaf = np.ones(max_nodes, dtype=bool)
        self.cover = np.zeros(max_nodes)    # training rows through each node
        self.split_gain = np.zeros(max_nodes)
        # missing-value routing (tree.h decision_type_ kDefaultLeftMask):
        # rows whose split feature is missing (NaN raw value / missing bin)
        # go left when default_left, right otherwise
        self.default_left = np.zeros(max_nodes, dtype=bool)
        self.missing_bin = np.full(max_nodes, -1, dtype=np.int32)
        self.num_nodes = 1
        self.num_leaves = 1
        self.max_depth_used = 0
        self.shrinkage_applied = 1.0
        # categorical splits (tree.h cat_threshold_): node -> raw left-going
        # category values, and node -> left-going bin bitmask (bool array)
        self.cat_left_values = {}
        self.cat_left_bins = {}
        # linear leaves (linear_tree_learner.cpp): node -> (feature indices,
        # coefficients); the constant part stays in leaf_value
        self.leaf_linear = {}

    def split(self, node, feature, bin_threshold, real_threshold,
              left_value, right_value, default_left=False, missing_bin=-1):
        li, ri = self.num_nodes, self.num_nodes + 1
        self.num_nodes += 2
        self.split_feature[node] = feature
        self.threshold_bin[node] = bin_threshold
        self.threshold_real[node] = real_threshold
        self.default_left[node] = bool(default_left)
        self.missing_bin[node] = int(missing_bin)
        self.left[node] = li
        self.right[node] = ri
        self.is_leaf[node] = False
        self.leaf_value[li] = left_value
        self.leaf_value[ri] = right_value
        self.num_leaves += 1
        return li, ri

    def shrinkage(self, rate):
        """tree.h Shrinkage: scale all leaf values."""
        self.leaf_value[self.is_leaf] *= rate
        for k in self.leaf_linear:
            feats, coefs = self.leaf_linear[k]
            self.leaf_linear[k] = (feats, coefs * rate)
        self.shrinkage_applied *= rate

    def predict_binned(self, bins):
        """Predict from binned features (training data)."""
        return self.leaf_value[self.leaf_index_binned(bins)]

    def leaf_index_binned(self, bins):
        n = len(bins)
        node = np.zeros(n, dtype=np.int32)
        while True:
            active_idx = np.where(~self.is_leaf[node])[0]
            if len(active_idx) == 0:
                break
            nd = node[active_idx]
            f = self.split_feature[nd]
            b = bins[active_idx, f]
            go_left = b <= self.threshold_bin[nd]
            mb = self.missing_bin[nd]
            go_left = np.where((mb >= 0) & (b == mb),
                               self.default_left[nd], go_left)
            if self.cat_left_bins:
                for i in np.unique(nd):
                    mask_bins = self.cat_left_bins.get(int(i))
                    if mask_bins is not None:
                        sel = nd == i
                        go_left[sel] = mask_bins[
                            np.clip(b[sel], 0, len(mask_bins) - 1)]
            node[active_idx] = np.where(go_left, self.left[nd],
                                        self.right[nd])
        return node

    def leaf_index_raw(self, X):
        """Leaf NODE index per raw-feature row (refit / SHAP helpers)."""
        X = np.asarray(X, dtype=np.float64)
        n = len(X)
        node = np.zeros(n, dtype=np.int32)
        while True:
            active_idx = np.where(~self.is_leaf[node])[0]
            if len(active_idx) == 0:
                break
            nd = node[active_idx]
            f = self.split_feature[nd]
            x = X[active_idx, f]
            go_left = x <= self.threshold_real[nd]
            go_left = np.where(np.isfinite(x), go_left,
                               self.default_left[nd])
            if self.cat_left_values:
                for i in np.unique(nd):
                    vals = self.cat_left_values.get(int(i))
                    if vals is not None:
                        sel = nd == i
                        go_left[sel] = np.isin(x[sel], vals) \
                            & np.isfinite(x[sel])
            node[active_idx] = np.where(go_left, self.left[nd],
                                        self.right[nd])
        return node

    def predict_raw(self, X):
        """Predict from raw features (new data); NaN follows each split's
        learned default direction (default_left)."""
        X = np.asarray(X, dtype=np.float64)
        node = self.leaf_index_raw(X)
        out = self.leaf_value[node].copy()
        if self.leaf_linear:
            for leaf, (feats, coefs) in self.leaf_linear.items():
                sel = node == leaf
                if np.any(sel):
                    Xf = np.nan_to_num(X[np.ix_(sel, feats)])
                    out[sel] += Xf @ coefs
        return out

    def to_dict(self):
        n = self.num_nodes
        return {
            "split_feature": self.split_feature[:n].tolist(),
            "threshold_real": [None if not np.isfinite(t) else float(t)
                               for t in self.threshold_real[:n]],
            "threshold_bin": self.threshold_bin[:n].tolist(),
            "left": self.left[:n].tolist(),
            "right": self.right[:n].tolist(),
            "leaf_value": self.leaf_value[:n].tolist(),
            "is_leaf": self.is_leaf[:n].tolist(),
            "cover": self.cover[:n].tolist(),
            "split_gain": self.split_gain[:n].tolist(),
            "default_left": self.default_left[:n].astype(int).tolist(),
            "missing_bin": self.missing_bin[:n].tolist(),
            "shrinkage": self.shrinkage_applied,
            "cat_left_values": {str(k): np.asarray(v).tolist()
                                for k, v in self.cat_left_values.items()},
            "cat_left_bins": {str(k): np.asarray(v).astype(int).tolist()
                              for k, v in self.cat_left_bins.items()},
            "leaf_linear": {str(k): [np.asarray(f).tolist(),
                                     np.asarray(c).tolist()]
                            for k, (f, c) in self.leaf_linear.items()},
        }

    @classmethod
    def from_dict(cls, d):
        n = len(d["leaf_value"])
        t = cls(n)
        t.num_nodes = n
        t.split_feature[:n] = d["split_feature"]
        t.threshold_real[:n] = [np.inf if v is None else v
                                for v in d["threshold_real"]]
        t.threshold_bin[:n] = d["threshold_bin"]
        t.left[:n] = d["left"]
        t.right[:n] = d["right"]
        t.leaf_value[:n] = d["leaf_value"]
        t.is_leaf[:n] = d["is_leaf"]
        if "cover" in d:
            t.cover[:n] = d["cover"]
        if "split_gain" in d:
            t.split_gain[:n] = d["split_gain"]
        if "default_left" in d:
            t.default_left[:n] = np.asarray(d["default_left"], dtype=bool)
        if "missing_bin" in d:
            t.missing_bin[:n] = d["missing_bin"]
        t.shrinkage_applied = float(d.get("shrinkage", 1.0))
        for k, v in (d.get("cat_left_values") or {}).items():
            t.cat_left_values[int(k)] = np.asarray(v, dtype=np.float64)
        for k, v in (d.get("cat_left_bins") or {}).items():
            t.cat_left_bins[int(k)] = np.asarray(v, dtype=bool)
        for k, (f, c) in (d.get("leaf_linear") or {}).items():
            t.leaf_linear[int(k)] = (np.asarray(f, dtype=int),
                                     np.asarray(c, dtype=np.float64))
        t.num_leaves = int(np.sum(t.is_leaf[:n]))
        return t
