"""Dataset: feature quantization for histogram-based tree learning.

Reference: LightGBM's BinMapper / Dataset (include/LightGBM/bin.h:507,
io/bin.cpp:737, io/dataset.cpp) — features are quantized to at most `max_bin`
bins found from (sampled) quantiles of the distinct values; trees then operate
purely on the small integer bin codes. Binning stays on the host (numpy,
once); the tree learner ships one (n, num_features) uint8/int32 bin matrix to
the device, where histograms come from the kernel in ops/histogram.py.

A copy of gpboost_tpu/boosting/dataset.py; only this docstring differs.
"""

import numpy as np


def load_svmlight(path, n_features=None):
    """Parse a LibSVM-format file "label idx:val idx:val ..." into
    (X dense (n, p), y (n,)) (reference: io/parser.cpp LibSVM parser).
    Indices may be 0- or 1-based; missing entries are 0."""
    labels = []
    rows = []
    max_idx = -1
    min_idx = 10 ** 9
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                k, v = tok.split(":")
                k = int(k)
                feats[k] = float(v)
                max_idx = max(max_idx, k)
                min_idx = min(min_idx, k)
            rows.append(feats)
    base = 1 if min_idx >= 1 else 0
    p = n_features if n_features is not None else (max_idx - base + 1)
    X = np.zeros((len(rows), p))
    for i, feats in enumerate(rows):
        for k, v in feats.items():
            j = k - base
            if 0 <= j < p:
                X[i, j] = v
    return X, np.asarray(labels)


def _data_from_pandas(df, pandas_categorical=None):
    """DataFrame -> (float ndarray, auto categorical column indices, column
    names, per-column category lists) — basic.py _data_from_pandas. When
    `pandas_categorical` is given (prediction time), object/category columns
    are coded against THOSE category lists (unseen values -> NaN)."""
    cols = list(df.columns)
    cat_idx = []
    cat_lists = {}
    out = np.empty((len(df), len(cols)), dtype=np.float64)
    for j, c in enumerate(cols):
        s = df[c]
        dt = str(s.dtype)
        is_cat = (dt == "category" or getattr(s.dtype, "kind", "") in "OUS"
                  or dt.startswith("str"))
        if is_cat:
            cat_idx.append(j)
            if pandas_categorical is not None and j in pandas_categorical:
                cats = pandas_categorical[j]
            elif dt == "category":
                cats = list(s.cat.categories)
            else:
                cats = sorted(x for x in s.dropna().unique())
            cat_lists[j] = list(cats)
            code = {v: i for i, v in enumerate(cats)}
            out[:, j] = [code.get(v, np.nan) for v in s]
        else:
            out[:, j] = np.asarray(s, dtype=np.float64)
    return out, cat_idx, [str(c) for c in cols], cat_lists


#: |x| <= kZeroThreshold is "zero" and gets a dedicated bin (bin.h)
_KZERO = 1e-35


def _greedy_find_bin(distinct, counts, max_bin, total_cnt, min_data_in_bin):
    """Upper bin bounds for one sign-range of a feature (io/bin.cpp:78
    GreedyFindBin). distinct must be sorted ascending with per-value counts.

    Two regimes: few distinct values -> one bin per value but merging until
    each bin holds >= min_data_in_bin samples; many values -> equal-count
    bins with 'big' values (count >= mean bin size) forced into their own
    bin. Returns a list ending in +inf."""
    nd = len(distinct)
    bounds = []
    if nd == 0 or max_bin <= 0:
        return [np.inf]
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                val = np.nextafter((distinct[i] + distinct[i + 1]) / 2.0,
                                   np.inf)
                if not bounds or val > bounds[-1]:
                    bounds.append(val)
                    cur = 0
        bounds.append(np.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt) // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = np.asarray(counts) >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = int(total_cnt - np.asarray(counts)[is_big].sum())
    mean_bin_size = (rest_sample_cnt / rest_bin_cnt) if rest_bin_cnt > 0 \
        else np.inf
    uppers, lowers = [], [distinct[0]]
    cur = 0
    bin_cnt = 0
    for i in range(nd - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur += counts[i]
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            uppers.append(distinct[i])
            bin_cnt += 1
            lowers.append(distinct[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = (rest_sample_cnt / rest_bin_cnt) \
                    if rest_bin_cnt > 0 else np.inf
    for i in range(len(uppers)):
        val = np.nextafter((uppers[i] + lowers[i + 1]) / 2.0, np.inf)
        if not bounds or val > bounds[-1]:
            bounds.append(val)
    bounds.append(np.inf)
    return bounds


def _find_bin_zero_as_one_bin(distinct, counts, max_bin, total_cnt,
                              min_data_in_bin):
    """io/bin.cpp:257 FindBinWithZeroAsOneBin: negatives and positives are
    binned separately with a count-proportional bin budget; zero always gets
    its own bin [-kZero, kZero]."""
    nd = len(distinct)
    counts = np.asarray(counts)
    left_sel = distinct <= -_KZERO
    right_sel = distinct > _KZERO
    cnt_left = int(counts[left_sel].sum())
    cnt_right = int(counts[right_sel].sum())
    cnt_zero = int(total_cnt) - cnt_left - cnt_right
    left_cnt = int(np.argmax(~left_sel)) if not left_sel.all() else nd
    bounds = []
    if left_cnt > 0 and max_bin > 1:
        left_max_bin = max(1, int(cnt_left / (total_cnt - cnt_zero)
                                  * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct[:left_cnt], counts[:left_cnt],
                                  left_max_bin, cnt_left, min_data_in_bin)
        if bounds:
            bounds[-1] = -_KZERO
    right_start = -1
    for i in range(left_cnt, nd):
        if distinct[i] > _KZERO:
            right_start = i
            break
    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        rb = _greedy_find_bin(distinct[right_start:], counts[right_start:],
                              right_max_bin, cnt_right, min_data_in_bin)
        bounds.append(_KZERO)
        bounds.extend(rb)
    else:
        bounds.append(np.inf)
    return bounds


class BinMapper:
    """Quantile-based binning of one feature, matching the reference's
    bin.cpp FindBin semantics (min_data_in_bin merging, dedicated zero bin,
    count-proportional budgets); NaN -> the last bin."""

    is_categorical = False
    use_missing = True          # class defaults for bare (__new__) mappers
    zero_as_missing = False

    def __init__(self, values, max_bin=255, min_data_in_bin=3,
                 use_missing=True, zero_as_missing=False):
        # MissingType semantics (bin.h:27, io/bin.cpp FindBin):
        #   use_missing=False  -> NaN is treated as zero (MissingType::None)
        #   zero_as_missing    -> zeros AND NaN share the missing bin
        #                         (MissingType::Zero); zeros then follow the
        #                         learned default direction at every split
        #   default            -> NaN gets the last bin (MissingType::NaN)
        self.use_missing = bool(use_missing)
        self.zero_as_missing = bool(zero_as_missing) and self.use_missing
        v = np.asarray(values, dtype=np.float64)
        if not self.use_missing:
            v = np.nan_to_num(v, nan=0.0)
        elif self.zero_as_missing:
            v = np.where(v == 0.0, np.nan, v)
        finite = v[np.isfinite(v)]
        uniq, counts = np.unique(finite, return_counts=True)
        self.has_nan = bool(np.any(~np.isfinite(v)))
        max_real_bins = max_bin - (1 if self.has_nan else 0)
        self.upper_bounds = np.asarray(_find_bin_zero_as_one_bin(
            uniq, counts, max_real_bins, len(finite), min_data_in_bin))
        self.num_bins = len(self.upper_bounds) + (1 if self.has_nan else 0)
        self.nan_bin = self.num_bins - 1 if self.has_nan else -1

    def transform(self, values):
        v = np.asarray(values, dtype=np.float64)
        if not self.use_missing:
            v = np.nan_to_num(v, nan=0.0)
        elif self.zero_as_missing:
            v = np.where(v == 0.0, np.nan, v)
        from ..native import bin_column
        return bin_column(v, self.upper_bounds,
                          nan_bin=self.nan_bin if self.has_nan else -1)

    def bin_to_threshold(self, b):
        """Real-valued threshold for 'go left if x <= t' at bin boundary b."""
        return float(self.upper_bounds[min(b, len(self.upper_bounds) - 1)]) \
            if b < len(self.upper_bounds) - 1 else np.inf


class CategoricalBinMapper:
    """Categorical feature binning (bin.h CategoricalBin / io/bin.cpp
    categorical FindBin): each of the most frequent categories gets its own
    bin; rare categories and NaN share the overflow bin."""

    is_categorical = True

    def __init__(self, values, max_bin=255):
        v = np.asarray(values, dtype=np.float64)
        finite = v[np.isfinite(v)]
        cats, counts = np.unique(finite, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        keep = cats[order[: max_bin - 1]]
        self.categories = np.sort(keep)            # bin i <-> categories[i]
        self.num_bins = len(self.categories) + 1   # + overflow/NaN bin
        self.other_bin = self.num_bins - 1
        self.has_nan = bool(np.any(~np.isfinite(v)))
        self.nan_bin = self.other_bin

    def transform(self, values):
        v = np.asarray(values, dtype=np.float64)
        idx = np.searchsorted(self.categories, v)
        idx = np.clip(idx, 0, len(self.categories) - 1)
        hit = np.isfinite(v) & (self.categories[idx] == v)
        return np.where(hit, idx, self.other_bin).astype(np.int32)

    def bin_to_threshold(self, b):
        return np.inf

    def bins_to_values(self, bin_mask):
        """Raw category values of the bins selected by a bool mask."""
        sel = np.where(np.asarray(bin_mask[: len(self.categories)]))[0]
        return self.categories[sel]


class FeatureBundle:
    """Exclusive feature bundling (io/dataset_loader.cpp FindGroups /
    io/bin.cpp bundling): mutually (near-)exclusive sparse features share one
    histogram column; bundle bin = offset_j + (bin_j - 1) + 1 for the single
    nonzero feature j of the row, 0 when all features are at their default
    (zero) bin."""

    def __init__(self, feature_ids, mappers):
        self.feature_ids = list(feature_ids)
        self.mappers = list(mappers)
        self.offsets = []
        off = 1                       # bin 0 = all-default
        for m in self.mappers:
            self.offsets.append(off)
            off += m.num_bins
        self.num_bins = off

    def encode(self, X):
        """Bundle-bin column for raw feature matrix X (n, p_full)."""
        n = len(X)
        out = np.zeros(n, dtype=np.int32)
        for fid, m, off in zip(self.feature_ids, self.mappers, self.offsets):
            col = X[:, fid]
            nz = np.isfinite(col) & (col != 0.0)
            out[nz] = off + m.transform(col[nz])
        return out

    def to_dict(self):
        return {"feature_ids": self.feature_ids,
                "upper_bounds": [np.asarray(m.upper_bounds).tolist()
                                 for m in self.mappers]}

    is_categorical = False
    has_nan = False

    def bin_to_threshold(self, b):
        # bundle splits live in bin space; prediction re-encodes raw rows
        return float("inf")

    @classmethod
    def from_dict(cls, d):
        ms = []
        for ub in d["upper_bounds"]:
            m = BinMapper.__new__(BinMapper)
            m.upper_bounds = np.asarray(ub)
            m.has_nan = False
            m.num_bins = len(m.upper_bounds)
            m.nan_bin = -1
            ms.append(m)
        return cls(d["feature_ids"], ms)


class Dataset:
    """Training dataset (basic.py:1180 Dataset API subset)."""

    def __init__(self, data, label=None, max_bin=255, weight=None,
                 categorical_feature=None, feature_name=None, params=None,
                 free_raw_data=False, reference=None, group=None):
        if isinstance(data, str):
            # file path (basic.py Dataset(data=<path>)): LibSVM when entries
            # look like idx:val, else delimited text with the label in the
            # first column
            with open(data) as f:
                first = f.readline()
            if ":" in first.split("#", 1)[0]:
                X, y = load_svmlight(data)
                data = X
                if label is None:
                    label = y
            else:
                sep = "\t" if "\t" in first else ","
                has_header = any(c.isalpha() for c in first.split(sep)[0])
                M = np.genfromtxt(data, delimiter=sep,
                                  skip_header=1 if has_header else 0)
                if M.ndim == 1:
                    M = M[:, None]
                data = M[:, 1:]
                if label is None:
                    label = M[:, 0]
        self.pandas_categorical = None
        if hasattr(data, "dtypes") and hasattr(data, "columns"):
            # pandas DataFrame (basic.py _data_from_pandas): category/object
            # columns are coded against their sorted category lists, recorded
            # so prediction-time frames map to the SAME codes
            data, auto_cat, names, self.pandas_categorical = \
                _data_from_pandas(data)
            if feature_name is None:
                feature_name = names
            if categorical_feature is None and auto_cat:
                categorical_feature = auto_cat
        if hasattr(label, "values"):
            label = np.asarray(label.values, dtype=np.float64).ravel()
        self.data = np.asarray(data, dtype=np.float64)
        if self.data.ndim == 1:
            self.data = self.data[:, None]
        self.label = None if label is None else np.asarray(label, dtype=np.float64)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float64)
        # query/group sizes for ranking tasks (metadata.cpp query_boundaries)
        self.group = None if group is None else np.asarray(group,
                                                           dtype=np.int64)
        self.max_bin = int((params or {}).get("max_bin", max_bin))
        self.min_data_in_bin = int((params or {}).get("min_data_in_bin", 3))
        self.feature_name = feature_name
        cf = categorical_feature
        if cf is None:
            cf = (params or {}).get("categorical_feature")
        self.categorical_feature = []
        if cf is not None and cf != "auto":
            for c in ([cf] if np.isscalar(cf) or isinstance(cf, str) else cf):
                if isinstance(c, str):
                    if feature_name and c in feature_name:
                        c = feature_name.index(c)
                    else:
                        c = int(c.replace("Column_", ""))
                self.categorical_feature.append(int(c))
        self.num_data, self.num_features = self.data.shape
        self._reference = reference
        self._constructed = False
        self.enable_bundle = bool((params or {}).get("enable_bundle", False))
        self.max_conflict_rate = float(
            (params or {}).get("max_conflict_rate", 0.0))
        # missing-value handling (config.h use_missing / zero_as_missing)
        self.use_missing = bool((params or {}).get("use_missing", True))
        self.zero_as_missing = bool(
            (params or {}).get("zero_as_missing", False))
        self.bundles = []
        self.kept_features = None

    def construct(self):
        if self._constructed:
            return self
        if self._reference is not None:
            self._reference.construct()
            self.mappers = self._reference.mappers
            self.bundles = self._reference.bundles
            self.kept_features = self._reference.kept_features
        else:
            self.mappers = [
                CategoricalBinMapper(self.data[:, j], self.max_bin)
                if j in self.categorical_feature
                else BinMapper(self.data[:, j], self.max_bin,
                               self.min_data_in_bin,
                               use_missing=self.use_missing,
                               zero_as_missing=self.zero_as_missing)
                for j in range(self.num_features)]
            if self.enable_bundle:
                self._find_bundles()
        if self.bundles:
            kept = self.kept_features
            cols = [self.mappers[j].transform(self.data[:, j])
                    for j in kept]
            cols += [b.encode(self.data) for b in self.bundles]
            self.bins = np.column_stack(cols) if cols else                 np.zeros((self.num_data, 0), dtype=np.int32)
            self.learner_mappers = [self.mappers[j] for j in kept]                 + self.bundles
            self.num_bins = max(m.num_bins for m in self.learner_mappers)
        else:
            self.bins = np.column_stack([
                m.transform(self.data[:, j])
                for j, m in enumerate(self.mappers)])
            self.learner_mappers = self.mappers
            self.num_bins = max(m.num_bins for m in self.mappers)
        self._constructed = True
        return self

    def _find_bundles(self):
        """Greedy exclusive-feature grouping (dataset_loader.cpp FindGroups):
        sparse numeric features whose nonzero sets conflict on at most
        max_conflict_rate of the rows share a bundle."""
        n = self.num_data
        max_conflicts = int(self.max_conflict_rate * n)
        nz = {}
        for j in range(self.num_features):
            if j in self.categorical_feature:
                continue
            col = self.data[:, j]
            mask = np.isfinite(col) & (col != 0.0)
            if mask.sum() <= 0.5 * n:       # only sparse features bundle
                nz[j] = mask
        order = sorted(nz, key=lambda j: -nz[j].sum())
        groups = []                          # (feature_ids, used_mask)
        for j in order:
            placed = False
            for g in groups:
                if int((g[1] & nz[j]).sum()) <= max_conflicts:
                    g[0].append(j)
                    g[1] |= nz[j]
                    placed = True
                    break
            if not placed:
                groups.append([[j], nz[j].copy()])
        self.bundles = [
            FeatureBundle(g[0], [self.mappers[j] for j in g[0]])
            for g in groups if len(g[0]) > 1]
        bundled = {j for b in self.bundles for j in b.feature_ids}
        self.kept_features = [j for j in range(self.num_features)
                              if j not in bundled]

    def set_label(self, label):
        self.label = np.asarray(label, dtype=np.float64)
        return self

    def get_label(self):
        return self.label

    def set_group(self, group):
        """Per-query document counts for ranking (basic.py Dataset.set_group)."""
        self.group = None if group is None else np.asarray(group,
                                                           dtype=np.int64)
        return self

    def get_group(self):
        return self.group

    def num_rows(self):
        return self.num_data

    def num_feature(self):
        return self.num_features

    def encode_raw(self, X):
        """Learner-space bin matrix for raw rows (identity when no EFB
        bundles are active)."""
        self.construct()
        X = np.asarray(X, dtype=np.float64)
        cols = [self.mappers[j].transform(X[:, j])
                for j in (self.kept_features
                          if self.bundles else range(self.num_features))]
        cols += [b.encode(X) for b in self.bundles]
        return np.column_stack(cols)
