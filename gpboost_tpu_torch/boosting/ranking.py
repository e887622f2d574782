"""Learning-to-rank objectives and metrics of the PyTorch port
(counterpart of gpboost_tpu/boosting/ranking.py; reference
src/LightGBM/objective/rank_objective.hpp: LambdarankNDCG :97-283,
RankXENDCG :289-361; metric/rank_metric.hpp, metric/map_metric.hpp,
metric/dcg_calculator.cpp: label gains 2^l - 1, position discounts
1/log2(2 + rank)).

The label checks, the metrics and the per-query numpy gradient functions
are copies of the JAX package's numpy module; the numpy gradients are the
plain form the tests hold the device versions to. `QueryLayout` computes
the same gradients on the booster's device with no host read: the queries
sit in a padded (Q, L_max) layout built once, each query is sorted by
descending score with a stable sort (as np.argsort(-s, kind="stable")),
and lambdarank forms only the band of pairs whose better rank is below
the truncation level, (Q, T, L_max) instead of (Q, L_max, L_max). The
sigmoid is exact, as in the JAX package (the reference uses a 2^20-entry
lookup table). rank_xendcg's uniforms come from RandomState(seed + q) for
query q in every call, so they are drawn once, at setup.
"""

import numpy as np
import torch

# label_gain[l] = 2^l - 1 (dcg_calculator.cpp:33 DefaultLabelGain)
DEFAULT_LABEL_GAIN = np.array([(1 << i) - 1 for i in range(31)],
                              dtype=np.float64)
DEFAULT_EVAL_AT = (1, 2, 3, 4, 5)


def query_boundaries(group):
    """Cumulative boundaries from per-query document counts."""
    group = np.asarray(group, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(group)])


def _discount(ranks):
    return 1.0 / np.log2(2.0 + ranks)


def check_rank_labels(labels, label_gain=DEFAULT_LABEL_GAIN):
    lv = np.asarray(labels)
    if not np.all(lv >= 0):
        raise ValueError("ranking labels must be non-negative integers")
    if not np.all(lv == lv.astype(int)):
        raise ValueError("ranking labels must be integers")
    if lv.max(initial=0) >= len(label_gain):
        raise ValueError(f"ranking label {int(lv.max())} exceeds the "
                         f"label_gain table (size {len(label_gain)})")


def max_dcg_at_k(labels, k, label_gain=DEFAULT_LABEL_GAIN):
    """Max possible DCG@k: labels sorted descending
    (dcg_calculator.cpp:54 CalMaxDCGAtK)."""
    ls = np.sort(np.asarray(labels))[::-1][:k]
    return float(np.sum(label_gain[ls.astype(int)]
                        * _discount(np.arange(len(ls)))))


def dcg_at_k(labels, scores, k, label_gain=DEFAULT_LABEL_GAIN):
    """DCG@k of the score-induced ordering (stable descending sort,
    dcg_calculator.cpp:110 CalDCGAtK)."""
    order = np.argsort(-np.asarray(scores), kind="stable")[:k]
    ls = np.asarray(labels)[order].astype(int)
    return float(np.sum(label_gain[ls] * _discount(np.arange(len(ls)))))


def ndcg_metric(labels, scores, boundaries, eval_at=DEFAULT_EVAL_AT,
                label_gain=DEFAULT_LABEL_GAIN):
    """Mean NDCG@k per k in eval_at (rank_metric.hpp NDCGMetric::Eval;
    queries with no relevant documents count as 1)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    out = {}
    for k in np.atleast_1d(np.asarray(eval_at, dtype=int)):
        vals = []
        for qi in range(len(boundaries) - 1):
            s, e = boundaries[qi], boundaries[qi + 1]
            mx = max_dcg_at_k(labels[s:e], k, label_gain)
            vals.append(1.0 if mx <= 0.0
                        else dcg_at_k(labels[s:e], scores[s:e], k,
                                      label_gain) / mx)
        out[int(k)] = float(np.mean(vals))
    return out


def map_metric(labels, scores, boundaries, eval_at=DEFAULT_EVAL_AT):
    """Mean average precision @k (map_metric.hpp MapMetric::Eval;
    labels > 0 are relevant)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    out = {}
    for k in np.atleast_1d(np.asarray(eval_at, dtype=int)):
        vals = []
        for qi in range(len(boundaries) - 1):
            s, e = boundaries[qi], boundaries[qi + 1]
            order = np.argsort(-scores[s:e], kind="stable")
            rel = (labels[s:e][order] > 0).astype(np.float64)[:k]
            if rel.sum() <= 0:
                vals.append(0.0)
                continue
            prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            vals.append(float(np.sum(prec * rel) / rel.sum()))
        out[int(k)] = float(np.mean(vals))
    return out


def lambdarank_gradients(labels, scores, boundaries, sigmoid=1.0, norm=True,
                         truncation_level=30,
                         label_gain=DEFAULT_LABEL_GAIN):
    """LambdaMART gradients/hessians (rank_objective.hpp:138-227
    LambdarankNDCG::GetGradientsForOneQuery), vectorized per query: the
    plain numpy form of `QueryLayout.lambdarank`."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n = len(scores)
    grad = np.zeros(n)
    hess = np.zeros(n)
    for qi in range(len(boundaries) - 1):
        s, e = int(boundaries[qi]), int(boundaries[qi + 1])
        c = e - s
        if c <= 1:
            continue
        sc = scores[s:e]
        lb = labels[s:e].astype(int)
        inv_max_dcg = max_dcg_at_k(lb, truncation_level, label_gain)
        if inv_max_dcg <= 0:
            continue
        inv_max_dcg = 1.0 / inv_max_dcg
        order = np.argsort(-sc, kind="stable")
        ssc = sc[order]
        slb = lb[order]
        best, worst = ssc[0], ssc[-1]
        ranks = np.arange(c)
        disc = _discount(ranks)
        gains = label_gain[slb]

        # pair matrices in sorted space: entry (a, b) = unordered pair {a, b}
        lab_ne = slb[:, None] != slb[None, :]
        in_trunc = np.minimum(ranks[:, None], ranks[None, :]) \
            < truncation_level
        valid = lab_ne & in_trunc & (ranks[:, None] != ranks[None, :])
        a_is_high = slb[:, None] > slb[None, :]
        # delta_score = s_high - s_low, from a's perspective:
        ds = np.where(a_is_high, ssc[:, None] - ssc[None, :],
                      ssc[None, :] - ssc[:, None])
        dcg_gap = np.abs(gains[:, None] - gains[None, :])
        paired_disc = np.abs(disc[:, None] - disc[None, :])
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg
        if norm and best != worst:
            delta_ndcg = delta_ndcg / (0.01 + np.abs(ds))
        with np.errstate(over="ignore"):
            p = 1.0 / (1.0 + np.exp(np.clip(sigmoid * ds, -500, 500)))
        lam = -sigmoid * delta_ndcg * p              # high's contribution
        hs = sigmoid * sigmoid * delta_ndcg * p * (1.0 - p)
        lam = np.where(valid, lam, 0.0)
        hs = np.where(valid, hs, 0.0)
        # grad[a] = sum_b (+lam if a is high else -lam); hess always adds
        ga = np.sum(np.where(a_is_high, lam, -lam), axis=1)
        ha = np.sum(hs, axis=1)
        # sum over unordered pairs of -2*lam == -sum over the full matrix
        sum_lambdas = -float(np.sum(lam))
        if norm and sum_lambdas > 0:
            f = np.log2(1.0 + sum_lambdas) / sum_lambdas
            ga, ha = ga * f, ha * f
        gq = np.zeros(c)
        hq = np.zeros(c)
        gq[order] = ga
        hq[order] = ha
        grad[s:e] = gq
        hess[s:e] = hq
    return grad, hess


def xendcg_gradients(labels, scores, boundaries, seed=0):
    """Rank-XENDCG gradients (rank_objective.hpp:289-361 RankXENDCG;
    arXiv:1911.09798): per-query softmax cross-entropy against a perturbed
    2^l - uniform target, with third-order corrections. The plain numpy
    form of `QueryLayout.xendcg`."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n = len(scores)
    grad = np.zeros(n)
    hess = np.zeros(n)
    for qi in range(len(boundaries) - 1):
        s, e = int(boundaries[qi]), int(boundaries[qi + 1])
        c = e - s
        if c <= 1:
            continue
        rng = np.random.RandomState(seed + qi)
        sc = scores[s:e]
        lb = labels[s:e]
        m = sc - sc.max()
        rho = np.exp(m) / np.sum(np.exp(m))
        phi = np.power(2.0, lb.astype(int)) - rng.uniform(size=c)
        inv_denom = 1.0 / max(1e-15, float(np.sum(phi)))
        # first-order terms
        l1 = -phi * inv_denom + rho
        params = l1 / (1.0 - rho)
        sum_l1 = float(np.sum(params))
        # second-order terms
        l2 = rho * (sum_l1 - params)
        g = l1 + l2
        params = l2 / (1.0 - rho)
        sum_l2 = float(np.sum(params))
        g = g + rho * (sum_l2 - params)
        grad[s:e] = g
        hess[s:e] = rho * (1.0 - rho)
    return grad, hess


# elements of one lambdarank band chunk, (queries, T, L_max), in float64
_BAND_ELEMS = 1 << 24


class QueryLayout:
    """The queries of a ranking Dataset on the device, and their
    lambdarank and rank_xendcg gradients there.

    boundaries: host query boundaries; labels: host integer labels. The
    layout is (Q, L) with L the longest query: `idx` gathers each query's
    rows (padding points at row 0), `valid` marks the real entries and
    `flat` lists the real entries' positions in the flattened layout in
    row order, so `G.reshape(-1)[flat]` is the per-row vector without a
    boolean mask (whose size would need a host read). The labels, their
    gains, each query's 1 / maxDCG@truncation_level (0 for a query whose
    maxDCG is 0) and, for rank_xendcg, 2^label minus the query's uniforms
    are built here once."""

    def __init__(self, boundaries, labels, device, label_gain=None,
                 truncation_level=30, xendcg_seed=None):
        qb = np.asarray(boundaries, dtype=np.int64)
        lens = np.diff(qb)
        labels = np.asarray(labels).astype(np.int64)
        gain = DEFAULT_LABEL_GAIN if label_gain is None \
            else np.asarray(label_gain, dtype=np.float64)
        Q, L = len(lens), max(int(lens.max(initial=1)), 1)
        pos = np.arange(L)
        valid = pos[None, :] < lens[:, None]
        idx = np.where(valid, qb[:-1, None] + pos[None, :], 0)
        lab = np.where(valid, labels[idx], -1)
        self.n = int(qb[-1])
        self.shape = (Q, L)
        self.truncation_level = int(truncation_level)
        inv_max = np.zeros(Q)
        for q in range(Q):
            mx = max_dcg_at_k(labels[qb[q]:qb[q + 1]],
                              self.truncation_level, gain) \
                if lens[q] > 1 else 0.0
            if mx > 0:
                inv_max[q] = 1.0 / mx
        dev = torch.device(device)

        def up(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self.idx = up(idx)
        self.valid = up(valid)
        self.flat = up(np.flatnonzero(valid.reshape(-1)))
        self.lens = up(lens)
        self.labels = up(lab)
        self.gains = up(np.where(valid, gain[np.maximum(lab, 0)], 0.0))
        self.inv_max_dcg = up(inv_max)
        # the queries with a pair (the numpy loops skip the others)
        self.multi = up(lens > 1)
        self.phi = self.inv_denom = None
        if xendcg_seed is not None:
            phi = np.zeros((Q, L))
            for q in range(Q):
                c = int(lens[q])
                if c > 1:
                    u = np.random.RandomState(xendcg_seed + q).uniform(size=c)
                    phi[q, :c] = np.power(2.0, labels[qb[q]:qb[q + 1]]) - u
            self.phi = up(phi)
            self.inv_denom = up(1.0 / np.maximum(1e-15, phi.sum(1)))

    def _rows(self, G):
        """(Q, L) -> (n,) in row order."""
        return G.reshape(-1)[self.flat]

    def lambdarank(self, F, sigmoid=1.0, norm=True):
        """(grad, hess) of LambdarankNDCG at the scores F (n,), on F's
        device, equal to `lambdarank_gradients` up to the order of the
        sums. Rank a < T pairs with every b (the rows of the band); a pair
        with b >= T reaches b through the band's column sums."""
        Q, L = self.shape
        T = min(self.truncation_level, L)
        S = F[self.idx]
        S = torch.where(self.valid, S, torch.full_like(S, float("inf")))
        # descending scores, ties in row order, padding last
        order = torch.sort(torch.where(self.valid, -S, S), dim=1,
                           stable=True).indices
        ssc = torch.where(self.valid, torch.gather(S, 1, order),
                          torch.zeros_like(S))
        slb = torch.gather(self.labels, 1, order)
        gain = torch.gather(self.gains, 1, order)
        ranks = torch.arange(L, device=F.device)
        disc = 1.0 / torch.log2(2.0 + ranks.to(F.dtype))
        best = ssc[:, 0]
        worst = torch.gather(ssc, 1,
                             (self.lens - 1).clamp_min(0)[:, None])[:, 0]
        Gs = torch.zeros((Q, L), dtype=F.dtype, device=F.device)
        Hs = torch.zeros_like(Gs)
        col = (ranks >= T)[None, None, :]
        step = max(1, _BAND_ELEMS // (T * L))
        for q0 in range(0, Q, step):
            q = slice(q0, min(Q, q0 + step))
            sa, sb = ssc[q, :T, None], ssc[q, None, :]
            la, lb = slb[q, :T, None], slb[q, None, :]
            valid = (la != lb) & (ranks[:T, None] != ranks[None, :]) \
                & self.valid[q, :T, None] & self.valid[q, None, :]
            a_high = la > lb
            ds = torch.where(a_high, sa - sb, sb - sa)
            delta = (gain[q, :T, None] - gain[q, None, :]).abs() \
                * (disc[:T, None] - disc[None, :]).abs() \
                * self.inv_max_dcg[q, None, None]
            if norm:
                delta = torch.where((best[q] != worst[q])[:, None, None],
                                    delta / (0.01 + ds.abs()), delta)
            p = 1.0 / (1.0 + torch.exp(torch.clamp(sigmoid * ds, -500, 500)))
            zero = torch.zeros_like(p)
            lam = torch.where(valid, -sigmoid * delta * p, zero)
            hs = torch.where(valid, sigmoid * sigmoid * delta * p * (1.0 - p),
                             zero)
            slam = torch.where(a_high, lam, -lam)
            g = torch.zeros_like(Gs[q])
            h = torch.zeros_like(Gs[q])
            g[:, :T] = slam.sum(2)
            h[:, :T] = hs.sum(2)
            g = g - torch.where(col, slam, zero).sum(1)
            h = h + torch.where(col, hs, zero).sum(1)
            if norm:
                # the full pair matrix's sum: the band once, and its
                # b >= T part once more for the transposed entries
                sl = -(lam.sum((1, 2))
                       + torch.where(col, lam, zero).sum((1, 2)))
                f = torch.where(sl > 0, torch.log2(1.0 + sl) / sl,
                                torch.ones_like(sl))
                g, h = g * f[:, None], h * f[:, None]
            Gs[q], Hs[q] = g, h
        # back from sorted positions to each query's row order
        G = torch.zeros_like(Gs).scatter_(1, order, Gs)
        H = torch.zeros_like(Hs).scatter_(1, order, Hs)
        return self._rows(G), self._rows(H)

    def xendcg(self, F):
        """(grad, hess) of RankXENDCG at the scores F (n,), on F's device,
        equal to `xendcg_gradients` with the layout's seed up to the order
        of the sums."""
        S = F[self.idx]
        S = torch.where(self.valid, S, torch.full_like(S, -float("inf")))
        m = S - S.max(1, keepdim=True).values
        e = torch.exp(m)
        rho = e / e.sum(1, keepdim=True)
        l1 = -self.phi * self.inv_denom[:, None] + rho
        params = l1 / (1.0 - rho)
        l2 = rho * (params.sum(1, keepdim=True) - params)
        g = l1 + l2
        params = l2 / (1.0 - rho)
        g = g + rho * (params.sum(1, keepdim=True) - params)
        keep = self.valid & self.multi[:, None]
        zero = torch.zeros_like(g)
        return (self._rows(torch.where(keep, g, zero)),
                self._rows(torch.where(keep, rho * (1.0 - rho), zero)))
