#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gpboost_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases; any failure exits non-zero and prints no result line:
  1. device: needs CUDA (no CPU fallback); prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles the histogram kernel (csrc/histogram.cu) from the
     checkout's sources and prints the build seconds;
  3. kernel vs plain: the kernel against its plain PyTorch version on the
     card at the slice's shapes (n = 10,000 rows, p = 5, the dataset's real
     bin count; uint8 and int32 bins; root, unaligned, empty and one-row
     segments, host-int and device-tensor segments), bitwise repeatability,
     and both versions' times (CUDA events, median of 25);
  4. the slice at full size: the bench configuration w_gpboost1000
     (n = 10,000, p = 5, 2-D coordinates, exponential kernel, Vecchia with
     20 neighbours, 31-leaf trees, learning rate 0.1, float32 engine,
     sim_gpboost data with seed 1) for 10 rounds, then predict on 1,000 new
     points; the kernel's launch count over that run must be positive;
  5. card vs CPU: the same slice at n = 2,000 in float64 on the card (with
     the kernel) and on the CPU (plain version): first tree, covariance
     parameters and predictions.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 1
N_FULL, N_CPU, P, ROUNDS, N_PRED = 10_000, 2_000, 5, 10, 1_000
PARAMS = {"objective": "regression", "learning_rate": 0.1, "num_leaves": 31,
          "verbose": 0}


def sim_gpboost(n, p=P, seed=SEED):
    """bench.py sim_gpboost: spatial GP-like effect + nonlinear trees part."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2)
    X = rng.rand(n, p)
    f = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    b = np.sin(6 * coords[:, 0]) * np.cos(4 * coords[:, 1])
    return coords, X, f + b + 0.3 * rng.randn(n)


def new_points(n, p=P, seed=SEED + 1):
    rng = np.random.RandomState(seed)
    return rng.rand(n, p), rng.rand(n, 2)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the GPU "
                           "only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build(histogram):
    path, secs, log = histogram.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {os.path.relpath(path)} in {secs:.2f} s; "
          + " | ".join(ptxas), flush=True)
    return secs


def _time_ms(torch, fn, reps=25):
    """Median device time of fn() in ms over reps launches (CUDA events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel(torch, gpt, histogram):
    """Kernel vs its plain version on the card at the slice's shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False   # plain einsum in full f32
    _, X, y = sim_gpboost(N_FULL)
    ds = gpt.Dataset(X, label=y)
    ds.construct()
    num_bins = int(ds.num_bins)
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    stats = np.ones((N_FULL, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(N_FULL)
    stats[:, 1] = rng.rand(N_FULL) + 0.5
    stats_d = torch.as_tensor(stats, device=dev)
    bins_u8 = torch.as_tensor(ds.bins.astype(np.uint8), device=dev)
    bins_i32 = bins_u8.to(torch.int32)
    cases = [("uint8", bins_u8, 0, N_FULL), ("uint8", bins_u8, 1237, 4321),
             ("uint8", bins_u8, 500, 0), ("uint8", bins_u8, N_FULL - 1, 1),
             ("int32", bins_i32, 0, N_FULL), ("int32", bins_i32, 3, 7777)]
    max_err = 0.0
    for name, bins, s0, cnt in cases:
        for seg in ((s0, cnt), (torch.tensor(s0, device=dev),
                                torch.tensor(cnt, device=dev))):
            k1 = histogram.hist_segment(bins, stats_d, *seg, num_bins)
            k2 = histogram.hist_segment(bins, stats_d, *seg, num_bins)
            ref = histogram.hist_segment_plain(bins, stats_d, s0, cnt,
                                               num_bins)
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                raise AssertionError(f"{name} [{s0},+{cnt}): two launches "
                                     "differ")
            if not torch.equal(k1[:, 2], ref[:, 2]):
                raise AssertionError(f"{name} [{s0},+{cnt}): counts differ")
            err = float((k1[:, :2] - ref[:, :2]).abs().max())
            # f32 sums of order-one values over <= 10k rows, in another order
            if not err <= 1e-4:
                raise AssertionError(f"{name} [{s0},+{cnt}): grad/hess error "
                                     f"{err:.3g} > 1e-4")
            max_err = max(max_err, err)
        print(f"[kernel] {name} bins, segment [{s0}, {s0 + cnt}): ok", flush=True)
    ms = _time_ms(torch, lambda: histogram.hist_segment(
        bins_u8, stats_d, 0, N_FULL, num_bins))
    plain_ms = _time_ms(torch, lambda: histogram.hist_segment_plain(
        bins_u8, stats_d, 0, N_FULL, num_bins))
    print(f"[kernel] hist_segment n={N_FULL} p={P} B={num_bins} uint8: "
          f"kernel {ms:.4f} ms, plain einsum {plain_ms:.4f} ms, "
          f"max |err| {max_err:.3g}", flush=True)
    return {"name": "hist_segment", "route": "cuda",
            "source": "gpboost_tpu_torch/csrc/histogram.cu",
            "replaces": "gpboost_tpu/ops/histogram.py:85",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _train(torch, gpt, n, dtype, device):
    """The slice: returns (booster, gp, initial-fit seconds, train seconds)."""
    coords, X, y = sim_gpboost(n)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=20, dtype=dtype,
                     device=device)
    fit_secs = []
    fit = gp.fit

    def timed_fit(*args, **kwargs):
        t = time.perf_counter()
        out = fit(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        fit_secs.append(time.perf_counter() - t)
        return out

    gp.fit = timed_fit
    t0 = time.perf_counter()
    bst = gpt.train(PARAMS, gpt.Dataset(X, label=y), num_boost_round=ROUNDS,
                    gp_model=gp, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return bst, gp, fit_secs[0], time.perf_counter() - t0


def phase_slice(torch, gpt, histogram):
    """w_gpboost1000 at full width for 10 rounds on the card, then predict."""
    histogram.hist_segment.launches = 0
    bst, gp, fit_s, train_s = _train(torch, gpt, N_FULL, "float32", "cuda")
    Xn, cn = new_points(N_PRED)
    t0 = time.perf_counter()
    pred = bst.predict(Xn, gp_coords_pred=cn, predict_var=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    launches = histogram.hist_segment.launches
    cov = gp.get_cov_pars()
    if not (np.all(np.isfinite(cov)) and np.all(cov > 0)):
        raise AssertionError(f"covariance parameters {cov}")
    for k in ("response_mean", "response_var"):
        if pred[k].shape != (N_PRED,) or not np.all(np.isfinite(pred[k])):
            raise AssertionError(f"prediction {k} not finite / wrong shape")
    if len(bst.trees) != ROUNDS or launches <= 0:
        raise AssertionError(f"{len(bst.trees)} trees, {launches} kernel "
                             "launches")
    print(f"[slice] n={N_FULL} m=20 float32, {ROUNDS} rounds: initial GP fit "
          f"{fit_s:.3f} s, mean per round {(train_s - fit_s) / ROUNDS:.4f} s "
          f"(train {train_s:.3f} s incl. the fit), predict {N_PRED} points "
          f"{pred_s:.3f} s; cov pars {cov.tolist()}; hist_segment launches "
          f"{launches}", flush=True)
    return launches


def _split_records(tree):
    internal = np.flatnonzero(~tree.is_leaf[:tree.num_nodes])
    return [(int(i), int(tree.split_feature[i]), int(tree.threshold_bin[i]),
             float(tree.split_gain[i])) for i in internal]


def phase_card_vs_cpu(torch, gpt):
    """The slice at n = 2,000 in float64: card (kernel) against CPU (plain)."""
    runs = {dev: _train(torch, gpt, N_CPU, "float64", dev)
            for dev in ("cuda", "cpu")}
    (bg, gg, _, tg), (bc, gc, _, tc) = runs["cuda"], runs["cpu"]
    rg, rc = _split_records(bg.trees[0]), _split_records(bc.trees[0])
    if [r[:3] for r in rg] != [r[:3] for r in rc]:
        i = next(k for k, (a, b) in enumerate(zip(rg, rc)) if a[:3] != b[:3])
        gap = abs(rg[i][3] - rc[i][3]) / max(abs(rc[i][3]), 1e-30)
        print(f"[card-vs-cpu] first tree: split {i} differs: card {rg[i]} "
              f"cpu {rc[i]}, relative gain gap {gap:.3g}", flush=True)
        if not gap < 1e-5:
            raise AssertionError("first-tree splits differ beyond an f32 "
                                 "near-tie")
    else:
        print(f"[card-vs-cpu] first tree: all {len(rg)} split records equal",
              flush=True)
    cg, cc = gg.get_cov_pars(), gc.get_cov_pars()
    # f32 histogram sums in another order move leaf values by ~1e-7 and the
    # refitted float64 covariance parameters by far less than 1e-4
    cov_rel = float(np.max(np.abs(cg / cc - 1.0)))
    if not cov_rel < 1e-4:
        raise AssertionError(f"cov pars card {cg} cpu {cc}")
    Xn, cn = new_points(200)
    pg = bg.predict(Xn, gp_coords_pred=cn)["response_mean"]
    pc = bc.predict(Xn, gp_coords_pred=cn)["response_mean"]
    # trees agree to f32 rounding of their leaf values (~1e-7 x 10 rounds)
    pred_err = float(np.max(np.abs(pg - pc)))
    if not pred_err < 1e-4:
        raise AssertionError(f"predictions differ by {pred_err}")
    print(f"[card-vs-cpu] n={N_CPU} float64 {ROUNDS} rounds: cov pars "
          f"max rel diff {cov_rel:.3g} (card {cg.tolist()}), predictions max "
          f"|diff| {pred_err:.3g}; train card {tg:.3f} s, cpu {tc:.3f} s",
          flush=True)


def main():
    import torch
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import histogram

    phase_device(torch)
    phase_build(histogram)
    kernel = phase_kernel(torch, gpt, histogram)
    kernel["launches"] = phase_slice(torch, gpt, histogram)
    phase_card_vs_cpu(torch, gpt)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase: report and exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
