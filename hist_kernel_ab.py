#!/usr/bin/env python3
"""Times this checkout's histogram kernels against another checkout's on
one NVIDIA GPU, in turns (other, this, this, other), at the shapes the
tree learners give them.

    python3 hist_kernel_ab.py --other DIR     # DIR: root of the other checkout

Each timing is the kernel's own device time per launch (torch.profiler
kernel durations, mean of 25 launches) beside the CUDA-event time around
the wrapper call (median of 25). Shapes: hist_masked at n = 200,000, p = 50
with about half the rows selected; hist_block over all those rows;
hist_segment at n = 200,000, p = 50 (whole and half segment) and at
n = 10,000, p = 5 (whole segment); uint8 bins, the datasets' real bin
counts (sim_boost and sim_gpboost of chip_smoke.py).

Then boosting_n200k_p50 (chip_smoke.py phase 7's configuration) with each
checkout's kernels swapped into this checkout's tree learners, one Booster
per checkout, their rounds interleaved in one process (the order flips
every round), so that both see the same host: the serial positional
learner (hist_segment) and the data learner on a one-rank NCCL group
(hist_masked), 12 rounds each; wall seconds per round, rounds 2-12.

Prints one line per timing and writes them all to
chiprun_out/hist_kernel_ab.json.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_histogram(root, name):
    """ops/histogram.py of the checkout at root, as module `name`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "gpboost_tpu_torch", "ops", "histogram.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROUNDS = 12


def _adapters(h):
    """Module h's wrappers with this checkout's learner-side signatures
    (a (2,) segment tensor with cnt None, an amax keyword)."""
    if hasattr(h, "stat_amax"):
        return h.hist_segment, h.hist_masked

    def segment(bins, stats, s0, cnt, num_bins, amax=None):
        if cnt is None:
            s0, cnt = s0[0], s0[1]
        return h.hist_segment(bins, stats, s0, cnt, num_bins)

    def masked(bins_T, node, stats_T, target, num_bins, amax=None):
        return h.hist_masked(bins_T, node, stats_T, target, num_bins)
    return segment, masked


def _rounds(torch, gpt, cs, mods, ds, mode):
    """{checkout: wall seconds of rounds 2..ROUNDS} of one Booster per
    checkout, rounds interleaved."""
    import torch.distributed as dist
    from gpboost_tpu_torch.boosting import tree_learner
    kernels = {k: _adapters(m) for k, m in mods.items()}
    with tempfile.TemporaryDirectory() as tmp:
        params = dict(cs.BOOST)
        if mode == "data":
            dist.init_process_group("nccl", store=dist.FileStore(
                os.path.join(tmp, "store"), 1), rank=0, world_size=1)
            params.update(num_parallel_devices=1, tree_learner="data")
        try:
            boosters = {k: gpt.Booster(params, ds, device="cuda")
                        for k in mods}
            secs = {k: [] for k in mods}
            order = list(mods)
            for r in range(ROUNDS):
                for k in (order if r % 2 else order[::-1]):
                    tree_learner.hist_segment, tree_learner.hist_masked = \
                        kernels[k]
                    t0 = time.perf_counter()
                    boosters[k].update()
                    torch.cuda.synchronize()
                    if r:
                        secs[k].append(time.perf_counter() - t0)
        finally:
            tree_learner.hist_segment, tree_learner.hist_masked = \
                kernels["this"]
            if mode == "data":
                dist.destroy_process_group()
    return secs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("hist_kernel_ab: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import gpboost_tpu_torch as gpt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    mods = {"other": _load_histogram(os.path.abspath(args.other),
                                     "other_histogram"),
            "this": _load_histogram(HERE, "this_histogram")}
    for m in mods.values():
        m.build()
    dev = torch.device("cuda")

    X, y = cs.sim_boost()
    ds = gpt.Dataset(X, label=y)
    ds.construct()
    nb = int(ds.num_bins)
    n, p = ds.bins.shape
    rng = np.random.RandomState(cs.SEED_BOOST)
    stats = np.ones((n, 3), dtype=np.float32)
    stats[:, 0] = rng.randn(n)
    stats[:, 1] = rng.rand(n) + 0.5
    node = torch.as_tensor(rng.randint(0, 2, size=n).astype(np.int32),
                           device=dev)
    bins_pos = torch.as_tensor(np.ascontiguousarray(ds.bins, dtype=np.uint8),
                               device=dev)
    bins_T = bins_pos.T.contiguous()
    stats_pos = torch.as_tensor(stats, device=dev)
    stats_T = stats_pos.T.contiguous()

    _, Xs, ys = cs.sim_gpboost(cs.N_FULL)
    dss = gpt.Dataset(Xs, label=ys)
    dss.construct()
    nbs = int(dss.num_bins)
    ns = cs.N_FULL
    small_bins = torch.as_tensor(dss.bins.astype(np.uint8), device=dev)
    small_stats = stats_pos[:ns].contiguous()

    def calls(h):
        """name -> a call of module h's wrapper at that shape; this
        checkout's wrappers get the per-tree amax, as the learners pass it."""
        kw = lambda s, d: ({"amax": h.stat_amax(s, d)}  # noqa: E731
                           if hasattr(h, "stat_amax") else {})
        kT, kp, ks = kw(stats_T, 1), kw(stats_pos, 0), kw(small_stats, 0)
        return {
            f"hist_masked n={n} p={p} half selected": lambda: h.hist_masked(
                bins_T, node, stats_T, 1, nb, **kT),
            f"hist_block n={n} p={p} all rows": lambda: h.hist_block(
                bins_T, stats_T, nb, **kT),
            f"hist_segment n={n} p={p} whole": lambda: h.hist_segment(
                bins_pos, stats_pos, 0, n, nb, **kp),
            f"hist_segment n={n} p={p} half": lambda: h.hist_segment(
                bins_pos, stats_pos, 777, n // 2, nb, **kp),
            f"hist_segment n={ns} p={small_bins.shape[1]} whole":
                lambda: h.hist_segment(small_bins, small_stats, 0, ns, nbs,
                                       **ks),
        }

    rows = []
    table = {k: calls(m) for k, m in mods.items()}
    for shape in table["this"]:
        for which in ("other", "this", "this", "other"):
            fn = table[which][shape]
            rows.append({"shape": shape, "checkout": which,
                         "device_ms": cs._device_ms(torch, fn),
                         "event_ms": cs._time_ms(torch, fn), "card": card})
            print(f"[ab] {shape} {which}: device "
                  f"{cs._fmt_ms(rows[-1]['device_ms'])}, events "
                  f"{rows[-1]['event_ms']:.4f} ms", flush=True)
    for mode in ("serial", "data"):
        for which, secs in _rounds(torch, gpt, cs, mods, ds, mode).items():
            rows.append({"shape": f"boosting_n200k_p50 {mode} learner round",
                         "checkout": which, "mean_s": float(np.mean(secs)),
                         "min_s": float(np.min(secs)),
                         "max_s": float(np.max(secs)), "card": card})
            print(f"[ab] boosting_n200k_p50 {mode} learner, {which} "
                  f"kernels: rounds 2-{ROUNDS} mean {np.mean(secs):.4f} s "
                  f"(min {np.min(secs):.4f}, max {np.max(secs):.4f})",
                  flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "hist_kernel_ab.json"),
              "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
