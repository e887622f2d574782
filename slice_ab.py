#!/usr/bin/env python3
"""Time the GPBoost slices of one checkout on the GPU, for A/B runs.

    python3 slice_ab.py DIR      # DIR: a checkout (e.g. a `git archive`)

Runs, with the package and the chip_smoke.py of DIR, chip_smoke.py's
phase 10 (grouped GPBoost at n = 100,000, q = 1,000: seconds per round,
host syncs by Python line, device busy share) and phase 4
(w_gpboost1000). To compare two checkouts on one card, run them in turns
in one chip call, e.g. `for d in OLD . . OLD; do python3 slice_ab.py $d;
done`; each run is its own process.
"""

import os
import sys


def main():
    root = os.path.abspath(sys.argv[1])
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import histogram
    print(f"== checkout {sys.argv[1]}", flush=True)
    cs.phase_device(torch)
    cs.phase_build(histogram)
    cs.phase_grouped_slice(torch, gpt, histogram)
    cs.phase_slice(torch, gpt, histogram)


if __name__ == "__main__":
    main()
