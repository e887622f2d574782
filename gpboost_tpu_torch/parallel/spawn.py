"""One-process entry point of the parallel tree learners: `spawn_train`
starts `world_size` local ranks, trains in their process group and returns
rank 0's booster. It is what the JAX package's
`train(..., num_parallel_devices=k)` is on one host.

Inside a group that the caller set up, `train` itself is the entry point:
pass num_parallel_devices equal to the group's size.
"""

import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device


def _rank_device(device, rank):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _worker(rank, world_size, backend, store_path, device, jobs, out_dir):
    """One rank: join the group through the FileStore, train every job in
    turn, write the model dicts to out_dir/rank<r>.json."""
    from ..boosting import Dataset, train
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                          world_size),
                            rank=rank, world_size=world_size)
    try:
        dicts = []
        for params, X, y, rounds in jobs:
            bst = train({**params, "num_parallel_devices": world_size},
                        Dataset(X, label=y), num_boost_round=rounds,
                        device=dev)
            dicts.append(bst.model_to_dict())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dicts, f)


def spawn_train(params, X, y, num_boost_round=100, world_size=2,
                backend=None, device=None):
    """Train Gaussian regression boosting in `world_size` local ranks
    (torch.multiprocessing spawn over a FileStore) and return rank 0's
    Booster, rebuilt from its model dict on `device`.

    params holds tree_learner ("data", "feature" or "voting") and the other
    booster parameters; num_parallel_devices is set to world_size. Every
    rank gets all of X and y and bins them alike; its learner keeps its own
    block of rows (data, voting) or of features (feature). A list of params
    trains one model after another in the same group and returns a list of
    boosters; X and y are then one data set for all, or lists of the same
    length. backend defaults to "nccl" on CUDA and "gloo" on the CPU
    (gloo also carries CUDA tensors, for several ranks on one card);
    device defaults to CUDA, rank r on card r % device_count. Raises if the
    ranks grew different trees.
    """
    from ..boosting.gbdt import Booster
    single = isinstance(params, dict)
    plist = [params] if single else list(params)
    Xs = list(X) if isinstance(X, (list, tuple)) else [X] * len(plist)
    ys = list(y) if isinstance(y, (list, tuple)) else [y] * len(plist)
    if not len(Xs) == len(ys) == len(plist):
        raise ValueError("params, X and y must be lists of one length")
    jobs = [(dict(p), np.asarray(Xi), np.asarray(yi), int(num_boost_round))
            for p, Xi, yi in zip(plist, Xs, ys)]
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(world_size, backend,
                                os.path.join(tmp, "store"), str(device),
                                jobs, tmp),
                 nprocs=world_size, join=True)
        per_rank = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
    for r in range(1, world_size):
        if [d["trees"] for d in per_rank[r]] \
                != [d["trees"] for d in per_rank[0]]:
            raise RuntimeError(f"rank {r} grew other trees than rank 0")
    boosters = [Booster(model_dict=d, device=device) for d in per_rank[0]]
    return boosters[0] if single else boosters
