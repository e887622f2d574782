"""The process group of the parallel tree learners (counterpart of the JAX
package's device mesh, gpboost_tpu/parallel/data_parallel.py make_mesh).

The learners communicate with `all_reduce` only, so NCCL and gloo (also on
CUDA tensors) both carry them. Without a group every collective here is the
identity: one process is one rank.
"""

import torch.distributed as dist


def default_group(num_parallel_devices):
    """The group `train` runs on for the `num_parallel_devices` parameter:
    the initialised default group, whose size must equal it; None (serial
    growth) when the parameter is not set. More than one device without an
    initialised group raises: the port never trains serially in its place.
    """
    if num_parallel_devices is None:
        return None
    k = int(num_parallel_devices)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if k != world:
            raise ValueError(f"num_parallel_devices={k} but the process "
                             f"group has {world} ranks")
        return dist.group.WORLD
    if k > 1:
        raise ValueError(f"num_parallel_devices={k} needs an initialised "
                         "torch.distributed process group (spawn_train "
                         "starts one)")
    return None


def block(total, rank, world_size):
    """[lo, hi) of rank's even contiguous share of `total` rows or features
    (the first total % world_size ranks hold one more)."""
    q, r = divmod(int(total), int(world_size))
    lo = rank * q + min(rank, r)
    return lo, lo + q + (1 if rank < r else 0)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """In-place all_reduce of t over group; the identity without one."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t

