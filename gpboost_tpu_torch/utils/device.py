"""Device and dtype resolution shared by the port's entry points."""

import torch


def resolve_device(device=None):
    """The torch.device a model runs on: the given one, else the first CUDA
    card. Without a card and without an explicit device it raises: the CPU
    runs the port only when the caller passes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


def resolve_dtype(dtype):
    """'float32'/'f32'/torch.float32 -> torch.float32, anything else float64
    (the GP side's default, as in the reference)."""
    if dtype in (torch.float32, "float32", "f32"):
        return torch.float32
    return torch.float64
