from .dataset import Dataset
from .gbdt import Booster, train

__all__ = ["Dataset", "Booster", "train"]
