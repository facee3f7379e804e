"""Training utilities: losses, data pipeline, guards, epoch drivers.

JAX re-design of `QViT_with_GETA/utils.py` and `my_dataset.py`: the
loss math is identical, but the step is a single jitted pure function over
(params, batch) and the data pipeline feeds statically-shaped numpy batches
(XLA recompiles on shape change, so the loader pads the trailing batch).
"""

from .losses import (
    one_hot,
    cross_entropy_onehot_target,
    softmax_cross_entropy,
    mixup,
    kd_loss,
    group_lasso_loss,
)
from .native_prep import (
    PrefetchLoader,
    gather_rows,
    native_prep_available,
    normalize_u8_batch,
)
from .data import (
    ArrayDataset,
    ImageFolderDataset,
    DataLoader,
    read_split_data,
    normalize_image,
)
from .guards import NonFiniteLossError, all_finite, assert_tree_finite
from .training import TrainLoop, evaluate, topk_accuracy

__all__ = [
    "one_hot",
    "cross_entropy_onehot_target",
    "softmax_cross_entropy",
    "mixup",
    "kd_loss",
    "group_lasso_loss",
    "ArrayDataset",
    "ImageFolderDataset",
    "DataLoader",
    "read_split_data",
    "normalize_image",
    "PrefetchLoader",
    "gather_rows",
    "native_prep_available",
    "normalize_u8_batch",
    "NonFiniteLossError",
    "all_finite",
    "assert_tree_finite",
    "TrainLoop",
    "evaluate",
    "topk_accuracy",
]
