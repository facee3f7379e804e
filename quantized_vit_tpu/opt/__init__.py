"""Optimizer layer: GETA / HESSO hybrid sparse+quant training.

JAX re-design of only_train_once/optimizer/ (SURVEY.md §2.3): node
groups are declarative metadata, all tensor math is jitted, redundant-group
membership is mask vectors.
"""

from .checkpoint import load_checkpoint, save_checkpoint, scan_checkpoint
from .geta import GETA, GETAConfig
from .groups import (
    NodeGroup,
    ParamEntry,
    Transform,
    get_path,
    group_matrix,
    group_sq_norms,
    kept_indices_for_axis,
    set_path,
)
from .hesso import HESSO, HESSOConfig
from .hesso_cric import HESSOCRIC, HESSOCRICConfig
from .importance import DEFAULT_CRITERIA, combine_importance_scores

__all__ = [
    "GETA",
    "GETAConfig",
    "HESSO",
    "HESSOConfig",
    "HESSOCRIC",
    "HESSOCRICConfig",
    "NodeGroup",
    "ParamEntry",
    "Transform",
    "DEFAULT_CRITERIA",
    "combine_importance_scores",
    "group_matrix",
    "group_sq_norms",
    "kept_indices_for_axis",
    "get_path",
    "set_path",
    "save_checkpoint",
    "load_checkpoint",
    "scan_checkpoint",
]
