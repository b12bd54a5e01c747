from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer
from repro_torch.utils.tree import (
    flatten_dict,
    tree_global_norm,
    tree_leaves,
    tree_map,
    unflatten_dict,
)

__all__ = ["Timer", "flatten_dict", "get_logger", "tree_global_norm", "tree_leaves",
           "tree_map", "unflatten_dict"]
