"""Star-tree segments: the pre-aggregated cube, its builder and its
query operator (port of ``pinot_tpu.startree``; host numpy)."""
from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig, build_star_tree
from pinot_tpu_torch.startree.index import StarTreeIndex, STAR
from pinot_tpu_torch.startree.operator import is_fit_for_star_tree, execute_star_tree

__all__ = [
    "StarTreeBuilderConfig",
    "build_star_tree",
    "StarTreeIndex",
    "STAR",
    "is_fit_for_star_tree",
    "execute_star_tree",
]
