"""Buffer k-d tree core in torch (counterpart of ``repro.core``).

Applications use the ``repro_torch.api`` front door; this package is the
implementation layer:

  BufferKDTree      build + LazySearch kNN on the chunked or host tier
  build_top_tree    pointerless top tree construction (numpy)
  knn_brute         exact tiled brute-force ground truth
  knn_host_kdtree   the paper's classic k-d tree baseline (host numpy)
"""

from repro_torch.core.brute import knn_brute
from repro_torch.core.hostkdtree import knn_host_kdtree
from repro_torch.core.lazysearch import BufferKDTree, SearchStats
from repro_torch.core.toptree import TopTree, build_top_tree, suggest_height

__all__ = [
    "BufferKDTree",
    "SearchStats",
    "TopTree",
    "build_top_tree",
    "suggest_height",
    "knn_brute",
    "knn_host_kdtree",
]
