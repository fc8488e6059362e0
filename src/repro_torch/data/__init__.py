"""repro_torch.data — the kNN data of the launcher (``PointCloud``).

Counterpart of ``repro.data``; its ``TokenPipeline`` (the LM stack's) is
ROADMAP Queue 1 item 20.
"""

from repro_torch.data.pipeline import PointCloud

__all__ = ["PointCloud"]
