"""repro_torch.data — seeded data (counterpart of ``repro.data``): the LM
stack's ``TokenPipeline`` and the kNN launcher's ``PointCloud``."""

from repro_torch.data.pipeline import PointCloud, TokenPipeline

__all__ = ["TokenPipeline", "PointCloud"]
