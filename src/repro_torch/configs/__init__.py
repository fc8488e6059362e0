"""Architecture configs (``--arch`` selectable), copied from ``repro.configs``,
and ``configs/shapes.py``: the dry run's shape cells and input specs.
"""

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config, registry

__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "registry"]
