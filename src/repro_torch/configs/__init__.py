"""Architecture configs (``--arch`` selectable), copied from ``repro.configs``.

``configs/shapes.py`` (the dry run's input specs) is not ported: it waits for
the dry-run launcher (ROADMAP Queue 1 item 19).
"""

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config, registry

__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "registry"]
