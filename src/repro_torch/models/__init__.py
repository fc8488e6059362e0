"""repro_torch.models — the dense decoder stack (counterpart of ``repro.models``).

``LanguageModel`` runs the mixers ``global`` / ``local`` and the MLPs
``dense`` / ``none`` for inference; the MoE, SSM and RG-LRU families and
the vision / audio frontends raise ``NotPorted`` (ROADMAP Queue 1 item 20's
remainder).  ``params_from_reference`` loads a ``repro`` parameter pytree.
"""

from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import NotPorted
from repro_torch.models.model import LanguageModel

__all__ = ["LanguageModel", "NotPorted", "params_from_reference"]
