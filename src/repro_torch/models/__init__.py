"""repro_torch.models — the model stack (counterpart of ``repro.models``).

``LanguageModel`` runs every family of the ten configs on one device: the
attention mixers ``global`` / ``local``, ``rglru`` and ``ssm``, the MLPs
``dense`` / ``moe`` / ``none``, and the vision / audio frontend stubs; it
trains (``repro_torch.training``) and serves (``repro_torch.serving``).
``params_from_reference`` loads a ``repro`` parameter pytree,
``opt_state_from_reference`` its optimizer state, and
``read_reference_checkpoint`` a checkpoint directory ``repro`` wrote.
"""

from repro_torch.models.convert import (
    opt_state_from_reference,
    params_from_reference,
    read_reference_checkpoint,
)
from repro_torch.models.model import LanguageModel

__all__ = ["LanguageModel", "params_from_reference", "opt_state_from_reference",
           "read_reference_checkpoint"]
