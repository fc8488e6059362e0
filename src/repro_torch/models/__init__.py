"""repro_torch.models — the model stack (counterpart of ``repro.models``).

``LanguageModel`` runs every family of the ten configs on one device: the
attention mixers ``global`` / ``local``, ``rglru`` and ``ssm``, the MLPs
``dense`` / ``moe`` / ``none``, and the vision / audio frontend stubs; it
trains (``repro_torch.training``) and serves (``repro_torch.serving``).
``params_from_reference`` loads a ``repro`` parameter pytree,
``opt_state_from_reference`` its optimizer state, and
``read_reference_checkpoint`` a checkpoint directory ``repro`` wrote.
``ShardedLM`` (``lm.shard(Dist(mesh, ...))``) runs it across the slots of
a mesh: tensor, sequence and expert parallelism.
"""

from repro_torch.models.convert import (
    opt_state_from_reference,
    params_from_reference,
    read_reference_checkpoint,
    reference_from_shards,
    shards_from_reference,
)
from repro_torch.models.model import LanguageModel
from repro_torch.models.sharded import ShardedLM
from repro_torch.models.transformer import Dist

__all__ = ["LanguageModel", "ShardedLM", "Dist", "params_from_reference",
           "opt_state_from_reference", "read_reference_checkpoint", "shards_from_reference",
           "reference_from_shards"]
