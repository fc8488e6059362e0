"""LanguageModel: embed -> block stack -> norm -> unembed (+ loss, + decode).

Counterpart of ``repro.models.model.LanguageModel`` as an ``nn.Module``
that owns its parameters (fp32, on ``device``: cuda:0 unless given).  The
reference's stateless ``lm.forward(params, batch)`` is ``lm.forward(batch)``
here; ``models/convert.py::params_from_reference`` turns a reference
parameter pytree into a state dict for ``load_state_dict``.

Batch contract (the reference's):
  train/prefill: {"tokens": int[B, S]} (+ "labels": int[B, S] for the loss;
                  -1 = masked)
  decode:        {"tokens": int[B, 1], "pos": int scalar or int[B],
                  "active": bool[B] (optional)} + the caches
Arrays may be numpy or tensors; they are moved to the model's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import transformer
from repro_torch.models.layers import (
    apply_embed,
    apply_norm,
    apply_unembed,
    init_embed,
    init_norm,
    softmax_xent,
)

__all__ = ["LanguageModel", "default_device"]


def default_device() -> torch.device:
    """cuda:0; raises where no card is visible (pass a CPU device instead)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device=torch.device('cpu') "
                           "to run on the CPU")
    return torch.device("cuda", 0)


class LanguageModel(nn.Module):
    """A dense decoder bound to a config, its weights drawn from ``generator``
    (normal / sqrt(fan_in), as the reference draws them; default seed 0)."""

    def __init__(self, cfg, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device) if device is not None else default_device()
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.embed = init_embed(cfg, generator, device)
        self.blocks = transformer.init_stack(cfg, generator, device)
        self.final_norm = init_norm(cfg, cfg.d_model, device)

    def bind(self, params) -> "LanguageModel":
        """Load ``params`` (a state dict, e.g. ``params_from_reference``'s)
        unless it is None; the reference's serving classes take the weights
        beside the model, the port's take them through this."""
        if params is not None:
            self.load_state_dict(params)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _embed(self, batch) -> torch.Tensor:
        return apply_embed(self.embed, self._tensor(batch["tokens"]), self.cfg)

    # -- forward ------------------------------------------------------------
    def hidden_states(self, tokens) -> torch.Tensor:
        """Final-norm hidden states [B, S, D] in the compute dtype."""
        x, _ = transformer.stack_forward(self.blocks, self._embed({"tokens": tokens}),
                                         self.cfg)
        return apply_norm(self.final_norm, x, self.cfg)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the padded vocabulary for hidden states ``h``."""
        return apply_unembed(self.embed, h, self.cfg)

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits f32[B, S, V_pad], aux f32[3])."""
        x, aux = transformer.stack_forward(self.blocks, self._embed(batch), self.cfg)
        return self.unembed(apply_norm(self.final_norm, x, self.cfg)), aux

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _ = self.forward(batch)
        ce = softmax_xent(logits, self._tensor(batch["labels"]), self.cfg.vocab_size)
        return ce, {"ce": ce, "loss": ce}

    @torch.no_grad()
    def prefill(self, batch) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """Serving prefill: (last-position logits f32[B, 1, V_pad], decode-layout
        caches).  Only the last position is unembedded."""
        x, caches = transformer.stack_prefill(self.blocks, self._embed(batch), self.cfg)
        return self.unembed(apply_norm(self.final_norm, x[:, -1:], self.cfg)), caches

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> List[Dict[str, torch.Tensor]]:
        return transformer.init_stack_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def decode_step(self, batch, caches):
        """One token per row: (logits f32[B, 1, V_pad], caches), the caches
        written in place at the active rows' slots."""
        cfg = self.cfg
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only; no decode step")
        active = batch.get("active")
        x, caches = transformer.stack_decode(
            self.blocks, self._embed(batch), caches, self._tensor(batch["pos"]), cfg,
            active=None if active is None else self._tensor(active, torch.bool))
        return self.unembed(apply_norm(self.final_norm, x, cfg)), caches
