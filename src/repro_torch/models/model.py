"""LanguageModel: embed -> block stack -> norm -> unembed (+ loss, + decode).

Counterpart of ``repro.models.model.LanguageModel`` as an ``nn.Module``
that owns its parameters (fp32, on ``device``: cuda:0 unless given).  The
reference's stateless ``lm.forward(params, batch)`` is ``lm.forward(batch)``
here; ``models/convert.py::params_from_reference`` turns a reference
parameter pytree into a state dict for ``load_state_dict``.

``LanguageModel(cfg, tp=T)`` has the reference's ``tp``-padded shapes
(query heads padded to a multiple of T, the padding zeroed); its
``param_specs()`` are the reference's PartitionSpecs by state-dict name.
The reference's ``lm.forward(params, batch, dist)`` is
``lm.shard(dist).forward(batch)``: a ``models/sharded.py::ShardedLM``
holding each slot's shards (``device="meta"`` builds the shapes alone).

Batch contract (the reference's):
  train/prefill: {"tokens": int[B, S]} (+ "frontend_feats": float[B, T_f,
                  frontend_dim] for the vision prefix, or in place of the
                  tokens for audio; + "labels": int[B, S] for the loss,
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
from repro_torch.models.frontends import apply_frontend, frontend_specs, init_frontend
from repro_torch.models.layers import (
    apply_embed,
    apply_norm,
    apply_unembed,
    embed_specs,
    init_embed,
    init_norm,
    norm_specs,
    resolve_specs,
    softmax_xent,
)

__all__ = ["LanguageModel", "default_device", "param_specs"]


def default_device() -> torch.device:
    """cuda:0; raises where no card is visible (pass a CPU device instead)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device=torch.device('cpu') "
                           "to run on the CPU")
    return torch.device("cuda", 0)


def param_specs(cfg, tp: int = 1) -> Dict[str, tuple]:
    """{state-dict name: the reference's spec} of ``LanguageModel(cfg, tp)``
    (``repro/models/model.py:47``, the stacked group axis dropped)."""
    parts = {"embed": embed_specs(cfg), "frontend": frontend_specs(cfg)}
    for i, kind in enumerate(cfg.layer_kinds()):
        parts[f"blocks.{i}"] = transformer.layer_specs(cfg, kind, tp)
    parts["final_norm"] = norm_specs(cfg)
    return {f"{m}.{k}": v for m, d in parts.items() for k, v in d.items()}


class LanguageModel(nn.Module):
    """A model of any of the ten configs, its weights drawn from
    ``generator`` (normal / sqrt(fan_in), as the reference draws them;
    default seed 0), with ``heads_padded(cfg, tp)`` query heads."""

    def __init__(self, cfg, *, tp: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        device = torch.device(device) if device is not None else default_device()
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.embed = init_embed(cfg, generator, device)
        self.frontend = init_frontend(cfg, generator, device)
        self.blocks = transformer.init_stack(cfg, generator, device, tp)
        self.final_norm = init_norm(cfg, cfg.d_model, device)

    def param_specs(self) -> Dict[str, tuple]:
        """{state-dict name: spec}, in ``named_parameters`` order."""
        specs = param_specs(self.cfg, self.tp)
        return {k: specs[k] for k, _ in self.named_parameters()}

    def sharded_specs(self, specs, data_axes) -> Dict[str, tuple]:
        return resolve_specs(specs, data_axes)

    def shard(self, dist, specs: Optional[Dict[str, tuple]] = None):
        """This model's weights placed on ``dist``'s mesh by ``specs``
        (default: ``param_specs()``): a ``ShardedLM``."""
        from repro_torch.models.sharded import ShardedLM

        if dist.tp != self.tp:
            raise ValueError(f"the model was built for tp={self.tp}, the mesh has {dist.tp}")
        return ShardedLM.place(self.cfg, dist, self.state_dict(),
                               specs if specs is not None else self.param_specs())

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
        cfg = self.cfg
        if cfg.frontend == "audio":
            # the encoder's input is the (stub) frame-embedding stream itself
            return apply_frontend(self.frontend,
                                  self._tensor(batch["frontend_feats"], torch.float32), cfg)
        x = apply_embed(self.embed, self._tensor(batch["tokens"]), cfg)
        if cfg.frontend == "vision":
            # anyres image tiles form a prefix before the text tokens
            feats = apply_frontend(self.frontend,
                                   self._tensor(batch["frontend_feats"], torch.float32), cfg)
            x = torch.cat([feats, x], dim=1)
        return x

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
        """(mean CE + the MoE terms, metrics: ce, loss and the moe_* terms)."""
        cfg = self.cfg
        logits, aux = self.forward(batch)
        labels = self._tensor(batch["labels"])
        if cfg.frontend == "vision":
            # the image-prefix positions carry no LM loss
            labels = torch.cat([labels.new_full((labels.shape[0], cfg.frontend_tokens), -1),
                                labels], dim=1)
        ce = softmax_xent(logits, labels, cfg.vocab_size)
        total, metrics = ce, {"ce": ce}
        if cfg.n_experts:
            total = total + cfg.moe_aux_coef * aux[0] + cfg.moe_z_coef * aux[1]
            metrics.update(moe_load_balance=aux[0], moe_z=aux[1], moe_drop=aux[2])
        metrics["loss"] = total
        return total, metrics

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
            self.blocks, apply_embed(self.embed, self._tensor(batch["tokens"]), cfg), caches,
            self._tensor(batch["pos"]), cfg,
            active=None if active is None else self._tensor(active, torch.bool))
        return self.unembed(apply_norm(self.final_norm, x, cfg)), caches
