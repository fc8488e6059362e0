"""The local train step: autograd on ``LanguageModel.loss``, then AdamW.

Counterpart of ``repro.training.step.build_train_step`` on one device.
``make_sharded_train_step``, ``apply_fsdp``, ``opt_state_specs`` and
``compression.py`` need a device axis and wait for ROADMAP Queue 1 item 21.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.training.optimizer import Hyper, adamw_update

__all__ = ["build_train_step"]


def _rows(x, j: int, ga: int):
    """Microbatch j of ``ga``: rows j::ga (the reference's strided split)."""
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1 and x.shape[0]:
        return x[j::ga]
    return x


def build_train_step(lm, h: Hyper) -> Callable:
    """``step_fn(opt_state, batch, step) -> metrics`` updating ``lm``'s
    parameters and ``opt_state`` (``adamw_init``'s) in place.  Metrics:
    ``loss``, ``ce`` (+ ``moe_load_balance``, ``moe_z``, ``moe_drop`` for
    MoE configs) as 0-d tensors, ``grad_norm`` (before clipping) and
    ``lr``.

    With ``h.grad_accum = ga > 1`` the batch's leading dim is split strided
    (microbatch j = rows j::ga, ``repro/training/step.py:91-97``); the
    microbatches' gradients are summed in fp32 in order, then divided by ga,
    and their metrics averaged.  ``h.unroll_accum`` keeps the reference's
    field: there it chooses a Python-unrolled loop over a ``lax.scan``; in
    eager PyTorch both are this same loop."""
    ga = h.grad_accum
    names = [k for k, _ in lm.named_parameters()]

    def grads_and_metrics(batch):
        params = [p for _, p in lm.named_parameters()]
        loss, metrics = lm.loss(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step_fn(opt_state: dict, batch: Dict[str, object], step: int) -> Dict[str, object]:
        if ga > 1:
            acc: List[torch.Tensor] = []
            ms = []
            for j in range(ga):
                g, m = grads_and_metrics({k: _rows(v, j, ga) for k, v in batch.items()})
                if acc:
                    torch._foreach_add_(acc, [x.float() for x in g])
                else:
                    acc = [x.float().clone() for x in g]
                ms.append(m)
                del g
            grads = dict(zip(names, torch._foreach_div(acc, float(ga))))
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            g, metrics = grads_and_metrics(batch)
            grads = dict(zip(names, g))
        params = dict(lm.named_parameters())
        _, _, om = adamw_update(grads, opt_state, params, step, h)
        metrics.update(om)
        return metrics

    return step_fn
