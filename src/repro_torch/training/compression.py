"""Error-feedback int8 gradient compression over the data slots.

Counterpart of ``repro.training.compression``: on the data-parallel
all-reduce each slot quantizes (grad + error) to int8 with one scale per
tensor shared by every slot (the max of the slots' max |x| / 127, + 1e-12),
the int8 payload is summed in int32, the mean is ``summed * scale / n``,
and each slot keeps its quantization residual as the error fed into its
next step (the 1-bit SGD / EF-SGD lineage).  The reference runs inside a
``shard_map`` with ``pmax`` / ``psum`` over an axis; here the slots' tensors
come as one list per slot, in slot order, and the collectives are
``distributed/mesh.py``'s.  The order of the operations is the reference's
``_compress_one`` (``repro/training/compression.py:28-40``), with two
roundings as XLA makes them: the division by the slot count is a product
with its float32 reciprocal, and the residual is rounded once (a fused
multiply-subtract); so the means and the errors are the reference's bit
for bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.distributed.mesh import all_max

__all__ = ["ef_int8_allreduce", "init_error_state"]

Tensors = Dict[str, torch.Tensor]


def init_error_state(grads_like: Tensors) -> Tensors:
    """fp32 zeros like each gradient (one slot's)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


@torch.no_grad()
def _compress_one(gs: Sequence[torch.Tensor], es: Sequence[torch.Tensor]):
    n = len(gs)
    devs = [g.device for g in gs]
    xs = [g.float() + e for g, e in zip(gs, es)]
    # one scale for every slot, so that sum_i q_i * scale == (sum_i q_i) * scale
    shared = all_max([x.abs().amax() / 127.0 + 1e-12 for x in xs], devs)
    qs = [torch.clamp(torch.round(x / s), -127, 127) for x, s in zip(xs, shared)]
    # the payload is int8; the sum accumulates in int32 (exact for n <= 2**24 / 127)
    summed = qs[0].to(torch.int8).to(torch.int32)
    for q in qs[1:]:
        summed = summed + q.to(torch.int8).to(torch.int32).to(summed.device)
    summed = summed.float()
    # ``summed * scale / n`` as XLA computes it: the division by the
    # constant n a multiplication by its float32 reciprocal
    inv_n = torch.tensor(1.0, dtype=torch.float32) / n
    means = [summed.to(d) * s * inv_n.to(d) for d, s in zip(devs, shared)]
    # the residual rounded once, as XLA's fused multiply-subtract rounds it
    # (q * s is exact in float64, and so is x - q * s, which lies within
    # half a quantization step of x)
    errs = [(x.double() - q.double() * s.double()).float() for x, q, s in zip(xs, qs, shared)]
    return means, errs


def ef_int8_allreduce(grads: Sequence[Tensors], errors: Sequence[Tensors]
                      ) -> Tuple[List[Tensors], List[Tensors]]:
    """The mean of the data slots' ``grads`` (one dict per slot, in slot
    order) with int8 error-feedback compression.  Returns (the mean on
    every slot, in each gradient's dtype; each slot's new error state)."""
    means = [dict() for _ in grads]
    errs = [dict() for _ in grads]
    for k in grads[0]:
        m, e = _compress_one([g[k] for g in grads], [e[k] for e in errors])
        for i in range(len(grads)):
            means[i][k] = m[i].to(grads[i][k].dtype)
            errs[i][k] = e[i]
    return means, errs
