"""Input-shape registry: the four assigned shape cells + input_specs().

Counterpart of ``repro.configs.shapes``.  Shapes are GLOBAL (whole-mesh)
sizes; ``input_specs`` returns ``meta`` tensors (shapes and dtypes, no
allocation) plus the matching specs, tuples with one entry per dimension
(the reference's ``PartitionSpec``; the form ``models/model.py::
param_specs`` and ``distributed/mesh.py::SlotMesh`` use):

  train_4k     train_step   seq 4096,   global batch 256
  prefill_32k  serve prefill seq 32768, global batch 32
  decode_32k   serve_step   1 new token, KV cache 32768, global batch 128
  long_500k    serve_step   1 new token, cache 524288,  global batch 1

``cell_supported`` encodes the skip rules (sub-quadratic for long_500k; no
decode for encoder-only) with human-readable reasons.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["ShapeSpec", "SHAPES", "cell_supported", "effective_data_axes", "input_specs",
           "batch_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.kind == "decode" and not cfg.supports_decode():
        return False, f"{cfg.name} is encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, (
            f"{cfg.name} has unbounded full-attention layers: 500k decode "
            "needs an O(seq) KV cache; run only for SSM/hybrid archs (spec)"
        )
    return True, ""


def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def effective_data_axes(global_batch: int, data_axes, mesh=None):
    """Trim batch-sharding axes until their product divides the batch
    (e.g. long_500k's batch of 1 replicates instead of sharding)."""
    dax = tuple(data_axes)
    if mesh is None:
        return dax
    while dax:
        prod = 1
        for a in dax:
            prod *= mesh.shape[a]
        if prod and global_batch % prod == 0:
            return dax
        dax = dax[1:]  # drop the outermost (pod) axis first
    return ()


def input_specs(cfg, shape: ShapeSpec, data_axes=("data",), mesh=None):
    """Returns (batch dict of meta tensors, dict of specs)."""
    b, s = shape.global_batch, shape.seq_len
    dax = effective_data_axes(b, data_axes, mesh)
    # one axis is named alone, as a PartitionSpec normalizes ("data",)
    entry = (dax[0] if len(dax) == 1 else dax) if dax else None
    tok_spec = (entry, None)

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, torch.Tensor] = {}
        specs: Dict[str, tuple] = {}
        if cfg.frontend == "vision":
            s_text = s - cfg.frontend_tokens
            batch["tokens"] = _f((b, s_text), torch.int32)
            batch["frontend_feats"] = _f((b, cfg.frontend_tokens, cfg.frontend_dim),
                                         torch.bfloat16)
            specs["tokens"] = tok_spec
            specs["frontend_feats"] = (entry, None, None)
            label_len = s_text
        elif cfg.frontend == "audio":
            batch["frontend_feats"] = _f((b, s, cfg.frontend_dim), torch.bfloat16)
            specs["frontend_feats"] = (entry, None, None)
            label_len = s
        else:
            batch["tokens"] = _f((b, s), torch.int32)
            specs["tokens"] = tok_spec
            label_len = s
        if shape.kind == "train":
            batch["labels"] = _f((b, label_len), torch.int32)
            specs["labels"] = tok_spec
        return batch, specs

    # decode: one new token against a cache of seq_len
    batch = {"tokens": _f((b, 1), torch.int32), "pos": _f((), torch.int32)}
    specs = {"tokens": tok_spec, "pos": ()}
    return batch, specs


def batch_specs(cfg, shape: ShapeSpec, data_axes=("data",)):
    """Convenience: just the specs."""
    return input_specs(cfg, shape, data_axes)[1]
