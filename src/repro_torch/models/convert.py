"""The reference's parameters, optimizer state and checkpoints -> the port's.

``repro``'s ``LanguageModel.init`` returns
``{"embed", "frontend", "blocks": {"groups": [...], "rest": [...]},
"final_norm"}``: ``groups`` holds one layer dict per position li of
``cfg.layer_pattern``, each leaf stacked over the G pattern cycles, so layer
``g * len(pattern) + li`` is ``groups[li]`` at index g; ``rest`` holds the
layers past the last full cycle.  The einsum layouts (``w_q`` [d, H, dh],
``w_o`` [H, dh, d]) and the tied ``embedding`` are the port's own, so each
leaf keeps its shape and its key.  Every family maps this way: attention,
RG-LRU and SSM mixers, MoE experts and router, the frontend, and the
layers past the last cycle (RecurrentGemma's 38 = 12 * 3 + 2).

    lm = LanguageModel(cfg, device=torch.device("cpu"))
    lm.load_state_dict(params_from_reference(params_np, cfg))

``opt_state_from_reference`` converts the reference's AdamW state (m, v,
count and the optional fp32 master) to the port's
(``training/optimizer.py``), and ``read_reference_checkpoint`` reads a
checkpoint directory the reference's ``CheckpointManager`` wrote (keys are
its ``/``-joined pytree paths, bf16 leaves stored as uint16) into both, so
that a run trained under JAX resumes in the port.

Across slots: ``shards_from_reference(params_np, cfg, dist)`` places the
reference's parameters of ``LanguageModel(cfg, tp=T).init(...)`` (padded
heads and all) as a ``ShardedLM`` on ``dist``'s mesh by the reference's
specs, and ``reference_from_shards`` gathers the shards back into the
reference's pytree of full numpy arrays, equal to its input bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import pdtype
from repro_torch.training.checkpoint import CheckpointManager

__all__ = ["params_from_reference", "opt_state_from_reference", "read_reference_checkpoint",
           "reference_layers", "shards_from_reference", "reference_from_shards"]

# leaves the reference keeps in fp32 whatever cfg.param_dtype says
_FP32_LEAVES = ("router", "A_log", "lam")


def _flat(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        name = f"{prefix}.{key}"
        if isinstance(value, dict):
            _flat(name, value, out)
        else:
            out[name] = np.asarray(value)


def reference_layers(blocks, cfg) -> List[dict]:
    """The reference's ``{"groups", "rest"}`` (params or caches) as one tree
    per layer, in layer order."""
    gs = cfg.group_size()
    layers = []
    for g in range(cfg.n_groups()):
        for li in range(gs):
            layers.append(_index(blocks["groups"][li], g))
    layers.extend(blocks.get("rest") or [])
    return layers


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def _flat_params(tree, cfg) -> Dict[str, np.ndarray]:
    """A params-shaped reference tree as {state-dict name: array}."""
    flat: Dict[str, np.ndarray] = {}
    _flat("embed", tree["embed"], flat)
    _flat("frontend", tree.get("frontend") or {}, flat)
    for i, layer in enumerate(reference_layers(tree["blocks"], cfg)):
        _flat(f"blocks.{i}", layer, flat)
    _flat("final_norm", tree["final_norm"], flat)
    return flat


def params_from_reference(params_np, cfg, device=None) -> Dict[str, torch.Tensor]:
    """A state dict for ``LanguageModel(cfg)`` from the reference's params
    (numpy arrays, or anything ``np.asarray`` takes), on ``device`` (CPU
    by default); each leaf in the port's dtype for it."""
    dt = pdtype(cfg)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
                device=device, dtype=torch.float32 if k.rsplit(".", 1)[-1] in _FP32_LEAVES
                else dt)
            for k, v in _flat_params(params_np, cfg).items()}


def opt_state_from_reference(opt_np, cfg, device=None) -> Dict[str, object]:
    """The port's AdamW state (``training.optimizer.adamw_init``'s layout)
    from the reference's ``{"m", "v", "count"(, "master")}``: the moments
    and the master copy in fp32, keyed by state-dict name; ``count`` an
    int32 scalar tensor."""
    out: Dict[str, object] = {
        name: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
               for k, v in _flat_params(opt_np[name], cfg).items()}
        for name in ("m", "v", "master") if name in opt_np}
    out["count"] = torch.tensor(int(np.asarray(opt_np["count"])), dtype=torch.int32,
                                device=device)
    return out


def _from_stored(arr: np.ndarray, dtype: Optional[str]) -> np.ndarray:
    """A stored leaf as numpy: bf16 (stored as uint16) widened exactly to fp32."""
    if dtype == "bfloat16":
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def _nest(flat: Dict[str, np.ndarray]):
    """``/``-joined pytree paths -> nested dicts; a dict whose keys are all
    integers (a list in the reference's tree) becomes a list."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def read_reference_checkpoint(directory: str, cfg, *, step: Optional[int] = None,
                              device=None) -> Tuple[Dict[str, torch.Tensor], dict, dict]:
    """(params, optimizer state, manifest) from a checkpoint directory the
    reference wrote for ``{"params": params, "opt": opt}``: the newest
    ``step_%010d`` unless ``step`` is given.  Load the params with
    ``lm.load_state_dict`` and hand the state to the train step; the
    manifest's ``extra`` carries the data step."""
    if step is None:
        step = CheckpointManager(directory).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        tree = _nest({k: _from_stored(z[k], dtypes.get(k)) for k in z.files})
    params = params_from_reference(tree["params"], cfg, device)
    return params, opt_state_from_reference(tree["opt"], cfg, device), manifest


def shards_from_reference(params_np, cfg, dist, specs=None):
    """A ``ShardedLM`` on ``dist``'s mesh holding the reference's
    parameters (``LanguageModel(cfg, tp=dist.tp).init``'s, as numpy),
    placed by ``specs`` (default: the reference's own, ``param_specs``)."""
    from repro_torch.models.model import param_specs
    from repro_torch.models.sharded import ShardedLM

    full = params_from_reference(params_np, cfg)
    return ShardedLM.place(cfg, dist, full, specs if specs is not None
                           else param_specs(cfg, dist.tp))


def _nest_layer(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _stack(trees: List[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def reference_from_shards(sharded) -> dict:
    """The reference's parameter pytree (``{"embed", "frontend", "blocks":
    {"groups": [...], "rest": [...]}, "final_norm"}``, layer groups
    stacked) of full numpy arrays gathered from a ``ShardedLM``'s shards
    (bf16 parameters widened to fp32)."""
    cfg = sharded.cfg
    flat = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sharded.state_dict("cpu").items()}
    tree = {name: _nest_layer({k[len(name) + 1:]: v for k, v in flat.items()
                               if k.startswith(name + ".")})
            for name in ("embed", "frontend", "final_norm")}
    layers = [_nest_layer({k[len(f"blocks.{i}") + 1:]: v for k, v in flat.items()
                           if k.startswith(f"blocks.{i}.")}) for i in range(cfg.n_layers)]
    gs, ng = cfg.group_size(), cfg.n_groups()
    groups = [_stack([layers[g * gs + li] for g in range(ng)]) for li in range(gs)] if ng else []
    tree["blocks"] = {"groups": groups, "rest": layers[ng * gs:]}
    return tree
