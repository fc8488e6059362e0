"""The reference's parameter pytree -> the port's state dict.

``repro``'s ``LanguageModel.init`` returns
``{"embed", "frontend", "blocks": {"groups": [...], "rest": [...]},
"final_norm"}``: ``groups`` holds one layer dict per position li of
``cfg.layer_pattern``, each leaf stacked over the G pattern cycles, so layer
``g * len(pattern) + li`` is ``groups[li]`` at index g; ``rest`` holds the
layers past the last full cycle.  The einsum layouts (``w_q`` [d, H, dh],
``w_o`` [H, dh, d]) and the tied ``embedding`` are the port's own, so each
leaf keeps its shape and its key.

    lm = LanguageModel(cfg, device=torch.device("cpu"))
    lm.load_state_dict(params_from_reference(params_np, cfg))
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.layers import NotPorted, pdtype

__all__ = ["params_from_reference", "reference_layers"]


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
    layers.extend(blocks["rest"])
    return layers


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def params_from_reference(params_np, cfg) -> Dict[str, torch.Tensor]:
    """A state dict for ``LanguageModel(cfg)`` from the reference's params
    (numpy arrays, or anything ``np.asarray`` takes)."""
    if params_np.get("frontend"):
        raise NotPorted(f"{cfg.name}: frontend parameters; ROADMAP Queue 1 item 20's "
                        "remainder")
    flat: Dict[str, np.ndarray] = {}
    _flat("embed", params_np["embed"], flat)
    for i, layer in enumerate(reference_layers(params_np["blocks"], cfg)):
        _flat(f"blocks.{i}", layer, flat)
    _flat("final_norm", params_np["final_norm"], flat)
    dt = pdtype(cfg)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dt) for k, v in flat.items()}
