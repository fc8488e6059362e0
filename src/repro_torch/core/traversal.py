"""FindLeafBatch: vectorized, stackless top-tree traversal (paper Alg. 1, l.5).

Counterpart of ``repro.core.traversal``: every query runs an implicit
depth-first NN traversal of the top tree as a 2-word state machine, and all
queries advance together with masked tensor ops.

state per query
  node  : int32 heap index currently occupied (0 == traversal finished)
  fromc : int32 0 => arrived from parent (descending)
                1 => ascending, arrived from left child
                2 => ascending, arrived from right child

transition (radius r = distance to the current k-th candidate):
  descending internal node      -> step to near child
  descending arrival at a leaf  -> PAUSE (leaf must be scanned)
  ascending from near child     -> if |q[dim]-split| < r: descend far child
                                   else: keep ascending
  ascending from far child      -> keep ascending
  ascending out of the root     -> DONE

The JAX reference runs ``lax.while_loop`` until no query moves.  Ported as
it stands, that loop would read ``.any()`` back to the host on every step.
A query that is paused or done does not move, and between two leaf visits
a query takes at most 2h - 1 transitions (ascend from the leaf's parent to
the root: h - 1; cross to the far child: 1; descend to a leaf: h - 1), and
h from the root to its first leaf.  So ``advance`` runs a fixed
``2h + 1`` masked steps with no host read; the parity tests hold its
leaf-visit sequences equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = [
    "TraversalState",
    "init_state",
    "exit_leaf",
    "advance",
    "DONE",
]

DONE = -1  # traversal finished; query retired


class TraversalState(NamedTuple):
    node: torch.Tensor   # int32[m] heap index (0 = done)
    fromc: torch.Tensor  # int32[m] 0=parent, 1=left child, 2=right child


def init_state(m: int, device) -> TraversalState:
    """All queries start by descending from the root."""
    return TraversalState(
        node=torch.ones((m,), dtype=torch.int32, device=device),
        fromc=torch.zeros((m,), dtype=torch.int32, device=device),
    )


def exit_leaf(state: TraversalState, first_leaf_heap: int) -> TraversalState:
    """Move a query out of the leaf it just had scanned: it resumes by
    ascending to its parent; which child it was is its heap parity."""
    node = state.node
    at_leaf = node >= first_leaf_heap
    return TraversalState(
        node=torch.where(at_leaf, node >> 1, node),
        fromc=torch.where(at_leaf, 1 + (node & 1), state.fromc),
    )


def _one_step(
    state: TraversalState,
    queries: torch.Tensor,     # f32[m, d]
    radius: torch.Tensor,      # f32[m]
    split_dim: torch.Tensor,   # i64[2**h]
    split_val: torch.Tensor,   # f32[2**h]
    first_leaf_heap: int,
) -> TraversalState:
    """One state-machine transition for every query (masked where frozen)."""
    node, fromc = state.node, state.fromc
    at_leaf = node >= first_leaf_heap
    frozen = (node == 0) | (at_leaf & (fromc == 0))

    safe_node = torch.where(frozen | at_leaf, 1, node)
    safe_long = safe_node.long()
    dim = split_dim[safe_long]
    val = split_val[safe_long]
    qv = torch.gather(queries, 1, dim[:, None])[:, 0]
    go_left = qv <= val
    near = 2 * safe_node + (~go_left).to(torch.int32)
    far = 2 * safe_node + go_left.to(torch.int32)

    descending = fromc == 0
    near_side = torch.where(go_left, 1, 2)
    visit_far = (fromc == near_side) & (torch.abs(qv - val) < radius)
    at_root = safe_node == 1
    n_asc = torch.where(visit_far, far, torch.where(at_root, 0, safe_node >> 1))
    f_asc = torch.where(
        visit_far, 0, torch.where(at_root, 0, 1 + (safe_node & 1))
    )
    new_node = torch.where(descending, near, n_asc).to(torch.int32)
    new_fromc = torch.where(descending, 0, f_asc).to(torch.int32)
    return TraversalState(
        node=torch.where(frozen, node, new_node),
        fromc=torch.where(frozen, fromc, new_fromc),
    )


def advance(
    state: TraversalState,
    queries: torch.Tensor,
    radius: torch.Tensor,
    split_dim: torch.Tensor,
    split_val: torch.Tensor,
    *,
    first_leaf_heap: int,
) -> Tuple[torch.Tensor, TraversalState]:
    """Advance every query to its next leaf (or retire it).

    Returns ``(leaf, state)``: ``leaf[i]`` is the leaf the query paused at,
    or ``DONE`` (-1) once its traversal completed.  ``split_dim`` must be an
    int64 tensor (it indexes the feature axis).
    """
    height = first_leaf_heap.bit_length() - 1
    for _ in range(2 * height + 1):
        state = _one_step(state, queries, radius, split_dim, split_val,
                          first_leaf_heap)
    leaf = torch.where(
        state.node >= first_leaf_heap, state.node - first_leaf_heap, DONE
    ).to(torch.int32)
    return leaf, state
