"""Train steps: the local one (autograd on ``LanguageModel.loss``, then
AdamW) and the sharded one over a mesh of slots.

Counterpart of ``repro.training.step``.  ``build_train_step`` is the
reference's on one device.  ``make_sharded_train_step(lm, h, mesh,
param_mode=...)`` is its pjit-sharded step, explicit: the parameters live
per slot (``models/sharded.py::ShardedLM``) by the mode's specs, the
optimizer state per slot by ``opt_state_specs``, and after the backward
the train step sums each shard's gradient over the slots that hold a copy
of it, slot 0 first (the data-parallel all-reduce, and the model slots'
shares of a replicated parameter), or reduce-scatters it over the data
axes where the reference constrains the gradients to ``apply_fsdp``'s
specs.  The modes (``repro/training/step.py:140``):

  tp        parameters and moments split over ``model``, replicated over
            the data axes (each data replica updates its copy);
  zero1     + the moments split over the data axes too (``apply_fsdp``'s
            dimension): each slot updates its chunk of the parameters, and
            the chunks are gathered back over the data slots;
  mp_zero1  + bf16 parameters, the fp32 master (and the moments) split over
            the data axes; build the model with ``param_dtype="bfloat16"``;
  fsdp      the parameters themselves split over the data axes, gathered
            at each use (``ShardedLM._use``; again in backward under
            remat), their gradients reduce-scattered.

``grad_compression="ef_int8"`` (``tp`` only) replaces the exact
data-parallel sum by ``compression.ef_int8_allreduce``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.mesh import shard_shape, shard_slices, spec_axes
from repro_torch.roofline.analysis import record_collective
from repro_torch.training.compression import ef_int8_allreduce, init_error_state
from repro_torch.training.optimizer import Hyper, adamw_update, opt_state_specs

__all__ = ["build_train_step", "apply_fsdp", "stacked_groups", "make_sharded_train_step",
           "sharded_adamw_init", "gather_train_state", "place_train_state", "train_state_specs",
           "train_state_template",
           "loss_gradients", "spec_slot_bytes",
           "slot_state_bytes",
           "PARAM_MODES"]

PARAM_MODES = ("tp", "zero1", "mp_zero1", "fsdp")


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


# --------------------------------------------------------------------------
# the sharded step
# --------------------------------------------------------------------------
def stacked_groups(cfg) -> Dict[str, int]:
    """{layer-parameter prefix ``blocks.i.``: the group count} for the
    layers the reference stacks over cycles of the pattern (the ones past
    the last full cycle it keeps unstacked)."""
    ng, gs = cfg.n_groups(), cfg.group_size()
    return {f"blocks.{i}.": ng for i in range(ng * gs)}


def apply_fsdp(pspecs: Dict[str, tuple], shapes: Dict[str, Sequence[int]],
               data_axes: Sequence[str], mesh, *, skip_dim0: bool = True,
               groups: Optional[Dict[str, int]] = None) -> Dict[str, tuple]:
    """ZeRO-3 / FSDP spec transform (``repro/training/step.py:29``): split
    each parameter's largest still-replicated dimension that the data
    degree divides over the data axes.  ``groups`` (``stacked_groups``)
    names the parameters the reference stacks over layer groups: the
    choice is made on the stacked shape, whose group axis ``skip_dim0``
    passes over, and the spec is returned for the unstacked tensor."""
    dp = int(np.prod([mesh.shape[a] for a in data_axes]))
    groups = groups or {}
    data_entry = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    out = {}
    for name, spec in pspecs.items():
        lead = next((n for p, n in groups.items() if name.startswith(p)), None)
        shape = tuple(shapes[name])
        spec = tuple(spec)
        if lead is not None:
            shape, spec = (lead,) + shape, (None,) + spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for d in dims for a in spec_axes(d)}
        if not used & set(data_axes):
            cands = [(shape[i], i) for i in range(len(dims))
                     if dims[i] is None and shape[i] % dp == 0 and shape[i] > 1
                     and not (skip_dim0 and i == 0 and len(dims) > 1)]
            if cands:
                dims[max(cands)[1]] = data_entry
        dims = tuple(dims)
        out[name] = dims[1:] if lead is not None else dims
    return out


def _sub_slices(shape, outer, inner, mesh, slot) -> tuple:
    """Where ``slot``'s shard under ``inner`` lies inside its shard under
    ``outer`` (``inner`` = ``outer`` + a split of a dimension ``outer``
    leaves whole)."""
    out = []
    full = shard_slices(shape, inner, mesh, slot)
    for i, n in enumerate(shape):
        o = outer[i] if i < len(outer) else None
        a = inner[i] if i < len(inner) else None
        out.append(slice(None) if spec_axes(o) == spec_axes(a) else full[i])
    return tuple(out)


def _shard_key(shape, spec, mesh, slot) -> tuple:
    return tuple((x.start, x.stop) for x in shard_slices(shape, spec, mesh, slot))


def _groups_by_shard(shape, spec, mesh) -> List[List[int]]:
    """The slots holding each shard under ``spec``, in slot order."""
    out: Dict[tuple, List[int]] = {}
    for s in range(mesh.size):
        out.setdefault(_shard_key(shape, spec, mesh, s), []).append(s)
    return list(out.values())


def _sum_slots(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """ts[0] + ts[1] + ... in fp32, on the first one's device."""
    total = ts[0].float()
    for t in ts[1:]:
        total = total + t.float().to(total.device)
    return total


def _local_grads(params, batch, names):
    """Each slot's gradient of ``params.loss(batch)`` w.r.t. its shards
    (zeros where a shard takes no part), and the metrics.  A parameter
    stored narrower than the compute dtype (bf16 under mp_zero1 with fp32
    compute) takes its gradient in the compute dtype: the slots' shares
    are summed before the one rounding to the parameter's dtype, as the
    reference's gradient is the convert of the summed product."""
    from repro_torch.models.layers import cdtype

    mesh, cd = params.mesh, cdtype(params.cfg)
    wide = torch.empty((), dtype=cd).element_size()
    stored = {}
    for s in range(mesh.size):
        for n in names:
            t = params.params[s][n]
            if t.is_floating_point() and t.element_size() < wide:
                stored[s, n] = t
                params.params[s][n] = t.detach().to(cd).requires_grad_(True)
    try:
        flat = [params.params[s][n] for s in range(mesh.size) for n in names]
        loss, metrics = params.loss(batch)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for (s, n), t in stored.items():
            params.params[s][n] = t
    out, it = [], iter(zip(flat, gs))
    for _ in range(mesh.size):
        d = {}
        for n in names:
            p, g = next(it)
            d[n] = torch.zeros_like(p) if g is None else g
        out.append(d)
    return out, {k: v.detach() for k, v in metrics.items()}


def loss_gradients(params, batch, device="cpu"):
    """(the full gradient of ``params.loss(batch)`` by name, fp32 on
    ``device``; the metrics): each shard's slot shares summed, slot 0 first,
    then gathered (what the sharded step's reduction computes)."""
    from repro_torch.distributed.mesh import gather

    names = list(params.specs)
    local, metrics = _local_grads(params, batch, names)
    mesh, out = params.mesh, {}
    for n in names:
        per_slot = [None] * mesh.size
        for members in _groups_by_shard(params.shapes[n], params.specs[n], mesh):
            total = _sum_slots([local[s][n] for s in members])
            for s in members:
                per_slot[s] = total
        out[n] = gather(per_slot, params.shapes[n], params.specs[n], mesh, device)
    return out, metrics


def sharded_adamw_init(params, ospecs: dict, *, error_feedback: bool = False) -> List[dict]:
    """Each slot's AdamW state by ``ospecs`` (``opt_state_specs``'s, as
    the mode sets them): fp32 zero moments, an int32 count, and (with a
    ``"master"`` entry) the fp32 master copied from the slot's chunk of
    the parameters; with ``error_feedback`` fp32 zero errors like the
    slot's parameters (``ef_int8_allreduce``)."""
    mesh = params.mesh
    out = []
    for s in range(mesh.size):
        dev = mesh.devices[s]
        st = {"m": {}, "v": {}, "count": torch.zeros((), dtype=torch.int32, device=dev)}
        for n, shape in params.shapes.items():
            for k in ("m", "v"):
                st[k][n] = torch.zeros(shard_shape(shape, ospecs[k][n], mesh, s),
                                       dtype=torch.float32, device=dev)
        if "master" in ospecs:
            st["master"] = {
                n: params.params[s][n].detach()[_sub_slices(
                    shape, params.specs[n], ospecs["master"][n], mesh, s)].float().clone()
                for n, shape in params.shapes.items()}
        if error_feedback:
            st["error"] = init_error_state(params.params[s])
        out.append(st)
    return out


def slot_state_bytes(params, opt: List[dict]) -> List[Dict[str, int]]:
    """Each slot's resident bytes of parameters and optimizer state, as held."""
    def nb(d):
        return sum(t.numel() * t.element_size() for t in d.values())

    return [{"params": nb(params.params[s]),
             "opt": sum(nb(v) if isinstance(v, dict) else v.numel() * v.element_size()
                        for v in opt[s].values())} for s in range(params.mesh.size)]


def spec_slot_bytes(specs: dict, dtypes: Dict[str, torch.dtype], mesh) -> List[Dict[str, int]]:
    """Each slot's bytes of parameters, gradients (the "grads" layout, in
    the parameters' dtypes) and optimizer state that
    ``make_sharded_train_step``'s specs give for the full shapes: what
    ``slot_state_bytes`` and ``step_fn.grad_bytes`` should find."""
    def shard_numel(shape, spec, s):
        return int(np.prod(shard_shape(shape, spec, mesh, s)))

    shapes, out = specs["shapes"], []
    for s in range(mesh.size):
        p = sum(shard_numel(shapes[n], specs["params"][n], s) *
                torch.empty((), dtype=dtypes[n]).element_size() for n in shapes)
        g = sum(shard_numel(shapes[n], specs["grads"][n], s) *
                torch.empty((), dtype=dtypes[n]).element_size() for n in shapes)
        o = 4 + sum(shard_numel(shapes[n], specs["opt"][k][n], s) * 4
                    for k in ("m", "v", "master") if k in specs["opt"] for n in shapes)
        out.append({"params": p, "grads": g, "opt": o})
    return out


def make_sharded_train_step(lm, h: Hyper, mesh, *, data_axes: Tuple[str, ...] = ("data",),
                            model_axis: str = "model", param_mode: str = "tp",
                            grad_compression: Optional[str] = None):
    """(step_fn, {"params", "opt", "grads": specs, "dist": Dist}) for ``lm``
    (a ``LanguageModel(cfg, tp)``, any device, ``"meta"`` too: only its
    config and shapes are read) on ``mesh``, a ``SlotMesh``.

    ``step_fn(params, opt_state, batch, step) -> metrics`` takes the
    ``ShardedLM`` placed by the "params" specs (``lm.shard(dist, specs)``)
    and ``sharded_adamw_init``'s state, and updates both in place; the
    metrics (``loss``, ``ce``, the MoE terms, ``grad_norm``, ``lr``) are
    the whole batch's, on the lead slot."""
    from repro_torch.models.layers import resolve_specs
    from repro_torch.models.transformer import Dist

    if param_mode not in PARAM_MODES:
        raise ValueError(f"param_mode {param_mode!r} not in {PARAM_MODES}")
    if grad_compression not in (None, "ef_int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if grad_compression and (param_mode != "tp" or h.grad_accum > 1):
        raise ValueError("ef_int8 compression replaces the data-parallel all-reduce of the "
                         "'tp' mode, once a step (grad_accum 1); the other modes "
                         "reduce-scatter")
    tp = mesh.shape[model_axis]
    if lm.tp != tp:
        raise ValueError(f"the model was built for tp={lm.tp}, the mesh's {model_axis} is {tp}")
    dist = Dist(mesh=mesh, data_axes=tuple(data_axes), model_axis=model_axis, tp=tp)
    cfg = lm.cfg
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    groups = stacked_groups(cfg)
    pspecs = resolve_specs(lm.param_specs(), data_axes)
    if param_mode == "fsdp":
        pspecs = apply_fsdp(pspecs, shapes, data_axes, mesh, groups=groups)
    ospecs = opt_state_specs(pspecs, master_fp32=param_mode == "mp_zero1")
    zp = apply_fsdp(pspecs, shapes, data_axes, mesh, groups=groups)
    if param_mode in ("zero1", "mp_zero1"):
        for k in ("m", "v", "master"):
            if k in ospecs:
                ospecs[k] = dict(zp)
    gspecs = zp if param_mode != "tp" else dict(pspecs)
    names = list(shapes)
    data_set = set(data_axes)
    # per parameter: the slots holding each shard of it, and of its gradient
    p_groups = {n: _groups_by_shard(shapes[n], pspecs[n], mesh) for n in names}
    g_groups = {n: _groups_by_shard(shapes[n], gspecs[n], mesh) for n in names}
    chunk = {(n, s): _sub_slices(shapes[n], pspecs[n], gspecs[n], mesh, s)
             for n in names if gspecs[n] != pspecs[n] for s in range(mesh.size)}

    def reduce_grads(params, local: List[Dict[str, torch.Tensor]], opt):
        """Each slot's gradient in the ``gspecs`` layout, in the parameter's
        dtype: the shares of the slots holding one shard summed in fp32
        (slot 0 first), then, where the gradient is split further over the
        data axes, the slot's chunk."""
        out = [dict() for _ in range(mesh.size)]
        for n in names:
            for members in p_groups[n]:
                if grad_compression:
                    # the model replicas' shares summed exactly, then the
                    # data replicas' compressed mean (each as if of its own
                    # mean loss: n_data times its share of the global one)
                    by_row: Dict[int, List[int]] = {}
                    for s in members:
                        by_row.setdefault(mesh.index_along(s, data_axes), []).append(s)
                    rows = list(by_row.values())
                    nd = len(rows)
                    sums = []
                    for r in rows:
                        t = local[r[0]][n].float()
                        for s in r[1:]:
                            t = t + local[s][n].float().to(t.device)
                        sums.append({n: t * nd})
                    means, errs = ef_int8_allreduce(sums, [{n: opt[r[0]]["error"][n]}
                                                           for r in rows])
                    for r, mean, err in zip(rows, means, errs):
                        for s in r:
                            out[s][n] = mean[n].to(mesh.devices[s])
                            opt[s]["error"][n] = err[n].to(mesh.devices[s])
                    continue
                # summed in fp32, kept in the parameter's dtype as the
                # reference's gradients are (bf16 under mp_zero1): the
                # reference's all-reduce, or its reduce-scatter where the
                # gradient is split further over the data axes
                total = _sum_slots([local[s][n] for s in members]).to(
                    params.params[members[0]][n].dtype)
                record_collective("reduce-scatter" if (n, members[0]) in chunk
                                  else "all-reduce",
                                  total.numel() * total.element_size(), len(members))
                for s in members:
                    t = total.to(mesh.devices[s])
                    out[s][n] = t[chunk[n, s]] if (n, s) in chunk else t
        return out

    def grad_norm(grads) -> torch.Tensor:
        """sqrt of the sum of squares of the whole gradient: each distinct
        shard once, names in order, shards in slot order."""
        lead = mesh.devices[0]
        total = None
        for n in names:
            for members in g_groups[n]:
                sq = grads[members[0]][n].float().square().sum().to(lead)
                total = sq if total is None else total + sq
        return torch.sqrt(total)

    def update_slot(s, params, grads, opt, step, gnorm):
        leaves = params.params[s]
        if param_mode in ("zero1", "mp_zero1"):
            view = {n: leaves[n].detach()[chunk[n, s]] if (n, s) in chunk else leaves[n].detach()
                    for n in names}
        else:
            view = {n: leaves[n].detach() for n in names}
        _, _, om = adamw_update(grads[s], opt[s], view, step, h,
                                gnorm=gnorm.to(mesh.devices[s]))
        return om

    @torch.no_grad()
    def gather_chunks(params):
        """zero1 / mp_zero1: every data slot's updated chunk into the other
        data slots' copies of the parameter (the all-gather)."""
        for n in names:
            dim = next((i for i, e in enumerate(gspecs[n]) if set(spec_axes(e)) & data_set
                        and gspecs[n][i] != (pspecs[n][i] if i < len(pspecs[n]) else None)),
                       None)
            if dim is None:
                continue
            for grp in mesh.groups(spec_axes(gspecs[n][dim])):
                # the group's chunks, in its order, are the whole shard
                pieces = [params.params[src][n].detach()[chunk[n, src]] for src in grp]
                record_collective("all-gather", pieces[0].numel() * pieces[0].element_size(),
                                  len(grp))
                lead = pieces[0].device
                full = torch.cat([p.to(lead) for p in pieces], dim=dim)
                for dst in grp:
                    params.params[dst][n].detach().copy_(full)

    def step_fn(params, opt_state: List[dict], batch: Dict[str, object], step: int):
        ga = h.grad_accum
        if ga > 1:
            # each microbatch's gradient reduced (reduce-scattered where the
            # mode says) before it is added to the fp32 accumulator, as the
            # reference constrains every microbatch's
            acc, ms = None, []
            for j in range(ga):
                g, m = _local_grads(params, {k: _rows(v, j, ga) for k, v in batch.items()},
                                    names)
                g = reduce_grads(params, g, opt_state)
                if acc is None:
                    acc = [{n: t.float().clone() for n, t in d.items()} for d in g]
                else:
                    for a, d in zip(acc, g):
                        torch._foreach_add_(list(a.values()), [d[n].float() for n in a])
                ms.append(m)
                del g
            grads = [{n: t / ga for n, t in a.items()} for a in acc]
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            local, metrics = _local_grads(params, batch, names)
            grads = reduce_grads(params, local, opt_state)
            del local
        step_fn.grad_bytes = [sum(t.numel() * t.element_size() for t in g.values())
                              for g in grads]
        gnorm = grad_norm(grads)
        om = {}
        for s in range(mesh.size):
            om = update_slot(s, params, grads, opt_state, step, gnorm)
        if param_mode in ("zero1", "mp_zero1"):
            gather_chunks(params)
        metrics.update(grad_norm=gnorm, lr=om["lr"])
        return metrics

    return step_fn, {"params": pspecs, "opt": ospecs, "grads": gspecs, "dist": dist,
                     "shapes": shapes}


@torch.no_grad()
def gather_train_state(params, opt: List[dict], ospecs: dict, device="cpu") -> dict:
    """The full training state ``{"params": {name: tensor}, "opt": {"m",
    "v"(, "master"): {name: tensor}, "count"}}`` on ``device``: the
    layout a one-slot run checkpoints (``CheckpointManager.save``)."""
    from repro_torch.distributed.mesh import gather

    mesh = params.mesh
    state = {"params": params.state_dict(device), "opt": {}}
    for k in ("m", "v", "master"):
        if k in ospecs:
            state["opt"][k] = {n: gather([opt[s][k][n] for s in range(mesh.size)], shape,
                                         ospecs[k][n], mesh, device)
                               for n, shape in params.shapes.items()}
    state["opt"]["count"] = opt[0]["count"].to(device)
    return state


def train_state_template(specs: dict) -> dict:
    """``gather_train_state``'s structure with shapes only (meta tensors):
    the template ``CheckpointManager.restore`` reads a state into."""
    meta = torch.device("meta")
    shapes = specs["shapes"]
    opt = {k: {n: torch.empty(s, device=meta) for n, s in shapes.items()}
           for k in ("m", "v", "master") if k in specs["opt"]}
    opt["count"] = torch.empty((), device=meta)
    return {"params": {n: torch.empty(s, device=meta) for n, s in shapes.items()}, "opt": opt}


def train_state_specs(specs: dict) -> dict:
    """The spec of every leaf of ``gather_train_state``'s layout (for
    ``CheckpointManager.restore(..., shardings=(mesh, this))``)."""
    return {"params": specs["params"],
            "opt": {**{k: v for k, v in specs["opt"].items() if k != "count"}, "count": ()}}


def place_train_state(cfg, dist, state: dict, specs: dict):
    """(``ShardedLM``, per-slot optimizer state) on ``dist``'s mesh by
    ``make_sharded_train_step``'s specs, from a full training state
    (``gather_train_state``'s layout) or from one whose leaves are already
    per-slot lists (``CheckpointManager.restore(..., shardings=...)``)."""
    from repro_torch.distributed.mesh import place
    from repro_torch.models.sharded import ShardedLM

    mesh = dist.mesh

    def slots(leaf, spec):
        return list(leaf) if isinstance(leaf, (list, tuple)) else place(leaf, spec, mesh)

    per_slot = [dict() for _ in range(mesh.size)]
    for n, spec in specs["params"].items():
        for s, t in enumerate(slots(state["params"][n], spec)):
            per_slot[s][n] = t.detach().requires_grad_(True)
    params = ShardedLM(cfg, dist, per_slot, dict(specs["params"]), dict(specs["shapes"]))
    counts = slots(state["opt"]["count"], ())
    opt = [{"count": counts[s].to(device=mesh.devices[s], dtype=torch.int32)}
           for s in range(mesh.size)]
    for k in ("m", "v", "master"):
        if k in specs["opt"]:
            for n, spec in specs["opt"][k].items():
                for s, t in enumerate(slots(state["opt"][k][n], spec)):
                    opt[s].setdefault(k, {})[n] = t.float()
    return params, opt
