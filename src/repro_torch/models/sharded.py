"""The language model across the slots of a mesh: tensor, sequence and
expert parallelism.

Counterpart of the reference's ``dist`` paths (``Dist(mesh, data_axes,
model_axis, tp)``): what GSPMD partitions there from PartitionSpecs and
``with_sharding_constraint`` is explicit here.  ``ShardedLM`` holds, for
every slot of a ``distributed.mesh.SlotMesh``, its shard of each parameter
by the reference's spec for it (``LanguageModel.param_specs``, or the
train step's ``fsdp`` specs), and runs the model as one program over the
slots, layer by layer, each slot computing with its own shards and the
activations moving between slots through the collectives of
``distributed/mesh.py``:

* **rows and model slots**: the batch is split over the data axes (row d
  = the d-th contiguous block of rows); each row's tokens are replicated
  over its model slots;
* **embedding / logits / cross-entropy** over vocabulary shards: a slot
  looks up the tokens in its rows of the table (zero elsewhere) and the
  lookups are summed; each slot's logits are its vocabulary columns (the
  pad columns past ``vocab_size`` masked); the log-sum-exp takes the max
  over slots, then the sum of exp, and the label's logit comes from the
  slot that holds it;
* **attention**: each slot its query heads (``heads_padded``) and, where
  ``kv_sharded``, its kv heads; else every slot computes K / V and reads
  the group of each of its heads; the output projection's partial sums
  are summed over the model slots.  With K / V replicated the decode cache
  is split along its length (``attention.cache_specs``): a decode step
  gathers the query heads, each slot scores its stretch of the cache, and
  the softmax is taken over the slots (max, sum of exp, then the weighted
  values summed);
* **MLP**: gate / up split over d_ff, down's partial sums summed; **MoE**:
  each model slot its E / tp experts over the row's tokens (capacity from
  one data row's token count, ``moe.py``), the routed and the shared
  expert's partial sums summed; load balance and z averaged over the
  rows, the drop fraction over every slot; with tp = 1 the reference's
  MoE is global, so the rows' tokens are gathered and routed together;
* **RG-LRU / SSM**: the width (heads) split over the model slots; the
  SSM's gated norm over the whole d_inner sums its squares over the slots;
* **sequence parallelism** (``cfg.seq_shard``, tp > 1): between blocks
  the residual stream, norms and adds are split along the sequence over
  the model slots (GSPMD's ceil split, so any length); the normed input is
  gathered before each mixer / MLP and its output reduce-scattered;
* **fsdp**: a parameter stored split over the data axes is gathered at
  each use (a layer's inside its remat wrapper, so backward gathers it
  again) and its gradient comes back reduce-scattered.

Every collective sums slot 0 first; one Python thread issues every slot's
work in order (no fan-out threads: the program is one autograd graph whose
backward the collectives' transposes drive), so two runs give the same
bits.  A replicated parameter's gradient on a slot is that slot's share;
the train step sums the shares of each shard (``training/step.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import (
    all_gather,
    all_max,
    all_sum,
    place,
    gather,
    reduce_scatter,
    reduce_to,
    shard_shape,
    spec_axes,
    split_bounds,
)
from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.frontends import apply_frontend
from repro_torch.models.layers import (
    MODEL,
    apply_mlp,
    apply_norm,
    cdtype,
    padded_vocab,
    resolve_specs,
)
from repro_torch.models.transformer import Dist, _remat

__all__ = ["ShardedLM", "data_dim"]

Slots = List[torch.Tensor]


class _Params:
    """One slot's parameters of one module, by attribute (``p.w_q``)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.__dict__.update(tensors)

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__


def data_dim(spec, data_axes) -> Optional[int]:
    """The dimension ``spec`` splits over (some of) the data axes, or None."""
    for i, entry in enumerate(spec or ()):
        axes = spec_axes(entry)
        if axes and set(axes) <= set(data_axes):
            return i
        if set(axes) & set(data_axes):
            raise ValueError(f"spec {spec} mixes the data axes with others in one entry")
    return None


class ShardedLM:
    """``cfg``'s model on ``dist.mesh``: ``params[slot][name]`` is slot's
    shard of parameter ``name`` (a leaf that requires grad) by
    ``specs[name]``; ``shapes[name]`` is the full shape."""

    def __init__(self, cfg, dist: Dist, params: List[Dict[str, torch.Tensor]],
                 specs: Dict[str, tuple], shapes: Dict[str, Tuple[int, ...]]):
        mesh = dist.mesh
        if dist.model_axis != MODEL:
            raise ValueError(f"the specs name the model axis {MODEL!r}, not {dist.model_axis!r}")
        extra = set(mesh.axis_names) - set(dist.data_axes) - {dist.model_axis}
        if extra or dist.tp != mesh.shape.get(dist.model_axis, 1):
            raise ValueError(f"mesh {mesh.shape} is not data axes {dist.data_axes} x "
                             f"{dist.model_axis} = {dist.tp}")
        self.cfg, self.dist, self.mesh = cfg, dist, mesh
        self.params, self.specs, self.shapes = params, specs, shapes
        self.tp = dist.tp
        self.n_rows = mesh.axis_size(dist.data_axes)
        # rows[d][m]: the slot at data index d, model index m
        self.rows = [[0] * self.tp for _ in range(self.n_rows)]
        for s in range(mesh.size):
            m = mesh.coords(s).get(dist.model_axis, 0)
            self.rows[mesh.index_along(s, dist.data_axes)][m] = s
        self.seq = bool(cfg.seq_shard) and self.tp > 1
        self.kv_split = attention.kv_sharded(cfg, self.tp)
        self.n_heads = attention.heads_padded(cfg, self.tp)
        kinds = set(k for pair in cfg.layer_kinds() for k in pair)
        if "moe" in kinds and cfg.n_experts % self.tp:
            raise ValueError(f"{cfg.n_experts} experts do not split over tp={self.tp}")
        if "ssm" in kinds and (cfg.ssm_heads or cfg.ssm_expand * cfg.d_model // 64) % self.tp:
            raise ValueError(f"the SSM's heads do not split over tp={self.tp}")
        self._names: Dict[str, List[str]] = {}
        # each MoE layer's (dropped, routed) assignments summed over the
        # slots in the last forward, as tensors on the lead slot (aux's drop
        # fraction is the reference's mean of the slots' fractions)
        self.moe_counts: List[Tuple[torch.Tensor, torch.Tensor]] = []

    # -- placement ----------------------------------------------------------
    @classmethod
    def place(cls, cfg, dist: Dist, state_dict: Dict[str, torch.Tensor],
              specs: Dict[str, tuple]) -> "ShardedLM":
        """Each slot's shard of ``state_dict`` (full tensors, any device),
        copied to its device."""
        specs = resolve_specs(dict(specs), dist.data_axes)
        per_slot = [dict() for _ in range(dist.mesh.size)]
        shapes = {}
        for name, spec in specs.items():
            full = state_dict[name]
            shapes[name] = tuple(full.shape)
            for s, t in enumerate(place(full.detach(), spec, dist.mesh)):
                per_slot[s][name] = t.requires_grad_(True)
        return cls(cfg, dist, per_slot, specs, shapes)

    def state_dict(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The full parameters (gathered from the shards) on ``device``."""
        with torch.no_grad():
            return {n: gather([p[n] for p in self.params], self.shapes[n], self.specs[n],
                              self.mesh, device) for n in self.specs}

    # -- helpers --------------------------------------------------------------
    def _dev(self, s: int) -> torch.device:
        return self.mesh.devices[s]

    def _row_devs(self, d: int) -> List[torch.device]:
        return [self._dev(s) for s in self.rows[d]]

    def _use(self, module: str) -> List[_Params]:
        """Every slot's parameters under ``module`` (``blocks.3``: its
        ``norm1.scale`` as ``p.norm1.scale``) as used: gathered over the
        data axes where stored split over them (fsdp)."""
        if module not in self._names:
            self._names[module] = [n for n in self.specs if n.startswith(module + ".")]
        out = [dict() for _ in range(self.mesh.size)]

        def put(s, key, t):
            node = out[s]
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t

        for name in self._names[module]:
            key = name[len(module) + 1:]
            dim = data_dim(self.specs[name], self.dist.data_axes)
            if dim is None:
                for s in range(self.mesh.size):
                    put(s, key, self.params[s][name])
                continue
            axes = spec_axes(self.specs[name][dim])
            for group in self.mesh.groups(axes):
                full = all_gather([self.params[s][name] for s in group], dim,
                                  [self._dev(s) for s in group])
                for s, t in zip(group, full):
                    put(s, key, t)

        def ns(node):
            return _Params({k: ns(v) if isinstance(v, dict) else v for k, v in node.items()})

        return [ns(o) for o in out]

    def _by_row(self, fn, xs: Slots) -> Slots:
        """Apply ``fn(parts, devices) -> parts`` to each row's model slots."""
        out = list(xs)
        for d, row in enumerate(self.rows):
            for s, t in zip(row, fn([xs[s] for s in row], self._row_devs(d))):
                out[s] = t
        return out

    def _sum(self, xs: Slots) -> Slots:
        return self._by_row(all_sum, xs)

    def _seq_gather(self, xs: Slots) -> Slots:
        return self._by_row(lambda p, dv: all_gather(p, 1, dv), xs) if self.seq else xs

    def _seq_reduce(self, xs: Slots) -> Slots:
        """The partial sums of a mixer / MLP: summed, and split along the
        sequence under sequence parallelism."""
        if self.seq:
            return self._by_row(lambda p, dv: reduce_scatter(p, 1, dv), xs)
        return self._sum(xs)

    def _seq_split(self, xs: Slots) -> Slots:
        """Each model slot's stretch of the sequence (sequence parallelism)."""
        if not self.seq:
            return xs
        out = list(xs)
        for row in self.rows:
            for m, s in enumerate(row):
                lo, hi = split_bounds(xs[s].shape[1], self.tp, m)
                out[s] = xs[s][:, lo:hi]
        return out

    def _row_slices(self, n: int) -> List[slice]:
        if n % self.n_rows:
            raise ValueError(f"a batch of {n} rows does not split over {self.n_rows} data rows")
        b = n // self.n_rows
        return [slice(d * b, (d + 1) * b) for d in range(self.n_rows)]

    def _to_slots(self, a, dtype) -> List[torch.Tensor]:
        """A batch array split by rows, on each slot's device."""
        t = (a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))).to(dtype)
        return self._place_rows(t, self._row_slices(t.shape[0]))

    def _place_rows(self, t: torch.Tensor, rs: List[slice]) -> List[torch.Tensor]:
        out = [None] * self.mesh.size
        for d, row in enumerate(self.rows):
            for s in row:
                out[s] = t[rs[d]].to(self._dev(s))
        return out

    # -- embedding / logits -------------------------------------------------
    def _embed_tokens(self, tokens: List[torch.Tensor]) -> Slots:
        cfg, dt = self.cfg, cdtype(self.cfg)
        pe = self._use("embed")
        v = padded_vocab(cfg)
        parts = []
        for s in range(self.mesh.size):
            m = self.mesh.coords(s).get(MODEL, 0)
            lo, hi = split_bounds(v, self.tp, m)
            local = tokens[s] - lo
            inside = (local >= 0) & (local < hi - lo)
            rows = F.embedding(local.clamp(0, max(hi - lo - 1, 0)), pe[s].embedding).to(dt)
            parts.append(torch.where(inside[..., None], rows, torch.zeros((), dtype=dt,
                                                                           device=rows.device)))
        xs = self._sum(parts)
        if cfg.emb_scale:
            scale = torch.tensor(np.sqrt(cfg.d_model), dtype=dt).item()
            xs = [x * scale for x in xs]
        return xs

    def _embed(self, batch) -> Slots:
        cfg = self.cfg
        feats = None
        if cfg.frontend != "none":
            feats = self._to_slots(batch["frontend_feats"], torch.float32)
            pf = self._use("frontend")
            feats = [apply_frontend(pf[s], feats[s], cfg) for s in range(self.mesh.size)]
        if cfg.frontend == "audio":
            return feats
        xs = self._embed_tokens(self._to_slots(batch["tokens"], torch.long))
        if cfg.frontend == "vision":
            xs = [torch.cat([f, x], dim=1) for f, x in zip(feats, xs)]
        return xs

    def _logits(self, xs: Slots) -> Slots:
        """Each slot's fp32 logits over its vocabulary columns (softcapped)."""
        cfg, dt = self.cfg, cdtype(self.cfg)
        pe = self._use("embed")
        out = []
        for s in range(self.mesh.size):
            w = pe[s].embedding.to(dt).T if cfg.tie_embeddings else pe[s].unembed.to(dt)
            lg = (xs[s] @ w).float()
            if cfg.logit_softcap:
                lg = torch.tanh(lg / cfg.logit_softcap) * cfg.logit_softcap
            out.append(lg)
        return out

    def _vocab_lo(self, s: int) -> int:
        return split_bounds(padded_vocab(self.cfg), self.tp, self.mesh.coords(s).get(MODEL, 0))[0]

    def _gather_logits(self, lg: Slots) -> torch.Tensor:
        """The full logits [B, S, V_pad] on the lead slot."""
        device = self._dev(0)
        rows = []
        for d, row in enumerate(self.rows):
            full = all_gather([lg[s] for s in row], -1, [device] * self.tp)[0] if self.tp > 1 \
                else lg[row[0]].to(device)
            rows.append(full)
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]

    def _xent(self, lg: Slots, labels: List[torch.Tensor]) -> torch.Tensor:
        """Mean CE over the unmasked tokens of every row, on the lead slot:
        the vocabulary-parallel log-sum-exp (pad columns masked)."""
        cfg = self.cfg
        lead = self._dev(0)
        nll_sums, counts = [], []
        for d, row in enumerate(self.rows):
            devs = self._row_devs(d)
            masked, mx = [], []
            for s in row:
                col = self._vocab_lo(s) + torch.arange(lg[s].shape[-1], device=lg[s].device)
                x = lg[s].masked_fill(col >= cfg.vocab_size, -1e30) \
                    if padded_vocab(cfg) != cfg.vocab_size else lg[s]
                masked.append(x)
                mx.append(x.detach().amax(-1))
            gmax = all_max(mx, devs)
            se = [torch.exp(x - g[..., None]).sum(-1) for x, g in zip(masked, gmax)]
            lab = labels[row[0]]
            ll = []
            for s, x in zip(row, masked):
                local = labels[s].clamp(0, cfg.vocab_size - 1).long() - self._vocab_lo(s)
                inside = (local >= 0) & (local < x.shape[-1])
                got = torch.gather(x, -1, local.clamp(0, max(x.shape[-1] - 1, 0))[..., None])[..., 0]
                ll.append(torch.where(inside, got, torch.zeros((), device=x.device)))
            lse = gmax[0].to(lead) + torch.log(reduce_to(se, lead))
            nll = (lse - reduce_to(ll, lead)) * (lab >= 0).float().to(lead)
            nll_sums.append(nll.sum())
            counts.append((lab >= 0).float().sum().to(lead))
        return reduce_to(nll_sums, lead) / torch.clamp(reduce_to(counts, lead), min=1.0)

    # -- layers ---------------------------------------------------------------
    def _heads(self, s: int) -> Tuple[int, int]:
        m = self.mesh.coords(s).get(MODEL, 0)
        hl = self.n_heads // self.tp
        return m * hl, (m + 1) * hl

    def _attn(self, i: int, ps: List[_Params], hs: Slots, start: int, want_cache: bool):
        cfg = self.cfg
        window = cfg.window if cfg.layer_kinds()[i][0] == "local" else 0
        causal = not cfg.encoder_only
        g = self.n_heads // cfg.n_kv_heads
        ys, caches = [], []
        for s in range(self.mesh.size):
            p, h = ps[s].mixer, hs[s]
            positions = start + torch.arange(h.shape[1], device=h.device)
            q, k, v = attention._qkv(p, h, cfg, positions)
            ku, vu = k, v
            if self.tp > 1 and not self.kv_split:
                h0, h1 = self._heads(s)
                grp = torch.arange(h0, h1, device=h.device) // g
                ku, vu = k.index_select(2, grp), v.index_select(2, grp)
            out = attention.attend(q, ku, vu, cfg, start=start, causal=causal, window=window)
            ys.append(torch.einsum("bshk,hkd->bsd", out, p.w_o.to(cdtype(cfg))))
            if want_cache:
                c = attention.prefill_cache(k, v, window, start)
                if self.tp > 1 and not self.kv_split:
                    lo, hi = split_bounds(c["k"].shape[1], self.tp,
                                          self.mesh.coords(s)[MODEL])
                    c = {n: t[:, lo:hi].contiguous() for n, t in c.items()}
                caches.append(c)
        return ys, caches

    def _mixer(self, i: int, ps: List[_Params], hs: Slots, start: int, want_cache: bool):
        """Each slot's partial mixer output (and its cache / state)."""
        kind = self.cfg.layer_kinds()[i][0]
        if kind in ("global", "local"):
            return self._attn(i, ps, hs, start, want_cache)
        if kind == "rglru":
            outs = [rglru.rglru_forward(ps[s].mixer, hs[s], self.cfg, return_state=True)
                    for s in range(self.mesh.size)]
            return [o[0] for o in outs], [o[1] for o in outs]
        mixed = [ssm.ssm_mix(ps[s].mixer, hs[s], self.cfg) for s in range(self.mesh.size)]
        return self._ssm_out(ps, [m[0] for m in mixed], [m[1] for m in mixed]), \
            [m[2] for m in mixed]

    def _ssm_out(self, ps: List[_Params], ys: Slots, zs: Slots) -> Slots:
        """The SSM's gated norm over the whole d_inner (the sums of squares
        summed over the model slots) and each slot's partial projection."""
        gq = [ssm.gate_sq(y, z) for y, z in zip(ys, zs)]
        sq = self._sum([q for _, q in gq])
        d_inner = self.cfg.ssm_expand * self.cfg.d_model
        return [ssm.gated_out(ps[s].mixer, gq[s][0], sq[s], d_inner, self.cfg)
                for s in range(self.mesh.size)]

    def _moe(self, ps: List[_Params], hs: Slots, reduce):
        """(each slot's MoE output, its partial sums combined by ``reduce``;
        aux f32[3] on the lead slot)."""
        cfg, lead = self.cfg, self._dev(0)
        if self.tp == 1:
            # the reference's MoE at tp = 1 is one computation over the whole
            # batch: the rows' tokens routed together, the capacity global
            full = all_gather(hs, 0, [self._dev(s) for s in range(self.mesh.size)])
            outs = [moe.moe_mlp(ps[s].mlp, full[s], cfg) for s in range(self.mesh.size)]
            rs = self._row_slices(full[0].shape[0])
            ys = [outs[s][0][rs[self.mesh.index_along(s, self.dist.data_axes)]]
                  for s in range(self.mesh.size)]
            a = outs[0][1]
            n_routed = full[0].shape[0] * full[0].shape[1] * cfg.moe_top_k
            self.moe_counts.append((torch.round(a.drop_frac.detach() * n_routed).to(lead),
                                    torch.tensor(n_routed, device=lead)))
            return ys, torch.stack([a.load_balance, a.z_loss, a.drop_frac]).to(lead)
        e_local = cfg.n_experts // self.tp
        routed, shared, lbs, zs, drops = [], [], [], [], []
        dropped, assigned = [], []
        for s in range(self.mesh.size):
            h = hs[s]
            x2 = h.reshape(-1, h.shape[-1])
            m = self.mesh.coords(s)[MODEL]
            y, probs, topi, drop = moe._dispatch_compute_combine(ps[s].mlp, x2, cfg,
                                                                 m * e_local, e_local)
            routed.append(y.reshape(h.shape))
            if cfg.n_shared_experts:
                shared.append(moe._shared_expert(ps[s].mlp, x2, cfg).reshape(h.shape))
            if m == 0:   # the router's statistics are the same on every model slot
                lb, z = moe._aux_losses(probs, topi, cfg)
                lbs.append(lb.to(lead))
                zs.append(z.to(lead))
            drops.append(drop.to(lead))
            with torch.no_grad():
                mine = ((topi >= m * e_local) & (topi < (m + 1) * e_local)).sum()
                dropped.append(torch.round(drop * mine).to(lead))
                assigned.append(mine.to(lead))
        self.moe_counts.append((sum(dropped), sum(assigned)))
        ys = reduce(routed)
        if shared:
            ys = [a + b for a, b in zip(ys, reduce(shared))]
        aux = torch.stack([reduce_to(lbs, lead) / self.n_rows, reduce_to(zs, lead) / self.n_rows,
                           reduce_to(drops, lead) / self.mesh.size])
        return ys, aux

    def _layer(self, i: int, xs: Slots, start: int, want_cache: bool):
        """One block over every slot: (xs, aux f32[3] or None, caches)."""
        cfg = self.cfg
        mlp_kind = cfg.layer_kinds()[i][1]
        ps = self._use(f"blocks.{i}")
        n = self.mesh.size
        hs = self._seq_gather([apply_norm(ps[s].norm1, xs[s], cfg) for s in range(n)])
        ys, caches = self._mixer(i, ps, hs, start, want_cache)
        ys = self._seq_reduce(ys)
        if cfg.post_norm:
            ys = [apply_norm(ps[s].norm1_post, ys[s], cfg) for s in range(n)]
        xs = [x + y for x, y in zip(xs, ys)]
        aux = None
        if mlp_kind != "none":
            hs = self._seq_gather([apply_norm(ps[s].norm2, xs[s], cfg) for s in range(n)])
            if mlp_kind == "dense":
                ys = self._seq_reduce([apply_mlp(ps[s].mlp, hs[s], cfg) for s in range(n)])
            else:
                ys, aux = self._moe(ps, hs, self._seq_reduce)
            if cfg.post_norm:
                ys = [apply_norm(ps[s].norm2_post, ys[s], cfg) for s in range(n)]
            xs = [x + y for x, y in zip(xs, ys)]
        return xs, aux, caches

    def _stack(self, xs: Slots, start: int = 0):
        """The blocks: (xs, aux f32[3] on the lead slot), each cycle of the
        layer pattern under ``cfg.remat``."""
        cfg, lead = self.cfg, self._dev(0)
        self.moe_counts = []
        gs, ng = cfg.group_size(), cfg.n_groups()
        aux = torch.zeros((3,), dtype=torch.float32, device=lead)

        def layers(ids, *flat):
            h, a = list(flat), torch.zeros((3,), dtype=torch.float32, device=lead)
            for i in ids:
                h, la, _ = self._layer(i, h, start, False)
                if la is not None:
                    a = a + la
            return (*h, a)

        for gi in range(ng):
            ids = range(gi * gs, (gi + 1) * gs)
            out = _remat(lambda *f, ids=ids: layers(ids, *f), cfg)(*xs)
            xs, aux = list(out[:-1]), aux + out[-1]
        out = layers(range(ng * gs, cfg.n_layers), *xs)
        return list(out[:-1]), aux + out[-1]

    def _final(self, xs: Slots) -> Slots:
        pn = self._use("final_norm")
        return [apply_norm(pn[s], xs[s], self.cfg) for s in range(self.mesh.size)]

    # -- public: the reference's LanguageModel methods under ``dist`` -----------
    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits f32[B, S, V_pad] gathered on the lead slot, aux f32[3])."""
        xs, aux = self._stack(self._seq_split(self._embed(batch)))
        xs = self._seq_gather(self._final(xs))
        return self._gather_logits(self._logits(xs)), aux

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean CE + the MoE terms, metrics), on the lead slot."""
        cfg = self.cfg
        xs, aux = self._stack(self._seq_split(self._embed(batch)))
        xs = self._seq_gather(self._final(xs))
        labels = batch["labels"]
        labels = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(
            np.asarray(labels))
        if cfg.frontend == "vision":
            labels = torch.cat([labels.new_full((labels.shape[0], cfg.frontend_tokens), -1),
                                labels], dim=1)
        ce = self._xent(self._logits(xs), self._to_slots(labels, torch.long))
        total, metrics = ce, {"ce": ce}
        if cfg.n_experts:
            total = total + cfg.moe_aux_coef * aux[0] + cfg.moe_z_coef * aux[1]
            metrics.update(moe_load_balance=aux[0], moe_z=aux[1], moe_drop=aux[2])
        metrics["loss"] = total
        return total, metrics

    @torch.no_grad()
    def prefill(self, batch):
        """(last-position logits f32[B, 1, V_pad] on the lead slot, caches):
        ``caches[layer][slot]`` is the slot's shard of the layer's
        decode-layout cache (``cache_specs``) or recurrent state."""
        xs = self._seq_split(self._embed(batch))
        caches = []
        for i in range(self.cfg.n_layers):
            xs, _, c = self._layer(i, xs, 0, True)
            caches.append(c)
        xs = [x[:, -1:] for x in self._seq_gather(xs)]
        lg = self._logits(self._final(xs))
        return self._gather_logits(lg), caches

    def cache_specs(self, i: int) -> Dict[str, tuple]:
        """Layer ``i``'s cache specs, the data axes resolved."""
        kind = self.cfg.layer_kinds()[i][0]
        if kind in ("global", "local"):
            sp = attention.cache_specs(self.cfg, self.tp)
        elif kind == "rglru":
            sp = rglru.rglru_state_specs(self.cfg)
        else:
            sp = ssm.ssm_state_specs(self.cfg)
        return resolve_specs(sp, self.dist.data_axes)

    def init_cache(self, batch: int, max_len: int) -> List[List[Dict[str, torch.Tensor]]]:
        """Zero caches, each slot's shard allocated on its slot alone."""
        out = []
        for i, (kind, _) in enumerate(self.cfg.layer_kinds()):
            meta = torch.device("meta")
            if kind in ("global", "local"):
                full = attention.make_cache(self.cfg, batch, max_len,
                                            self.cfg.window if kind == "local" else 0, meta)
            elif kind == "rglru":
                full = rglru.make_rglru_state(self.cfg, batch, meta)
            else:
                full = ssm.make_ssm_state(self.cfg, batch, meta)
            specs = self.cache_specs(i)
            out.append([{n: torch.zeros(shard_shape(t.shape, specs[n], self.mesh, s),
                                        dtype=t.dtype, device=self._dev(s))
                         for n, t in full.items()} for s in range(self.mesh.size)])
        return out

    def grow_cache(self, caches, max_len: int):
        """Pad prefill-emitted caches to decode capacity (``grow_cache``);
        a cache split along its length is gathered, padded and split again."""
        out = []
        for (kind, _), layer in zip(self.cfg.layer_kinds(), caches):
            if kind not in ("global", "local"):
                out.append(layer)
                continue
            tgt = min(self.cfg.window, max_len) if kind == "local" else max_len
            new = list(layer)
            if self.tp > 1 and not self.kv_split:
                for row in self.rows:
                    for name in layer[row[0]]:
                        full = torch.cat([layer[s][name] for s in row], dim=1)
                        full = F.pad(full, (0, 0, 0, 0, 0, max(tgt - full.shape[1], 0)))
                        for m, s in enumerate(row):
                            lo, hi = split_bounds(full.shape[1], self.tp, m)
                            new[s] = dict(new[s]) if new[s] is layer[s] else new[s]
                            new[s][name] = full[:, lo:hi].contiguous()
            else:
                new = [{n: F.pad(t, (0, 0, 0, 0, 0, max(tgt - t.shape[1], 0)))
                        for n, t in c.items()} for c in layer]
            out.append(new)
        return out

    @torch.no_grad()
    def decode_step(self, batch, caches):
        """One token per row: (logits f32[B, 1, V_pad] on the lead slot,
        caches written in place)."""
        cfg = self.cfg
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only; no decode step")
        tokens = torch.as_tensor(np.asarray(batch["tokens"])) if not isinstance(
            batch["tokens"], torch.Tensor) else batch["tokens"]
        b = tokens.shape[0]
        rs = self._row_slices(b)
        pos = batch["pos"]
        pos = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(np.asarray(pos))
        pos = pos.long().reshape(-1).expand(b) if pos.dim() == 0 else pos.long()
        pos_s = self._place_rows(pos, rs)
        act = batch.get("active")
        act_s = None
        if act is not None:
            act = act if isinstance(act, torch.Tensor) else torch.as_tensor(np.asarray(act))
            act_s = [torch.nonzero(a.bool()).reshape(-1) for a in self._place_rows(act, rs)]
        xs = self._embed_tokens(self._place_rows(tokens.long(), rs))
        n = self.mesh.size
        for i, (kind, mlp_kind) in enumerate(cfg.layer_kinds()):
            ps = self._use(f"blocks.{i}")
            hs = [apply_norm(ps[s].norm1, xs[s], cfg) for s in range(n)]
            if kind in ("global", "local"):
                window = cfg.window if kind == "local" else 0
                if self.tp > 1 and not self.kv_split:
                    ys = self._decode_split(ps, hs, caches[i], pos_s, act_s, window)
                else:
                    ys = [attention.attn_decode(ps[s].mixer, hs[s], caches[i][s], pos_s[s], cfg,
                                                layer_window=window,
                                                active=None if act_s is None else act_s[s])[0]
                          for s in range(n)]
            elif kind == "rglru":
                ys = [rglru.rglru_decode(ps[s].mixer, hs[s], caches[i][s], cfg,
                                         active=None if act_s is None else act_s[s])[0]
                      for s in range(n)]
            else:
                mixed = [ssm.ssm_decode_mix(ps[s].mixer, hs[s], caches[i][s], cfg,
                                            active=None if act_s is None else act_s[s])
                         for s in range(n)]
                ys = self._ssm_out(ps, [m[0] for m in mixed], [m[1] for m in mixed])
            ys = self._sum(ys)
            if cfg.post_norm:
                ys = [apply_norm(ps[s].norm1_post, ys[s], cfg) for s in range(n)]
            xs = [x + y for x, y in zip(xs, ys)]
            if mlp_kind != "none":
                hs = [apply_norm(ps[s].norm2, xs[s], cfg) for s in range(n)]
                if mlp_kind == "dense":
                    ys = self._sum([apply_mlp(ps[s].mlp, hs[s], cfg) for s in range(n)])
                else:
                    ys, _ = self._moe(ps, hs, self._sum)
                if cfg.post_norm:
                    ys = [apply_norm(ps[s].norm2_post, ys[s], cfg) for s in range(n)]
                xs = [x + y for x, y in zip(xs, ys)]
        lg = self._logits(self._final(xs))
        return self._gather_logits(lg), caches

    def _decode_split(self, ps, hs, caches, pos_s, act_s, window) -> Slots:
        """Attention of one token against a cache split along its length
        over the model slots: each slot writes the tokens whose cache slot
        it holds, scores every (gathered) query head against its stretch,
        and the softmax is taken over the slots: the max, then the sum of
        exp, then the probability-weighted values (rounded to the cache's
        dtype, as the one-slot softmax is) summed.  Returns each slot's
        partial output projection."""
        cfg, dt = self.cfg, cdtype(self.cfg)
        kv, dh = cfg.n_kv_heads, cfg.d_head
        g = self.n_heads // kv
        ys = [None] * self.mesh.size
        for d, row in enumerate(self.rows):
            devs = self._row_devs(d)
            length = sum(caches[s]["k"].shape[1] for s in row)
            qs, spans, lo = [], [], 0
            for s in row:
                p, h, c, pos_b = ps[s].mixer, hs[s], caches[s], pos_s[s]
                q, k_new, v_new = attention._qkv(p, h, cfg, pos_b[:, None])
                qs.append(q)
                hi = lo + c["k"].shape[1]
                spans.append((lo, hi))
                slot = attention.decode_slots(pos_b, length, window)
                rows = torch.arange(h.shape[0], device=h.device) if act_s is None else act_s[s]
                if hi > lo:   # the rows whose slot is in this stretch (by value)
                    at = slot[rows]
                    attention.write_cache_where(c, rows, (at - lo).clamp(0, hi - lo - 1),
                                                (at >= lo) & (at < hi), k_new, v_new, cfg)
                lo = hi
            qf = all_gather(qs, 2, devs)
            scores, maxes, values = [], [], []
            for (lo, hi), s, q in zip(spans, row, qf):
                b = q.shape[0]
                ck, cv = attention.cache_values(caches[s], cfg)
                sc = attention._block_scores(q.reshape(b, 1, kv, g, dh), ck, cfg)[..., 0, :]
                idx = torch.arange(lo, hi, device=sc.device)
                sc.masked_fill_(~attention.valid_slots(pos_s[s], idx, length, window)[:, None, None],
                                attention.NEG_INF)
                scores.append(sc)
                values.append(cv)
                maxes.append(sc.amax(-1) if hi > lo else
                             torch.full(sc.shape[:-1], attention.NEG_INF, device=sc.device))
            gmax = all_max(maxes, devs)
            ex = [torch.exp(sc - m[..., None]) for sc, m in zip(scores, gmax)]
            tot = all_sum([e.sum(-1) for e in ex], devs)
            parts = [torch.einsum("bhgk,bkhd->bhgd", (e / t[..., None]).to(cv.dtype).float(),
                                  cv.float()) for e, t, cv in zip(ex, tot, values)]
            outs = all_sum(parts, devs)
            for s, out in zip(row, outs):
                b = out.shape[0]
                h0, h1 = self._heads(s)
                o = out.to(hs[s].dtype).reshape(b, 1, self.n_heads, dh)[:, :, h0:h1]
                ys[s] = torch.einsum("bshk,hkd->bsd", o, ps[s].mixer.w_o.to(dt))
        return ys
