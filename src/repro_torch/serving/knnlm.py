"""kNN-LM: the buffer k-d tree as the datastore of a language model.

Counterpart of ``repro.serving.knnlm``.  A datastore of (context key ->
next token) pairs is indexed with ``KNNIndex``; at serve time the LM's
next-token distribution is interpolated with a kNN distribution over the
retrieved neighbours:

    p(y|x) = (1 - lam) * p_LM(y|x) + lam * p_kNN(y|x)
    p_kNN(y) ∝ Σ_{(c_i, y_i) in kNN(f(x))} 1[y_i = y] * exp(-d(f(x), c_i)/T)

The key f(x) is the LM's final-norm hidden state projected to ``proj_dim``
(16 by default, inside the k-d tree's range) by a fixed column-orthonormal
matrix: numpy's ``default_rng(seed).normal`` then ``np.linalg.qr``, the
reference's bit for bit.  So every datastore query runs the narrow
leaf-scan kernel.  The projection runs on the LM's device in fp32.

Hidden states are computed ``EMBED_TOKENS`` tokens at a time (whole
sequences), so a corpus of any size embeds within device memory.
``next_token_probs`` runs the block stack once and unembeds only each
sequence's last position (the reference unembeds every position, then
keeps the last, and runs the stack a second time for the key).

``serve()`` puts retrieval behind a ``KNNServer`` (a ``streaming`` or
``dynamic`` index); ``mutable=True`` plans the ``dynamic`` engine, whose
``extend_datastore`` appends pairs without a rebuild; ``save_datastore`` /
``load_datastore`` snapshot the index and the value array in one version.
When the ``IndexSpec`` names no devices, the index goes on the LM's device.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import IndexSpec, KNNIndex
from repro_torch.models.model import LanguageModel

__all__ = ["KNNLM", "EMBED_TOKENS"]

# tokens per forward pass when embedding (whole sequences; at least one):
# at S = 2048, 8 sequences, whose fp32 attention scores at 16 heads take 2 GiB
EMBED_TOKENS = 2 ** 14


class KNNLM:
    def __init__(
        self,
        lm: LanguageModel,
        params=None,
        *,
        proj_dim: int = 16,
        k: int = 10,
        lam: float = 0.25,
        temperature: float = 1.0,
        tree_height: Optional[int] = None,
        n_chunks: Optional[int] = None,
        index_spec: Optional[IndexSpec] = None,
        mutable: bool = False,
        seed: int = 0,
    ):
        """``params``: None (``lm``'s own weights) or a state dict loaded
        into ``lm`` (``LanguageModel.bind``)."""
        self.lm = lm.bind(params)
        self.k = k
        self.lam = lam
        self.temp = temperature
        self.proj_dim = proj_dim
        spec = index_spec or IndexSpec()
        overrides = {"k_hint": k}
        if tree_height is not None:
            overrides["height"] = tree_height
        if n_chunks is not None:
            overrides["n_chunks"] = n_chunks
        if mutable:
            overrides["mutable"] = True
        if spec.devices is None:
            overrides["devices"] = (lm.device,)
        self.index_spec = spec.replace(**overrides)
        rng = np.random.default_rng(seed)
        w = rng.normal(size=(lm.cfg.d_model, proj_dim)).astype(np.float32)
        q, _ = np.linalg.qr(w)   # column-orthonormal: distance-friendlier
        self.proj = q.astype(np.float32)
        self._proj_t = torch.from_numpy(self.proj).to(lm.device)
        self.index: Optional[KNNIndex] = None
        self.values: Optional[np.ndarray] = None
        self._server = None          # KNNServer while serve() is active

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _hidden(self, tokens: np.ndarray) -> Iterator[Tuple[slice, torch.Tensor]]:
        """(rows, final-norm hidden states [rows, S, D]) for batches of whole
        sequences of about ``EMBED_TOKENS`` tokens."""
        tokens = np.asarray(tokens)
        step = max(1, EMBED_TOKENS // max(1, tokens.shape[1]))
        for r0 in range(0, tokens.shape[0], step):
            rows = slice(r0, min(r0 + step, tokens.shape[0]))
            yield rows, self.lm.hidden_states(tokens[rows])

    def _project(self, h: torch.Tensor) -> np.ndarray:
        return (h.float().reshape(-1, h.shape[-1]) @ self._proj_t).cpu().numpy()

    def embed_contexts(self, tokens: np.ndarray) -> np.ndarray:
        """tokens int[B, S] -> projected keys f32[B*S, proj_dim]."""
        b, s = np.asarray(tokens).shape
        keys = np.empty((b * s, self.proj_dim), np.float32)
        for rows, h in self._hidden(tokens):
            keys[rows.start * s: rows.stop * s] = self._project(h)
        return keys

    # ------------------------------------------------------------------
    def build_datastore(self, tokens: np.ndarray) -> None:
        """Index every (context prefix -> next token) pair of a corpus.
        tokens: int[B, S+1]; key = hidden state at t, value = token t+1."""
        ctx, nxt = tokens[:, :-1], tokens[:, 1:]
        keys = self.embed_contexts(ctx)
        self.values = nxt.reshape(-1).astype(np.int64)
        self.index = KNNIndex.build(keys, spec=self.index_spec)

    def extend_datastore(self, tokens: np.ndarray) -> np.ndarray:
        """Append a corpus slice (the ``build_datastore`` layout) without a
        rebuild; returns the assigned key ids.  The first call builds; later
        ones insert, which needs a mutable index (``mutable=True``),
        otherwise ``KNNIndex.insert`` raises ``MutabilityError``."""
        if self.index is None:
            self.build_datastore(tokens)
            return np.arange(self.values.shape[0], dtype=np.int64)
        ctx, nxt = tokens[:, :-1], tokens[:, 1:]
        ids = self.index.insert(self.embed_contexts(ctx))
        # ids are insertion-ordered: the values extend in lockstep
        self.values = np.concatenate([self.values, nxt.reshape(-1).astype(np.int64)])
        return ids

    def serve(self, *, max_batch: int = 64, default_deadline_ms: float = 50.0,
              calibration=None, **server_kw):
        """Put retrieval behind an online ``KNNServer`` and return it: each
        query row of ``next_token_probs`` becomes a request, micro-batched
        with all other in-flight requests.  The index must be ``streaming``
        or ``dynamic`` (else ``StreamingUnsupported``); ``unserve()`` goes
        back to direct batch queries."""
        from repro_torch.serving.knn_server import KNNServer

        if self.index is None:
            raise RuntimeError("no datastore to serve: call build_datastore")
        self._server = KNNServer(
            self.index, k=self.k, max_batch=max_batch,
            default_deadline_ms=default_deadline_ms,
            calibration=calibration, **server_kw,
        )
        return self._server

    def unserve(self) -> None:
        """Detach and close the server; retrieval reverts to ``index.query``."""
        if self._server is not None:
            self._server.close()
            self._server = None

    def _retrieve(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """kNN of the query rows, through the server when one is attached.
        A bounded server may shed under overload (``Overloaded``): back off
        for its own wait estimate and retry, at most 20 times."""
        if self._server is None:
            dists, idx = self.index.query(q, k=self.k)
            return dists, idx
        from repro_torch.serving.knn_server import Overloaded

        tickets = []
        for row in q:
            for _attempt in range(20):
                try:
                    tickets.append(self._server.submit(row))
                    break
                except Overloaded as e:
                    time.sleep(min(max(e.est_wait_s, 0.001), 0.25))
            else:
                raise Overloaded("kNN server stayed overloaded through 20 backoff "
                                 "retries; shed this decode step")
        pairs = [t.result(timeout=60.0) for t in tickets]
        return np.stack([d for d, _ in pairs]), np.stack([i for _, i in pairs])

    def drain_index(self, timeout=None) -> None:
        """Wait for background index maintenance (the dynamic engine's
        merges).  Retrieval is exact without it."""
        if self.index is not None:
            self.index.drain(timeout)

    # ------------------------------------------------------------------
    def save_datastore(self, path: Optional[str] = None) -> int:
        """Snapshot the index and the value array in one version
        (``path=None``: the index's persist dir); returns the version."""
        if self.index is None or self.values is None:
            raise RuntimeError("no datastore to save: call build_datastore")
        self.drain_index()
        return self.index.save(path, extra_arrays={"values": self.values})

    def load_datastore(self, path: str, *, devices=None) -> None:
        """Restore a ``save_datastore`` snapshot (plus its WAL tail) onto
        ``devices`` (default: the LM's device).  Keys replayed from the WAL
        past the saved value array are refused, not served with wrong
        tokens."""
        self.index = KNNIndex.load(path, devices=devices or (self.lm.device,))
        values = self.index._extra_arrays.get("values")
        if values is None:
            raise RuntimeError(f"{path!r} holds no kNN-LM value array: it was not "
                               "written by save_datastore")
        self.values = np.asarray(values, np.int64)
        live = getattr(self.index._state, "live_ids", None)
        if callable(live):
            ids = live()                    # sorted i64
            max_id = int(ids[-1]) if ids.size else -1
        else:
            max_id = self.index.n - 1       # immutable: ids are 0..n-1
        if max_id >= self.values.shape[0]:
            raise RuntimeError(
                f"datastore values predate the index's WAL tail (max key id {max_id} "
                f">= {self.values.shape[0]} values): call save_datastore after "
                "extend_datastore, or rebuild")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def next_token_probs(self, tokens: np.ndarray) -> np.ndarray:
        """Interpolated next-token distribution at each sequence's last
        position.  tokens: int[B, S] -> f32[B, vocab]."""
        if self.index is None:
            raise RuntimeError("call build_datastore first")
        vocab = self.lm.cfg.vocab_size
        b = np.asarray(tokens).shape[0]
        p_lm = np.empty((b, vocab), np.float32)
        q = np.empty((b, self.proj_dim), np.float32)
        for rows, h in self._hidden(tokens):
            last = h[:, -1:]
            logits = self.lm.unembed(last)[:, 0, :vocab]
            p_lm[rows] = torch.softmax(logits, dim=-1).cpu().numpy()
            q[rows] = self._project(last)
        dists, idx = self._retrieve(q)

        p_knn = np.zeros_like(p_lm)
        w = np.exp(-dists / self.temp)                     # [B, k]
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
        vals = self.values[idx]                            # [B, k]
        for r in range(b):
            np.add.at(p_knn[r], vals[r], w[r])
        return (1 - self.lam) * p_lm + self.lam * p_knn
