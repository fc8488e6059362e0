"""repro_torch's LM serving path (``TokenPipeline``, ``KNNLM``,
``ServeEngine``, ``launch/serve.py``) vs the JAX reference, on the CPU.

Mirrors ``tests/test_serving_knnlm.py``.  Both packages get the same
weights (``params_from_reference``, the qwen15_0_5b smoke config in fp32,
so that the LMs agree within 1e-4; seeded noise on the QKV biases and norm
scales) and the same seeded corpora.  What is
compared, and how closely:

* token batches and the kNN-LM projection: bit for bit;
* keys (``embed_contexts``): rtol = atol = 1e-4;
* retrieval: distances within rtol 1e-5 of the port's ``knn_brute``, ids
  equal up to ties;
* ``next_token_probs``: within 1e-4 of the reference's on rows whose
  retrieved ids agree; where they differ, the differing neighbours' keys
  tie (their distances within 1e-4);
* greedy decoding: every token the port's engine emits is within 1e-3 of
  the row's largest logit when its prompt and emitted tokens are replayed
  through the reference's decode step (robust to near-ties of argmax).

The served path runs with a 5 s deadline, not the reference test's 25 ms
(a timing flake under load, ROADMAP Queue 3), and batches of exactly the
requests sent, so each batch closes full, not at its deadline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models.model import LanguageModel as RefLM
from repro.serving.knnlm import KNNLM as RefKNNLM
from repro_torch.api import IndexSpec, MutabilityError, StreamingUnsupported, knn_brute
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import LanguageModel, params_from_reference
from repro_torch.serving import KNNLM, Request, ServeEngine, knnlm

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed(params, seed=0):
    """Seeded noise (0.1 * N(0, 1)) on the QKV biases and norm scales, which
    the reference initialises to 0 and 1, so that both paths are compared."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in ("b_q", "b_k", "b_v", "scale", "bias"):
            return leaf + jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def models():
    """(reference lm, reference params, port lm): qwen15_0_5b smoke, fp32."""
    rcfg = ref_config("qwen15_0_5b", smoke=True).replace(dtype="float32")
    cfg = get_config("qwen15_0_5b", smoke=True).replace(dtype="float32")
    rlm = RefLM(rcfg)
    params = _perturbed(rlm.init(jax.random.key(0))[0])
    lm = LanguageModel(cfg, device=CPU)
    lm.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), cfg))
    return rlm, params, lm


@pytest.fixture(scope="module")
def bf16_lm():
    return LanguageModel(get_config("qwen15_0_5b", smoke=True), device=CPU,
                         generator=torch.Generator().manual_seed(1))


def _corpus(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(
        np.int32)


# --------------------------------------------------------------------------
# TokenPipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,shards,step", [
    (512, 33, 8, 0, 1, 0), (1000, 17, 12, 3, 3, 5), (151936, 64, 4, 1, 2, 2)])
def test_token_pipeline_batches_equal_the_reference(vocab, seq, batch, seed, shards, step):
    ours = TokenPipeline(vocab, seq, batch, seed=seed, n_shards=shards)
    ref = RefTokenPipeline(vocab, seq, batch, seed=seed, n_shards=shards)
    np.testing.assert_array_equal(ours.table, ref.table)
    a, b = ours.global_batch_at(step), ref.global_batch_at(step)
    assert set(a) == set(b) == {"tokens", "labels"}
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == (batch, seq)
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(ours.shard_batch(step, shards - 1)["tokens"],
                                  ref.shard_batch(step, shards - 1)["tokens"])
    assert TokenPipeline.state_for(step) == RefTokenPipeline.state_for(step)
    with pytest.raises(ValueError):
        TokenPipeline(vocab, seq, 5, n_shards=2)


# --------------------------------------------------------------------------
# KNNLM against the reference
# --------------------------------------------------------------------------
def _pair_knnlm(models, **kw):
    rlm, params, lm = models
    return RefKNNLM(rlm, params, **kw), KNNLM(lm, **kw)


def test_projection_equals_the_reference_bit_for_bit(models):
    for proj_dim, seed in ((8, 0), (16, 3)):
        ref, ours = _pair_knnlm(models, proj_dim=proj_dim, seed=seed)
        assert ours.proj.dtype == np.float32
        np.testing.assert_array_equal(ours.proj, ref.proj)


def test_index_goes_on_the_lms_device(models):
    _, _, lm = models
    assert KNNLM(lm).index_spec.devices == (CPU,)
    spec = IndexSpec(devices=(CPU, CPU))
    assert KNNLM(lm, index_spec=spec).index_spec.devices == (CPU, CPU)
    assert KNNLM(lm, k=7).index_spec.k_hint == 7


def test_keys_match_the_reference_in_every_batching(models, monkeypatch):
    ref, ours = _pair_knnlm(models, proj_dim=8)
    toks = _corpus(ours.lm.cfg, (5, 32), seed=11)
    want = ref.embed_contexts(toks)
    got = ours.embed_contexts(toks)
    assert got.shape == want.shape == (5 * 32, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    monkeypatch.setattr(knnlm, "EMBED_TOKENS", 70)   # two sequences a pass, the last alone
    np.testing.assert_allclose(ours.embed_contexts(toks), got, rtol=1e-6, atol=1e-6)


def _check_exact(knn, keys, q, k):
    dd, di = knn.index.query(q, k=k)
    bd, bi = knn_brute(q, keys, k, device=CPU)
    np.testing.assert_allclose(dd, bd, rtol=1e-5, atol=1e-6)
    d_of = np.sqrt(((q[:, None, :] - keys[di]) ** 2).sum(-1))
    np.testing.assert_allclose(d_of, bd, rtol=1e-5, atol=1e-5)   # ids equal up to ties


def test_retrieval_is_exact(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=5, tree_height=3)
    corpus = _corpus(lm.cfg, (8, 33), seed=1)
    knn.build_datastore(corpus)
    keys = knn.embed_contexts(corpus[:, :-1])
    assert knn.index.n == keys.shape[0] == knn.values.shape[0] == 8 * 32
    np.testing.assert_array_equal(knn.values, corpus[:, 1:].reshape(-1))
    _check_exact(knn, keys, keys[:64], 5)
    _check_exact(knn, keys, knn.embed_contexts(_corpus(lm.cfg, (2, 9), seed=2)), 5)


def _assert_probs_match(ref_knn, knn, toks):
    """next_token_probs of both packages: equal within 1e-4 where the
    retrieved ids agree; elsewhere the differing neighbours tie."""
    p_ref, p = ref_knn.next_token_probs(toks), knn.next_token_probs(toks)
    assert p.shape == p_ref.shape == (toks.shape[0], knn.lm.cfg.vocab_size)
    q_ref = ref_knn.embed_contexts(toks)[toks.shape[1] - 1:: toks.shape[1]]
    q = knn.embed_contexts(toks)[toks.shape[1] - 1:: toks.shape[1]]
    rd, ri = ref_knn.index.query(q_ref, k=knn.k)
    dd, di = knn.index.query(q, k=knn.k)
    np.testing.assert_allclose(dd, rd, **TOL)
    same = (np.sort(di, 1) == np.sort(ri, 1)).all(1)
    assert same.sum() >= 1
    np.testing.assert_allclose(p[same], p_ref[same], **TOL)
    for r in np.nonzero(~same)[0]:
        off = di[r] != ri[r]
        np.testing.assert_allclose(dd[r][off], rd[r][off], **TOL)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-3)
    assert (p >= 0).all()
    return p


@pytest.mark.parametrize("lam", [0.3, 1.0])
def test_next_token_probs_match_the_reference(models, lam):
    ref_knn, knn = _pair_knnlm(models, proj_dim=8, k=5, lam=lam, tree_height=3)
    corpus = _corpus(knn.lm.cfg, (8, 33), seed=0)
    ref_knn.build_datastore(corpus)
    knn.build_datastore(corpus)
    _assert_probs_match(ref_knn, knn, corpus[:4, :16])
    _assert_probs_match(ref_knn, knn, _corpus(knn.lm.cfg, (3, 7), seed=9))


def test_lam_zero_equals_the_lm(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=3, lam=0.0, tree_height=3)
    corpus = _corpus(lm.cfg, (4, 17), seed=2)
    knn.build_datastore(corpus)
    q = corpus[:2, :8]
    with torch.no_grad():
        logits, _ = lm({"tokens": q})
    p_lm = torch.softmax(logits[:, -1, : lm.cfg.vocab_size], -1).numpy()
    np.testing.assert_allclose(knn.next_token_probs(q), p_lm, rtol=1e-5, atol=1e-6)
    # and prefill's last-position logits give the same distribution
    last, _ = lm.prefill({"tokens": q})
    np.testing.assert_allclose(
        torch.softmax(last[:, 0, : lm.cfg.vocab_size], -1).numpy(), p_lm,
        rtol=1e-5, atol=1e-6)


def test_next_token_probs_runs_the_stack_once_and_unembeds_the_last_position(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=3, tree_height=3)
    knn.build_datastore(_corpus(lm.cfg, (4, 17), seed=3))
    seen = {"stack": 0, "unembed": []}
    stack, unembed = lm.hidden_states, lm.unembed

    def counted_stack(tokens):
        seen["stack"] += 1
        return stack(tokens)

    def counted_unembed(h):
        seen["unembed"].append(tuple(h.shape))
        return unembed(h)

    lm.hidden_states, lm.unembed = counted_stack, counted_unembed
    try:
        knn.next_token_probs(_corpus(lm.cfg, (3, 12), seed=4))
    finally:
        del lm.hidden_states, lm.unembed
    assert seen == {"stack": 1, "unembed": [(3, 1, lm.cfg.d_model)]}


def test_mutable_datastore_extends_incrementally(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=5, mutable=True)
    corpus = _corpus(lm.cfg, (6, 25), seed=3)
    knn.build_datastore(corpus)
    assert knn.index.engine_name == "dynamic"
    n0 = knn.values.shape[0]
    extra = _corpus(lm.cfg, (4, 25), seed=4)
    ids = knn.extend_datastore(extra)
    assert ids.tolist() == list(range(n0, n0 + 4 * 24))
    assert knn.values.shape[0] == knn.index.n == n0 + 4 * 24
    keys = np.concatenate([knn.embed_contexts(corpus[:, :-1]),
                           knn.embed_contexts(extra[:, :-1])])
    _check_exact(knn, keys, keys[::7], 5)
    p = knn.next_token_probs(extra[:2, :8])
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-3)

    # the first extend of an empty store builds it
    fresh = KNNLM(lm, proj_dim=8, k=3, mutable=True)
    assert fresh.extend_datastore(corpus).tolist() == list(range(6 * 24))
    # an immutable store refuses to grow, loudly and typed
    frozen = KNNLM(lm, proj_dim=8, k=3, tree_height=3)
    frozen.build_datastore(corpus)
    with pytest.raises(MutabilityError):
        frozen.extend_datastore(extra)


def test_datastore_save_load_roundtrip(models, tmp_path):
    _, _, lm = models
    root = str(tmp_path / "store")
    knn = KNNLM(lm, proj_dim=8, k=5, mutable=True, index_spec=IndexSpec(persist_dir=root))
    knn.build_datastore(_corpus(lm.cfg, (6, 25), seed=5))
    knn.save_datastore()
    knn.extend_datastore(_corpus(lm.cfg, (3, 25), seed=6))
    knn.save_datastore()   # values stay in lockstep with the WAL
    q = _corpus(lm.cfg, (3, 10), seed=7)
    p0 = knn.next_token_probs(q)

    knn2 = KNNLM(lm, proj_dim=8, k=5, mutable=True)
    knn2.load_datastore(root)
    np.testing.assert_array_equal(knn2.values, knn.values)
    assert knn2.index.n == knn.index.n
    np.testing.assert_array_equal(knn2.next_token_probs(q), p0)
    knn2.extend_datastore(_corpus(lm.cfg, (2, 25), seed=8))
    assert knn2.index.n == knn2.values.shape[0]

    # an immutable store exported to a directory
    frozen = KNNLM(lm, proj_dim=8, k=5, tree_height=3)
    frozen.build_datastore(_corpus(lm.cfg, (4, 17), seed=9))
    frozen.save_datastore(str(tmp_path / "frozen"))
    back = KNNLM(lm, proj_dim=8, k=5)
    back.load_datastore(str(tmp_path / "frozen"))
    np.testing.assert_array_equal(back.next_token_probs(q), frozen.next_token_probs(q))


def test_stale_values_are_refused_on_load(models, tmp_path):
    _, _, lm = models
    root = str(tmp_path / "store")
    knn = KNNLM(lm, proj_dim=8, k=3, mutable=True, index_spec=IndexSpec(persist_dir=root))
    knn.build_datastore(_corpus(lm.cfg, (4, 17), seed=6))
    knn.save_datastore()
    # extend WITHOUT saving: the keys reach the WAL, the values stay in memory
    knn.extend_datastore(_corpus(lm.cfg, (2, 17), seed=7))
    knn.drain_index()
    with pytest.raises(RuntimeError, match="values predate"):
        KNNLM(lm, proj_dim=8, k=3, mutable=True).load_datastore(root)
    with pytest.raises(RuntimeError, match="no datastore"):
        KNNLM(lm).save_datastore(str(tmp_path / "none"))


@pytest.mark.parametrize("mutable", [False, True])
def test_datastores_load_across_the_two_packages(models, tmp_path, mutable):
    """A datastore saved by repro's KNNLM loads into the port's and the
    reverse: the same values and keys, the same distributions."""
    ref_knn, knn = _pair_knnlm(models, proj_dim=8, k=5, lam=0.5, mutable=mutable)
    corpus = _corpus(knn.lm.cfg, (6, 25), seed=10)
    q = _corpus(knn.lm.cfg, (3, 9), seed=12)

    ref_knn.build_datastore(corpus)
    ref_knn.save_datastore(str(tmp_path / "from_ref"))
    ours = KNNLM(knn.lm, proj_dim=8, k=5, lam=0.5, mutable=mutable)
    ours.load_datastore(str(tmp_path / "from_ref"))
    np.testing.assert_array_equal(ours.values, ref_knn.values)
    assert ours.index.n == ref_knn.index.n
    _assert_probs_match(ref_knn, ours, q)

    knn.build_datastore(corpus)
    knn.save_datastore(str(tmp_path / "from_port"))
    theirs = RefKNNLM(ref_knn.lm, ref_knn.params, proj_dim=8, k=5, lam=0.5,
                      mutable=mutable)
    theirs.load_datastore(str(tmp_path / "from_port"))
    np.testing.assert_array_equal(theirs.values, knn.values)
    _assert_probs_match(theirs, knn, q)


def test_serve_parity_through_knn_server(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=5, lam=0.3, index_spec=IndexSpec(engine="streaming"))
    corpus = _corpus(lm.cfg, (8, 33), seed=5)
    knn.build_datastore(corpus)
    toks = _corpus(lm.cfg, (4, 12), seed=6)
    p_direct = knn.next_token_probs(toks)
    server = knn.serve(max_batch=4, default_deadline_ms=5_000.0)
    try:
        p_served = knn.next_token_probs(toks)
        assert server.stats()["completed"] == 4
    finally:
        knn.unserve()
    np.testing.assert_allclose(p_served, p_direct, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(knn.next_token_probs(toks), p_direct, rtol=1e-5, atol=1e-6)


def test_serve_requires_a_streaming_engine(models):
    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=3, tree_height=3)
    with pytest.raises(RuntimeError, match="no datastore"):
        knn.serve()
    with pytest.raises(RuntimeError, match="build_datastore"):
        knn.next_token_probs(np.zeros((1, 4), np.int32))
    knn.build_datastore(_corpus(lm.cfg, (4, 17), seed=6))   # default plan: not streaming
    with pytest.raises(StreamingUnsupported):
        knn.serve()


def test_overloaded_server_is_retried(models, monkeypatch):
    """A shedding server (``Overloaded``) is backed off from and retried."""
    from repro_torch.serving import Overloaded

    _, _, lm = models
    knn = KNNLM(lm, proj_dim=8, k=3, index_spec=IndexSpec(engine="streaming"))
    knn.build_datastore(_corpus(lm.cfg, (4, 17), seed=6))
    toks = _corpus(lm.cfg, (2, 5), seed=7)
    want = knn.next_token_probs(toks)
    server = knn.serve(max_batch=2, default_deadline_ms=5_000.0)
    try:
        submit, calls = server.submit, []

        def flaky(row, *a, **kw):
            calls.append(1)
            if len(calls) % 2:
                raise Overloaded("full", est_wait_s=0.0)
            return submit(row, *a, **kw)

        monkeypatch.setattr(server, "submit", flaky)
        np.testing.assert_allclose(knn.next_token_probs(toks), want, rtol=1e-5, atol=1e-6)
        assert len(calls) == 4
        monkeypatch.setattr(server, "submit", lambda *a, **kw: (_ for _ in ()).throw(
            Overloaded("full", est_wait_s=0.0)))
        with pytest.raises(Overloaded, match="20 backoff"):
            knn.next_token_probs(toks)
    finally:
        knn.unserve()


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------
def test_engine_tokens_are_the_references_greedy_choices(models):
    """The port's emitted greedy tokens replayed through repro's decode
    step, batched like the engine (slot 1 inactive): each within 1e-3 of
    the row's largest logit."""
    rlm, params, lm = models
    cfg = lm.cfg
    prompt = np.array([3, 14, 15, 9], np.int32)
    new = 6
    eng = ServeEngine(lm, slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=new))
    out = eng.run()[0].out_tokens
    assert len(out) == new

    dec = jax.jit(rlm.decode_step)
    caches, _ = rlm.init_cache(2, 64)

    def step1(tok, pos, caches):
        batch = {"tokens": jnp.asarray(np.array([[tok], [0]], np.int32)),
                 "pos": jnp.asarray(np.array([pos, 0], np.int32)),
                 "active": jnp.asarray(np.array([True, False]))}
        return dec(params, batch, caches)

    for t, tok in enumerate(prompt[:-1]):
        _, caches = step1(int(tok), t, caches)
    for i, tok in enumerate([int(prompt[-1])] + out[:-1]):
        lg, caches = step1(tok, len(prompt) - 1 + i, caches)
        row = np.asarray(lg[0, 0, : cfg.vocab_size], np.float32)
        assert row[out[i]] >= row.max() - 1e-3, (i, row.max() - row[out[i]])


def test_engine_matches_its_own_decode_in_bf16(bf16_lm):
    """The reference test's check on the port's bf16 model: replaying the
    prompt and emitted tokens through decode_step gives each emitted token
    within 1e-3 of the row's largest logit."""
    lm = bf16_lm
    prompt = np.array([7, 1, 300, 42, 5], np.int32)
    eng = ServeEngine(lm, slots=3, max_len=32)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
    out = eng.run()[0].out_tokens
    caches = lm.init_cache(3, 32)
    stream = list(prompt) + out
    for t in range(len(stream) - 1):
        batch = {"tokens": np.array([[stream[t]], [0], [0]]), "pos": np.array([t, 0, 0]),
                 "active": np.array([True, False, False])}
        lg, caches = lm.decode_step(batch, caches)
        if t >= len(prompt) - 1:
            row = lg[0, 0, : lm.cfg.vocab_size].numpy()
            assert row[stream[t + 1]] >= row.max() - 1e-3


def test_engine_reuses_slots(bf16_lm):
    eng = ServeEngine(bf16_lm, slots=2, max_len=64)
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=np.arange(2 + rid, dtype=np.int32) + 1,
                           max_new_tokens=3 + rid % 2))
    done = eng.run()
    assert sorted(done) == list(range(5))
    for rid, req in done.items():
        assert len(req.out_tokens) == 3 + rid % 2
    assert eng.slot_req == [None, None] and eng.slot_pos.tolist() == [0, 0]


def test_engine_retires_on_eos(bf16_lm):
    eng = ServeEngine(bf16_lm, slots=1, max_len=64)
    eng.submit(Request(rid=0, prompt=np.array([5, 6], np.int32), max_new_tokens=5))
    first = eng.run()[0].out_tokens[0]
    eng = ServeEngine(bf16_lm, slots=1, max_len=64, eos_id=first)
    eng.submit(Request(rid=0, prompt=np.array([5, 6], np.int32), max_new_tokens=5))
    assert eng.run()[0].out_tokens == [first]


def test_engine_slots_are_isolated(bf16_lm):
    """Slot 0's logits do not depend on what slot 1 decodes."""
    lm = bf16_lm
    vocab = lm.cfg.vocab_size
    prompt = np.array([7, 8, 9], np.int32)
    eng1 = ServeEngine(lm, slots=2, max_len=64)
    eng1.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng1._admit()
    eng2 = ServeEngine(lm, slots=2, max_len=64)
    eng2.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng2.submit(Request(rid=1, prompt=np.array([100, 200], np.int32), max_new_tokens=4))
    eng2._admit()
    t1 = 200
    for i, tok in enumerate([9, 42, 7, 300]):
        lg1 = eng1._run_tokens(np.array([tok, 0]), np.array([2 + i, 0]),
                               np.array([True, False]))
        lg2 = eng2._run_tokens(np.array([tok, t1]), np.array([2 + i, 1 + i]),
                               np.array([True, True]))
        np.testing.assert_allclose(lg1[0, 0, :vocab].numpy(), lg2[0, 0, :vocab].numpy(),
                                   atol=1e-3, rtol=0)
        t1 = int(lg2[1, 0, :vocab].argmax())


def test_lockstep_admission_costs_max_not_sum(bf16_lm):
    lm = bf16_lm
    eng = ServeEngine(lm, slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32) + 1, max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=np.arange(3, dtype=np.int32) + 1, max_new_tokens=2))
    eng._admit()
    assert eng.decode_steps == 4          # max(4, 2), not 6
    assert eng.slot_pos.tolist() == [4, 2]
    assert sorted(eng.run()) == [0, 1]

    def first_logits(with_neighbor):
        e = ServeEngine(lm, slots=2, max_len=64)
        e.submit(Request(rid=0, prompt=np.array([3, 14, 15, 9, 2], np.int32),
                         max_new_tokens=1))
        if with_neighbor:
            e.submit(Request(rid=1, prompt=np.array([7, 8], np.int32), max_new_tokens=1))
        e._admit()
        lg = e._run_tokens(np.array([2, 0]), e.slot_pos.copy(), np.array([True, False]))
        return lg[0, 0, : lm.cfg.vocab_size].numpy()

    np.testing.assert_allclose(first_logits(False), first_logits(True), atol=1e-3, rtol=0)


def test_temperature_sampling_is_seeded(bf16_lm):
    def tokens(seed):
        eng = ServeEngine(bf16_lm, slots=2, max_len=64, seed=seed)
        eng.submit(Request(rid=0, prompt=np.array([4, 5, 6], np.int32), max_new_tokens=12,
                           temperature=5.0))
        return eng.run()[0].out_tokens

    assert tokens(0) == tokens(0)
    assert tokens(0) != tokens(1)
    assert all(0 <= t < bf16_lm.cfg.vocab_size for t in tokens(2))


def test_engine_takes_the_references_params_argument(models):
    rlm, params, lm = models
    other = LanguageModel(lm.cfg, device=CPU, generator=torch.Generator().manual_seed(9))
    eng = ServeEngine(other, params_from_reference(jax.tree.map(np.asarray, params), lm.cfg),
                      slots=1, max_len=16)
    for name, t in lm.state_dict().items():
        assert torch.equal(eng.lm.state_dict()[name], t)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_serve_launcher_decodes_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen15_0_5b", "--smoke", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out
    assert out.count("  req ") == 3


def test_serve_launcher_knn_traffic_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--knn", "--device", "cpu", "--requests", "40", "--n", "3000",
                "--rate", "2000", "--max-batch", "8", "--deadline-ms", "5000"])
    out = capsys.readouterr().out
    assert "[serve --knn] 40 requests" in out and "ok=40 shed=0" in out
    assert "engine=streaming" in out and "slots=[cpu]" in out
