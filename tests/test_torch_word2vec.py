"""``lgcnhs_tpu_torch.data.word2vec`` against ``lgcnhs_tpu.data.word2vec``.

The host draws are identical: vocabulary, (center, context) pairs, the
initial input table and the batched epoch permutations all come from one
``default_rng(seed)`` in the same order. With JAX's negative stream injected
(``torch_port_checks.jax_negatives``), the trained vectors agree within
``VEC_ATOL`` absolute: f32 sums and Adam's arithmetic in another order.
Measured here: 1.5e-7 (dim 5) and 1.8e-6 (dim 20) against vectors of
magnitude ~0.3, the initial table's scale being 0.5/dim.
"""
import numpy as np
import pytest
import torch

from lgcnhs_tpu.data import features as jf
from lgcnhs_tpu.data import word2vec as jw
from lgcnhs_tpu_torch.data import features as tf
from lgcnhs_tpu_torch.data import word2vec as tw
from torch_port_checks import jax_negatives

VEC_ATOL = 1e-5


def _corpus(n_docs=300, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)] + ["apple", "banana", "circuit"]
    docs = [list(rng.choice(words, size=int(rng.integers(0, 15)))) for _ in range(n_docs)]
    docs[3] = ["solo"]  # a one-token document has no pair
    docs[4] = []  # an empty one pools to zeros
    return docs


def test_vocab_pairs_and_initial_table_are_identical():
    docs = _corpus()
    assert tw.build_vocab(docs, 2)[0] == jw.build_vocab(docs, 2)[0]
    np.testing.assert_array_equal(tw.build_vocab(docs)[1], jw.build_vocab(docs)[1])
    vocab, _ = jw.build_vocab(docs)
    for want, got in zip(jw._skipgram_pairs(docs, vocab, 5, np.random.default_rng(3)),
                         tw._skipgram_pairs(docs, vocab, 5, np.random.default_rng(3))):
        np.testing.assert_array_equal(got, want)
    # the plan replays the JAX trainer's draws in order: pairs, w_in0, epochs
    p = tw.plan(docs, 8, epochs=3, batch_size=256, seed=11)
    rng = np.random.default_rng(11)
    centers, contexts = jw._skipgram_pairs(docs, vocab, 5, rng)
    w_in0 = rng.uniform(-0.5 / 8, 0.5 / 8, size=(len(vocab), 8)).astype(np.float32)
    order = np.concatenate([rng.permutation(centers.size) for _ in range(3)])
    order = np.resize(order, p.n_steps * 256)
    assert p.n_steps == int(np.ceil(3 * centers.size / 256))
    np.testing.assert_array_equal(p.w_in0, w_in0)
    np.testing.assert_array_equal(p.batch_c.ravel(), centers[order])
    np.testing.assert_array_equal(p.batch_o.ravel(), contexts[order])


def test_written_out_gradient_is_autograd_of_the_loss():
    rng = np.random.default_rng(5)
    w_in = torch.from_numpy(rng.standard_normal((30, 6)).astype(np.float32) * 0.3)
    w_out = torch.from_numpy(rng.standard_normal((30, 6)).astype(np.float32) * 0.3)
    c, o = (torch.from_numpy(rng.integers(0, 30, 64)) for _ in range(2))
    neg = torch.from_numpy(rng.integers(0, 30, (64, 5)))
    tables = [w_in.clone().requires_grad_(True), w_out.clone().requires_grad_(True)]
    want = torch.autograd.grad(tw.sgns_loss(*tables, c, o, neg), tables)
    for got, w in zip(tw.sgns_grads(w_in, w_out, c, o, neg), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-7)


def test_linear_lr_is_optax_linear_schedule():
    import optax

    sched = optax.linear_schedule(5e-3, 1e-4, 37)
    for count in (0, 1, 17, 36, 37, 50):
        assert tw.linear_lr(5e-3, 1e-4, 37, count) == float(sched(count))


@pytest.mark.parametrize("dim,batch_size,epochs", [(5, 1024, 5), (20, 256, 3)])
def test_sgns_with_jax_negatives_matches_jax(dim, batch_size, epochs):
    docs = _corpus()
    want = jw.train_word2vec(docs, dim, batch_size=batch_size, epochs=epochs, seed=7)
    negs = jax_negatives(docs, batch_size=batch_size, epochs=epochs, seed=7)
    got = tw.train_word2vec(docs, dim, batch_size=batch_size, epochs=epochs, seed=7,
                            device="cpu", negatives=negs)
    assert got.vocab == want.vocab
    assert np.abs(got.vectors - want.vectors).max() <= VEC_ATOL
    # the training moved the table well past the tolerance
    assert np.abs(want.vectors - tw.plan(docs, dim, epochs=epochs, batch_size=batch_size,
                                         seed=7).w_in0).max() > 100 * VEC_ATOL
    np.testing.assert_array_equal(tw.document_vectors(got, docs, dim)[4], np.zeros(dim))
    np.testing.assert_allclose(tw.document_vectors(got, docs, dim),
                               jw.document_vectors(want, docs, dim), rtol=0, atol=VEC_ATOL)


def test_sgns_own_negatives_learn_and_repeat():
    """Device-drawn negatives: deterministic under the seed, and the vectors
    learn co-occurrence (``tests/test_word2vec.py``'s two-cluster corpus)."""
    rng = np.random.default_rng(0)
    a, b = ["apple", "banana", "fruit"], ["circuit", "voltage", "wire"]
    docs = [list(rng.choice(a if rng.random() < 0.5 else b, size=6)) for _ in range(300)]
    m1 = tw.train_word2vec(docs, 16, epochs=3, batch_size=512, seed=1, device="cpu")
    m2 = tw.train_word2vec(docs, 16, epochs=3, batch_size=512, seed=1, device="cpu")
    np.testing.assert_array_equal(m1.vectors, m2.vectors)
    v = {t: m1.vectors[i] for t, i in m1.vocab.items()}

    def cos(x, y):
        return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))

    assert cos(v["apple"], v["banana"]) > cos(v["apple"], v["voltage"]) + 0.2


def test_edge_corpora_and_bad_injection():
    assert tw.train_word2vec([[], []], 4, device="cpu").vectors.shape == (0, 4)
    one = tw.train_word2vec([["a"], ["b"]], 4, seed=2, device="cpu")
    np.testing.assert_array_equal(one.vectors, jw.train_word2vec([["a"], ["b"]], 4, seed=2).vectors)
    with pytest.raises(ValueError, match="negatives of shape"):
        tw.train_word2vec(_corpus(), 4, device="cpu", negatives=np.zeros((1, 2, 3), np.int32))


def test_text_embeddings_sgns_uses_the_torch_trainer(monkeypatch):
    """``text_embeddings(method="sgns")`` tokenizes as JAX does and pools
    the torch trainer's vectors; with JAX's negatives both packages' outputs
    agree within VEC_ATOL."""
    texts = ["The river king returns, at night", "A night in the city", "", "river city war",
             "the last summer garden", "King of the river"] * 30
    docs = [jf.preprocess_text(t) for t in texts]
    negs = jax_negatives(docs, seed=42)
    train = tw.train_word2vec
    monkeypatch.setattr(tw, "train_word2vec",
                        lambda *a, **kw: train(*a, **kw, negatives=negs))
    got = tf.text_embeddings(texts, 5, method="sgns", device="cpu")
    want = jf.text_embeddings(texts, 5, method="sgns")
    assert np.abs(got - want).max() <= VEC_ATOL


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CPU-only machine shows the missing card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.train_word2vec(_corpus(), 4)
