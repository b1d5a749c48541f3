"""Word2Vec (skip-gram with negative sampling) in torch, on the card.

Port of ``lgcnhs_tpu/data/word2vec.py``, which runs the whole training run as
one jitted ``lax.scan`` (reference: a fresh gensim Word2Vec per text column,
window 5, min_count 1, mean-pooled, ``processing/handleFeature.py:206-238``).
The host side is the JAX package's draw for draw: one ``default_rng(seed)``
gives the per-position reduced windows of the (center, context) pairs, the
input table ``U(-0.5/dim, 0.5/dim)`` and the epoch permutations, padded by
``np.resize`` to whole batches. The steps run on ``device`` (the card unless
the CPU is asked for), each one:

- negatives from the unigram^0.75 distribution, ``torch.multinomial`` with a
  generator seeded from ``seed`` on the device. JAX draws them with
  ``jax.random.categorical``, which torch cannot replay, so ``negatives=``
  takes an injected (n_steps, B, negative) stream (``plan`` gives n_steps);
- the gradient of JAX's SGNS ``loss_fn`` (``sgns_loss``), written out
  (``sgns_grads``: no autograd graph a step) and dense: every row of both
  tables gets one, zero where the batch misses it. It sums into the tables'
  rows by ``index_put_(accumulate=True)``: sorted, so in a fixed order, on
  the card; on the CPU the run takes one thread (torch adds with atomics
  across threads there), so a seed gives one table on either device;
- optax's Adam (b1 0.9, b2 0.999, eps 1e-8) written out with ``_foreach``
  ops over both tables: it moves every row every step, rows with a zero
  gradient included, as JAX's does (a sparse Adam skips them and drifts
  from it); the learning rate is optax's ``linear_schedule(lr, min_lr,
  n_steps)`` at the step count, in f32.

The document vector is the mean of its tokens' input vectors (gensim
``model.wv``), zeros when none is in the vocabulary.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lgcnhs_tpu_torch.runtime.device import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Word2VecModel(NamedTuple):
    """Trained token vectors: ``vocab`` maps token -> row of ``vectors``."""

    vocab: Dict[str, int]
    vectors: np.ndarray  # (V, dim) float32 input-side vectors


class Plan(NamedTuple):
    """The host side of a run: vocabulary, counts, the (n_steps, B) center
    and context batches and the initial input table."""

    vocab: Dict[str, int]
    freq: np.ndarray
    batch_c: np.ndarray
    batch_o: np.ndarray
    w_in0: np.ndarray

    @property
    def n_steps(self) -> int:
        return self.batch_c.shape[0]


def build_vocab(
    token_docs: Sequence[Sequence[str]], min_count: int = 1
) -> Tuple[Dict[str, int], np.ndarray]:
    """Vocabulary in descending-frequency order plus the count vector."""
    counts: Dict[str, int] = {}
    for doc in token_docs:
        for t in doc:
            counts[t] = counts.get(t, 0) + 1
    items = sorted(
        ((t, c) for t, c in counts.items() if c >= min_count),
        key=lambda tc: (-tc[1], tc[0]),
    )
    vocab = {t: i for i, (t, _) in enumerate(items)}
    freq = np.array([c for _, c in items], dtype=np.float64)
    return vocab, freq


def _skipgram_pairs(
    token_docs: Sequence[Sequence[str]],
    vocab: Dict[str, int],
    window: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) id pairs with per-position reduced windows."""
    centers: List[int] = []
    contexts: List[int] = []
    for doc in token_docs:
        ids = [vocab[t] for t in doc if t in vocab]
        n = len(ids)
        if n < 2:
            continue
        b = rng.integers(1, window + 1, size=n)
        for i in range(n):
            lo = max(0, i - int(b[i]))
            hi = min(n, i + int(b[i]) + 1)
            for j in range(lo, hi):
                if j != i:
                    centers.append(ids[i])
                    contexts.append(ids[j])
    return (
        np.asarray(centers, dtype=np.int32),
        np.asarray(contexts, dtype=np.int32),
    )


def plan(
    token_docs: Sequence[Sequence[str]],
    dim: int,
    *,
    window: int = 5,
    min_count: int = 1,
    epochs: int = 5,
    batch_size: int = 1024,
    seed: int = 42,
) -> Plan:
    """The JAX trainer's host draws, in its order. ``batch_c`` is empty
    (0 steps) when the corpus has no pair."""
    rng = np.random.default_rng(seed)
    vocab, freq = build_vocab(token_docs, min_count)
    empty = np.zeros((0, batch_size), dtype=np.int32)
    if not vocab:
        return Plan(vocab, freq, empty, empty, np.zeros((0, dim), dtype=np.float32))
    centers, contexts = _skipgram_pairs(token_docs, vocab, window, rng)
    w_in0 = rng.uniform(-0.5 / dim, 0.5 / dim, size=(len(vocab), dim)).astype(np.float32)
    if centers.size == 0:
        return Plan(vocab, freq, empty, empty, w_in0)
    order = np.concatenate([rng.permutation(centers.size) for _ in range(epochs)])
    n_steps = max(1, int(np.ceil(order.size / batch_size)))
    order = np.resize(order, n_steps * batch_size)
    return Plan(vocab, freq, centers[order].reshape(n_steps, batch_size),
                contexts[order].reshape(n_steps, batch_size), w_in0)


def linear_lr(lr: float, min_lr: float, n_steps: int, count: int) -> float:
    """optax ``linear_schedule(lr, min_lr, n_steps)`` at ``count``, in f32."""
    f32 = np.float32
    frac = f32(1) - f32(min(max(count, 0), n_steps)) / f32(n_steps)
    return float(f32(lr - min_lr) * frac + f32(min_lr))


def sgns_loss(w_in: torch.Tensor, w_out: torch.Tensor, c: torch.Tensor, o: torch.Tensor,
              neg: torch.Tensor) -> torch.Tensor:
    """The JAX ``loss_fn``: -(mean log sigma(u.v_o) + mean sum log sigma(-u.v_neg))."""
    u = w_in[c]
    pos = (u * w_out[o]).sum(-1)
    negs = (u[:, None, :] * w_out[neg]).sum(-1)
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-negs).sum(1).mean())


def sgns_grads(w_in: torch.Tensor, w_out: torch.Tensor, c: torch.Tensor, o: torch.Tensor,
               neg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sgns_loss``'s gradient with respect to both tables, dense, written
    out (no autograd graph a step): d/dpos = -sigma(-pos)/B, d/dneg =
    sigma(neg)/B, summed into the tables' rows by ``index_put_``."""
    u, vo, vn = w_in[c], w_out[o], w_out[neg]
    B = c.shape[0]
    dpos = torch.sigmoid(-(u * vo).sum(-1)).div_(-B)[:, None]
    dneg = torch.sigmoid((u[:, None, :] * vn).sum(-1)).div_(B)[:, :, None]
    g_in = torch.zeros_like(w_in).index_put_((c,), dpos * vo + (dneg * vn).sum(1),
                                             accumulate=True)
    g_out = torch.zeros_like(w_out).index_put_((o,), dpos * u, accumulate=True)
    g_out.index_put_((neg.reshape(-1),), (dneg * u[:, None, :]).reshape(-1, u.shape[1]),
                     accumulate=True)
    return g_in, g_out


@contextlib.contextmanager
def _one_thread(on: bool):
    was = torch.get_num_threads()
    if on:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def train_word2vec(
    token_docs: Sequence[Sequence[str]],
    dim: int,
    *,
    window: int = 5,
    min_count: int = 1,
    negative: int = 5,
    epochs: int = 5,
    lr: float = 5e-3,
    min_lr: float = 1e-4,
    batch_size: int = 1024,
    seed: int = 42,
    device="cuda",
    negatives: Optional[np.ndarray] = None,
) -> Word2VecModel:
    """Train SGNS vectors on tokenized documents (module docstring).
    ``negatives``: an injected (n_steps, batch_size, negative) id stream in
    place of the device draws."""
    device = resolve_device(device)
    p = plan(token_docs, dim, window=window, min_count=min_count, epochs=epochs,
             batch_size=batch_size, seed=seed)
    if p.n_steps == 0:
        return Word2VecModel(p.vocab, p.w_in0)
    if negatives is not None and negatives.shape != (p.n_steps, batch_size, negative):
        raise ValueError(f"negatives of shape {negatives.shape}; this run takes "
                         f"{(p.n_steps, batch_size, negative)}")
    V = len(p.vocab)
    params = [torch.from_numpy(p.w_in0).to(device),
              torch.zeros((V, dim), dtype=torch.float32, device=device)]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    batch_c = torch.from_numpy(p.batch_c.astype(np.int64)).to(device)
    batch_o = torch.from_numpy(p.batch_o.astype(np.int64)).to(device)
    if negatives is None:
        noise = torch.from_numpy(p.freq ** 0.75).to(device=device, dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(seed)
    else:
        injected = torch.from_numpy(np.asarray(negatives, dtype=np.int64)).to(device)
    with _one_thread(device.type == "cpu"):
        for t in range(p.n_steps):
            if negatives is None:
                neg = torch.multinomial(noise, batch_size * negative, replacement=True,
                                        generator=gen).view(batch_size, negative)
            else:
                neg = injected[t]
            grads = sgns_grads(*params, batch_c[t], batch_o[t], neg)
            # optax's Adam: moments, bias corrections in f32, -lr(t) * update
            f32 = np.float32
            c1 = float(f32(1) - f32(ADAM_B1) ** f32(t + 1))
            c2 = float(f32(1) - f32(ADAM_B2) ** f32(t + 1))
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(mu, c1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -linear_lr(lr, min_lr, p.n_steps, t))
            torch._foreach_add_(params, update)
    w_in = params[0]
    return Word2VecModel(p.vocab, w_in.cpu().numpy())


def document_vectors(
    model: Word2VecModel, token_docs: Sequence[Sequence[str]], dim: int
) -> np.ndarray:
    """Mean-pooled token vectors per document, zeros when no token is in
    vocabulary (contract of ``getWord2Vec``, ``handleFeature.py:225-238``)."""
    out = np.zeros((len(token_docs), dim), dtype=np.float32)
    for i, doc in enumerate(token_docs):
        ids = [model.vocab[t] for t in doc if t in model.vocab]
        if ids:
            out[i] = model.vectors[ids].mean(axis=0)
    return out
