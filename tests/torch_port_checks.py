"""Shared checks of the PyTorch port's tests (not collected: no test_ prefix).

``tie_equivalence`` is the serve contract of ``tests/tpu_smoke.py``: two
top-k index lists agree slot for slot except where the slot's values, under
an independent f64 reference, are equal within a relative gap.
"""
import numpy as np


def tie_equivalence(want_idx, got_idx, ref_vals):
    """(agreement, max relative value gap over mismatched slots).

    ``ref_vals`` is the (U, I) f64 reference score matrix both index lists
    are read against."""
    want_idx, got_idx = np.asarray(want_idx), np.asarray(got_idx)
    rows = np.arange(want_idx.shape[0])[:, None]
    mism = want_idx != got_idx
    agreement = 1.0 - float(mism.mean())
    if not mism.any():
        return agreement, 0.0
    w = ref_vals[rows, want_idx][mism]
    g = ref_vals[rows, got_idx][mism]
    gap = np.abs(w - g) / (np.maximum(np.abs(w), np.abs(g)) + 1e-5)
    return agreement, float(gap.max())


def dyadic(rng, shape, lo=-4, hi=5, denom=8):
    """Values in {lo/denom, ..., (hi-1)/denom}: products and short sums are
    exact in f32, so every summation order gives the same scores, with many
    exact ties."""
    return (rng.integers(lo, hi, shape) / denom).astype(np.float32)


def jax_negatives(token_docs, *, window=5, min_count=1, negative=5, epochs=5,
                  batch_size=1024, seed=42):
    """The negative ids ``lgcnhs_tpu.data.word2vec.train_word2vec`` draws,
    (n_steps, batch_size, negative) int32: its key splits replayed in a
    ``lax.scan`` (``key, sub = split(key)``, then ``categorical(sub, 0.75
    log freq)`` each step, from ``PRNGKey(seed)``), with n_steps from its own
    host draws."""
    import jax
    import jax.numpy as jnp

    from lgcnhs_tpu.data.word2vec import _skipgram_pairs, build_vocab

    rng = np.random.default_rng(seed)
    vocab, freq = build_vocab(token_docs, min_count)
    centers, _ = _skipgram_pairs(token_docs, vocab, window, rng)
    n_steps = max(1, int(np.ceil(epochs * centers.size / batch_size)))
    logits = jnp.asarray(0.75 * np.log(freq), dtype=jnp.float32)

    def step(key, _):
        key, sub = jax.random.split(key)
        neg = jax.random.categorical(sub, logits, shape=(batch_size, negative))
        return key, neg.astype(jnp.int32)

    _, negs = jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=n_steps)
    return np.asarray(negs)


def pin_text_method(monkeypatch, method="hash"):
    """Both packages' dataset pipelines embed text with ``method`` (their
    ``text_embeddings`` names patched where the pipelines look them up)."""
    import functools

    import lgcnhs_tpu.data.douban as jdb
    import lgcnhs_tpu.data.features as jf
    import lgcnhs_tpu.data.movielens as jml
    import lgcnhs_tpu.data.movielens1m as jm1
    import lgcnhs_tpu_torch.data.douban as tdb
    import lgcnhs_tpu_torch.data.features as tf
    import lgcnhs_tpu_torch.data.movielens as tml
    import lgcnhs_tpu_torch.data.movielens1m as tm1

    for features, modules in ((jf, (jml, jm1, jdb)), (tf, (tml, tm1, tdb))):
        pinned = functools.partial(features.text_embeddings, method=method)
        for module in modules:
            monkeypatch.setattr(module, "text_embeddings", pinned)


class MeshRun:
    """One CPU mesh run of ``tests/torch_mesh_worker.py``: D x M gloo ranks
    started at once (one thread each, a file store under ``tmp``), running
    ``suite`` on ``inputs``. ``results()`` waits for every rank and returns
    their output dicts in rank order; a rank that fails or passes
    ``timeout`` seconds fails the run (and stops the others)."""

    def __init__(self, suite, mesh_shape, inputs, tmp, timeout=240):
        import os
        import subprocess
        import sys

        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(tmp, exist_ok=True)
        self.tmp, self.timeout = str(tmp), timeout
        self.world = int(mesh_shape[0]) * int(mesh_shape[1])
        in_npz = os.path.join(self.tmp, "inputs.npz")
        np.savez(in_npz, mesh=np.asarray(mesh_shape), **inputs)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(here) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.join(here, "torch_mesh_worker.py"), str(rank),
                 str(self.world), os.path.join(self.tmp, "store"), suite, in_npz, self.tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(self.world)
        ]

    def results(self):
        import os
        import subprocess

        logs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=self.timeout)
                logs.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"mesh run passed {self.timeout} s")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (rc, out, err) in enumerate(logs):
            assert rc == 0, f"rank {rank} failed:\n{err[-4000:]}"
        outs = []
        for rank in range(self.world):
            with np.load(os.path.join(self.tmp, f"{rank}.npz")) as data:
                outs.append({name: data[name] for name in data.files})
        return outs


# A stand-in for the reference checkout (``ReferenceModules`` loads these five
# files): each imports the reference's const / utils.log / utils.wrapper, as
# the reference's files do, so the loader's stubs serve them, and delegates
# to the JAX package (lists from ``models.spread.recommend_spread_method`` at
# float64, metrics from ``eval.metrics``).
_STANDIN_MODEL = '''"""Stand-in model/SpreadMethod/model.py: the split as a graph, and the
lists and f64 resource matrices of lgcnhs_tpu's spread models."""
import jax
import numpy as np

from const import cfg
from utils.log import logger
from utils.wrapper import calTimes

from lgcnhs_tpu.config import load_config
from lgcnhs_tpu.data.graph import EdgeSet, InteractionGraph, edges_from_df, interaction_matrix
from lgcnhs_tpu.models.spread import recommend_spread_method, spread_scores


def graph_of(n_users, n_items, train_df, val_df):
    train, val = edges_from_df(train_df), edges_from_df(val_df)
    empty = EdgeSet(np.zeros(0, np.int32), np.zeros(0, np.int32))
    return InteractionGraph(n_users, n_items, train, train, val, empty)


def _x64(fn):
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", was)


def _config():
    return load_config(dataset=cfg.DATA_SET, overrides={
        "k": cfg.RECOMMEND["k"], "compute.dtype": "float64",
        "hparams.lambda_": cfg.MODEL["HyperParameter"]["lambda"]})


@calTimes(logger, "recommend")
def recommend(graph, method):
    return _x64(lambda: np.array(recommend_spread_method(graph, _config(), method)))


@calTimes(logger, "scores")
def scores(graph, method):
    A = interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val,
                           dtype=np.float64)
    return _x64(lambda: np.asarray(spread_scores(A, method, cfg.DATA_SET,
                                                 cfg.MODEL["HyperParameter"]["lambda"])))
'''

_STANDIN_RECOMMEND = '''"""Stand-in model/SpreadMethod/recommend.py: recommendSpreadMethod, its
lists altered as SWAP_TIE and REPLACE_ITEM (set above) say."""
from const import cfg
from utils.log import logger
from utils.wrapper import calTimes
from model.SpreadMethod import model


@calTimes(logger, "recommendSpreadMethod")
def recommendSpreadMethod(n_users, n_items, train_df, val_df, method):
    graph = model.graph_of(n_users, n_items, train_df, val_df)
    rec = model.recommend(graph, method)
    if SWAP_TIE or REPLACE_ITEM:
        F = model.scores(graph, method)
    if SWAP_TIE:  # the first two adjacent items of equal score trade places
        tied = [(u, j) for u in range(n_users) for j in range(rec.shape[1] - 1)
                if F[u, rec[u, j]] == F[u, rec[u, j + 1]]]
        if tied:
            u, j = tied[0]
            rec[u, j], rec[u, j + 1] = rec[u, j + 1], rec[u, j]
    if REPLACE_ITEM:  # user 0's last item gives way to one of another score
        last = rec[0, -1]
        rec[0, -1] = next(i for i in range(n_items)
                          if i not in rec[0] and F[0, i] != F[0, last])
    logger.info("recommendSpreadMethod %s for %d users", method, n_users)
    return {u: rec[u].tolist() for u in range(n_users)}
'''

_STANDIN_TRANS = '''"""Stand-in utils/trans.py: the reference's dict and matrix converters."""
import numpy as np

from utils.log import logger
from utils.wrapper import calTimes


def getUserItemsDictByDataframe(df):
    pos = {}
    for u, i in zip(df["user_id"].tolist(), df["item_id"].tolist()):
        pos.setdefault(int(u), []).append(int(i))
    return pos


def getItemDegreeByUserPosItemDict(train_pos, val_pos):
    deg = {}
    for pos in (train_pos, val_pos):
        for items in pos.values():
            for i in items:
                deg[i] = deg.get(i, 0) + 1
    return deg


@calTimes(logger, "getInteractionMatrixByDataframe")
def getInteractionMatrixByDataframe(n_users, n_items, df):
    A = np.zeros((n_users, n_items))
    A[df["user_id"].to_numpy(), df["item_id"].to_numpy()] = 1.0
    return A


def recommendDictToTensor(rec_dict):
    return np.array([rec_dict[u] for u in range(len(rec_dict))])
'''

_STANDIN_ACCURATE = '''"""Stand-in metrics/accurate.py: P, R, F1, NDCG by lgcnhs_tpu's
eval.metrics, P shifted by SHIFT (set above)."""
import numpy as np

from utils.log import logger
from utils.wrapper import calTimes

from lgcnhs_tpu.data.graph import EdgeSet
from lgcnhs_tpu.eval.metrics import EvalContext, accurate_metrics


@calTimes(logger, "getAccurateMetrics")
def getAccurateMetrics(test_pos, rec, k):
    rec = np.asarray(rec)[:, :k]
    users = [u for u, items in test_pos.items() for _ in items]
    items = [i for its in test_pos.values() for i in its]
    n_items = 1 + max(int(rec.max()), max(items))
    test = EdgeSet(np.asarray(users, np.int32), np.asarray(items, np.int32))
    empty = EdgeSet(np.zeros(0, np.int32), np.zeros(0, np.int32))
    ctx = EvalContext.build(rec.shape[0], n_items, test, empty, empty)
    p, r, f1, n = accurate_metrics(ctx, rec)
    return p + SHIFT, r, f1, n
'''

_STANDIN_DIVERSITY = '''"""Stand-in metrics/diversity.py: H and I by lgcnhs_tpu's eval.metrics on
the interaction matrix and item degrees the caller passes."""
import dataclasses

import numpy as np

from utils.log import logger
from utils.wrapper import calTimes

from lgcnhs_tpu.data.graph import EdgeSet
from lgcnhs_tpu.eval.metrics import EvalContext, diversity_metrics


@calTimes(logger, "getDiversityMetrics")
def getDiversityMetrics(rec, item_deg, A, k):
    rec = np.asarray(rec)[:, :k]
    U, I = A.shape
    users, items = np.nonzero(A)
    seen = EdgeSet(users.astype(np.int32), items.astype(np.int32))
    empty = EdgeSet(np.zeros(0, np.int32), np.zeros(0, np.int32))
    ctx = EvalContext.build(U, I, empty, seen, empty)
    deg = np.array([item_deg.get(i, 0) for i in range(I)], dtype=ctx.item_deg.dtype)
    return diversity_metrics(dataclasses.replace(ctx, item_deg=deg), rec)
'''


def write_reference_standin(root, swap_tie=False, replace_item=False, shift=0.0):
    """The five reference files ``ReferenceModules`` loads, under ``root``
    (the ``model/SpreadMethod`` package as a namespace package). Faithful by
    default; ``swap_tie`` swaps the first two adjacent tied items of a list,
    ``replace_item`` puts an item of another score in user 0's last slot,
    ``shift`` is added to P."""
    import os

    files = {
        "model/SpreadMethod/model.py": _STANDIN_MODEL,
        "model/SpreadMethod/recommend.py":
            f"SWAP_TIE = {swap_tie!r}\nREPLACE_ITEM = {replace_item!r}\n" + _STANDIN_RECOMMEND,
        "utils/trans.py": _STANDIN_TRANS,
        "metrics/accurate.py": f"SHIFT = {shift!r}\n" + _STANDIN_ACCURATE,
        "metrics/diversity.py": _STANDIN_DIVERSITY,
    }
    for rel, text in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
