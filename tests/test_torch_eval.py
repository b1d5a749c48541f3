"""The port's six-metric evaluation (``eval/metrics.py``) against the JAX
package's, on one seeded (U, k) list and graph: the rounded metric dict
(Novelty included) equal value for value, the unrounded P/R/NDCG/H/I
within 1e-6 relative, and the two other forms of I@k
(``internal_similarity_from_matrix``, ``internal_similarity_direct``)
within 1e-6 relative of ``internal_similarity``. Plus the P + R = 0 case
(F1 = 0) and F1 from the already-rounded P and R.
"""
import numpy as np
import pytest
import torch

from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.eval import metrics as jeval
from lgcnhs_tpu.ops import metrics_ops as jops
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.eval import metrics as teval
from lgcnhs_tpu_torch.ops import metrics_ops as tops

U, I, K = 120, 300, 10


def _edges(module, rng, n):
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    return module.EdgeSet(users, items)


def _contexts(seed):
    """(JAX context, port context, rec): the same seeded splits in both;
    the last 5 items have no train/val interaction (zero degree)."""
    out = []
    for module, ctx_cls in ((jgraph, jeval.EvalContext), (tgraph, teval.EvalContext)):
        rng = np.random.default_rng(seed)
        train, val, test = (_edges(module, rng, n) for n in (3000, 400, 400))
        train = module.EdgeSet(train.users, np.minimum(train.items, I - 6))
        val = module.EdgeSet(val.users, np.minimum(val.items, I - 6))
        out.append(ctx_cls.build(U, I, test, train, val))
    rng = np.random.default_rng(seed + 100)
    rec = np.argsort(rng.random((U, I)), axis=1)[:, :K].astype(np.int32)
    rec[:3, :5] = np.arange(I - 5, I)  # lists holding zero-degree items
    return out[0], out[1], rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_dict_equals_jax(seed):
    jctx, tctx, rec = _contexts(seed)
    want = jeval.evaluate_recommendations(jctx, rec, include_novelty=True)
    got = teval.evaluate_recommendations(tctx, rec, include_novelty=True)
    assert got == want
    assert list(got) == ["P", "R", "F1", "NDCG", "H", "I", "Novelty"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unrounded_metrics_match_jax(seed):
    jctx, tctx, rec = _contexts(seed)
    p, r, n = (float(x) for x in jops.all_accuracy_metrics(
        rec, jctx.eval_pos, jctx.eval_counts, jctx.eval_present))
    h = float(jops.hamming_distance(rec, I))
    i = float(jops.internal_similarity(rec, jctx.interaction, jctx.item_deg))
    got_prn = teval.accuracy_unrounded(tctx, rec)
    got_hi = teval.diversity_unrounded(tctx, rec)
    np.testing.assert_allclose([*got_prn, *got_hi], [p, r, n, h, i], rtol=1e-6, atol=0)
    nov = float(tops.novelty_avg_degree(torch.from_numpy(rec), torch.from_numpy(tctx.item_deg)))
    np.testing.assert_allclose(nov, float(jops.novelty_avg_degree(rec, jctx.item_deg)),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_internal_similarity_forms_agree(seed):
    jctx, tctx, rec = _contexts(seed)
    want = float(jops.internal_similarity(rec, jctx.interaction, jctx.item_deg))
    rec_t = torch.from_numpy(rec)
    A = torch.from_numpy(tctx.interaction)
    deg = torch.from_numpy(tctx.item_deg)
    S = tops.similarity_matrix(A, deg)
    forms = {
        "bilinear": tops.internal_similarity(rec_t, A, deg),
        "from_matrix": tops.internal_similarity_from_matrix(rec_t, S),
        "direct": tops.internal_similarity_direct(rec_t, A, deg, chunk=32),
        "direct, one chunk": tops.internal_similarity_direct(rec_t, A, deg, chunk=512),
    }
    for name, value in forms.items():
        np.testing.assert_allclose(float(value), want, rtol=1e-6, err_msg=name)


def test_zero_precision_and_recall_give_f1_zero():
    """No list hits a test positive: P = R = 0 and F1 = 0 in both packages
    (the reference would divide by zero)."""
    jctx, tctx, _ = _contexts(3)
    rec = np.zeros((U, K), np.int32)
    for u in range(U):
        rec[u] = np.flatnonzero(~tctx.eval_pos[u])[:K]
    want = jeval.evaluate_recommendations(jctx, rec)
    got = teval.evaluate_recommendations(tctx, rec)
    assert got == want and got["P"] == got["R"] == got["F1"] == 0.0


def test_f1_from_rounded_precision_and_recall():
    _, tctx, rec = _contexts(0)
    p, r, f1, _ = teval.accurate_metrics(tctx, rec)
    assert f1 == round(2 * p * r / (p + r), 5)
    assert (p, r) == tuple(round(x, 5) for x in teval.accuracy_unrounded(tctx, rec)[:2])


def test_host_arrays_go_to_the_named_device():
    _, tctx, rec = _contexts(0)
    assert tctx.device == torch.device("cpu")
    assert tctx.on_device(rec).device == torch.device("cpu")
    assert tctx.on_device(torch.from_numpy(rec)).dtype == torch.int32
