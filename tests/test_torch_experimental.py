"""The experimental autoencoders (``models/experimental.py``) against the JAX
package, at ``tests/test_experimental.py``'s 20 x 30 problem (feature widths
10 and 14, so the zero-padding runs) with one user and one item that have no
interaction.

- Forward at f64 (x64 on in JAX, restored after) on JAX's parameters
  carried across by ``experimental_params_from_jax``: the joint adjacency,
  the GCN forward, one GAT layer and the GAT forward within 1e-12 of each
  output's scale (f64 sums in another order), the isolated rows 0 in both;
  the GAT loss's gradient, finite and within 1e-12 of scale.
- Training at f32 from JAX's initial parameters, 50 epochs: the loss history
  within 1e-5 relative at every epoch, the parameters within 1e-4 of scale
  (optax's and torch's Adam round their f32 updates apart).
- ``autoencoder_scores`` within 1e-5 of scale on the same parameters (JAX's
  trained ones);
  ``hybrid_gat_fusion``'s top-10 lists (``ops/topk.masked_topk``, train
  positives masked) identical to the same ranking of JAX's scores.
- The port's own-seed init (shapes, Glorot bounds), a falling MSE over 150
  epochs, the unknown kind and the default device (CUDA, raising here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.models import experimental as je
from lgcnhs_tpu_torch.models import experimental as te
from lgcnhs_tpu_torch.ops.topk import masked_topk

U, I, FU, FI, H = 20, 30, 10, 14, 16
ISOLATED_USER, ISOLATED_ITEM = 3, 5
KINDS = ["gcn", "gat"]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(2)
    R = (rng.random((U, I)) < 0.2).astype(np.float32)
    R[ISOLATED_USER] = 0.0
    R[:, ISOLATED_ITEM] = 0.0
    Xu = rng.standard_normal((U, FU)).astype(np.float32)
    Xi = rng.standard_normal((I, FI)).astype(np.float32)
    return R, Xu, Xi


@pytest.fixture(scope="module")
def jax_trained(problem):
    """{kind: (JAX's parameters, loss history)} after 50 epochs at lr 1e-2
    from ``train_autoencoder``'s own init (``PRNGKey(42)``)."""
    return {kind: je.train_autoencoder(*problem, hidden_dim=H, lr=1e-2, epochs=50, kind=kind)
            for kind in KINDS}


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _padded64(R, Xu, Xi):
    """R and the zero-padded [Xu; Xi] in f64, as numpy arrays."""
    Xu = np.pad(Xu, ((0, 0), (0, FI - FU)))
    return R.astype(np.float64), np.vstack([Xu, Xi]).astype(np.float64)


def test_forward_f64_matches_jax(problem, x64):
    R, X = _padded64(*problem)
    pj = je.init_autoencoder(jax.random.PRNGKey(7), FI, H)
    assert pj.W1.dtype == jnp.float64
    pt = te.experimental_params_from_jax(pj, "cpu")
    Rj, Xj = jnp.asarray(R), jnp.asarray(X)
    Rt, Xt = torch.from_numpy(R), torch.from_numpy(X)

    A_j, A_t = jax.jit(je.joint_normalized_adj)(Rj), te.joint_normalized_adj(Rt)
    assert _rel(A_t, A_j) <= 1e-12
    assert _rel(te.gcn_autoencoder_forward(pt, A_t, Xt),
                je.gcn_autoencoder_forward(pj, A_j, Xj)) <= 1e-12

    layer_j = jax.jit(je._gat_layer)(Xj[:U], Xj[U:], Rj, pj.W1, pj.b1, pj.a1)
    layer_t = te._gat_layer(Xt[:U], Xt[U:], Rt, pt.W1, pt.b1, pt.a1)
    assert _rel(layer_t, layer_j) <= 1e-12
    assert not layer_t[ISOLATED_USER].any() and not np.asarray(layer_j)[ISOLATED_USER].any()

    for got, want, isolated in zip(te.gat_autoencoder_forward(pt, Rt, Xt[:U], Xt[U:]),
                                   je.gat_autoencoder_forward(pj, Rj, Xj[:U], Xj[U:]),
                                   (ISOLATED_USER, ISOLATED_ITEM)):
        assert got.dtype == torch.float64
        assert _rel(got, want) <= 1e-12
        assert not got[isolated].any() and not np.asarray(want)[isolated].any()


def test_gat_gradient_f64_matches_jax(problem, x64):
    """The isolated rows' NaN softmax stays out of the backward in both."""
    R, X = _padded64(*problem)
    pj = je.init_autoencoder(jax.random.PRNGKey(8), FI, H)
    Rj, Xj = jnp.asarray(R), jnp.asarray(X)

    def loss_j(p):
        Zu, Zi = je.gat_autoencoder_forward(p, Rj, Xj[:U], Xj[U:])
        return jnp.mean((Zu - Xj[:U]) ** 2) + jnp.mean((Zi - Xj[U:]) ** 2)

    grads_j = jax.grad(loss_j)(pj)
    pt = te.MLPGraphParams(*(t.requires_grad_(True)
                             for t in te.experimental_params_from_jax(pj, "cpu")))
    Rt, Xt = torch.from_numpy(R), torch.from_numpy(X)
    Zu, Zi = te.gat_autoencoder_forward(pt, Rt, Xt[:U], Xt[U:])
    loss = torch.mean((Zu - Xt[:U]) ** 2) + torch.mean((Zi - Xt[U:]) ** 2)
    loss.backward()
    for name, gj, t in zip(te.MLPGraphParams._fields, grads_j, pt):
        assert torch.isfinite(t.grad).all(), name
        assert _rel(t.grad, gj) <= 1e-12, name


@pytest.mark.parametrize("kind", KINDS)
def test_training_matches_jax_from_its_init(problem, jax_trained, kind):
    R, Xu, Xi = problem
    pj, hist_j = jax_trained[kind]
    # JAX's own init: train_autoencoder's PRNGKey(seed=42) at the padded width
    init = te.experimental_params_from_jax(je.init_autoencoder(jax.random.PRNGKey(42), FI, H),
                                           "cpu")
    pt, hist_t = te.train_autoencoder(R, Xu, Xi, hidden_dim=H, lr=1e-2, epochs=50, kind=kind,
                                      init=init, device="cpu")
    hist_j, hist_t = np.asarray(hist_j), np.asarray(hist_t)
    assert hist_t.shape == (50,)
    assert np.all(np.abs(hist_t - hist_j) <= 1e-5 * np.abs(hist_j))
    for name, a, b in zip(te.MLPGraphParams._fields, pj, pt):
        assert b.dtype == torch.float32
        assert _rel(b, a) <= 1e-4, name


@pytest.mark.parametrize("kind", KINDS)
def test_scores_match_jax(problem, jax_trained, kind):
    R, Xu, Xi = problem
    pj = jax_trained[kind][0]
    got = te.autoencoder_scores(te.experimental_params_from_jax(pj, "cpu"), R, Xu, Xi,
                                kind=kind)
    want = np.asarray(je.autoencoder_scores(pj, R, Xu, Xi, kind=kind))
    assert got.dtype == torch.float32 and got.shape == (U, I)
    assert _rel(got, want) <= 1e-5


def test_hybrid_gat_fusion_lists_match_jax(problem, jax_trained):
    R, Xu, Xi = problem
    pj = jax_trained["gat"][0]
    got = te.hybrid_gat_fusion(te.experimental_params_from_jax(pj, "cpu"), R, Xu, Xi, lam=0.5)
    want = np.asarray(je.hybrid_gat_fusion(pj, R, Xu, Xi, lam=0.5))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    seen = torch.from_numpy(R > 0)
    assert torch.equal(masked_topk(got, seen, 10), masked_topk(torch.tensor(want), seen, 10))


def test_own_seed_init():
    p = te.init_autoencoder(torch.Generator().manual_seed(0), FI, H)
    shapes = {"W1": (FI, H), "b1": (H,), "W2": (H, FI), "b2": (FI,), "a1": (2 * H,),
              "a2": (2 * FI,)}
    assert {n: tuple(t.shape) for n, t in zip(p._fields, p)} == shapes
    assert not p.b1.any() and not p.b2.any()
    for t, fans in ((p.W1, FI + H), (p.W2, H + FI), (p.a1, 2 * H + 1), (p.a2, 2 * FI + 1)):
        bound = np.sqrt(6.0 / fans)
        assert t.abs().max() <= bound and t.abs().max() > 0.5 * bound
    again = te.init_autoencoder(torch.Generator().manual_seed(0), FI, H)
    assert all(torch.equal(a, b) for a, b in zip(p, again))


@pytest.mark.parametrize("kind", KINDS)
def test_training_reduces_mse(problem, kind):
    R, Xu, Xi = problem
    _, history = te.train_autoencoder(R, Xu, Xi, hidden_dim=H, epochs=150, lr=1e-2, kind=kind,
                                      device="cpu")
    assert np.isfinite(history).all()
    assert history[-1] < history[0] * 0.9


def test_unknown_kind_raises(problem):
    with pytest.raises(ValueError, match="kind"):
        te.train_autoencoder(*problem, kind="bogus", device="cpu")


def test_training_defaults_to_the_card(problem, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.train_autoencoder(*problem, epochs=1)
