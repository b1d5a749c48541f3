"""The port's large-graph propagation (``lgcnhs_tpu_torch/ops/propagation.py``:
``edge_gcn_norm``, the COO segment sum, the bucketed-ELL layout with its
self-adjoint backward) and ``data/graph.device_bf16_incidence`` against
``lgcnhs_tpu``, on the same numpy-seeded inputs.

Tolerances: the bucketed arrays and the bf16 incidence identical; the edge
weights within one f32 step of JAX's (XLA's f32 rsqrt is not correctly
rounded; the port rounds d^-1/2 from f64) and equal to the f64 weights
rounded to f32; propagation with the same weights within 1e-12 under x64
and 1e-5 relative at f32 (sums in another order); the self-adjoint
gradient within 1e-12 relative of autograd through the plain COO
propagation at f64.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.config import ComputeConfig as JCompute
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.ops import propagation as jprop
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch.config import ComputeConfig as TCompute
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.ops import propagation as tprop
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D = 150, 90, 8


@contextlib.contextmanager
def x64(on: bool):
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _skewed_edges(seed=0):
    """Deduped edges with heavy hubs: item 0 is every user's (147 users,
    past the 128 of the linear caps: a 1/8-octave cap), user 0 has every
    item, and a few nodes have no edge."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U - 3, 1500)
    i = rng.integers(0, I - 2, 1500)
    u = np.concatenate([u, np.arange(U - 3), np.zeros(I - 2, np.int64)])
    i = np.concatenate([i, np.zeros(U - 3, np.int64), np.arange(I - 2)])
    es = tgraph.unique_edges(tgraph.EdgeSet(u.astype(np.int32), i.astype(np.int32)))
    return es.users, es.items


def _tables(seed, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((U, D)).astype(dtype), rng.standard_normal((I, D)).astype(dtype))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_edge_gcn_norm_matches_jax():
    eu, ei = _skewed_edges(1)
    got = tprop.edge_gcn_norm(_t(eu), _t(ei), U, I)
    assert got.dtype == torch.float32
    want = np.asarray(jprop.edge_gcn_norm(jnp.asarray(eu), jnp.asarray(ei), U, I))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)
    du = np.bincount(eu, minlength=U).astype(np.float64)
    di = np.bincount(ei, minlength=I).astype(np.float64)
    exact = (1 / np.sqrt(du[eu])).astype(np.float32) * (1 / np.sqrt(di[ei])).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)
    # binary degrees: the weights of the dense normalized_bipartite
    R_hat = tgraph.normalized_bipartite(U, I, tgraph.EdgeSet(eu, ei), dtype=np.float64)
    np.testing.assert_allclose(got.numpy(), R_hat[eu, ei], rtol=2.5e-7, atol=0)  # 3 roundings


@pytest.mark.parametrize("min_cap", [4, 1])
def test_bucketed_incidence_identical_to_jax(min_cap):
    eu, ei = _skewed_edges(2)
    w = np.random.default_rng(3).random(eu.shape[0]).astype(np.float32)
    want = jprop.build_bucketed_incidence(eu, ei, w, U, I, min_cap=min_cap)
    got = tprop.build_bucketed_incidence(eu, ei, w, U, I, min_cap=min_cap)
    for side in ("users", "items"):
        g, j = getattr(got, side), getattr(want, side)
        assert len(g.nbr) == len(j.nbr) == len(g.w) > 2
        for a, b in zip(g.nbr + g.w + (g.inv,), j.nbr + j.w + (j.inv,)):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    caps = [m.shape[1] for m in got.users.nbr + got.items.nbr]
    assert max(caps) > 128  # the octave branch of _bucket_caps ran


def test_bucket_caps_match_jax():
    deg = np.concatenate([np.arange(0, 3000), [4095, 4096, 4097, 10_000, 123_457]])
    for min_cap in (1, 4, 8):
        np.testing.assert_array_equal(tprop._bucket_caps(deg, min_cap),
                                      jprop._bucket_caps(deg, min_cap))


@pytest.mark.parametrize("layout", ["coo", "bucketed"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_propagation_matches_jax(layout, dtype):
    eu, ei = _skewed_edges(4)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    w = (np.random.default_rng(5).random(eu.shape[0]) + 0.1).astype(np_dtype)
    ue, ie = _tables(6, np_dtype)
    with x64(dtype == "float64"):
        if layout == "coo":
            want = jprop.lightgcn_propagate_coo(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(eu),
                                                jnp.asarray(ei), jnp.asarray(w), U, I, 3)
        else:
            want = jprop.lightgcn_propagate_bucketed(
                jnp.asarray(ue), jnp.asarray(ie),
                jprop.build_bucketed_incidence(eu, ei, w, U, I), 3)
        want = [np.asarray(x) for x in want]
    if layout == "coo":
        got = tprop.lightgcn_propagate_coo(torch.from_numpy(ue), torch.from_numpy(ie), _t(eu),
                                           _t(ei), torch.from_numpy(w), U, I, 3)
    else:
        got = tprop.lightgcn_propagate_bucketed(
            torch.from_numpy(ue), torch.from_numpy(ie),
            tprop.build_bucketed_incidence(eu, ei, w, U, I), 3)
    for g, j in zip(got, want):
        assert g.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        if dtype == "float64":
            np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


def test_layouts_agree_with_the_dense_propagation():
    """COO, bucketed and dense propagation of the same graph, f64."""
    eu, ei = _skewed_edges(7)
    norm = tprop.edge_gcn_norm(_t(eu), _t(ei), U, I).double()
    ue, ie = (torch.from_numpy(t) for t in _tables(8, np.float64))
    R_hat = torch.zeros((U, I), dtype=torch.float64)
    R_hat[_t(eu), _t(ei)] = norm
    want = tprop.lightgcn_propagate(ue, ie, R_hat, 3)
    binc = tprop.build_bucketed_incidence(eu, ei, norm.numpy(), U, I)
    for got in (tprop.lightgcn_propagate_coo(ue, ie, _t(eu), _t(ei), norm, U, I, 3),
                tprop.lightgcn_propagate_bucketed(ue, ie, binc, 3)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


def test_self_adjoint_gradient_matches_autograd_of_the_coo_propagation():
    """The bucketed propagation's backward (the pair applied to the output
    gradients, no scatter) against autograd through the plain COO
    propagation's gathers and ``index_add_``, f64; and torch's gradcheck of
    the autograd.Function itself on a smaller graph."""
    eu, ei = _skewed_edges(9)
    norm = torch.from_numpy((np.random.default_rng(10).random(eu.shape[0]) + 0.1))
    binc = tprop.build_bucketed_incidence(eu, ei, norm.numpy(), U, I)
    rng = np.random.default_rng(11)
    cot_u, cot_i = (torch.from_numpy(rng.standard_normal(s)) for s in ((U, D), (I, D)))
    grads = []
    for run in ("bucketed", "coo"):
        ue, ie = (torch.from_numpy(t).requires_grad_(True) for t in _tables(12, np.float64))
        if run == "bucketed":
            out = tprop.lightgcn_propagate_bucketed(ue, ie, binc, 3)
        else:
            out = tprop.lightgcn_propagate_coo(ue, ie, _t(eu), _t(ei), norm, U, I, 3)
        loss = (out[0] * cot_u).sum() + (out[1] * cot_i).sum() + (out[0] ** 2).sum()
        grads.append(torch.autograd.grad(loss, (ue, ie)))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)

    small_u, small_i = eu < 20, ei < 15
    keep = small_u & small_i
    sb = tprop.build_bucketed_incidence(eu[keep], ei[keep], norm.numpy()[keep], 20, 15)
    pair = tprop.make_bucketed_propagator(sb)
    x_u = torch.from_numpy(rng.standard_normal((20, 3))).requires_grad_(True)
    x_i = torch.from_numpy(rng.standard_normal((15, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(pair, (x_u, x_i))


def test_choose_propagation_matches_jax():
    """The single-device dispatch, both dtypes, on both sides of the 4 GB
    budget and of the density threshold."""
    shapes = ((6040, 3706, 545_390), (50_000, 30_000, 2_000_000), (50_000, 30_000, 1_400_000),
              (200_000, 100_000, 5_000_000), (10_000, 10_000, 500), (30_000, 40_000, 2_000_000),
              (1000, 2000, 100_000), (100, 100, 5))
    for dtype in ("float32", "bfloat16"):
        for threshold in (0.001, 0.0, 1.0):
            t = TCompute(dtype=dtype, dense_threshold=threshold)
            j = JCompute(dtype=dtype, dense_threshold=threshold)
            for shape in shapes:
                assert ttrainer.choose_propagation(*shape, t) == \
                    jtrainer.choose_propagation(*shape, j), (dtype, threshold, shape)


def test_device_bf16_incidence_identical_to_jax():
    eu, ei = _skewed_edges(13)
    # repeated rows collapse: binary degrees
    es_t = tgraph.EdgeSet(np.r_[eu, eu[:40]], np.r_[ei, ei[:40]])
    got = tgraph.device_bf16_incidence(U, I, es_t, "cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (U, I)
    want = jgraph.device_bf16_incidence(U, I, jgraph.EdgeSet(es_t.users, es_t.items))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
