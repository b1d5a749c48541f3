"""Propagation in the port against the JAX package: the graph arrays it
reads, the dense ``ops/propagation.lightgcn_propagate``, and kernel 1,
``dual_matmul``, through its plain twin (the CUDA kernel itself runs only
on the card, in ``chip_smoke.py``).

Pallas runs in interpret mode, as ``tests/test_pallas_propagation.py`` runs
it. Tolerances:
- dual_matmul on dyadic inputs (multiples of 1/8): every product and sum is
  exact in f32, so the twin equals JAX bitwise, forward and VJP, for all
  four dtype pairs; on normal inputs (f32 pair) within 1e-6 of each
  output's scale (f32 sums in another order);
- the dense f64 path within 1e-12, the f32 path within 1e-5 relative;
- the bf16 wrappers within 2^-7 of each output's scale: the layers cast
  their inputs to bf16 at the same places as JAX, but an f32 sum taken in
  another order can round one bf16 step apart before the next layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.ops import propagation as jprop
from lgcnhs_tpu.ops.pallas import propagation as jpallas
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.ops import propagation as tprop
from lgcnhs_tpu_torch.ops.cuda import propagation as tdual
from lgcnhs_tpu_torch.train.trainer import device_binary_factors

U, I, D = 47, 71, 16
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _dyadic(rng, shape):
    return (rng.integers(-4, 5, shape) / 8).astype(np.float32)


def _edges(rng, U, I, n):
    return (rng.integers(0, U, n).astype(np.int32), rng.integers(0, I, n).astype(np.int32))


def _both(a, name):
    """The same numpy array as a JAX array and a torch tensor of dtype name."""
    return jnp.asarray(a, JAX[name]), torch.from_numpy(np.asarray(a)).to(TORCH[name])


def _scale_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


# -- graph arrays -------------------------------------------------------------


def test_graph_arrays_match_jax():
    rng = np.random.default_rng(0)
    users, items = _edges(rng, U, I, 600)
    users[-5:], items[-5:] = users[:5], items[:5]  # duplicated rows
    t_es, j_es = tgraph.EdgeSet(users, items), jgraph.EdgeSet(users, items)
    for got, want in (
        (tgraph.item_degrees(I, t_es, t_es), jgraph.item_degrees(I, j_es, j_es)),
        (tgraph.user_pos_counts(U, t_es), jgraph.user_pos_counts(U, j_es)),
        (tgraph.users_present(U + 3, t_es), jgraph.users_present(U + 3, j_es)),
        (tgraph.normalized_bipartite(U, I, t_es), jgraph.normalized_bipartite(U, I, j_es)),
        (tgraph.normalized_bipartite(U, I, t_es, dtype=np.float64),
         jgraph.normalized_bipartite(U, I, j_es, dtype=np.float64)),
        *zip(tgraph.binary_incidence_factors(U, I, t_es),
             jgraph.binary_incidence_factors(U, I, j_es)),
    ):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_device_binary_factors_match_numpy():
    rng = np.random.default_rng(1)
    es = tgraph.EdgeSet(*_edges(rng, U + 2, I, 500))  # users U, U+1 may be isolated
    for got, want in zip(device_binary_factors(U + 2, I, es, "cpu"),
                         tgraph.binary_incidence_factors(U + 2, I, es)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


# -- dual_matmul --------------------------------------------------------------


def _dual_problem(rng, r_name, e_name, dyadic=True):
    draw = (lambda s: _dyadic(rng, s)) if dyadic else (
        lambda s: rng.standard_normal(s).astype(np.float32))
    mask = rng.random((U, I)) < 0.3
    R = mask.astype(np.int8) if r_name == "int8" else np.where(mask, draw((U, I)), 0)
    return R, draw((I, D)), draw((U, D)), draw((U, D)), draw((I, D))


@pytest.mark.parametrize("r_name,e_name", [("f32", "f32"), ("bf16", "bf16"),
                                           ("int8", "bf16"), ("int8", "f32")])
def test_dual_matmul_ref_and_vjp_match_jax(r_name, e_name):
    R, X, Y, gU, gI = _dual_problem(np.random.default_rng(2), r_name, e_name)
    Rj, Rt = _both(R, r_name)
    Xj, Xt = _both(X, e_name)
    Yj, Yt = _both(Y, e_name)
    want, vjp = jax.vjp(lambda x, y: jpallas.dual_matmul(Rj, x, y, True), Xj, Yj)
    want_dx, want_dy = vjp((jnp.asarray(gU), jnp.asarray(gI)))
    Xt.requires_grad_(True)
    Yt.requires_grad_(True)
    got = tdual.dual_matmul_ref(Rt, Xt, Yt)
    got_dx, got_dy = torch.autograd.grad(got, (Xt, Yt), (torch.from_numpy(gU),
                                                         torch.from_numpy(gI)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    for g, w in ((got_dx, want_dx), (got_dy, want_dy)):
        assert g.dtype == TORCH[e_name] and w.dtype == JAX[e_name]
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    # the wrapper takes the twin for CPU tensors and launches nothing
    launches = tdual.dual_matmul.launches
    for g, w in zip(tdual.dual_matmul(Rt, Xt, Yt), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tdual.dual_matmul.launches == launches


def test_dual_matmul_ref_f32_continuous_matches_jax():
    R, X, Y, _, _ = _dual_problem(np.random.default_rng(3), "f32", "f32", dyadic=False)
    got = tdual.dual_matmul_ref(*(torch.from_numpy(a) for a in (R, X, Y)))
    want = jpallas.dual_matmul(*(jnp.asarray(a) for a in (R, X, Y)), True)
    for g, w in zip(got, want):
        _scale_close(g.numpy(), w, 1e-6)


def test_dual_matmul_rejects_mixed_dtypes():
    R = torch.ones((8, 16))
    Xb, Yb = torch.ones((16, 4), dtype=torch.bfloat16), torch.ones((8, 4), dtype=torch.bfloat16)
    for args in ((R, Xb, Yb), (R.bfloat16(), Xb, Yb.float()), (R.to(torch.int16), Xb, Yb)):
        for fn in (tdual.dual_matmul_ref, tdual.dual_matmul):
            with pytest.raises(ValueError, match="dtypes must agree"):
                fn(*args)
    with pytest.raises(ValueError, match="shape mismatch"):
        tdual.dual_matmul_ref(R, torch.ones((15, 4)), torch.ones((8, 4)))


def test_dual_guard_and_transpose():
    """The guard sized from the kernel's shared memory; R is read in its
    own layout (no transposed copy): a padded-stride view goes through."""
    h100 = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100
    assert tdual.fits_smem_dual(64, h100) and tdual.fits_smem_dual(128, h100)
    assert not tdual.fits_smem_dual(129, h100) and not tdual.fits_smem_dual(0, h100)
    widest = max(tdual.smem_bytes(64, r, e) for r, e in tdual.PAIRS)
    assert widest == tdual.smem_bytes(64, torch.float32, torch.float32) == 143_360
    assert not tdual.fits_smem_dual(64, widest - 1) and tdual.fits_smem_dual(64, widest)
    # propagation.cu Layout: 4 stages of (raw R chunk + 64 rows of X or Y);
    # int8 R is widened in registers, so no bf16 copy of the chunk is kept;
    # 128-row tiles for the bf16 pairs to D=64
    assert tdual.smem_bytes(64) == 4 * (128 * 80 + 64 * 64 * 2) == 73_728
    assert tdual.smem_bytes(128) == 4 * (64 * 80 + 64 * 128 * 2) == 86_016
    assert tdual.smem_bytes(64, torch.bfloat16, torch.bfloat16) == \
        4 * (128 * 72 * 2 + 64 * 64 * 2) == 106_496
    assert tdual.smem_bytes(128, torch.float32, torch.float32) == 208_896
    # a block's output rows: 128 for the bf16 pairs up to DT = 64, else 64
    assert tdual.smem_bytes(128, torch.bfloat16, torch.bfloat16) == \
        4 * (64 * 72 * 2 + 64 * 128 * 2) == 102_400
    assert tdual.smem_bytes(64, torch.float32, torch.float32) == \
        4 * (64 * 68 * 4 + 64 * 72 * 4) == 143_360
    # X/Y tiles DT wide: d rounded up to 16, 32, 64 or 128
    assert [tdual.smem_bytes(d) for d in (1, 3, 16, 17, 20, 64, 65, 128)] == \
        [4 * (128 * 80 + 64 * dt * 2) for dt in (16, 16, 16, 32, 32, 64)] + [86_016] * 2
    assert tdual.fits_dual(4096, torch.device("cpu"))  # the twin takes any width
    assert not hasattr(tdual, "transpose_for_dual")
    R = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    Rp = tdual.pad_for_dual(R)
    assert torch.equal(Rp, R) and Rp.stride() == (64, 1)
    X, Y = torch.ones((4, 2)), torch.ones((3, 2))
    for g, w in zip(tdual.dual_matmul(Rp, X, Y), tdual.dual_matmul_ref(R, X, Y)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_dual_splits_fill_the_card_once():
    """Split-K sizing: at ML-1M (int8/bf16, D=64, 132 SMs, two blocks an SM)
    role U's 58 item chunks go in 3 parts, role I's 95 user chunks in 4:
    48 * 3 + 29 * 4 = 260 blocks, all resident; with enough tiles, none."""
    def block_rows(d, e):  # the launcher's dual_matmul_block_rows
        return 128 if e == torch.bfloat16 and d <= 64 else 64

    def splits(U_, I_, d, r, e):
        return tdual.dual_splits(U_, I_, block_rows(d, e), 2 * 132)

    assert splits(6040, 3706, 64, torch.int8, torch.bfloat16) == (3, 4)
    for U_, I_, d in ((6040, 3706, 64), (300, 70, 8), (70, 1000, 128), (1, 1, 8)):
        for r, e in tdual.PAIRS:
            su, si = splits(U_, I_, d, r, e)
            bm = block_rows(d, e)
            assert 1 <= su <= -(-I_ // 64) and 1 <= si <= -(-U_ // 64)
            assert (su, si) == (1, 1) or -(-U_ // bm) * su + -(-I_ // bm) * si <= 2 * 132
    assert splits(60_000, 60_000, 64, torch.int8, torch.bfloat16) == (1, 1)


@pytest.mark.parametrize("r_name,e_name", [("f32", "f32"), ("bf16", "bf16"),
                                           ("int8", "bf16"), ("int8", "f32")])
def test_pad_for_dual_view_equals_r_and_matches_jax(r_name, e_name):
    """R's padded-stride copy: its (U, I) view equals R, its row stride is a
    multiple of 64 entries with zeros past I, and the twin through it equals
    the twin without it and the Pallas kernel in interpret mode."""
    R, X, Y, gU, gI = _dual_problem(np.random.default_rng(5), r_name, e_name)
    Rj, Rt = _both(R, r_name)
    Rp = tdual.pad_for_dual(Rt)
    assert Rp.shape == Rt.shape and Rp.dtype == Rt.dtype and torch.equal(Rp, Rt)
    ld = Rp.stride(0)
    assert Rp.stride(1) == 1 and ld % tdual.ROW_ALIGN == 0 and ld >= I
    full = torch.as_strided(Rp, (U, ld), (ld, 1))
    assert not full[:, I:].any()
    assert tdual.rows_aligned(Rp) and not tdual.rows_aligned(Rt)  # I = 71 entries a row
    _, Xt = _both(X, e_name)
    _, Yt = _both(Y, e_name)
    Xj, Yj = jnp.asarray(X, JAX[e_name]), jnp.asarray(Y, JAX[e_name])
    want = jpallas.dual_matmul(Rj, Xj, Yj, True)
    cot = (torch.from_numpy(gU), torch.from_numpy(gI))
    results = []
    for r in (Rp, Rt):
        x, y = Xt.clone().requires_grad_(True), Yt.clone().requires_grad_(True)
        out = tdual.dual_matmul_ref(r, x, y)
        results.append((*out, *torch.autograd.grad(out, (x, y), cot)))
    for g, w in zip(results[0], results[1]):
        assert torch.equal(g, w)
    for g, w in zip(results[0][:2], want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


# -- the wrappers ---------------------------------------------------------------


@pytest.fixture(scope="module")
def binary_problem():
    rng = np.random.default_rng(4)
    users, items = _edges(rng, U, I, 500)
    t_es, j_es = tgraph.EdgeSet(users, items), jgraph.EdgeSet(users, items)
    R_hat = jgraph.normalized_bipartite(U, I, j_es)
    R8, du, di = tgraph.binary_incidence_factors(U, I, t_es)
    eu = (0.3 * rng.standard_normal((U, D))).astype(np.float32)
    ei = (0.3 * rng.standard_normal((I, D))).astype(np.float32)
    w_u = rng.standard_normal((U, D)).astype(np.float32)
    w_i = rng.standard_normal((I, D)).astype(np.float32)
    return R_hat, (R8, du, di), eu, ei, w_u, w_i


def _forward_and_grads(fn, eu, ei, w_u, w_i, framework):
    """Both outputs, and the gradients of sum(a_u w_u) + sum(a_i w_i)."""
    if framework == "jax":
        def f(u, i):
            a_u, a_i = fn(u, i)
            return jnp.sum(a_u * w_u) + jnp.sum(a_i * w_i), (a_u, a_i)

        (_, outs), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(eu), jnp.asarray(ei))
        return [np.asarray(a) for a in (*outs, *grads)]
    u, i = torch.tensor(eu, requires_grad=True), torch.tensor(ei, requires_grad=True)
    a_u, a_i = fn(u, i)
    grads = torch.autograd.grad((a_u * torch.from_numpy(w_u)).sum()
                                + (a_i * torch.from_numpy(w_i)).sum(), (u, i))
    return [a.detach().numpy() for a in (a_u, a_i, *grads)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_propagate_dual_wrappers_match_pallas(binary_problem, bf16):
    R_hat, (R8, du, di), eu, ei, w_u, w_i = binary_problem
    rel = 2.0 ** -7 if bf16 else 1e-5
    cases = (
        (lambda u, i: jpallas.lightgcn_propagate_pallas(u, i, jnp.asarray(R_hat), 3, bf16, True),
         lambda u, i: tdual.lightgcn_propagate_dual(u, i, torch.from_numpy(R_hat), 3, bf16)),
        (lambda u, i: jpallas.lightgcn_propagate_pallas_binary(
            u, i, jnp.asarray(R8), jnp.asarray(du), jnp.asarray(di), 3, bf16, True),
         lambda u, i: tdual.lightgcn_propagate_dual_binary(
            u, i, torch.from_numpy(R8), torch.from_numpy(du), torch.from_numpy(di), 3, bf16)),
    )
    for j_fn, t_fn in cases:
        want = _forward_and_grads(j_fn, eu, ei, w_u, w_i, "jax")
        got = _forward_and_grads(t_fn, eu, ei, w_u, w_i, "torch")
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            _scale_close(g, w, rel)


# -- dense propagation -----------------------------------------------------------


def test_lightgcn_propagate_f64_matches_jax(binary_problem):
    R_hat, _, eu, ei, w_u, w_i = binary_problem
    R64 = R_hat.astype(np.float64)
    eu64, ei64, wu64, wi64 = (a.astype(np.float64) for a in (eu, ei, w_u, w_i))
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = _forward_and_grads(lambda u, i: jprop.lightgcn_propagate(u, i, jnp.asarray(R64), 3),
                                  eu64, ei64, wu64, wi64, "jax")
    finally:
        jax.config.update("jax_enable_x64", was)
    got = _forward_and_grads(lambda u, i: tprop.lightgcn_propagate(u, i, torch.from_numpy(R64), 3),
                             eu64, ei64, wu64, wi64, "torch")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lightgcn_propagate_f32_matches_jax(binary_problem, bf16):
    R_hat, _, eu, ei, w_u, w_i = binary_problem
    want = _forward_and_grads(
        lambda u, i: jprop.lightgcn_propagate(u, i, jnp.asarray(R_hat), 3, bf16),
        eu, ei, w_u, w_i, "jax")
    got = _forward_and_grads(
        lambda u, i: tprop.lightgcn_propagate(u, i, torch.from_numpy(R_hat), 3, bf16),
        eu, ei, w_u, w_i, "torch")
    for g, w in zip(got[:2], want[:2]):
        _scale_close(g, w, 2.0 ** -7 if bf16 else 1e-5)
    if not bf16:  # the bf16 flavor's gradients are pinned through the dual wrappers
        for g, w in zip(got[2:], want[2:]):
            _scale_close(g, w, 1e-5)
