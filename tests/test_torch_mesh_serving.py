"""Item-sharded serving, ranking and diffusion of ``lgcnhs_tpu_torch`` on
CPU ranks (``tests/torch_mesh_worker.py``, gloo, one spawn per mesh shape)
against the port's single-device functions and JAX's sharded functions at
the same mesh shape (JAX on ``tests/conftest.py``'s 8 CPU devices).

One seeded problem: 37 users x 131 items (neither divides a model axis of
2 or 4; the last of 4 item blocks holds 32 real items), D=16. Retrieval
runs on continuous tables with two users scoring below the -1024 sentinel
everywhere (one of them with seen items, which then rank first); the
masked top-k and the spread ranker on dyadic scores (many exact ties); the
fused ranking on the tables and a 0/1 interaction matrix with empty users
and items.

- ``distributed_masked_topk`` and ``distributed_retrieve_topk``: ids
  identical to ``masked_topk`` / ``retrieve_topk`` and to JAX's sharded
  functions (ties to the lowest index), at k=1 and 33 (33 is a whole
  block at (1, 4): the last rank fills its 33rd slot with -inf).
- ``distributed_rank_exclude_seen`` with ``filter_seen`` True and False:
  ids identical to ``rank_exclude_seen_topk`` and to JAX's.
- ``distributed_fused_recommend``: ids identical to JAX's, and to
  ``fused_recommend`` except among exact zeros. F is 0 wherever no
  co-occurrence reaches an item, so G * F holds +0.0 and -0.0 ties; the
  sharded ranker's merge ties them (``jnp.lexsort`` compares them equal,
  JAX and the port alike) where the single-device ranker puts +0.0 first
  (the total order of ``top_k``). Every other slot is identical.
- ``sharded_diffusion_scores`` within 1e-5 of scale of the single-device
  diffusion (131 items, padded) and of JAX's sharded function (128 items:
  JAX's ``device_put`` needs a dividing catalog there).
- The ``k > block`` ValueError, in JAX's words.
- Every rank gets the same global result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.models import fusion as jfusion
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.parallel import sharding as jshard
from lgcnhs_tpu.runtime.mesh import make_mesh as j_make_mesh
from lgcnhs_tpu_torch.models.fusion import fused_recommend
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops import diffusion as tdiff
from lgcnhs_tpu_torch.ops import topk as ttopk
from torch_port_checks import MeshRun, dyadic

U, I, D = 37, 131, 16
KS = (1, 33)
LAM = 0.6
SHAPES = [(1, 2), (2, 2), (1, 4)]
I_DIV = 128  # a catalog JAX's sharded_diffusion_scores takes at every shape


def _inputs():
    rng = np.random.default_rng(11)
    ue = (rng.standard_normal((U, D)) * 0.3).astype(np.float32)
    ie = (rng.standard_normal((I, D)) * 0.3).astype(np.float32)
    seen = rng.random((U, I)) < 0.08
    # users 0 and 1 score below -1024 everywhere; user 1's seen items outrank
    ie[:, 0] = 1.0 + np.abs(ie[:, 0])
    ue[:2] = 0.0
    ue[:2, 0] = -3000.0
    seen[:2] = False
    seen[1, [5, 17, 130]] = True
    A = (rng.random((U, I)) < 0.1).astype(np.float32)
    A[3] = 0.0  # a user with no interaction
    A[:, [4, 77]] = 0.0  # items with none
    return {"ue": ue, "ie": ie, "seen": seen, "scores": dyadic(rng, (U, I)), "A": A,
            "A_div": np.ascontiguousarray(A[:, :I_DIV]), "lam": LAM, "ks": np.asarray(KS)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(inputs, {shape: every rank's outputs})."""
    root = tmp_path_factory.mktemp("mesh_serve")
    inputs = _inputs()
    started = {}
    for shape in SHAPES:
        block = -(-I // shape[1])
        started[shape] = MeshRun("serve", shape, {**inputs, "k_over": block + 1},
                                 root / f"{shape[0]}x{shape[1]}")
    return inputs, {shape: run.results() for shape, run in started.items()}


def _single_device(name, inp, k):
    t = {n: torch.from_numpy(np.asarray(inp[n])) for n in ("ue", "ie", "seen", "scores", "A")}
    if name == "masked":
        return ttopk.masked_topk(t["scores"], t["seen"], k)
    if name == "retrieve":
        return ttopk.retrieve_topk(t["ue"], t["ie"], t["seen"], k)
    if name.startswith("rank."):
        return ttopk.rank_exclude_seen_topk(t["scores"], t["seen"], k, name == "rank.True")
    return fused_recommend(LightGCNParams(t["ue"], t["ie"]), t["A"], t["seen"],
                           torch.tensor(LAM), k)


def _jax_sharded(name, inp, k, shape):
    mesh = j_make_mesh(shape)
    seen = jnp.asarray(inp["seen"])
    if name == "masked":
        return jshard.distributed_masked_topk(mesh, jnp.asarray(inp["scores"]), seen, k)
    if name == "retrieve":
        return jshard.distributed_retrieve_topk(mesh, jnp.asarray(inp["ue"]),
                                                jnp.asarray(inp["ie"]), seen, k)
    if name.startswith("rank."):
        return jshard.distributed_rank_exclude_seen(mesh, jnp.asarray(inp["scores"]), seen, k,
                                                    filter_seen=name == "rank.True")
    return jfusion.distributed_fused_recommend(
        mesh, JParams(jnp.asarray(inp["ue"]), jnp.asarray(inp["ie"])), jnp.asarray(inp["A"]),
        seen, jnp.asarray(LAM, jnp.float32), k)


RANKERS = ["masked", "retrieve", "rank.True", "rank.False", "fused"]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", RANKERS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_ranking_ids(served, shape, name, k):
    inp, outs = served
    got = outs[shape][0][f"{name}.{k}"]
    assert got.shape == (U, k) and got.dtype == np.int32
    for out in outs[shape][1:]:
        np.testing.assert_array_equal(out[f"{name}.{k}"], got)
    np.testing.assert_array_equal(got, np.asarray(_jax_sharded(name, inp, k, shape)))
    want = _single_device(name, inp, k).numpy()
    if name != "fused":
        np.testing.assert_array_equal(got, want)
        return
    G = inp["ue"] @ inp["ie"].T
    G[inp["seen"]] = -1024.0
    F = tdiff.diffusion_scores(torch.from_numpy(inp["A"]), torch.tensor(LAM)).numpy()
    fused = G * F
    rows = np.arange(U)[:, None]
    apart = got != want
    # only ids of exact zeros (+0.0 against -0.0) trade places
    assert (fused[rows, got][apart] == 0).all() and (fused[rows, want][apart] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_diffusion(served, shape):
    inp, outs = served
    got = outs[shape][0]["diffusion"]
    want = tdiff.diffusion_scores(torch.from_numpy(inp["A"]), torch.tensor(LAM)).numpy()
    scale = float(np.abs(want).max())
    assert got.shape == (U, I)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    for out in outs[shape][1:]:
        np.testing.assert_array_equal(out["diffusion"], got)
    got_div = outs[shape][0]["diffusion_div"]
    want_div = np.asarray(jshard.sharded_diffusion_scores(
        j_make_mesh(shape), jnp.asarray(inp["A_div"]), LAM))
    np.testing.assert_allclose(got_div, want_div, rtol=0,
                               atol=1e-5 * float(np.abs(want_div).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k_beyond_a_block_raises_as_jax(served, shape):
    inp, outs = served
    block = -(-I // shape[1])
    with pytest.raises(ValueError) as want:
        jshard.distributed_masked_topk(j_make_mesh(shape), jnp.asarray(inp["scores"]),
                                       jnp.asarray(inp["seen"]), block + 1)
    for out in outs[shape]:
        assert str(out["k_over_msg"]) == str(want.value) == \
            f"k={block + 1} exceeds shard width {block}"
