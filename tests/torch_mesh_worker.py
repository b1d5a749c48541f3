"""One rank of a CPU mesh run of ``lgcnhs_tpu_torch`` (driven by
``tests/test_torch_mesh*.py``; not collected: no test_ prefix).

Each rank joins a gloo process group through a file store, builds the
(data, model) mesh, runs one suite of cases on inputs the test process
wrote to an npz, and writes its outputs to ``<out_dir>/<rank>.npz``. It
imports torch and the port only.

Usage: python torch_mesh_worker.py RANK WORLD STORE SUITE IN_NPZ OUT_DIR
"""
import contextlib
import io
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cfg(inp, case, **extra):
    """The trainer config of a training case (tests/test_mesh_flagship.py's
    schedule: 6 epochs, an eval every 3, batch 64, k=7)."""
    from lgcnhs_tpu_torch import config as tcfg

    over = {"synthetic_users": int(inp["users"]), "synthetic_items": int(inp["items"]),
            "synthetic_interactions": int(inp["interactions"]), "hparams.epochs": 6,
            "hparams.epoch_per_eval": 3, "hparams.batch_size": 64, "k": 7,
            "compute.dtype": {"f64": "float64", "bf16": "bfloat16",
                              "kernel": "bfloat16"}.get(case, "float32")}
    over.update(extra)
    return tcfg.load_config(dataset="synthetic", model="LightGCN", overrides=over)


def suite_train(inp, mesh, out):
    """mesh_from_config at this world size, each rank's blocks, and the
    mesh trainer on every case (whole tables and history on every rank)."""
    import numpy as np
    import torch

    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import (
        build_graph, normalized_bipartite, pos_bool_matrix, unique_edges,
    )
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.runtime import mesh as rmesh
    from lgcnhs_tpu_torch.train import trainer

    world = mesh.size
    base = _cfg(inp, "f32")
    out["none_11"] = rmesh.mesh_from_config(base.compute) is None
    auto = rmesh.mesh_from_config(_cfg(inp, "f32", **{"compute.mesh_shape": (0, 0)}).compute)
    out["auto_shape"] = np.asarray([auto.shape["data"], auto.shape["model"]])
    try:
        rmesh.mesh_from_config(_cfg(inp, "f32", **{"compute.mesh_shape": (world, 2)}).compute)
    except ValueError as e:
        out["mismatch_msg"] = str(e)

    splits, uf, itf = load_dataset(base, "cpu")
    graph = build_graph(splits)
    U, I = graph.n_users, graph.n_items
    plan = sharding.make_plan(mesh)
    es = unique_edges(graph.train)
    R, pos, eu, _ = sharding.shard_train_inputs(
        plan, normalized_bipartite(U, I, graph.train), pos_bool_matrix(U, I, graph.train),
        es.users, es.items)
    gen = torch.Generator().manual_seed(0)
    tables = sharding.shard_params(plan, LightGCNParams(torch.randn(U, 8, generator=gen),
                                                        torch.randn(I, 8, generator=gen)))
    for name, t in (("R", R), ("pos", pos), ("user_emb", tables.user_emb),
                    ("item_emb", tables.item_emb), ("edges", eu)):
        out[f"block.{name}"] = np.asarray(t.shape)
        # the block owns its memory: no view into the global array
        out[f"bytes.{name}"] = np.asarray([t.untyped_storage().nbytes(),
                                           t.numel() * t.element_size()])

    uses_kernels = trainer.uses_kernels
    for case in [str(c) for c in inp["cases"]]:
        extra = {"compute.mesh_shape": tuple(int(x) for x in inp["mesh"])}
        feats = (uf, itf) if case == "opti" else (None, None)
        # the factored int8 route for "kernel", the kernel's twin on the CPU
        trainer.uses_kernels = (lambda compute, device: True) if case == "kernel" \
            else uses_kernels
        if case == "resume":
            ckpt = os.path.join(str(inp["tmp"]), "ckpt")
            trainer.train_lightgcn(graph, _cfg(inp, case, **extra, **{"hparams.epochs": 4}),
                                   save_artifacts=False, checkpoint_dir=ckpt,
                                   checkpoint_every=2, device="cpu")
            result = trainer.train_lightgcn(graph, _cfg(inp, case, **extra), save_artifacts=False,
                                            checkpoint_dir=ckpt, checkpoint_every=2,
                                            device="cpu")
        else:
            result = trainer.train_lightgcn(graph, _cfg(inp, case, **extra), *feats,
                                            save_artifacts=False, device="cpu")
        out[f"{case}.user_emb"] = result.params.user_emb.numpy()
        out[f"{case}.item_emb"] = result.params.item_emb.numpy()
        for name, series in result.history.items():
            out[f"{case}.history.{name}"] = np.asarray(series, np.float64)


def suite_serve(inp, mesh, out):
    """The distributed rankers and the sharded diffusion on global inputs."""
    import torch

    from lgcnhs_tpu_torch.models.fusion import distributed_fused_recommend
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.parallel import sharding

    t = {name: torch.from_numpy(inp[name])
         for name in ("ue", "ie", "seen", "scores", "A", "A_div")}
    lam = torch.tensor(float(inp["lam"]), dtype=torch.float32)
    for k in (int(x) for x in inp["ks"]):
        out[f"masked.{k}"] = sharding.distributed_masked_topk(mesh, t["scores"], t["seen"], k)
        out[f"retrieve.{k}"] = sharding.distributed_retrieve_topk(mesh, t["ue"], t["ie"],
                                                                  t["seen"], k)
        for filter_seen in (True, False):
            out[f"rank.{filter_seen}.{k}"] = sharding.distributed_rank_exclude_seen(
                mesh, t["scores"], t["seen"], k, filter_seen)
        out[f"fused.{k}"] = distributed_fused_recommend(
            mesh, LightGCNParams(t["ue"], t["ie"]), t["A"], t["seen"], lam, k)
    out["diffusion"] = sharding.sharded_diffusion_scores(mesh, t["A"], lam)
    out["diffusion_div"] = sharding.sharded_diffusion_scores(mesh, t["A_div"], lam)
    try:
        sharding.distributed_masked_topk(mesh, t["scores"], t["seen"], int(inp["k_over"]))
    except ValueError as e:
        out["k_over_msg"] = str(e)


def suite_sweep(inp, mesh, out):
    """The three sharded sweeps (both layouts of ``sharded_lambda_sweep``)."""
    import torch

    from lgcnhs_tpu_torch.ops import sweep

    a = {name: torch.from_numpy(inp[name]) for name in
         ("G", "A", "W_gen", "seen", "eval_pos", "eval_counts", "eval_present", "S",
          "item_deg")}
    lams, k = inp["lambdas"], int(inp["k"])
    dense = [a[n] for n in ("G", "A", "W_gen", "seen", "eval_pos", "eval_counts",
                            "eval_present", "S")]
    out["grid"] = sweep.sharded_lambda_sweep(mesh, lams, *dense, k=k)
    out["item"] = sweep.sharded_lambda_sweep(mesh, lams, *dense, k=k, memory_budget_bytes=1)
    built = [a["G"], a["A"], None, a["seen"], a["eval_pos"], a["eval_counts"],
             a["eval_present"], None]
    out["gram"] = sweep.item_sharded_lambda_sweep(mesh, lams, *built, k=k,
                                                  item_deg=a["item_deg"])
    out["grid_built"] = sweep.sharded_lambda_sweep(mesh, lams, *built, k=k,
                                                   item_deg=a["item_deg"])
    out["tall"] = sweep.sharded_lambda_sweep_tall(
        mesh, lams, a["G"], a["A"], a["seen"], a["eval_pos"], a["eval_counts"],
        a["eval_present"], a["item_deg"], k=k)


def suite_cli(inp, mesh, out):
    """cli/main and cli/find_lambda with --mesh on the workdirs the test
    wrote; rank 0's printed lines kept."""
    from lgcnhs_tpu_torch.cli import find_lambda, main

    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        for model in [str(m) for m in inp["models"]]:
            main.main([*[str(a) for a in inp["main_args"]], "--model", model])
        find_lambda.main([str(a) for a in inp["lambda_args"]])
    out["stdout"] = stdout.getvalue()


def suite_coo(inp, mesh, out):
    """The edge-sharded COO half: the rank's edge blocks, one step of each
    layout and of the table-sharded plan on injected triples, the
    table-sharded scan against its step loop, the user-sharded CSR top-k,
    and the mesh trainer on the COO route with both plans (single-device
    COO factories poisoned), uninterrupted and resumed."""
    import numpy as np
    import torch

    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import EdgeSet, build_graph
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.ops.scalable import csr_keys, user_csr
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.train import trainer
    from lgcnhs_tpu_torch.train.checkpoint import optimizer_state

    U, I = int(inp["U"]), int(inp["I"])
    eu, ei, norm = inp["eu"], inp["ei"], inp["norm"]
    plan = sharding.make_plan(mesh)
    U_pad, I_pad = sharding.padded_catalog(plan, U, I)
    order = sharding.shard_coo_edges(plan, eu, ei, norm)
    for field, value in zip(order._fields, order):
        out[f"order.{field}"] = value
    hp = _cfg(inp, "f32", **{"hparams.embedding_dim": int(inp["D"])}).hparams
    edge_users, edge_items = (torch.from_numpy(a.astype(np.int64)) for a in (eu, ei))
    keys = csr_keys(*user_csr(U, EdgeSet(eu, ei)), mesh.device)
    se = {"bucketed": sharding.shard_bucketed_incidence(plan, eu, ei, norm, U, I),
          "segment": order}
    se_pad = sharding.shard_bucketed_incidence(plan, eu, ei, norm, U_pad, I_pad)

    def tables(sharded):
        init = LightGCNParams(torch.from_numpy(inp["ue0"]), torch.from_numpy(inp["ie0"]))
        blocks = sharding.shard_params(plan, init) if sharded else init
        return LightGCNParams(*(t.clone().requires_grad_(True) for t in blocks))

    def keep(prefix, params, loss):
        out[f"{prefix}.loss"] = loss
        for name, t in zip(LightGCNParams._fields, params):
            out[f"{prefix}.{name}"] = t.detach()

    # one step on the injected triples (the sampler's draws replaced)
    triples = tuple(torch.from_numpy(inp[n].astype(np.int64))
                    for n in ("t_users", "t_pos", "t_neg"))
    sampler = sharding.sample_bpr_batch_csr
    sharding.sample_bpr_batch_csr = lambda *a, **kw: triples
    try:
        for layout in ("bucketed", "segment"):
            params = tables(False)
            step = sharding.make_sharded_coo_train_step(
                plan, trainer.make_optimizer(hp, params), hp, U, I, layout=layout)
            keep(f"step.{layout}", params,
                 step(params, 0, None, se[layout], edge_users, edge_items, keys))
        params = tables(True)
        opt = trainer.make_optimizer(hp, params)
        step = sharding.make_table_sharded_coo_train_step(plan, opt, hp, U, I)
        keep("ts", params, step(params, 0, None, se_pad, edge_users, edge_items, keys))
        for name, moments in optimizer_state(opt, params).items():
            for m in ("exp_avg", "exp_avg_sq"):
                out[f"ts.{name}.{m}"] = moments[m]
    finally:
        sharding.sample_bpr_batch_csr = sampler

    # the table-sharded scan against its step loop, on the (5, epoch) draws
    params = tables(True)
    step = sharding.make_table_sharded_coo_train_step(plan, trainer.make_optimizer(hp, params),
                                                      hp, U, I)
    for e in range(3):
        loss = step(params, e, trainer.epoch_generator(5, e, mesh.device), se_pad, edge_users,
                    edge_items, keys)
    keep("ts_step", params, loss)
    params = tables(True)
    scan = sharding.make_table_sharded_coo_train_scan(plan, trainer.make_optimizer(hp, params),
                                                      hp, U, I)
    keep("ts_scan", params, scan(params, 5, 0, 3, se_pad, edge_users, edge_items, keys))

    out["csr53"] = sharding.distributed_csr_masked_topk(
        mesh, torch.from_numpy(inp["ue53"]), torch.from_numpy(inp["ie53"]), inp["rowptr53"],
        inp["cols53"], int(inp["k53"]))
    # 5 users in blocks of ceil(5 / ranks): on 4 ranks the last block is empty
    rowptr5 = inp["rowptr53"][:6]
    out["csr5"] = sharding.distributed_csr_masked_topk(
        mesh, torch.from_numpy(inp["ue53"][:5]), torch.from_numpy(inp["ie53"]), rowptr5,
        inp["cols53"][:rowptr5[-1]], int(inp["k53"]))

    def poison(*a, **kw):
        raise AssertionError("single-device COO factory built on a mesh")

    trainer.make_coo_train_step = trainer.build_bucketed_incidence = poison
    graph = build_graph(load_dataset(_cfg(inp, "f32"), "cpu")[0])
    for name, sharded in (("replicated", False), ("table_sharded", True)):
        over = {"compute.mesh_shape": tuple(int(x) for x in inp["mesh"]),
                "compute.dense_threshold": 1.0, "compute.coo_table_sharding": sharded}
        result = trainer.train_lightgcn(graph, _cfg(inp, "f32", **over), save_artifacts=False,
                                        device="cpu")
        keep(f"train.{name}", result.params, 0)
        for col, series in result.history.items():
            out[f"train.{name}.history.{col}"] = np.asarray(series, np.float64)
        # resume: 8 epochs with a checkpoint at 7, then on to 14, against 14
        resume = {**over, "hparams.epoch_per_eval": 7}
        ckpt = os.path.join(str(inp["tmp"]), f"ckpt_{name}")
        runs = {}
        for tag, epochs, ckpt_dir in (("full", 14, None), ("first", 8, ckpt),
                                      ("resumed", 14, ckpt)):
            runs[tag] = trainer.train_lightgcn(
                graph, _cfg(inp, "f32", **resume, **{"hparams.epochs": epochs}),
                save_artifacts=False, checkpoint_dir=ckpt_dir, checkpoint_every=7, device="cpu")
        for tag in ("full", "resumed"):
            keep(f"resume.{name}.{tag}", runs[tag].params, 0)


SUITES = {"train": suite_train, "serve": suite_serve, "sweep": suite_sweep, "cli": suite_cli,
          "coo": suite_coo}


def main() -> None:
    rank, world, store, suite, in_npz, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    from lgcnhs_tpu_torch.runtime.mesh import init_distributed, make_mesh

    init_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        with np.load(in_npz, allow_pickle=False) as data:
            inp = {name: data[name] for name in data.files}
        mesh = make_mesh(tuple(int(x) for x in inp["mesh"]))
        out = {}
        SUITES[suite](inp, mesh, out)
        arrays = {name: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                  for name, v in out.items()}
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
