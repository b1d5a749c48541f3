"""A configuration's inputs from the seed, and the program's config of it.

The benchmark makes the interaction table and the feature tables itself
(``data/synthetic.py``) and hands the same to the program and to the
reference. Every seed gets the same interactions in another order: one
table drawn from the configuration's own data seed, its user and item ids
permuted by the run's seed, split by the preset's split seed. So every
seed trains and serves a graph of the same sizes and degrees (memory and
work do not move with the seed) under other labels, from other features,
initial tables, triples and served tables.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from portbench.data.synthetic import synthesize_features, synthesize_movielens_like
from portbench.reference.data import Split, split_table


def table(config: dict, seed: int) -> dict:
    """The configuration's table with its ids permuted by ``seed``."""
    syn = config["synthetic"]
    rows = synthesize_movielens_like(syn["users"], syn["items"], syn["draws"], syn["seed"],
                                     syn["zipf"])
    rng = np.random.default_rng([seed, 1])
    users = rng.permutation(syn["users"]) + 1
    items = rng.permutation(syn["items"]) + 1
    return dict(rows, user=users[rows["user"] - 1], item=items[rows["item"] - 1])


def features(config: dict, seed: int, n_users: int, n_items: int) -> Tuple[np.ndarray, np.ndarray]:
    syn = config["synthetic"]
    return (synthesize_features(n_users, syn["user_feature_dim"], seed + 1),
            synthesize_features(n_items, syn["item_feature_dim"], seed + 2))


def reference_split(config: dict, rows: dict) -> Split:
    return split_table(rows, config["split_seed"], tuple(config["split"]))


def program_config(config: dict, seed: int, workdir: str):
    """The port's ``Config`` for ``config``: its prod preset with every value
    of the configuration file set explicitly, so the file is what runs."""
    from lgcnhs_tpu_torch.config import load_config

    syn = config["synthetic"]
    cfg = load_config(env=config["env"], dataset="synthetic", model=config["model"],
                      workdir=workdir, overrides={
                          "hparams.seed": int(seed),
                          "hparams.embedding_dim": config["embedding_dim"],
                          "hparams.layers": config["layers"],
                          "hparams.batch_size": config["batch_size"],
                          "hparams.lr": config["lr"],
                          "hparams.gamma": config["gamma"],
                          "hparams.epochs": config["epochs"],
                          "hparams.epoch_per_eval": config["epoch_per_eval"],
                          "hparams.epoch_per_lr_decay": config["epoch_per_lr_decay"],
                          "hparams.epsilon": config["epsilon"],
                          "hparams.lambda_": config["lambda"],
                          "compute.dtype": config["dtype"],
                          "k": config["k"],
                          "synthetic_users": syn["users"],
                          "synthetic_items": syn["items"],
                          "synthetic_interactions": syn["draws"],
                      })
    pre = dataclasses.replace(cfg.preprocessing, seed=config["split_seed"],
                              split_percentage=tuple(config["split"]))
    return cfg.replace(preprocessing=pre)


def program_graph(config: dict, rows: dict, seed: int, workdir: str):
    """(program config, the program's graph) through the port's own
    ``prepare_ratings`` and ``build_graph``."""
    from lgcnhs_tpu_torch.data.graph import build_graph
    from lgcnhs_tpu_torch.data.ratings import prepare_ratings

    cfg = program_config(config, seed, workdir)
    return cfg, build_graph(prepare_ratings(rows, cfg))
