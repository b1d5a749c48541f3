"""Raw-data ingestion: ``lgcnhs_tpu_torch`` against ``lgcnhs_tpu`` on seeded
directories in the ML-100K, ML-1M and Douban file schemas
(``lgcnhs_tpu_torch/data/raw_standins.py``: latin-1 titles, missing dates,
quoted fields, NA words, empty genre cells, text MINS, unknown movies).

Identical: the reader's columns against ``pd.read_csv``; every split's rows
in order, the id mappings and the feature tables (text embedded with
``method="hash"`` in both packages, ``torch_port_checks.pin_text_method``);
the CSV artifacts byte for byte and the id-mapping arrays (an npz also
stores its write time); ``load_cached_splits``; ``IdMapper`` decode; the
fetch helpers; ``cli/main --data-dir`` for all seven models on each schema
(one shared pair of seeded checkpoints, as ``test_torch_main.py``), its
``--target-user`` line, and ``cli/retrieve --decode``'s JSON.
"""
import dataclasses
import hashlib
import json
import logging
import os
import urllib.error
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from lgcnhs_tpu.cli import main as j_main
from lgcnhs_tpu.cli import retrieve as j_retrieve
from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import douban as jdb
from lgcnhs_tpu.data import fetch as jfetch
from lgcnhs_tpu.data import movielens as jml
from lgcnhs_tpu.data import movielens1m as jm1
from lgcnhs_tpu.data import ratings as jratings
from lgcnhs_tpu.data.idmap import IdMapper as JIdMapper
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import main as t_main
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data import datasets as tdatasets
from lgcnhs_tpu_torch.data import douban as tdb
from lgcnhs_tpu_torch.data import fetch as tfetch
from lgcnhs_tpu_torch.data import movielens as tml
from lgcnhs_tpu_torch.data import movielens1m as tm1
from lgcnhs_tpu_torch.data import ratings as tratings
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.data.idmap import IdMapper as TIdMapper
from lgcnhs_tpu_torch.data.synthetic import synthesize_movielens_like
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.runtime import table
from lgcnhs_tpu_torch.train import trainer as ttrainer
from lgcnhs_tpu_torch.data.raw_standins import write_douban, write_ml100k, write_ml1m
from torch_port_checks import pin_text_method

MODELS = ["ProbS", "HeatS", "HybridS", "LightGCN", "LightGCNOpti",
          "SpreadLightGCN", "SpreadLightGCNOpti"]
PREPARE = {"movielens": (jml.prepare_movielens, tml.prepare_movielens),
           "movielens1m": (jm1.prepare_movielens1m, tm1.prepare_movielens1m),
           "douban": (jdb.prepare_douban, tdb.prepare_douban)}
WIDE = {"quantile_start": 1.0, "quantile_end": 0.0}


def _write(schema, root):
    """(dataset, raw directory, preprocessing overrides) of one schema."""
    d = str(root / schema)
    if schema == "ml100k":
        write_ml100k(d, n_users=60, n_items=80, n_ratings=1500, seed=1)
        return "movielens", d, {}
    if schema == "ml1m":
        write_ml1m(d, synthesize_movielens_like(90, 140, 2500, seed=3), seed=2)
        return "movielens1m", d, {}
    if schema == "douban":  # a text MINS cell; the band widened to keep everyone
        write_douban(d, n_users=120, n_movies=90, n_ratings=2400, seed=4, mins_text="abc")
        return "douban", d, WIDE
    # the douban preset band keeps only users whose rating counts lie between
    # the counts' 0.99 and 0.991 quantiles
    write_douban(d, n_users=1500, n_movies=100, n_ratings=24000, seed=5)
    return "douban", d, {}


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    return {schema: _write(schema, root)
            for schema in ("ml100k", "ml1m", "douban", "douban_preset")}


def _paths(dataset, data_dir):
    fn = {"movielens": tfetch.ml100k_paths, "movielens1m": tfetch.ml1m_paths,
          "douban": tfetch.douban_paths}[dataset]
    return fn(data_dir)


def _configs(dataset, data_dir, over):
    jc = j_load_config(env="dev", dataset=dataset, model="HybridS")
    tc = tcfg.load_config(env="dev", dataset=dataset, model="HybridS")
    out = []
    for c in (jc, tc):
        pre = dataclasses.replace(c.preprocessing, dataset_paths=_paths(dataset, data_dir),
                                  **over)
        out.append(c.replace(preprocessing=pre))
    return out


# -- the reader and the writer -----------------------------------------------

READ_CASES = {
    "quoted_pipe": ('1|"Quoted" Title (1995)|01-Jan-1995||x|0\n'
                    '2|"A|B" (1990)||||1\n3|NA|NaN|None|n/a|\n'
                    '4|L\xe9on: \xfcber|01-Feb-1994|||0\n\n5|"multi\nline" x|||y|1\n',
                    dict(sep="|", encoding="iso-8859-1", names=list("abcdef"))),
    "header_csv": ('A,B,C,D,E\n1,x y,True,1.5,\n2,"q, ""r""",False,2,7\n'
                   '3,,True,,8\n\r\n4, z ,False,1e3,9\r\n',
                   dict()),
    "double_colon": ("1::Toy Story (1995)::Animation|Comedy\r\n2::L\xe9on: x (1994)::Crime\n"
                     "3::NA::\n\n", dict(sep="::", encoding="iso-8859-1", names=list("abc"))),
    "tab_ints": ("1\t2\t3\t874965758\n4\t5\t1\t874965759\n", dict(sep="\t", names=list("abcd"))),
    "short_rows_and_mixed": ('x,y,z\n1,true,a\n2,TRUE\n 3 ,false,7\n4_0,,8\n', dict()),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_read_table_matches_pandas(case, tmp_path):
    text, kw = READ_CASES[case]
    path = tmp_path / "f.txt"
    path.write_bytes(text.encode(kw.get("encoding", "utf-8")))
    engine = {"engine": "python"} if len(kw.get("sep", ",")) > 1 else {}
    want = pd.read_csv(path, header=None if "names" in kw else "infer", **kw, **engine)
    got = table.read_table(str(path), **kw)
    assert list(got) == list(want.columns)
    for name, col in want.items():
        values = col.tolist()
        assert len(got[name]) == len(values), name
        assert got[name].dtype.kind == ("O" if col.dtype.kind in "OT" or str(col.dtype) == "str"
                                        else col.dtype.kind), name
        for g, w in zip(got[name].tolist(), values):
            assert (g != g and w != w) or (g == w and type(g) is type(w)), (name, g, w)


def test_tab_csv_with_list_cells_matches_pandas():
    feats = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    feats[1] = 0.0
    columns = {"item_id": np.arange(4), "item_features": [r.tolist() for r in feats]}
    assert table.to_csv(columns, sep="\t") == pd.DataFrame(columns).to_csv(sep="\t", index=False)


# -- the pipelines ------------------------------------------------------------

def _assert_same_splits(js, ts):
    assert js.uid_mapping == ts.uid_mapping and js.iid_mapping == ts.iid_mapping
    assert (ts.n_users, ts.n_items) == (js.n_users, js.n_items)
    for name in ("rating", "train", "val", "test"):
        jd, td = getattr(js, name), getattr(ts, name)
        assert list(td) == list(jd.columns)
        for col in jd.columns:
            np.testing.assert_array_equal(td[col], jd[col].to_numpy(), err_msg=f"{name}.{col}")


def _assert_same_artifacts(jdir, tdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(jdir, name)) as j, np.load(os.path.join(tdir, name)) as t:
                for key in ("uid_classes", "iid_classes"):
                    assert t[key].dtype == j[key].dtype
                    np.testing.assert_array_equal(t[key], j[key])
            continue
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("schema", ["ml100k", "ml1m", "douban", "douban_preset"])
def test_pipeline_matches_jax(schema, raw, tmp_path, monkeypatch):
    pin_text_method(monkeypatch)
    dataset, data_dir, over = raw[schema]
    jc, tc = _configs(dataset, data_dir, over)
    j_prepare, t_prepare = PREPARE[dataset]
    js, ju, ji = j_prepare(jc, save_path=str(tmp_path / "j"))
    ts, tu, ti = t_prepare(tc, save_path=str(tmp_path / "t"), device="cpu")
    _assert_same_splits(js, ts)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ti, ji)
    _assert_same_artifacts(str(tmp_path / "j"), str(tmp_path / "t"))
    if schema == "douban_preset":
        assert 0 < ts.n_users < 20  # the band kept a few of 1500 users
    # the cached artifacts read back as JAX reads them
    jcache = jratings.load_cached_splits(str(tmp_path / "j"))
    tcache = tratings.load_cached_splits(str(tmp_path / "t"))
    _assert_same_splits(jcache, tcache)
    assert tratings.load_cached_splits(str(tmp_path / "missing")) is None


def test_ml100k_edge_cases_and_the_trained_embedder(raw, monkeypatch):
    """The u.item traps: the quoted title, the NaN title, missing dates in
    year bucket 0, unknown raw ids; and the port's own route (the torch
    word2vec on the CPU), whose non-text columns equal JAX's."""
    dataset, data_dir, over = raw["ml100k"]
    items = table.read_table(os.path.join(data_dir, "u.item"), sep="|", encoding="iso-8859-1",
                             names=tml.ITEM_COLUMNS)
    titles = table.as_str(items["movie_title"])
    assert titles[4] != titles[4]  # "NA" reads as NaN, pandas 3 astype(str) keeps it
    jc, tc = _configs(dataset, data_dir, over)
    ts, tu, ti = tml.prepare_movielens(tc, device="cpu")
    pin_text_method(monkeypatch)
    js, ju, ji = jml.prepare_movielens(jc)
    _assert_same_splits(js, ts)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(ti[:, :-5], ji[:, :-5])
    assert np.isfinite(ti).all() and np.abs(ti[:, -5:]).sum() > 0
    year = ti[:, len(tml.GENRE_COLUMNS):len(tml.GENRE_COLUMNS) + tml.N_YEAR_BUCKETS]
    missing = [ts.iid_mapping[i] for i, d in zip(items["movie_id"].tolist(),
                                                   items["release_date"].tolist())
               if d != d and i in ts.iid_mapping]
    assert missing and (year[missing, 0] == 1).all()
    # rated ids with no u.item row keep zero feature rows
    assert not ti[ts.iid_mapping[81]].any() and not ti[ts.iid_mapping[82]].any()


def test_load_dataset_dispatches_raw_files_to_ingestion(raw, tmp_path, monkeypatch):
    seen = []
    import lgcnhs_tpu_torch.data.features as tf

    real = tf.text_embeddings

    def spy(docs, dim, seed=42, method="auto", device="cuda"):
        seen.append(device)
        return real(docs, dim, seed, "hash")

    for module in (tml, tm1, tdb):
        monkeypatch.setattr(module, "text_embeddings", spy)
    for schema in ("ml100k", "ml1m", "douban"):
        dataset, data_dir, over = raw[schema]
        _, tc = _configs(dataset, data_dir, over)
        tc = tc.replace(workdir=str(tmp_path))
        splits, uf, itf = tdatasets.load_dataset(tc, device="cpu")
        assert uf.shape[0] == splits.n_users and itf.shape[0] == splits.n_items
        assert os.path.exists(os.path.join(tc.preprocess_path, "id_mappings.npz"))
    assert seen and set(seen) == {"cpu"}


def test_idmapper_decode_matches_jax(raw, monkeypatch):
    pin_text_method(monkeypatch)
    for schema in ("ml100k", "douban"):
        dataset, data_dir, over = raw[schema]
        jc, tc = _configs(dataset, data_dir, over)
        js = PREPARE[dataset][0](jc)[0]
        ts = PREPARE[dataset][1](tc, device="cpu")[0]
        jm, tm = JIdMapper.from_splits(js), TIdMapper.from_splits(ts)
        raw_users = list(ts.uid_mapping)[::7]
        np.testing.assert_array_equal(tm.users_to_internal(raw_users),
                                      jm.users_to_internal(raw_users))
        raw_items = list(ts.iid_mapping)[::5]
        np.testing.assert_array_equal(tm.items_to_internal(raw_items),
                                      jm.items_to_internal(raw_items))
        rec = np.random.default_rng(0).integers(0, ts.n_items, (ts.n_users, 4))
        assert tm.decode_recommendations(rec) == jm.decode_recommendations(rec)


# -- fetch (never the network) ------------------------------------------------

def test_fetch_helpers_match_jax(raw, tmp_path, monkeypatch):
    d = raw["ml100k"][1]
    assert tfetch.ml100k_paths(d) == jfetch.ml100k_paths(d)
    assert tfetch.ml1m_paths(d) == jfetch.ml1m_paths(d)
    assert tfetch.douban_paths(d) == jfetch.douban_paths(d)
    assert tfetch.have_ml100k(d) and not tfetch.have_ml1m(d)
    assert tfetch.have_ml1m(raw["ml1m"][1])
    zip_path = tmp_path / "ml-100k.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        for name in tfetch.ML100K_FILES.values():
            z.write(os.path.join(d, name), arcname=f"ml-100k/{name}")
    md5 = hashlib.md5(zip_path.read_bytes()).hexdigest()
    got = tfetch.fetch_ml100k(str(tmp_path / "t"), url=zip_path.as_uri(), md5=md5)
    want = jfetch.fetch_ml100k(str(tmp_path / "j"), url=zip_path.as_uri(), md5=md5)
    assert got == tfetch.ml100k_paths(str(tmp_path / "t" / "ml-100k"))
    assert want == jfetch.ml100k_paths(str(tmp_path / "j" / "ml-100k"))
    for key in got:
        with open(got[key], "rb") as a, open(want[key], "rb") as b:
            assert a.read() == b.read()
    assert tfetch.fetch_ml100k(str(tmp_path / "bad"), url=zip_path.as_uri(), md5="0" * 32) is None

    def no_egress(*a, **kw):
        raise urllib.error.URLError("no egress")

    monkeypatch.setattr("urllib.request.urlopen", no_egress)
    assert tfetch.fetch_ml1m(str(tmp_path / "none")) is None
    assert tfetch.fetch_ml100k(str(tmp_path / "t")) == got  # present: no download


# -- the entry points ---------------------------------------------------------

@pytest.fixture
def log_lines():
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(level=logging.DEBUG)
    logger = logging.getLogger("lgcnhs")
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


@pytest.fixture(scope="module")
def cli_dirs(raw, tmp_path_factory):
    """Per schema: its CLI arguments and two workdirs holding one shared pair
    of seeded checkpoints (LightGCN- and LightGCNOpti-shaped)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        pin_text_method(mp)
        for schema in ("ml100k", "ml1m", "douban"):
            dataset, data_dir, over = raw[schema]
            root = tmp_path_factory.mktemp(schema)
            dirs = (str(root / "j"), str(root / "t"))
            args = ["--dataset", dataset, "--data-dir", data_dir, "--env", "dev", "--k", "5"]
            if over:
                args += ["--quantile", "1", "0"]
            _, tc = _configs(dataset, data_dir, over)
            splits, uf, itf = tdatasets.load_dataset(tc.replace(workdir=str(root / "x")),
                                                     device="cpu")
            graph = build_graph(splits)
            gen = torch.Generator().manual_seed(0)
            tables = {"LightGCN": tlgcn.init_lightgcn(gen, graph.n_users, graph.n_items, 16),
                      "LightGCNOpti": tlgcn.init_lightgcn_opti(gen, uf, itf, 16)}
            for workdir in dirs:
                for name, params in tables.items():
                    path = checkpoint_path(tc.replace(workdir=workdir, model=name, k=5))
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    ttrainer.save_checkpoint(path, params)
            out[schema] = (args, dirs, splits)
    return out


def _json_line(out):
    return [line for line in out.splitlines() if line.startswith('{"model"')][-1]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("schema", ["ml100k", "ml1m", "douban"])
def test_main_data_dir_matches_jax(schema, model, cli_dirs, monkeypatch, capsys):
    pin_text_method(monkeypatch)
    args, (jdir, tdir), _ = cli_dirs[schema]
    want = j_main.main(["--platform", "cpu", "--model", model, "--workdir", jdir, *args])
    want_line = _json_line(capsys.readouterr().out)
    got = t_main.main(["--device", "cpu", "--model", model, "--workdir", tdir, *args])
    got_line = _json_line(capsys.readouterr().out)
    assert got == want
    assert got_line == want_line


@pytest.mark.parametrize("schema", ["ml100k", "douban"])
def test_target_user_by_raw_id_matches_jax(schema, cli_dirs, monkeypatch, log_lines, capsys):
    pin_text_method(monkeypatch)
    args, (jdir, tdir), splits = cli_dirs[schema]
    raw_user = str(list(splits.uid_mapping)[3])
    lines = {}
    for name, fn, flags in (("jax", j_main.main, ["--platform", "cpu", "--workdir", jdir]),
                            ("torch", t_main.main, ["--device", "cpu", "--workdir", tdir])):
        log_lines.clear()
        fn([*flags, "--model", "LightGCNOpti", *args, "--target-user", raw_user])
        lines[name] = [m for m in log_lines if m.startswith("recommendations for user")]
    capsys.readouterr()
    assert len(lines["torch"]) == 1 and lines["torch"] == lines["jax"]
    assert lines["torch"][0].startswith(f"recommendations for user {raw_user} (internal 3)")


@pytest.mark.parametrize("model", ["LightGCNOpti", "SpreadLightGCNOpti"])
def test_retrieve_decode_matches_jax(model, cli_dirs, monkeypatch, capsys):
    pin_text_method(monkeypatch)
    args, (jdir, tdir), splits = cli_dirs["douban"]
    want = j_retrieve.main(["--platform", "cpu", "--model", model, "--workdir", jdir,
                            "--decode", *args])
    got = t_retrieve.main(["--device", "cpu", "--model", model, "--workdir", tdir,
                           "--decode", *args])
    capsys.readouterr()
    np.testing.assert_array_equal(got, np.asarray(want))
    name = os.path.join("douban", "recommend", f"retrieval_{model}_5.json")
    with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
        text = b.read()
        assert text == a.read()
    decoded = json.loads(text)
    assert len(decoded) == splits.n_users and set(decoded) == {str(u) for u in splits.uid_mapping}
