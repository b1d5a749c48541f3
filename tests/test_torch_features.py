"""``lgcnhs_tpu_torch.data.features`` against ``lgcnhs_tpu.data.features``:
bucket maps, label cleaning, one/multi-hot, the stopword set, the text
preprocessing on both tokenizer routes (jieba where it imports, the regex
where it does not, forced the same way in both packages through
``sys.modules``), hash vectors and the ``hash`` embeddings, all identical.
"""
import math
import sys

import numpy as np
import pytest
import torch

from lgcnhs_tpu.data import features as jf
from lgcnhs_tpu_torch.data import features as tf

TEXTS = [
    "Toy Story (1995)",
    "L\xe9on: The Professional (1994)",
    "Things to Do in Denver, When You're Dead",
    "na\xefve caf\xe9 \xfcber se\xf1or gar\xe7on",
    "城市 爱情故事 Night of the Living Dead",
    "我们在夏天的花园里看星星",
    "It's the 2nd time: they've been there, isn't it?",
    "cats running quickly  \t\n  dogs",
    "",
    "   ",
    "1234 5678",
    float("nan"),
    "None",
    "don't won't shouldn't",
]


def test_bucket_maps_are_identical():
    for age in range(-5, 120):
        assert tf.age_bucket(age) == jf.age_bucket(age)
    for year in range(-1, 2030):
        assert tf.year_bucket(year) == jf.year_bucket(year)
    for minutes in np.linspace(-10, 400, 821).tolist():
        assert tf.duration_bucket(minutes) == jf.duration_bucket(minutes)


def test_label_maps_and_hots_are_identical():
    assert tf.GENRE_CLEAN_MAP == jf.GENRE_CLEAN_MAP
    labels = ["動畫", "Animation", "动画", "Drama", "", "unknown", "喜劇", "News"]
    assert tf.clean_genres(labels) == jf.clean_genres(labels)
    for row in ([], [""], ["汉语普通话", "英语", "法语"], ["英语", "英语"], ["中国大陆"],
                ["美国", "日本", "中国大陆"]):
        assert tf.language_codes(row) == jf.language_codes(row)
        assert tf.region_codes(row) == jf.region_codes(row)
    for index in (-1, 0, 3, 6, 7):
        assert tf.one_hot(index, 7) == jf.one_hot(index, 7)
    rows = [["a", "b"], [], ["c", "zz"], [""]]
    np.testing.assert_array_equal(tf.multi_hot(rows, ["", "a", "c"]),
                                  jf.multi_hot(rows, ["", "a", "c"]))


def test_stopwords_are_identical():
    assert tf._NLTK_ENGLISH_STOPWORDS == jf._NLTK_ENGLISH_STOPWORDS
    assert tf._english_stopwords() == jf._english_stopwords()


@pytest.fixture(params=["installed", "absent"])
def tokenizer_route(request, monkeypatch):
    """jieba as installed, or made unimportable in both packages."""
    if request.param == "absent":
        monkeypatch.setitem(sys.modules, "jieba", None)
    else:
        pytest.importorskip("jieba")
    return request.param


def test_preprocess_text_is_identical_on_both_routes(tokenizer_route):
    for text in TEXTS:
        assert tf.preprocess_text(text) == jf.preprocess_text(text), text
    # NaN is cast as the reference casts it: the token "nan"
    assert tf.preprocess_text(math.nan) == ["nan"]
    assert tf.preprocess_text("   ") == []


def test_a_failed_jieba_import_is_tried_once(monkeypatch):
    """Without jieba both packages split by the regex; the port searches
    for the module once, not once a document."""
    tries = []

    class Missing:
        def find_spec(self, name, path=None, target=None):
            if name == "jieba":
                tries.append(name)
                raise ImportError("no jieba")
            return None

    monkeypatch.delitem(sys.modules, "jieba", raising=False)
    monkeypatch.setattr(sys, "meta_path", [Missing(), *sys.meta_path])
    monkeypatch.setattr(tf, "_NO_JIEBA", False)
    want = [jf.preprocess_text(text) for text in TEXTS]
    tries.clear()
    assert [tf.preprocess_text(text) for text in TEXTS] == want
    assert tries == ["jieba"]


def test_hash_vectors_and_hash_embeddings_are_identical(tokenizer_route):
    for token in ("nan", "caf\xe9", "城市", "x"):
        np.testing.assert_array_equal(tf._hash_vector(token, 7), jf._hash_vector(token, 7))
    np.testing.assert_array_equal(tf.text_embeddings(TEXTS, 5, method="hash"),
                                  jf.text_embeddings(TEXTS, 5, method="hash"))


def test_text_embeddings_routes():
    with pytest.raises(ValueError, match="unknown text embedding method"):
        tf.text_embeddings(TEXTS, 3, method="bogus")
    try:
        import gensim  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tf.text_embeddings(TEXTS, 3, method="gensim")
    # "sgns" (and "auto" without gensim) trains on the device it is given
    out = tf.text_embeddings(TEXTS, 3, method="sgns", device="cpu")
    assert out.shape == (len(TEXTS), 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and not out[8].any()  # the empty text: zeros


def test_sgns_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CPU-only machine shows the missing card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.text_embeddings(TEXTS, 3, method="sgns")
