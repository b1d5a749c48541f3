"""Feature engineering: bucket maps, label cleaning, text preprocessing and
text embeddings.

Port of ``lgcnhs_tpu/data/features.py`` (reference
``processing/handleFeature.py``), its own copy: the same maps, the same
embedded NLTK stopword list and the same ``preprocess_text``. The tokenizer's
optional imports are the JAX package's exactly, so on any machine both take
the same route: ``jieba.lcut`` where jieba imports, else the ``[\\w]+``
regex; nltk's stopwords and WordNet lemmatizer where their corpora load,
else the embedded list and the identity.

``text_embeddings(method=...)``: ``"auto"`` (gensim where it imports, else
``"sgns"``), ``"gensim"``, ``"sgns"`` (the port's torch skip-gram trainer,
``data/word2vec.py``, on ``device``: the card unless the CPU is asked for)
or ``"hash"`` (seeded feature hashing, no training).
"""
from __future__ import annotations

import hashlib
import re
import string
import sys
from typing import Dict, List, Sequence

import numpy as np

# ---- bucketing maps (processing/handleFeature.py:17-59,147-164) ----


def age_bucket(age: int) -> int:
    """Reference ``ageMap`` (``handleFeature.py:17-36``), 0-based: seven
    buckets at 1-7, 8-16, 17-29, 30-39, 40-49, 50-59, >=60. The reference
    falls off the end and returns None for age < 1; we clamp to the first
    bucket (documented deviation — ML-100K has no such ages)."""
    if age <= 7:
        return 0
    if age <= 16:
        return 1
    if age <= 29:
        return 2
    if age <= 39:
        return 3
    if age <= 49:
        return 4
    if age <= 59:
        return 5
    return 6


def year_bucket(year: int) -> int:
    """Reference ``yearMap`` (``handleFeature.py:39-59``): 0 for missing
    (callers map unparseable years to 0 like the reference's "nan"), then
    <1970 -> 1, one bucket per decade through the 2000s, >=2010 -> 6."""
    if year < 1970:
        return 1
    if year < 1980:
        return 2
    if year < 1990:
        return 3
    if year < 2000:
        return 4
    if year < 2010:
        return 5
    return 6


def duration_bucket(minutes: float) -> int:
    """Reference ``durationMap`` (``handleFeature.py:147-164``), 0-based:
    six buckets at [0,30], (30,60], (60,90], (90,120], (120,150], >150.
    The reference returns None for negative durations; we clamp to the
    first bucket."""
    if minutes <= 30:
        return 0
    if minutes <= 60:
        return 1
    if minutes <= 90:
        return 2
    if minutes <= 120:
        return 3
    if minutes <= 150:
        return 4
    return 5


# ---- Douban label cleaning (handleFeature.py:62-144) ----

#: ``genreCleanMap``'s replacement dict (``handleFeature.py:69-98``):
#: traditional-Chinese and English genre labels normalized to the simplified
#: Chinese canon BEFORE multi-hot encoding, so e.g. 動畫/Animation/动画
#: collapse to one column instead of fragmenting into three. The mapping
#: values are the reference's spec, transcribed verbatim as data.
GENRE_CLEAN_MAP: Dict[str, str] = {
    "動畫": "动画",
    "Animation": "动画",
    "音樂": "音乐",
    "Music": "音乐",
    "動作": "动作",
    "Action": "动作",
    "兒童": "儿童",
    "Kids": "儿童",
    "紀錄片": "纪录片",
    "Documentary": "纪录片",
    "歷史": "历史",
    "History": "历史",
    "喜劇": "喜剧",
    "Comedy": "喜剧",
    "懸疑": "悬疑",
    "Mystery": "悬疑",
    "傳記": "传记",
    "Biography": "传记",
    "News": "传记",
    "愛情": "爱情",
    "Romance": "爱情",
    "驚悚": "惊悚",
    "Thriller": "惊悚",
    "惊栗": "惊悚",
    "劇情": "剧情",
    "Talk-Show": "脱口秀",
    "Reality-TV": "真人秀",
    "Drama": "戏曲",
    "Adult": "成人",
}


def clean_genres(labels: Sequence[str]) -> List[str]:
    """Reference ``genreCleanMap`` (``handleFeature.py:62-100``): per-label
    dict replacement, unknown labels (including the ``''`` empty token that
    splitting an empty GENRES cell produces) pass through unchanged."""
    return [GENRE_CLEAN_MAP.get(label, label) for label in labels]


def language_codes(labels: Sequence[str]) -> List[int]:
    """Reference ``languageMap`` (``handleFeature.py:102-122``): collapse
    language labels to codes {1: 汉语普通话, 2: 英语, 3: other}, deduplicated.
    An EMPTY list returns the ``[0]`` sentinel — note that through the
    reference's own pipeline this branch is unreachable (splitting an empty
    cell yields ``['']``, whose lone ``''`` label codes to 3), so real Douban
    language blocks are over classes ⊆ {1,2,3}. The reference returns
    ``list(set(...))`` (arbitrary order); we sort — MultiLabelBinarizer
    semantics are order-insensitive."""
    if len(labels) == 0:
        return [0]
    return sorted({1 if l == "汉语普通话" else 2 if l == "英语" else 3 for l in labels})


def region_codes(labels: Sequence[str]) -> List[int]:
    """Reference ``regionMap`` (``handleFeature.py:124-144``): codes
    {1: 中国大陆, 2: 美国, 3: other}; same empty-sentinel and ordering
    semantics as :func:`language_codes`."""
    if len(labels) == 0:
        return [0]
    return sorted({1 if l == "中国大陆" else 2 if l == "美国" else 3 for l in labels})


def one_hot(index: int, size: int) -> List[int]:
    v = [0] * size
    if 0 <= index < size:
        v[index] = 1
    return v


# ---- text preprocessing (handleFeature.py:167-203) ----

# The canonical NLTK English stopword list (corpora/stopwords/english).
# Embedded because nltk's corpus data is often not installed beside the
# library; the list is a fixed public constant, so embedding it gives exact
# parity with the reference's
# ``set(stopwords.words("english"))`` (``handleFeature.py:199-200``)
# whether or not the corpus download exists.
_NLTK_ENGLISH_STOPWORDS = frozenset(
    """i me my myself we our ours ourselves you you're you've you'll you'd
    your yours yourself yourselves he him his himself she she's her hers
    herself it it's its itself they them their theirs themselves what which
    who whom this that that'll these those am is are was were be been being
    have has had having do does did doing a an the and but if or because as
    until while of at by for with about against between into through during
    before after above below to from up down in out on off over under again
    further then once here there when where why how all any both each few
    more most other some such no nor not only own same so than too very s t
    can will just don don't should should've now d ll m o re ve y ain aren
    aren't couldn couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't
    haven haven't isn isn't ma mightn mightn't mustn mustn't needn needn't
    shan shan't shouldn shouldn't wasn wasn't weren weren't won won't wouldn
    wouldn't""".split()
)


def _english_stopwords() -> frozenset:
    """nltk's live list when its corpus data exists, else the embedded copy
    (they are identical; preferring the live one keeps us honest if nltk
    ever revises the list)."""
    try:
        from nltk.corpus import stopwords  # type: ignore

        return frozenset(stopwords.words("english"))
    except Exception:
        return _NLTK_ENGLISH_STOPWORDS


def _wordnet_lemmatize():
    """The reference WordNet-lemmatizes every token
    (``handleFeature.py:190-195``). Lemmatization needs the wordnet corpus
    data, which an nltk install may lack (the reference itself would raise
    LookupError then). Returns the real lemmatizer when the corpus is
    available, identity otherwise."""
    try:
        from nltk.stem import WordNetLemmatizer  # type: ignore

        lem = WordNetLemmatizer()
        lem.lemmatize("cats")  # force the lazy corpus load now
        return lem.lemmatize
    except Exception:
        return lambda w: w


_LEMMATIZE = None
_STOPWORDS: frozenset = frozenset()
_NO_JIEBA = False


def _jieba():
    """jieba where it imports, else None, as the JAX package's per-call
    ``import jieba`` decides; a failed import is remembered (Python retries a
    missing module's search on every import, ~1 ms a document), and a
    ``sys.modules`` entry (a module, or None to block it) always wins."""
    global _NO_JIEBA
    if "jieba" in sys.modules:
        return sys.modules["jieba"]
    if _NO_JIEBA:
        return None
    try:
        import jieba  # type: ignore

        return jieba
    except ImportError:
        _NO_JIEBA = True
        return None
_PUNCT_DIGITS = str.maketrans("", "", string.punctuation + string.digits)


def preprocess_text(text: str) -> List[str]:
    """Reference ``preprocessText`` (``handleFeature.py:167-203``) exactly:
    ``str(text)`` -> strip ``[^\\w\\s]`` -> strip ``\\d+`` -> lowercase ->
    ``jieba.lcut`` (segments Chinese, whitespace-splits English) -> drop
    whitespace tokens -> WordNet lemmatization (identity when the wordnet
    corpus is unavailable, see ``_wordnet_lemmatize``) -> remove NLTK English
    stopwords. Regex word-splitting replaces jieba only if jieba is absent."""
    global _LEMMATIZE, _STOPWORDS
    text = str(text)  # reference casts unconditionally (NaN -> "nan")
    text = re.sub(r"[^\w\s]", "", text)
    text = re.sub(r"\d+", "", text)
    text = text.lower()
    jieba = _jieba()
    if jieba is not None:
        tokens = [t for t in jieba.lcut(text) if t.strip() != ""]
    else:
        tokens = re.findall(r"[\w]+", text)
    if _LEMMATIZE is None:
        _LEMMATIZE = _wordnet_lemmatize()
        _STOPWORDS = _english_stopwords()
    tokens = [_LEMMATIZE(t) for t in tokens]
    return [t for t in tokens if t not in _STOPWORDS]


# ---- text embeddings (handleFeature.py:206-238) ----


def _hash_vector(token: str, dim: int) -> np.ndarray:
    """Deterministic unit-variance vector per token via blake2 seeding."""
    seed = int.from_bytes(hashlib.blake2s(token.encode("utf-8")).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dim).astype(np.float32)


def text_embeddings(
    documents: Sequence[str], dim: int, seed: int = 42, method: str = "auto",
    device="cuda",
) -> np.ndarray:
    """One mean-pooled vector per document, zero vector when empty
    (contract of ``getWord2Vec``, ``handleFeature.py:206-238``).
    ``method``: "auto" | "gensim" | "sgns" | "hash" (see module docstring);
    ``device`` is where ``sgns`` trains."""
    token_docs = [preprocess_text(d) for d in documents]

    if method in ("auto", "gensim"):
        try:  # gensim path (reference-faithful)
            from gensim.models import Word2Vec  # type: ignore

            model = Word2Vec(
                sentences=[t or [""] for t in token_docs],
                vector_size=dim,
                window=5,
                min_count=1,
                workers=4,
                seed=seed,
            )
            out = np.zeros((len(token_docs), dim), dtype=np.float32)
            for i, toks in enumerate(token_docs):
                vecs = [model.wv[t] for t in toks if t in model.wv]
                if vecs:
                    out[i] = np.mean(vecs, axis=0)
            return out
        except ImportError:
            if method == "gensim":
                raise
            method = "sgns"

    if method == "sgns":  # the port's torch skip-gram trainer
        from lgcnhs_tpu_torch.data.word2vec import document_vectors, train_word2vec

        model = train_word2vec(
            token_docs, dim, window=5, min_count=1, seed=seed, device=device
        )
        return document_vectors(model, token_docs, dim)

    if method != "hash":
        raise ValueError(f"unknown text embedding method {method!r}")
    cache: Dict[str, np.ndarray] = {}
    out = np.zeros((len(token_docs), dim), dtype=np.float32)
    for i, toks in enumerate(token_docs):
        if not toks:
            continue
        vecs = []
        for t in toks:
            if t not in cache:
                cache[t] = _hash_vector(t, dim)
            vecs.append(cache[t])
        out[i] = np.mean(vecs, axis=0)
    return out


def multi_hot(values: Sequence[Sequence[str]], vocabulary: Sequence[str]) -> np.ndarray:
    """MultiLabelBinarizer equivalent (``processing/handleDouban.py`` genre/
    language/region multi-hots)."""
    index = {v: j for j, v in enumerate(vocabulary)}
    out = np.zeros((len(values), len(vocabulary)), dtype=np.float32)
    for i, vals in enumerate(values):
        for v in vals:
            j = index.get(v)
            if j is not None:
                out[i, j] = 1.0
    return out
