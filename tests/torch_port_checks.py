"""Shared checks of the PyTorch port's tests (not collected: no test_ prefix).

``tie_equivalence`` is the serve contract of ``tests/tpu_smoke.py``: two
top-k index lists agree slot for slot except where the slot's values, under
an independent f64 reference, are equal within a relative gap.
"""
import numpy as np


def tie_equivalence(want_idx, got_idx, ref_vals):
    """(agreement, max relative value gap over mismatched slots).

    ``ref_vals`` is the (U, I) f64 reference score matrix both index lists
    are read against."""
    want_idx, got_idx = np.asarray(want_idx), np.asarray(got_idx)
    rows = np.arange(want_idx.shape[0])[:, None]
    mism = want_idx != got_idx
    agreement = 1.0 - float(mism.mean())
    if not mism.any():
        return agreement, 0.0
    w = ref_vals[rows, want_idx][mism]
    g = ref_vals[rows, got_idx][mism]
    gap = np.abs(w - g) / (np.maximum(np.abs(w), np.abs(g)) + 1e-5)
    return agreement, float(gap.max())


def dyadic(rng, shape, lo=-4, hi=5, denom=8):
    """Values in {lo/denom, ..., (hi-1)/denom}: products and short sums are
    exact in f32, so every summation order gives the same scores, with many
    exact ties."""
    return (rng.integers(lo, hi, shape) / denom).astype(np.float32)


def jax_negatives(token_docs, *, window=5, min_count=1, negative=5, epochs=5,
                  batch_size=1024, seed=42):
    """The negative ids ``lgcnhs_tpu.data.word2vec.train_word2vec`` draws,
    (n_steps, batch_size, negative) int32: its key splits replayed in a
    ``lax.scan`` (``key, sub = split(key)``, then ``categorical(sub, 0.75
    log freq)`` each step, from ``PRNGKey(seed)``), with n_steps from its own
    host draws."""
    import jax
    import jax.numpy as jnp

    from lgcnhs_tpu.data.word2vec import _skipgram_pairs, build_vocab

    rng = np.random.default_rng(seed)
    vocab, freq = build_vocab(token_docs, min_count)
    centers, _ = _skipgram_pairs(token_docs, vocab, window, rng)
    n_steps = max(1, int(np.ceil(epochs * centers.size / batch_size)))
    logits = jnp.asarray(0.75 * np.log(freq), dtype=jnp.float32)

    def step(key, _):
        key, sub = jax.random.split(key)
        neg = jax.random.categorical(sub, logits, shape=(batch_size, negative))
        return key, neg.astype(jnp.int32)

    _, negs = jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=n_steps)
    return np.asarray(negs)


def pin_text_method(monkeypatch, method="hash"):
    """Both packages' dataset pipelines embed text with ``method`` (their
    ``text_embeddings`` names patched where the pipelines look them up)."""
    import functools

    import lgcnhs_tpu.data.douban as jdb
    import lgcnhs_tpu.data.features as jf
    import lgcnhs_tpu.data.movielens as jml
    import lgcnhs_tpu.data.movielens1m as jm1
    import lgcnhs_tpu_torch.data.douban as tdb
    import lgcnhs_tpu_torch.data.features as tf
    import lgcnhs_tpu_torch.data.movielens as tml
    import lgcnhs_tpu_torch.data.movielens1m as tm1

    for features, modules in ((jf, (jml, jm1, jdb)), (tf, (tml, tm1, tdb))):
        pinned = functools.partial(features.text_embeddings, method=method)
        for module in modules:
            monkeypatch.setattr(module, "text_embeddings", pinned)


class MeshRun:
    """One CPU mesh run of ``tests/torch_mesh_worker.py``: D x M gloo ranks
    started at once (one thread each, a file store under ``tmp``), running
    ``suite`` on ``inputs``. ``results()`` waits for every rank and returns
    their output dicts in rank order; a rank that fails or passes
    ``timeout`` seconds fails the run (and stops the others)."""

    def __init__(self, suite, mesh_shape, inputs, tmp, timeout=240):
        import os
        import subprocess
        import sys

        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(tmp, exist_ok=True)
        self.tmp, self.timeout = str(tmp), timeout
        self.world = int(mesh_shape[0]) * int(mesh_shape[1])
        in_npz = os.path.join(self.tmp, "inputs.npz")
        np.savez(in_npz, mesh=np.asarray(mesh_shape), **inputs)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(here) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.join(here, "torch_mesh_worker.py"), str(rank),
                 str(self.world), os.path.join(self.tmp, "store"), suite, in_npz, self.tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(self.world)
        ]

    def results(self):
        import os
        import subprocess

        logs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=self.timeout)
                logs.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"mesh run passed {self.timeout} s")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (rc, out, err) in enumerate(logs):
            assert rc == 0, f"rank {rank} failed:\n{err[-4000:]}"
        outs = []
        for rank in range(self.world):
            with np.load(os.path.join(self.tmp, f"{rank}.npz")) as data:
                outs.append({name: data[name] for name in data.files})
        return outs
