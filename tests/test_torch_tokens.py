"""The port's copy of `data/tokens.py` against the JAX package's: the same
corpus files (written to tmp_path) and the synthetic stream give equal
streams and bitwise-equal batches."""

import numpy as np
import pytest

from distributed_neural_network_tpu.data import tokens as jt
from distributed_neural_network_tpu_torch.data import tokens as tt


def _corpora(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 300, size=4000)
    np.save(tmp_path / "c.npy", arr.astype(np.int32))
    arr.astype(np.uint16).tofile(tmp_path / "c.bin")
    (tmp_path / "c.txt").write_bytes(bytes(rng.integers(0, 256, size=3000).tolist()))
    return [str(tmp_path / f"c.{ext}") for ext in ("npy", "bin", "txt")] + [None]


def test_streams_and_batches_match_jax(tmp_path):
    for path in _corpora(tmp_path):
        js = jt.load_token_stream(path, vocab_size=300)
        ts = tt.load_token_stream(path, vocab_size=300)
        assert (ts.source, ts.n_train, ts.n_eval) == (js.source, js.n_train, js.n_eval)
        np.testing.assert_array_equal(np.asarray(ts.tokens), np.asarray(js.tokens))
        for split in ("train", "eval"):
            for step in (0, 7):
                got = tt.sample_batch(ts, batch=3, seq_len=16, step=step, seed=4, split=split)
                want = jt.sample_batch(js, batch=3, seq_len=16, step=step, seed=4, split=split)
                for a, b in zip(got, want):
                    assert a.dtype == np.int32
                    np.testing.assert_array_equal(a, b)


def test_errors_match_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        tt.load_token_stream(str(tmp_path / "missing.npy"), vocab_size=10)
    np.save(tmp_path / "big.npy", np.array([1, 2, 500], np.int32))
    with pytest.raises(ValueError, match="vocab_size"):
        tt.load_token_stream(str(tmp_path / "big.npy"), vocab_size=10)
    (tmp_path / "t.txt").write_bytes(b"abc")
    with pytest.raises(ValueError, match="byte-tokenized"):
        tt.load_token_stream(str(tmp_path / "t.txt"), vocab_size=100)
    ts = tt.load_token_stream(None, vocab_size=50, synthetic_tokens=512)
    with pytest.raises(ValueError, match="split"):
        tt.sample_batch(ts, batch=1, seq_len=4, step=0, split="test")
