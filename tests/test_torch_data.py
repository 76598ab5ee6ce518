"""The port's token streams against the JAX package's ``make_dataset``:
the ``markov``, ``uniform`` and ``file`` kinds give the same bytes for
the same config and step. The file stream reads a uint16 token file
that the test writes itself, with token values at and above ``vocab``
so that the modulo is exercised."""
import numpy as np
import pytest

from repro.train import data as jdata
from repro_torch.train import data as tdata


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("enc", [None, 6])
@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_synthetic_streams_match_jax(kind, enc):
    """Steps 0-2 of a seeded stream, with and without the stub frontend's
    ``enc_embeds`` (drawn after the tokens), byte for byte."""
    kw = dict(vocab=1000, seq_len=9, global_batch=3, kind=kind, seed=5,
              enc_ctx=enc, d_model=8 if enc else None)
    got = tdata.make_dataset(tdata.DataConfig(**kw))
    want = jdata.make_dataset(jdata.DataConfig(**kw))
    assert isinstance(got, tdata.SyntheticLM)
    for step in range(3):
        _equal(got.batch(step), want.batch(step))
    if kind == "uniform":
        toks = got.batch(0)["tokens"]
        assert toks.max() >= 512              # the whole vocabulary


def test_file_stream_matches_jax(tmp_path):
    """A file of 5000 uint16 tokens up to 65535, at vocab 1000: windows at
    the seeded starts, the tokens modulo vocab, labels shifted by one, no
    ``enc_embeds`` (as JAX's), byte for byte at steps 0-2."""
    path = tmp_path / "tokens.bin"
    raw = np.random.default_rng(11).integers(0, 65536, size=5000,
                                             dtype=np.uint16)
    raw.tofile(path)
    kw = dict(vocab=1000, seq_len=16, global_batch=4, kind="file",
              path=str(path), seed=3, enc_ctx=4, d_model=8)
    got = tdata.make_dataset(tdata.DataConfig(**kw))
    want = jdata.make_dataset(jdata.DataConfig(**kw))
    assert isinstance(got, tdata.FileTokens)
    for step in range(3):
        b = got.batch(step)
        _equal(b, want.batch(step))
        assert "enc_embeds" not in b
        assert b["tokens"].max() < 1000
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert (raw >= 1000).mean() > 0.9         # the modulo did work
    rows = got.batch(0)["tokens"]
    starts = np.random.default_rng(3 * 7_777_777).integers(
        0, 5000 - 17, size=4)
    np.testing.assert_array_equal(
        rows, np.stack([raw[s:s + 16] for s in starts]) % 1000)


def test_unknown_kind_and_missing_path_raise():
    with pytest.raises(ValueError, match="kind"):
        tdata.make_dataset(tdata.DataConfig(vocab=8, seq_len=4,
                                            global_batch=1, kind="zipf"))
    with pytest.raises(ValueError, match="path"):
        tdata.make_dataset(tdata.DataConfig(vocab=8, seq_len=4,
                                            global_batch=1, kind="file"))
