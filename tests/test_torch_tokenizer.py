"""The port's tokenizer against the JAX package's, on the miniature BPE
fixtures of ``tests/test_tokenizer.py``: ids equal (exact), the Python merge
loop equal to the native one (``native/libdcbpe.so``), and the hash fallback
equal, with its fallback rules.
"""

import gzip
import itertools

import numpy as np
import pytest

from distillclip_tpu.data import tokenizer as jax_tok
from distillclip_tpu_torch.data import tokenizer as tok

from test_tokenizer import MINI_MERGES

CAPTIONS = ["hello", "hello hello hello", "Hello,  WORLD!\tlow   hell", "a cat on a mat",
            "h3ll0 &amp; <b>x</b> naïve café 😀", "", "the quick brown fox " * 30]


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("bpe") / "mini.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write(MINI_MERGES)
    return str(p)


@pytest.fixture(scope="module")
def full_bpe_path(tmp_path_factory):
    """A synthetic merges file past CLIP's 48,894-merge limit."""
    base = list(tok.bytes_to_unicode().values())
    lines = ["#version: synthetic-full"]
    for a, b in itertools.product(base, base):
        lines.append(f"{a} {b}")
        if len(lines) > 48900:
            break
    p = tmp_path_factory.mktemp("bpe_full") / "full.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("context_length", [8, 77])
def test_ids_equal_jax_on_the_mini_vocabulary(bpe_path, native, context_length):
    ours = tok.SimpleTokenizer(bpe_path, merge_limit=None, use_native=native)
    ref = jax_tok.SimpleTokenizer(bpe_path, merge_limit=None, use_native=native)
    assert (ours._native is not None) == native          # the library is in the repo
    got = ours.tokenize(CAPTIONS, context_length=context_length)
    want = ref.tokenize(CAPTIONS, context_length=context_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert [ours.encode(c) for c in CAPTIONS] == [ref.encode(c) for c in CAPTIONS]
    assert ours.decode(ours.encode("hello hello")) == "hello hello"


def test_python_and_native_merge_loops_agree(full_bpe_path):
    py = tok.SimpleTokenizer(full_bpe_path, use_native=False)
    nat = tok.SimpleTokenizer(full_bpe_path, use_native=True)
    assert py.vocab_size == 49408 and py.sot_token == 49406 and py.eot_token == 49407
    np.testing.assert_array_equal(py.tokenize(CAPTIONS), nat.tokenize(CAPTIONS))
    np.testing.assert_array_equal(
        py.tokenize(CAPTIONS), jax_tok.SimpleTokenizer(full_bpe_path, use_native=False)
        .tokenize(CAPTIONS))


def test_truncation_matches_jax(bpe_path):
    long_text = "hello " * 50
    ours = tok.SimpleTokenizer(bpe_path, merge_limit=None)
    ref = jax_tok.SimpleTokenizer(bpe_path, merge_limit=None)
    np.testing.assert_array_equal(ours.tokenize([long_text], context_length=10),
                                  ref.tokenize([long_text], context_length=10))
    with pytest.raises(RuntimeError, match="too long"):
        ours.tokenize([long_text], context_length=10, truncate=False)


@pytest.mark.parametrize("vocab,ctx", [(49408, 77), (64, 8)])
def test_hash_fallback_matches_jax(tmp_path, monkeypatch, vocab, ctx):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    ours = tok.build_tokenizer(str(tmp_path / "missing.gz"), context_length=ctx,
                               vocab_size=vocab)
    ref = jax_tok.build_tokenizer(str(tmp_path / "missing.gz"), context_length=ctx,
                                  vocab_size=vocab)
    assert isinstance(ours, tok.HashTokenizer)
    got = ours.tokenize(CAPTIONS)
    np.testing.assert_array_equal(got, ref.tokenize(CAPTIONS))
    assert got.shape == (len(CAPTIONS), ctx) and got.max() < vocab


def test_build_tokenizer_picks_bpe_from_a_path_or_the_environment(bpe_path, tmp_path,
                                                                  monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    assert isinstance(tok.build_tokenizer(bpe_path), tok.SimpleTokenizer)
    assert isinstance(tok.build_tokenizer(None), tok.HashTokenizer)
    monkeypatch.setenv("CLIP_BPE_PATH", bpe_path)
    assert isinstance(tok.build_tokenizer(None), tok.SimpleTokenizer)
    monkeypatch.setenv("CLIP_BPE_PATH", str(tmp_path / "missing.gz"))
    assert isinstance(tok.build_tokenizer(None), tok.HashTokenizer)


def test_whitespace_clean_matches_jax():
    for text in ("  a \t b\n\nc ", "x y z", "tab\tend\n"):
        assert tok.whitespace_clean(text) == jax_tok.whitespace_clean(text)
