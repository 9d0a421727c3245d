"""CLIP's byte-BPE tokenizer, implemented from the algorithm.

Port of ``distillclip_tpu/data/tokenizer.py`` (framework-free, so the port
keeps its own copy): GPT-2 byte<->unicode table, lowercasing + whitespace
cleanup, BPE over a merges file, ``<|startoftext|>`` / ``<|endoftext|>``
specials, fixed context length 77 with zero padding; the merge loop runs in
Python or in ``native/libdcbpe.so`` (``native/bpe.cc``, shared as a file with
the JAX package), which give the same ids.

The merges vocabulary (OpenAI's ``bpe_simple_vocab_16e6.txt.gz``) is a data
artifact the deployment supplies.  Without it :func:`build_tokenizer` returns
:class:`HashTokenizer`, as the JAX package does.

The ``regex`` module (Unicode classes in the pre-tokenizer) is imported by
:class:`SimpleTokenizer` only, so the hash tokenizer works where it is not
installed; whitespace cleanup then uses the standard ``re``, whose ``\\s``
also matches the ASCII separators 0x1c-0x1f.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

try:  # pragma: no cover - optional, used for full unicode fixing when present
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False


def _regex():
    """The ``regex`` module where it is installed, else the standard ``re``."""
    try:
        import regex
    except ImportError:
        import re as regex
    return regex


@lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return _regex().sub(r"\s+", " ", text).strip()


@lru_cache()
def _pattern():
    import regex

    return regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        regex.IGNORECASE,
    )


class SimpleTokenizer:
    """CLIP BPE tokenizer built from a merges file.

    ``bpe_path`` points at a ``bpe_simple_vocab_16e6.txt.gz``-format file
    (first line a comment, then one merge per line).  ``merge_limit``
    truncates the merge list exactly like CLIP does (48894 merges to land at
    a 49408-entry vocabulary).
    """

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str, merge_limit: Optional[int] = 48894,
                 use_native: bool = True):
        _pattern()  # the regex module is required here
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # Drop the "#version" comment line, then keep exactly ``merge_limit``
        # merges.  CLIP does ``merges[1:49152-256-2+1]`` over the RAW line
        # list (comment included) = 48,894 merges -> vocab 49,408, EOT 49,407.
        merges = merges[1:]
        if merge_limit is not None:
            merges = merges[:merge_limit]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([self.SOT, self.EOT])

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}

        # optional C++ merge loop (native/bpe.cc); the same ids
        self._native = None
        if use_native:
            self._native = _load_native_bpe(merges)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[self.EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        native = self._native
        for token in _pattern().findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            if native is not None:
                bpe_tokens.extend(native.encode_word(token))
            else:
                bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens if t not in
                       (self.sot_token, self.eot_token, 0))
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        ).strip()

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 77,
        truncate: bool = True,
    ) -> np.ndarray:
        """[N, context_length] int32, sot + bpe + eot, zero-padded — the
        clip.tokenize contract the reference relies on."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result


class _NativeBpe:
    """ctypes wrapper over native/libdcbpe.so (exact-id C++ merge loop)."""

    def __init__(self, lib, handle):
        import ctypes

        self._lib = lib
        self._handle = handle
        self._buf = (ctypes.c_int32 * 512)()

    def encode_word(self, word: str) -> List[int]:
        n = self._lib.dc_bpe_encode_word(self._handle, word.encode("utf-8"),
                                         self._buf, 512)
        if n < 0:
            raise KeyError(f"native BPE: unknown token in {word!r}")
        return list(self._buf[: min(n, 512)])


def _load_native_bpe(merges):
    import ctypes

    candidates = [
        os.environ.get("DCBPE_PATH") or "",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native", "libdcbpe.so"),
    ]
    path = next((c for c in candidates if c and os.path.exists(c)), None)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.dc_bpe_create.restype = ctypes.c_void_p
        lib.dc_bpe_create.argtypes = [ctypes.c_char_p]
        lib.dc_bpe_encode_word.restype = ctypes.c_int
        lib.dc_bpe_encode_word.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.dc_bpe_vocab_size.restype = ctypes.c_int
        lib.dc_bpe_vocab_size.argtypes = [ctypes.c_void_p]
        merges_text = "\n".join(" ".join(m) for m in merges)
        handle = lib.dc_bpe_create(merges_text.encode("utf-8"))
        return _NativeBpe(lib, handle)
    except OSError:
        return None


class HashTokenizer:
    """Deterministic stand-in tokenizer for tests/benchmarks without the BPE
    vocabulary file: hashes whitespace words into the CLIP id range.  NOT
    CLIP-compatible — produces valid-shaped inputs only."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self._vocab = vocab_size
        self.context_length = context_length
        self.sot_token = vocab_size - 2
        self.eot_token = vocab_size - 1

    @property
    def vocab_size(self):
        return self._vocab

    def encode(self, text: str) -> List[int]:
        import hashlib

        out = []
        for w in whitespace_clean(basic_clean(text)).lower().split(" "):
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(1 + h % (self._vocab - 3))
        return out

    def tokenize(self, texts, context_length: int = None, truncate: bool = True):
        context_length = context_length or self.context_length
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result


def build_tokenizer(bpe_path: Optional[str] = None, context_length: int = 77,
                    vocab_size: int = 49408):
    """SimpleTokenizer when a vocab file is available, HashTokenizer otherwise.

    ``vocab_size`` bounds the hash fallback's ids so they stay in range for
    models with smaller vocabularies (real BPE always emits CLIP's 49408).
    """
    if bpe_path and os.path.exists(bpe_path):
        return SimpleTokenizer(bpe_path)
    default = os.environ.get("CLIP_BPE_PATH")
    if default and os.path.exists(default):
        return SimpleTokenizer(default)
    return HashTokenizer(vocab_size=vocab_size, context_length=context_length)
