"""CLIP byte-level BPE tokenizer (numpy only).

The port's own copy of ``clip_ebc_tpu/models/clip/tokenizer.py``: CLIP's
merge-rule BPE with the byte->unicode table, lowercase + whitespace
cleanup and ``<|startoftext|>``/``<|endoftext|>`` framing to a fixed
context length. The merge table (``bpe_simple_vocab_16e6.txt.gz``) ships
with OpenAI CLIP and is not bundled: ``ClipTokenizer`` reads it from
``vocab_path`` or ``$CLIP_BPE_VOCAB``. Without it :func:`tokenize` uses
the deterministic byte-level fallback, whose ids equal the JAX package's.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

# CLIP's pattern uses unicode \p{L}/\p{N} through the `regex` module; this
# stdlib pattern is equivalent for ASCII text, which covers every prompt
# the package generates (see prompts.py).
_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip().lower()


def _pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word, word[1:])}


class ClipTokenizer:
    """Byte-level BPE with CLIP's merge table and special tokens."""

    def __init__(self, vocab_path: Optional[str] = None) -> None:
        vocab_path = vocab_path or os.environ.get("CLIP_BPE_VOCAB")
        if vocab_path is None or not os.path.exists(vocab_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; pass vocab_path or set $CLIP_BPE_VOCAB "
                "(bpe_simple_vocab_16e6.txt.gz, ships with OpenAI CLIP)"
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {SOT: SOT, EOT: EOT}

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _WORD_RE.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT]


class ByteFallbackTokenizer:
    """Deterministic byte-level fallback when the BPE vocab is absent.

    Token ids are raw UTF-8 bytes (offset to dodge 0), with the standard
    SOT/EOT ids so EOT-argmax pooling still works. Not compatible with
    pretrained CLIP text weights.
    """

    sot_token = VOCAB_SIZE - 2
    eot_token = VOCAB_SIZE - 1

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in _clean(text).encode("utf-8")]


@functools.lru_cache(maxsize=1)
def _default_tokenizer():
    try:
        return ClipTokenizer()
    except FileNotFoundError:
        return ByteFallbackTokenizer()


def get_tokenizer(vocab_path: Optional[str] = None):
    if vocab_path is not None:
        return ClipTokenizer(vocab_path)
    return _default_tokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    tokenizer=None,
) -> np.ndarray:
    """Texts -> (N, context_length) int32, SOT/EOT framed, zero padded;
    over-length prompts are truncated with EOT kept as the last token."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token, *tok.encode(text), tok.eot_token]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [tok.eot_token]
        out[i, : len(ids)] = ids
    return out
