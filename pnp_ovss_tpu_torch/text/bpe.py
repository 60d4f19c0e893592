"""CLIP byte-pair-encoding tokenizer (the port's copy of
``pnp_ovss_tpu/text/bpe.py``; no external dependency).

The reference's search reward runs class names through LAVIS CLIP's text
processor, which is OpenAI CLIP's SimpleTokenizer: lowercase + whitespace
cleanup, a word/number/punctuation split, then BPE over a 49,152-merge
table with `</w>` end-of-word markers, wrapped in <|startoftext|> /
<|endoftext|> and zero-padded to context length 77.

The merge table (bpe_simple_vocab_16e6.txt.gz) ships with CLIP, not with
this repo: pass its path to ``from_merges_file``. ``toy()`` builds a
miniature merge table for tests and random-weight runs (the same code
path, a tiny vocab). The token pattern takes the ``regex`` module's
Unicode letter and number classes where ``regex`` is installed and an
ASCII ``re`` pattern otherwise, exactly as the JAX package does, so both
tokenise alike in any one environment.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode mapping."""
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


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP uses the `regex` module's \p{L}/\p{N}; plain `re` covers the ASCII
# class names this pipeline feeds it. Use `regex` when available.
try:  # pragma: no cover - environment-dependent
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:
    _re = re
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        re.IGNORECASE,
    )


class CLIPBPETokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: List[Tuple[str, str]], vocab: List[str]):
        self.byte_encoder = bytes_to_unicode()
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.cache = {
            self.SOT: self.SOT,
            self.EOT: self.EOT,
        }
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]

    # -- construction ----------------------------------------------------
    @classmethod
    def from_merges_file(cls, path: str) -> "CLIPBPETokenizer":
        """Build from CLIP's bpe_simple_vocab_16e6.txt(.gz)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # Line 0 is a version header; CLIP uses merges [1 : 49152-256-2+1].
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines if m]
        chars = list(bytes_to_unicode().values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab += ["".join(m) for m in merges]
        vocab += [cls.SOT, cls.EOT]
        return cls(merges, vocab)

    @classmethod
    def toy(cls, words: Sequence[str]) -> "CLIPBPETokenizer":
        """Tiny merge table that tokenises each given word as one token
        (exercises the real BPE loop; for tests / random-weight runs)."""
        chars = list(bytes_to_unicode().values())
        vocab = chars + [c + "</w>" for c in chars]
        merges: List[Tuple[str, str]] = []
        seen = set(vocab)
        for w in sorted(set(words)):
            pieces = [self_c for self_c in w[:-1]] + [w[-1] + "</w>"]
            while len(pieces) > 1:
                pair = (pieces[0], pieces[1])
                if pair not in merges:
                    merges.append(pair)
                merged = pieces[0] + pieces[1]
                if merged not in seen:
                    vocab.append(merged)
                    seen.add(merged)
                pieces = [merged] + pieces[2:]
        vocab += [cls.SOT, cls.EOT]
        return cls(merges, vocab)

    # -- BPE ---------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
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
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(
                self.encoder[piece]
                for piece in self.bpe(tok).split(" ")
                if piece in self.encoder
            )
        return ids

    def encode_batch(
        self, texts: Sequence[str], context_length: int = 77
    ) -> np.ndarray:
        """-> [N, context_length] int32, SOT ... EOT, zero-padded."""
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t)[: context_length - 2] + [
                self.eot_id
            ]
            out[i, : len(ids)] = ids
        return out
