"""Pure-Python CLIP byte-pair-encoding tokenizer (the port's copy of
``customnerf_tpu/guidance/bpe.py``).

A complete, dependency-light implementation of the CLIP text tokenizer
(the algorithm behind openai/CLIP ``simple_tokenizer.py`` and HF's
``CLIPTokenizer``), used by the SD text stack (reference loads HF's
tokenizer from the pipeline, ``nerf/sd.py:61-63``).  It loads the standard
diffusers ``tokenizer/`` layout — ``vocab.json`` + ``merges.txt`` — as
shipped with every SD checkpoint.

Validated bit-for-bit against ``transformers.CLIPTokenizer`` on synthetic
vocab fixtures (``tests/test_bpe.py``); the real 49k-merge CLIP vocab is not
redistributable from this offline environment, so it arrives with
``--sd_weights`` exactly like the model weights do.

Algorithm (CLIP flavor of GPT-2 BPE):
  * text cleaning: html-unescape, whitespace collapse, lowercase.
  * token split with CLIP's regex (specials, contractions, letters, digits,
    other).
  * byte-level alphabet via the GPT-2 bytes↔unicode bijection.
  * per-word BPE: word = chars with ``</w>`` appended to the LAST char;
    repeatedly merge the lowest-rank adjacent pair.
"""

from __future__ import annotations

import html
import json
import os
from functools import lru_cache
from typing import Dict, List, Tuple

try:  # CLIP's pattern uses \p{L}/\p{N}; the `regex` module supports them
    import regex as re
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is present in this env
    import re
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""\w+|[^\s\w]+""",
        re.IGNORECASE | re.UNICODE,
    )


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→unicode map (printable chars stay put)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def whitespace_clean(text: str) -> str:
    import re as _re
    return _re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """CLIP BPE from a diffusers-style ``tokenizer/`` directory."""

    model_max_length = 77

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.added_tokens: Dict[str, int] = {}
        self.cache = {"<|startoftext|>": ["<|startoftext|>"],
                      "<|endoftext|>": ["<|endoftext|>"]}

    @classmethod
    def from_dir(cls, tokenizer_dir: str) -> "ClipBPETokenizer":
        with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(tokenizer_dir, "merges.txt")) as f:
            for line in f.read().split("\n"):
                if line.startswith("#version") or not line.strip():
                    continue
                merges.append(tuple(line.split()))
        tok = cls(vocab, merges)
        added = os.path.join(tokenizer_dir, "added_tokens.json")
        if os.path.exists(added):
            with open(added) as f:
                tok.added_tokens.update(json.load(f))
        return tok

    @property
    def vocab_size(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    def add_token(self, token: str) -> int:
        """Register a modifier token like ``<new1>`` (textual inversion)."""
        if token not in self.added_tokens:
            self.added_tokens[token] = len(self.encoder) + len(self.added_tokens)
        return self.added_tokens[token]

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self.cache[token] = out
        return out

    def _encode_word(self, token: str) -> List[int]:
        btok = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
        return [self.encoder[t] for t in self.bpe(btok)]

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids, without BOS/EOS framing."""
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        # split out added (modifier) tokens first, longest-first
        segments = [text]
        for tok in sorted(self.added_tokens, key=len, reverse=True):
            next_segments = []
            for seg in segments:
                if isinstance(seg, int):
                    next_segments.append(seg)
                    continue
                parts = seg.split(tok)
                for i, part in enumerate(parts):
                    next_segments.append(part)
                    if i < len(parts) - 1:
                        next_segments.append(self.added_tokens[tok])
            segments = next_segments
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            for token in _PAT.findall(seg):
                ids.extend(self._encode_word(token))
        return ids

    def __call__(self, prompts: List[str], max_length: int = None, **_):
        """Batch encode with CLIP framing: BOS … EOS, padded to max_length
        with EOS (HF CLIPTokenizer's pad token) — returns int32 [B, L]."""
        import numpy as np

        L = max_length or self.model_max_length
        out = np.full((len(prompts), L), self.eos_token_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.encode(p)[: L - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out
