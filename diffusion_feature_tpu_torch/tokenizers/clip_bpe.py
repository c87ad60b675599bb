"""Self-contained CLIP BPE tokenizer.

Implements the byte-level-ish CLIP BPE scheme (lowercase, whitespace cleanup,
regex split, per-word BPE with '</w>' terminal) so no network or transformers
tokenizer assets are required at runtime.  Loads ``vocab.json`` +
``merges.txt`` from a local tokenizer dir (diffusers checkpoint layout).

When no vocab files are available (fully offline test mode), ``HashTokenizer``
provides a deterministic stand-in with the same interface and special-token
layout, which is sufficient for every shape/flow contract in the framework.
"""

from __future__ import annotations

import html
import json
import os
import re
from functools import lru_cache
from typing import List, Optional


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', text).strip()


_PAT = re.compile(
    # CLIP's pattern: letter runs ([\p{L}]+ ~ [^\W\d_]+), SINGLE digits
    # ([\p{N}]), punctuation runs; '35mm' -> '3','5','mm' like the reference.
    # CLIP's [^\s\p{L}\p{N}]+ treats '_' as part of a punctuation RUN
    # ('!_!' is ONE token), hence (?:[^\s\w]|_)+ rather than separate branches.
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP byte<->unicode table: every utf-8 byte maps to a printable
    unicode char so BPE never meets an unknown symbol (byte fallback)."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('\xa1'), ord('\xac') + 1))
          + list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """Minimal CLIP BPE with the reference pipelines' padding semantics:
    pad-to-max-length (77) with the pad token, truncate, BOS/EOS wrapped."""

    def __init__(self, vocab_path: str, merges_path: str,
                 model_max_length: int = 77, pad_with_eos: bool = True):
        with open(vocab_path, encoding='utf-8') as f:
            self.encoder = json.load(f)
        with open(merges_path, encoding='utf-8') as f:
            merges = f.read().split('\n')
        merges = [m for m in merges if m and not m.startswith('#version')]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder['<|startoftext|>']
        self.eos_token_id = self.encoder['<|endoftext|>']
        self.pad_token_id = self.eos_token_id if pad_with_eos else 0
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        byte_enc = bytes_to_unicode()
        ids = []
        for tok in _PAT.findall(text):
            # byte-encode first (CLIP byte-level BPE): non-ASCII text maps to
            # vocab symbols instead of being dropped
            tok = ''.join(byte_enc[b] for b in tok.encode('utf-8'))
            for piece in self._bpe(tok):
                if piece in self.encoder:
                    ids.append(self.encoder[piece])
        return ids

    def __call__(self, text, max_length: Optional[int] = None,
                 truncation: bool = True, padding: str = 'max_length'):
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        out = []
        for t in text:
            ids = [self.bos_token_id] + self.encode(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_token_id]
            if padding == 'max_length':
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return out


class HashTokenizer:
    """Deterministic offline stand-in: maps each whitespace token to a stable
    id via hashing.  Same special-token layout as CLIPTokenizer so prompt
    handling (incl. the >70-word long-prompt chunking, reference
    diffusion_feature.py:165-171) behaves identically."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77,
                 pad_with_eos: bool = True):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id if pad_with_eos else 0

    def encode(self, text: str) -> List[int]:
        import hashlib
        ids = []
        for tok in _whitespace_clean(text).lower().split(' '):
            if not tok:
                continue
            h = int(hashlib.md5(tok.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    __call__ = CLIPTokenizer.__call__


def load_clip_tokenizer(path: Optional[str], vocab_size: int = 49408,
                        pad_with_eos: bool = True):
    """Load real BPE assets when a local tokenizer dir exists; fall back to
    the deterministic hash tokenizer otherwise."""
    if path:
        vocab = os.path.join(path, 'vocab.json')
        merges = os.path.join(path, 'merges.txt')
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPTokenizer(vocab, merges, pad_with_eos=pad_with_eos)
    return HashTokenizer(vocab_size=vocab_size, pad_with_eos=pad_with_eos)
