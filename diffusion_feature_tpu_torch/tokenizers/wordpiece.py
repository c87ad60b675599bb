"""WordPiece tokenizer (BERT-style) with a local-vocab loader (a copy of
``diffusion_feature_tpu/tokenizers/wordpiece.py``).

HunyuanDiT's ``text_encoder`` is a BertModel whose tokenizer ships as
``tokenizer/vocab.txt`` in the checkpoint: greedy longest-match-first
WordPiece, every CJK character a token of its own, [CLS] first and [SEP]
last, padded with [PAD] to ``model_max_length`` with the attention mask.
Without a vocab file the loader falls back to the T5 hash tokenizer, as the
JAX package does, so both packages give the same ids offline.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .t5_tok import T5HashTokenizer


class WordPieceTokenizer:
    def __init__(self, vocab_path: str, model_max_length: int = 77,
                 lowercase: bool = True):
        self.vocab = {}
        with open(vocab_path, encoding='utf-8') as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip('\n')] = i
        self.model_max_length = model_max_length
        self.lowercase = lowercase
        self.pad_token_id = self.vocab.get('[PAD]', 0)
        self.cls_token_id = self.vocab.get('[CLS]', 101)
        self.sep_token_id = self.vocab.get('[SEP]', 102)
        self.unk_token_id = self.vocab.get('[UNK]', 100)

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)

    def _basic_tokens(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out, cur = [], []
        for ch in text:
            if self._is_cjk(ch):
                # BERT tokenize_chinese_chars: every CJK char is its own
                # token (essential for HunyuanDiT's bilingual prompts)
                if cur:
                    out.append(''.join(cur))
                    cur = []
                out.append(ch)
            elif ch.isalnum():
                cur.append(ch)
            else:
                if cur:
                    out.append(''.join(cur))
                    cur = []
                if not ch.isspace():
                    out.append(ch)        # punctuation is its own token
        if cur:
            out.append(''.join(cur))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = '##' + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_token_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in self._basic_tokens(text):
            ids.extend(self._wordpiece(w))
        return ids

    def __call__(self, texts, max_length: Optional[int] = None):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out_ids, out_mask = [], []
        for t in texts:
            ids = [self.cls_token_id] + self.encode(t)
            ids = ids[:max_length - 1] + [self.sep_token_id]
            mask = [1] * len(ids)
            pad = max_length - len(ids)
            out_ids.append(ids + [self.pad_token_id] * pad)
            out_mask.append(mask + [0] * pad)
        return out_ids, out_mask


def load_bert_tokenizer(path: Optional[str], model_max_length: int = 77,
                        vocab_size: int = 47020):
    """WordPiece from <path>/vocab.txt when present; hash fallback offline."""
    if path:
        vp = os.path.join(path, 'vocab.txt')
        if os.path.exists(vp):
            return WordPieceTokenizer(vp, model_max_length)
    return T5HashTokenizer(vocab_size=vocab_size,
                           model_max_length=model_max_length)
