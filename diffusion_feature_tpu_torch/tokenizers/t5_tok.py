"""T5 tokenizer (a copy of ``diffusion_feature_tpu/tokenizers/t5_tok.py``):
sentencepiece when the checkpoint has ``spiece.model`` and the package
imports, else a deterministic offline hash tokenizer with T5's
special-token layout (pad=0, eos=1, no BOS).  The hash tokenizer is the JAX
package's own choice where the model file is missing, so both packages
give the same ids."""

from __future__ import annotations

import hashlib
import os
import re
from typing import List, Optional


class T5HashTokenizer:
    def __init__(self, vocab_size: int = 32128, model_max_length: int = 120):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.pad_token_id = 0
        self.eos_token_id = 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for tok in re.sub(r'\s+', ' ', text).strip().lower().split(' '):
            if not tok:
                continue
            h = int(hashlib.md5(tok.encode()).hexdigest(), 16)
            ids.append(2 + h % (self.vocab_size - 2))
        return ids

    def __call__(self, text, max_length: Optional[int] = None,
                 truncation: bool = True, padding: str = 'max_length'):
        """Returns (ids, attention_mask) lists — T5 pipelines consume the
        mask (reference pixart encode_prompt contract,
        diffusion_feature.py:195-202)."""
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        out_ids, out_mask = [], []
        for t in text:
            ids = self.encode(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == 'max_length':
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            out_ids.append(ids)
            out_mask.append(mask)
        return out_ids, out_mask


class T5SentencePieceTokenizer(T5HashTokenizer):
    def __init__(self, model_path: str, model_max_length: int = 120):
        import sentencepiece as spm
        self.sp = spm.SentencePieceProcessor(model_file=model_path)
        self.model_max_length = model_max_length
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.vocab_size = self.sp.vocab_size()

    def encode(self, text):
        return list(self.sp.encode(text))


def load_t5_tokenizer(path: Optional[str], model_max_length: int = 120,
                      vocab_size: int = 32128):
    if path:
        spm_path = os.path.join(path, 'spiece.model')
        if os.path.exists(spm_path):
            try:
                return T5SentencePieceTokenizer(spm_path, model_max_length)
            except ImportError:
                pass
    return T5HashTokenizer(vocab_size=vocab_size,
                           model_max_length=model_max_length)
