"""Chunked long-prompt encoding (port of
``diffusion_feature_tpu/utils/prompt.py::encode_long_prompt``): the
reference's community workaround for CLIP's 77-token limit
(feature/components/encode_long_prompt.py:5-40), which the facade takes for
prompts of more than 70 words (diffusion_feature.py:165-171).
"""

from __future__ import annotations

import torch


@torch.inference_mode()
def encode_long_prompt(tokenizer, text_encoder, prompt: str, negative_prompt: str = ''):
    """Tokenize without truncation, pad the prompt and the negative prompt
    to one length rounded up to ``model_max_length``, encode each
    ``model_max_length`` chunk with ``text_encoder`` and concatenate the
    final-layernormed outputs along the sequence.  Returns
    (prompt_embeds, negative_prompt_embeds), each (1, S, hidden)."""
    max_length = tokenizer.model_max_length
    ids, nids = ([tokenizer.bos_token_id] + tokenizer.encode(t) + [tokenizer.eos_token_id]
                 for t in (prompt, negative_prompt))
    target = -(-max(len(ids), len(nids)) // max_length) * max_length
    device = next(text_encoder.parameters()).device
    out = []
    for seq in (ids, nids):
        seq = seq + [tokenizer.pad_token_id] * (target - len(seq))
        out.append(torch.cat([
            text_encoder(torch.tensor([seq[i:i + max_length]], dtype=torch.long,
                                      device=device))[0]
            for i in range(0, target, max_length)], dim=1))
    return out[0], out[1]
