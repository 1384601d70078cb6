"""Legacy stage-1 LM of the CosyVoice1 family: TransformerLM.

Port of minimax_speech_tpu/models/legacy_lm.py: a text encoder (rel-pos
transformer layers over text embeddings) and a causal rel-pos
transformer LM over the plan-based sequence layout of models/llm.py,
with separate text and speech embedding tables. The forward is the
training loss and accuracy. Its attention is the conformer layer's plain
torch attention, as it is XLA attention in the JAX package; no kernel
runs here.

The JAX module declares a speaker projection (spk_embed_affine_layer)
that its forward never calls, so its parameter tree has none; the port
leaves it out, and the speaker embedding enters at llm_input_size.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from minimax_speech_torch.models import conformer as cf
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils import losses


@dataclass(frozen=True)
class LegacyLMConfig:
    text_vocab_size: int = 51866
    speech_token_size: int = 4096
    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    text_encoder_blocks: int = 3
    llm_blocks: int = 6
    attention_heads: int = 8
    linear_units: int = 2048
    spk_embed_dim: int = 192
    lsm_weight: float = 0.0


class TransformerStack(nn.Module):
    """Pre-norm transformer layers with rel-pos attention, then a
    LayerNorm."""

    def __init__(self, d_model: int, n_blocks: int, heads: int,
                 linear_units: int):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"layer_{i}", cf.ConformerEncoderLayer(
                heads, linear_units, d_model=d_model))
        self.after_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, attn_mask, pad):
        pos = cf.espnet_rel_pos_emb(x.shape[1], x.shape[-1], x.dtype,
                                    x.device)
        for i in range(self.n_blocks):
            x = getattr(self, f"layer_{i}")(x, attn_mask, pos, pad)
        return self.after_norm(x)


class LegacyTransformerLM(nn.Module):
    def __init__(self, cfg: LegacyLMConfig = LegacyLMConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.text_embedding = nn.Embedding(c.text_vocab_size,
                                           c.text_encoder_input_size)
        self.text_encoder = TransformerStack(
            c.text_encoder_input_size, c.text_encoder_blocks,
            c.attention_heads, c.linear_units)
        self.text_encoder_affine_layer = nn.Linear(c.text_encoder_input_size,
                                                   c.llm_input_size)
        self.llm_embedding = nn.Embedding(2, c.llm_input_size)
        self.speech_embedding = nn.Embedding(c.speech_token_size + 3,
                                             c.llm_input_size)
        self.llm = TransformerStack(c.llm_input_size, c.llm_blocks,
                                    c.attention_heads, c.linear_units)
        self.llm_decoder = nn.Linear(c.llm_output_size,
                                     c.speech_token_size + 3)

    def encode_text(self, text_token, text_len):
        pad = mask_ops.make_non_pad_mask(text_len, text_token.shape[1])
        h = self.text_embedding(text_token)
        h = self.text_encoder(h, mask_ops.add_optional_chunk_mask(pad, 0),
                              pad.to(h.dtype))
        return self.text_encoder_affine_layer(h)

    def forward(self, src_type, tok_id, target, seq_len, spk_emb,
                text_token=None, text_len=None):
        """(loss, accuracy) of the plan (src_type, tok_id, target, seq_len;
        models/llm.build_lm_plan) with speaker embeddings spk_emb (B,
        llm_input_size). With text_token/text_len the SRC_TEXT positions
        take the text encoder's outputs in order (the k-th text position
        the k-th output); without, each text id's embedding through the
        affine layer."""
        c = self.cfg
        st = src_type[..., None]
        speech_e = self.speech_embedding(
            torch.clamp(tok_id, 0, c.speech_token_size + 2))
        special_e = self.llm_embedding(torch.clamp(tok_id, 0, 1))
        if text_token is not None:
            enc = self.encode_text(text_token, text_len)
            order = torch.cumsum((src_type == llm_mod.SRC_TEXT).long(),
                                 dim=1) - 1
            order = torch.clamp(order, 0, enc.shape[1] - 1)
            text_e = torch.gather(
                enc, 1, order[..., None].expand(-1, -1, enc.shape[-1]))
        else:
            # ids of other sources are clamped into the table; only
            # SRC_TEXT positions read text_e
            text_e = self.text_encoder_affine_layer(self.text_embedding(
                torch.clamp(tok_id, 0, c.text_vocab_size - 1)))
        emb = torch.where(st == llm_mod.SRC_TEXT, text_e,
                          torch.zeros_like(text_e))
        emb = torch.where(st == llm_mod.SRC_SPEECH, speech_e, emb)
        emb = torch.where(st == llm_mod.SRC_SPECIAL, special_e, emb)
        emb = torch.where(st == llm_mod.SRC_SPK, spk_emb[:, None, :], emb)

        t = emb.shape[1]
        pad = mask_ops.make_non_pad_mask(seq_len, t)
        attn = mask_ops.add_optional_chunk_mask(pad, 0) \
            & mask_ops.causal_mask(t, emb.device)[None]
        logits = self.llm_decoder(self.llm(emb, attn, pad.to(emb.dtype)))
        return (losses.label_smoothing_ce(logits, target, c.lsm_weight),
                losses.accuracy(logits, target))
