"""ERNIE — the counterpart of ``paddle_tpu/models/ernie.py`` (PaddleNLP's
``ernie/modeling.py``): word + position + token-type embeddings, a post-LN
encoder of ``nn.TransformerEncoderLayer`` (the port's plain ``_sdpa``
attention, bidirectional), the pooler, and the masked-LM and
sequence-classification heads.

The encoder layer is the shared ``TransformerEncoderLayer`` with its two
norms replaced at ERNIE's ``layer_norm_eps`` (re-registered last, so the
state dict keeps the JAX package's key order); the padding mask is
additive, ``(1 - m) * -1e4`` as ``[B, 1, 1, S]``; the masked-LM decoder
is tied to the word embeddings, with a bias. Parameters go on the
current device; one ``seed`` gives the JAX package's initial weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import nn
from ..nn import functional as F
from ..ops import arange, cast, matmul, unsqueeze, zeros_like


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def ernie_tiny(**kw):
    d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
    d.update(kw)
    return ErnieConfig(**d)


class ErnieEmbeddings(nn.Layer):
    def __init__(self, c: ErnieConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            padding_idx=c.pad_token_id)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = unsqueeze(
                arange(input_ids.shape[1], dtype="int32"), 0)
        if token_type_ids is None:
            token_type_ids = zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


def _ernie_layer(c: ErnieConfig) -> nn.Layer:
    """The post-LN ``nn.TransformerEncoderLayer`` with its norms at
    ERNIE's epsilon."""
    layer = nn.TransformerEncoderLayer(
        c.hidden_size, c.num_attention_heads, c.intermediate_size,
        dropout=c.hidden_dropout_prob, activation=c.hidden_act,
        attn_dropout=c.attention_probs_dropout_prob,
        normalize_before=False)
    # the reference's Layer re-registers a replaced sublayer last
    del layer.norm1, layer.norm2
    layer.norm1 = nn.LayerNorm(c.hidden_size, c.layer_norm_eps)
    layer.norm2 = nn.LayerNorm(c.hidden_size, c.layer_norm_eps)
    return layer


class ErnieModel(nn.Layer):
    def __init__(self, config: ErnieConfig):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config)
        self.encoder = nn.LayerList(
            [_ernie_layer(config) for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """Returns (sequence_output [B, S, H], pooled_output [B, H]).

        ``attention_mask``: [B, S], 1 attends and 0 pads (Paddle's
        convention), applied as an additive [B, 1, 1, S] bias."""
        add_mask = None
        if attention_mask is not None:
            m = cast(attention_mask, "float32")
            add_mask = (1.0 - unsqueeze(m, [1, 2])) * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, add_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def num_params(self):
        return sum(int(np.prod(p.shape)) for p in self.parameters())


class ErnieForMaskedLM(nn.Layer):
    """The masked-LM head, its decoder tied to the word embeddings."""

    def __init__(self, config: ErnieConfig):
        super().__init__()
        self.ernie = ErnieModel(config)
        c = config
        self.transform = nn.Linear(c.hidden_size, c.hidden_size)
        self.transform_ln = nn.LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.decoder_bias = self.create_parameter(
            [c.vocab_size], is_bias=True)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq, _ = self.ernie(input_ids, token_type_ids,
                            attention_mask=attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq)))
        logits = matmul(h, self.ernie.embeddings.word_embeddings.weight,
                        transpose_y=True) + self.decoder_bias
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels, ignore_index=-100)


class ErnieForSequenceClassification(nn.Layer):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout=None):
        super().__init__()
        self.ernie = ErnieModel(config)
        self.dropout = nn.Dropout(config.hidden_dropout_prob
                                  if dropout is None else dropout)
        self.classifier = nn.Linear(config.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels)
