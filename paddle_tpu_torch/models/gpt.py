"""GPT family — the counterpart of ``paddle_tpu/models/gpt.py`` (config 2
of ``BASELINE.json``: GPT-3 345M, PaddleFleetX's gpt configs), built from
the port's ``nn`` the way the JAX model is: pre-LN blocks of plain
scaled-dot-product attention and a GELU MLP, learned positions, the LM
head tied to the token embedding, and the shifted ``cross_entropy``
(``ignore_index=-100``).

``use_mp_layers=True`` (the default) builds the tensor-parallel layers,
which on one device compute what ``nn.Linear``/``nn.Embedding`` do, with
the same parameter names and shapes as ``use_mp_layers=False`` (so one
variant's state dict loads into the other); their embedding is
Xavier-normal where ``nn.Embedding`` is normal. A model-parallel group of
more than one rank raises (ROADMAP.md Queue A step 13). Parameters go on
the current device (``paddle_tpu_torch.set_device``); their values come
from the seeded key walk (``paddle_tpu_torch.seed``). Where the JAX model
adds and slices with Tensor operators, this one calls the ops (``add``,
``getitem``), so AMP casts there as it does there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import nn
from ..nn import functional as F
from ..ops import add, arange, getitem, matmul, reshape, unsqueeze
from ..parallel.fleet.mp import (ColumnParallelLinear, RowParallelLinear,
                                 VocabParallelEmbedding, parallel_matmul)


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    use_mp_layers: bool = True


def gpt3_345m(**kw):
    return GPTConfig(**kw)


def gpt_tiny(**kw):
    d = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
    d.update(kw)
    return GPTConfig(**d)


_ALL = slice(None)


class GPTAttention(nn.Layer):
    def __init__(self, c: GPTConfig):
        super().__init__()
        self.nh = c.num_attention_heads
        self.hd = c.hidden_size // c.num_attention_heads
        if c.use_mp_layers:
            self.qkv = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                            gather_output=False)
            self.out_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                              input_is_parallel=True)
        else:
            self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size)
            self.out_proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.dropout = c.attention_probs_dropout_prob

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        qkv = reshape(self.qkv(x), [B, S, 3, self.nh, self.hd])
        q, k, v = (getitem(qkv, (_ALL, _ALL, i)) for i in range(3))
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training)
        out = reshape(out, [B, S, self.nh * self.hd])
        return self.out_proj(out)


class GPTBlock(nn.Layer):
    def __init__(self, c: GPTConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c.hidden_size, c.layer_norm_epsilon)
        self.attn = GPTAttention(c)
        self.ln_2 = nn.LayerNorm(c.hidden_size, c.layer_norm_epsilon)
        if c.use_mp_layers:
            self.fc_in = ColumnParallelLinear(c.hidden_size,
                                              c.intermediate_size,
                                              gather_output=False)
            self.fc_out = RowParallelLinear(c.intermediate_size,
                                            c.hidden_size,
                                            input_is_parallel=True)
        else:
            self.fc_in = nn.Linear(c.hidden_size, c.intermediate_size)
            self.fc_out = nn.Linear(c.intermediate_size, c.hidden_size)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, x):
        x = add(x, self.dropout(self.attn(self.ln_1(x))))
        x = add(x, self.dropout(self.fc_out(F.gelu(self.fc_in(
            self.ln_2(x))))))
        return x


class GPTModel(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        c = config
        emb = VocabParallelEmbedding if c.use_mp_layers else nn.Embedding
        self.wte = emb(c.vocab_size, c.hidden_size)
        self.wpe = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.drop = nn.Dropout(c.hidden_dropout_prob)
        self.h = nn.LayerList([GPTBlock(c)
                               for _ in range(c.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size, c.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = unsqueeze(arange(input_ids.shape[1],
                                            dtype="int32"), 0)
        x = add(self.wte(input_ids), self.wpe(position_ids))
        x = self.drop(x)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(config)
        self.config = config

    def forward(self, input_ids, labels=None):
        hidden = self.gpt(input_ids)
        # the LM head tied to the token embedding
        logits = parallel_matmul(hidden, self.gpt.wte.weight,
                                 transpose_y=True,
                                 tensor_parallel_output=False) \
            if self.config.use_mp_layers else \
            _plain_head(hidden, self.gpt.wte.weight)
        if labels is None:
            return logits
        return F.cross_entropy(getitem(logits, (_ALL, slice(None, -1))),
                               getitem(labels, (_ALL, slice(1, None))),
                               ignore_index=-100)

    def num_params(self):
        return sum(int(np.prod(p.shape)) for p in self.parameters())


def _plain_head(hidden, w):
    return matmul(hidden, w, transpose_y=True)
