"""ERNIE-ViL 2.0-style dual encoder — the counterpart of
``paddle_tpu/models/ernie_vil.py`` (config 4 of ``BASELINE.json``): a ViT
image tower (a bias-free ``Conv2D`` patch embedding, a class token and
learned positions drawn from Normal(0, 0.02), a pre-LN
``TransformerEncoder``), a transformer text tower, the two projections
and the CLIP-style symmetric InfoNCE loss with a learned 0-d
``logit_scale``. Data parallelism (the reference's global-batch
negatives) waits for ROADMAP.md Queue A step 13; on one device the batch
is the card's share.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import nn
from ..ops import arange, concat, expand, flatten, transpose, unsqueeze
from ..ops._op import op


@dataclass
class ErnieViLConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vocab_size: int = 30522
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    max_text_len: int = 64
    embed_dim: int = 512
    logit_scale_init: float = 2.659  # ln(1/0.07)


def ernie_vil_base(**kw):
    return ErnieViLConfig(**kw)


def ernie_vil_tiny(**kw):
    d = dict(image_size=32, patch_size=8, vision_width=64, vision_layers=2,
             vision_heads=4, vocab_size=128, text_width=64, text_layers=2,
             text_heads=4, max_text_len=16, embed_dim=32)
    d.update(kw)
    return ErnieViLConfig(**d)


class VisionTransformer(nn.Layer):
    def __init__(self, c: ErnieViLConfig):
        super().__init__()
        self.patch_embed = nn.Conv2D(3, c.vision_width, c.patch_size,
                                     stride=c.patch_size, bias_attr=False)
        n_patches = (c.image_size // c.patch_size) ** 2
        self.cls_token = self.create_parameter(
            [1, 1, c.vision_width],
            default_initializer=nn.initializer.Normal(0, 0.02))
        self.pos_embed = self.create_parameter(
            [1, n_patches + 1, c.vision_width],
            default_initializer=nn.initializer.Normal(0, 0.02))
        layer = nn.TransformerEncoderLayer(
            c.vision_width, c.vision_heads, c.vision_width * 4, dropout=0.0,
            activation="gelu", normalize_before=True)
        self.encoder = nn.TransformerEncoder(layer, c.vision_layers)
        self.ln = nn.LayerNorm(c.vision_width)

    def forward(self, pixel_values):
        x = self.patch_embed(pixel_values)          # [B, W, H/p, W/p]
        x = transpose(flatten(x, 2), [0, 2, 1])     # [B, P, W]
        cls = expand(self.cls_token, [x.shape[0], 1, x.shape[2]])
        x = concat([cls, x], axis=1) + self.pos_embed
        x = self.encoder(x)
        return self.ln(x[:, 0])


class TextTransformer(nn.Layer):
    def __init__(self, c: ErnieViLConfig):
        super().__init__()
        self.embed = nn.Embedding(c.vocab_size, c.text_width)
        self.pos_embed = nn.Embedding(c.max_text_len, c.text_width)
        layer = nn.TransformerEncoderLayer(
            c.text_width, c.text_heads, c.text_width * 4, dropout=0.0,
            activation="gelu", normalize_before=True)
        self.encoder = nn.TransformerEncoder(layer, c.text_layers)
        self.ln = nn.LayerNorm(c.text_width)

    def forward(self, input_ids):
        pos = unsqueeze(arange(input_ids.shape[1], dtype="int32"), 0)
        x = self.embed(input_ids) + self.pos_embed(pos)
        x = self.encoder(x)
        return self.ln(x[:, 0])


@op
def _clip_loss(img_feat, txt_feat, logit_scale):
    """The symmetric InfoNCE over the batch's pairs. The features are
    normalized in their own type and the scores taken in the type that
    the 0-d ``logit_scale`` promotes them to (float32 beside bf16
    features under AMP), as jnp promotes; torch would keep a 0-d
    tensor's product in the features' type."""
    img = img_feat / torch.linalg.vector_norm(img_feat, dim=-1, keepdim=True)
    txt = txt_feat / torch.linalg.vector_norm(txt_feat, dim=-1, keepdim=True)
    dt = torch.promote_types(torch.promote_types(img.dtype, txt.dtype),
                             logit_scale.dtype)
    logits = (torch.exp(logit_scale).to(dt) * img.to(dt)) @ txt.to(dt).T
    li = torch.log_softmax(logits, dim=-1)
    lt = torch.log_softmax(logits.T, dim=-1)
    loss_i = -torch.mean(torch.diagonal(li))
    loss_t = -torch.mean(torch.diagonal(lt))
    return (loss_i + loss_t) / 2


class ErnieViLModel(nn.Layer):
    def __init__(self, config: ErnieViLConfig):
        super().__init__()
        self.config = config
        self.visual = VisionTransformer(config)
        self.text = TextTransformer(config)
        self.vision_proj = nn.Linear(config.vision_width, config.embed_dim,
                                     bias_attr=False)
        self.text_proj = nn.Linear(config.text_width, config.embed_dim,
                                   bias_attr=False)
        self.logit_scale = self.create_parameter(
            [], default_initializer=nn.initializer.Constant(
                config.logit_scale_init))

    def encode_image(self, pixel_values):
        return self.vision_proj(self.visual(pixel_values))

    def encode_text(self, input_ids):
        return self.text_proj(self.text(input_ids))

    def forward(self, pixel_values, input_ids, return_loss=True):
        img = self.encode_image(pixel_values)
        txt = self.encode_text(input_ids)
        if not return_loss:
            return img, txt
        return _clip_loss(img, txt, self.logit_scale)

    def num_params(self):
        return sum(int(np.prod(p.shape)) if p.shape else 1
                   for p in self.parameters())
