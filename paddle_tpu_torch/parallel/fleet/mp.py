"""Tensor-parallel layers on one device — the counterpart of
``paddle_tpu/parallel/fleet/mp.py``'s ``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding`` and ``parallel_matmul``
where no mesh is set: there the sharding constraints are no-ops
(``:45-52``), so each layer computes what ``nn.Linear`` /
``nn.Embedding`` compute, with the same parameter names, shapes and
initializers (the embedding is Xavier-normal). A model-parallel group
of more than one rank raises: sharding across cards is ROADMAP.md Queue A
step 13.
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F


def _check_group(mp_group):
    if mp_group is not None and getattr(mp_group, "nranks", 1) > 1:
        raise NotImplementedError(
            "model parallelism across ranks (mp degree > 1) is not ported; "
            "see ROADMAP.md Queue A step 13")


class ColumnParallelLinear(nn.Layer):
    """Weight ``[in, out]``; on one device, ``F.linear``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        _check_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr)
        if has_bias:
            self.bias = self.create_parameter(
                shape=[out_features], attr=None, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Layer):
    """Weight ``[in, out]``; on one device, ``F.linear`` without its bias,
    then the bias added (the reference adds it after the reduction)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        _check_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr)
        if has_bias:
            self.bias = self.create_parameter(
                shape=[out_features], attr=None, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        from ...ops import add
        out = F.linear(x, self.weight, None)
        if self.bias is not None:
            out = add(out, self.bias)
        return out


class VocabParallelEmbedding(nn.Layer):
    """Embedding ``[vocab, hidden]``, Xavier-normal."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        _check_group(mp_group)
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=nn.initializer.XavierNormal())

    def forward(self, x):
        return F.embedding(x, self.weight)


def parallel_matmul(x, weight, transpose_y=False, tensor_parallel_output=True):
    """The LM-head matmul (on one device, ``matmul``)."""
    from ...ops import matmul
    return matmul(x, weight, transpose_y=transpose_y)
