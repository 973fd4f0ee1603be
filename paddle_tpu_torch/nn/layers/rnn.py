"""Recurrent layers — the counterpart of ``paddle_tpu/nn/layers/rnn.py``:
the SimpleRNN, LSTM and GRU cells, the ``RNN``/``BiRNN`` sequence
wrappers and the multi-layer, optionally bidirectional stacks.

One direction of one layer runs the reference's step body (``_step``) in
a Python loop over time, where the JAX package scans it (``lax.scan``):
the same operations a step, so the same values. Gate weights keep
Paddle's layout — ``weight_ih [G*H, I]``, ``weight_hh [G*H, H]``, gate
order i, f, c, o (LSTM) and r, u, c (GRU, the reset gate applied to the
hidden projection plus its bias) — and the stacks keep the
``cells.{k}.weight_ih`` nesting, so a ``state_dict`` crosses from the
JAX package as it is. Weights draw ``Uniform(-1/sqrt(H), 1/sqrt(H))`` in
the reference's order, and the dropout between layers is ``F.dropout``'s
key walk: under one ``seed`` the weights and masks are the JAX
package's bit for bit.
"""
from __future__ import annotations

import torch

from ...ops._op import op
from .. import functional as F
from .. import initializer as I
from ..layer import Layer, LayerList

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


def _gates(x, h, w_ih, w_hh, b_ih, b_hh):
    g = x @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        g = g + b_ih
    if b_hh is not None:
        g = g + b_hh
    return g


def _step(mode, activation, x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One time step: ``x [B, I]``, ``h, c [B, H]`` to ``(h', c')``."""
    if mode == "simple":
        act = torch.tanh if activation == "tanh" else torch.relu
        return act(_gates(x, h, w_ih, w_hh, b_ih, b_hh)), c
    H = h.shape[-1]
    if mode == "lstm":
        g = _gates(x, h, w_ih, w_hh, b_ih, b_hh)
        i, f, cc, o = (g[..., :H], g[..., H:2 * H], g[..., 2 * H:3 * H],
                       g[..., 3 * H:])
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    # gru: r (reset), u (update), c (candidate); the reset gate scales the
    # hidden projection with its bias
    xg = x @ w_ih.T
    if b_ih is not None:
        xg = xg + b_ih
    hg = h @ w_hh.T
    if b_hh is not None:
        hg = hg + b_hh
    r = torch.sigmoid(xg[..., :H] + hg[..., :H])
    u = torch.sigmoid(xg[..., H:2 * H] + hg[..., H:2 * H])
    cand = torch.tanh(xg[..., 2 * H:] + r * hg[..., 2 * H:])
    return u * h + (1.0 - u) * cand, c


@op(name="_rnn_scan")
def _rnn_loop(x, h0, c0, w_ih, w_hh, b_ih, b_hh, mode="simple",
              activation="tanh", reverse=False):
    """A whole sequence, one layer, one direction: ``x [B, T, I]`` to
    ``y [B, T, H]`` and the final ``(h, c)``. One op under the JAX
    package's name (``_rnn_scan``), so AMP casts its inputs as there."""
    T = x.shape[1]
    h, c = h0, c0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _step(mode, activation, x[:, t], h, c, w_ih, w_hh, b_ih,
                     b_hh)
        ys[t] = h
    return torch.stack(ys, dim=1), h, c


@op
def _cell_step(x, h, c, w_ih, w_hh, b_ih, b_hh, mode="simple",
               activation="tanh"):
    return _step(mode, activation, x, h, c, w_ih, w_hh, b_ih, b_hh)


class _CellBase(Layer):
    def __init__(self, input_size, hidden_size, n_gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / (hidden_size ** 0.5)
        u = I.Uniform(-std, std)
        G = n_gates * hidden_size
        self.weight_ih = self.create_parameter(
            [G, input_size], attr=weight_ih_attr, default_initializer=u)
        self.weight_hh = self.create_parameter(
            [G, hidden_size], attr=weight_hh_attr, default_initializer=u)
        self.bias_ih = (None if bias_ih_attr is False else
                        self.create_parameter([G], attr=bias_ih_attr,
                                              default_initializer=u,
                                              is_bias=True))
        self.bias_hh = (None if bias_hh_attr is False else
                        self.create_parameter([G], attr=bias_hh_attr,
                                              default_initializer=u,
                                              is_bias=True))

    def _zero_state(self, x, batch=None):
        return torch.zeros(x.shape[0] if batch is None else batch,
                           self.hidden_size, dtype=x.dtype, device=x.device)

    def _cell(self, x, h, c):
        return _cell_step(x, h, c, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh, mode=self.mode,
                          activation=getattr(self, "activation", "tanh"))

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_CellBase):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    mode = "simple"

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, 1, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh|relu, got {activation}")
        self.activation = activation

    def forward(self, inputs, states=None):
        h = states if states is not None else self._zero_state(inputs)
        h_new, _ = self._cell(inputs, h, h)
        return h_new, h_new


class LSTMCell(_CellBase):
    """Gate order i, f, c, o (Paddle's layout); states are ``(h, c)``."""

    mode = "lstm"
    activation = "tanh"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, 4, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self._zero_state(inputs)
        else:
            h, c = states
        h_new, c_new = self._cell(inputs, h, c)
        return h_new, (h_new, c_new)


class GRUCell(_CellBase):
    """Gate order r, u, c; ``h' = u * h + (1 - u) * candidate``."""

    mode = "gru"
    activation = "tanh"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, 3, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None else self._zero_state(inputs)
        h_new, _ = self._cell(inputs, h, h)
        return h_new, h_new


def _run_direction(cell, x, h0, c0, reverse, time_major):
    if time_major:
        x = x.transpose(0, 1)
    y, hT, cT = _rnn_loop(x, h0, c0, cell.weight_ih, cell.weight_hh,
                          cell.bias_ih, cell.bias_hh, mode=cell.mode,
                          activation=getattr(cell, "activation", "tanh"),
                          reverse=reverse)
    if time_major:
        y = y.transpose(0, 1)
    return y, hT, cT


def _split_state(st):
    return tuple(st) if isinstance(st, (tuple, list)) else (st, st)


class RNN(Layer):
    """A cell run over the time dim of ``inputs`` (``paddle.nn.RNN``). Any
    cell with ``forward(step_input, states) -> (output, new_states)``
    works; the built-in cells take the loop of their step body."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        cell = self.cell
        if not isinstance(cell, _CellBase):
            return self._run_custom_cell(inputs, initial_states)
        if initial_states is None:
            z = cell._zero_state(inputs, inputs.shape[
                1 if self.time_major else 0])
            h0 = c0 = z
        else:
            h0, c0 = _split_state(initial_states)
        y, hT, cT = _run_direction(cell, inputs, h0, c0, self.is_reverse,
                                   self.time_major)
        return y, ((hT, cT) if cell.mode == "lstm" else hT)

    def _run_custom_cell(self, inputs, initial_states):
        tdim = 0 if self.time_major else 1
        T = inputs.shape[tdim]
        order = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = [None] * T
        for ti in order:
            xt = inputs[:, ti] if tdim == 1 else inputs[ti]
            out, states = (self.cell(xt) if states is None
                           else self.cell(xt, states))
            outs[ti] = out
        return torch.stack(outs, dim=tdim), states


class BiRNN(Layer):
    """A forward and a backward cell over one sequence, outputs
    concatenated (``paddle.nn.BiRNN``)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        bidx = 1 if self.time_major else 0
        outs, finals = [], []
        for cell, rev, i in ((self.cell_fw, False, 0),
                             (self.cell_bw, True, 1)):
            if initial_states is None:
                h0 = c0 = cell._zero_state(inputs, inputs.shape[bidx])
            else:
                h0, c0 = _split_state(initial_states[i])
            y, hT, cT = _run_direction(cell, inputs, h0, c0, rev,
                                       self.time_major)
            outs.append(y)
            finals.append((hT, cT) if cell.mode == "lstm" else hT)
        return torch.cat(outs, dim=-1), tuple(finals)


class _RNNBase(Layer):
    """The multi-layer, optionally bidirectional stack (``SimpleRNN``,
    ``LSTM``, ``GRU``): cell ``k = layer * directions + direction``, the
    outputs of both directions concatenated into the next layer, dropout
    between layers in training."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **cell_kwargs):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be forward|bidirect, "
                             f"got {direction}")
        self.mode = mode
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction != "forward"
        ndir = 2 if self.bidirectional else 1
        self.num_directions = ndir

        def make(in_sz):
            if mode == "lstm":
                return LSTMCell(in_sz, hidden_size, **cell_kwargs)
            if mode == "gru":
                return GRUCell(in_sz, hidden_size, **cell_kwargs)
            return SimpleRNNCell(in_sz, hidden_size, activation=activation,
                                 **cell_kwargs)

        cells = []
        for li in range(num_layers):
            in_sz = input_size if li == 0 else hidden_size * ndir
            cells.append(make(in_sz))
            if self.bidirectional:
                cells.append(make(in_sz))
        self.cells = LayerList(cells)

    def forward(self, inputs, initial_states=None):
        ndir = self.num_directions
        B = inputs.shape[1 if self.time_major else 0]

        def init_for(k):
            if initial_states is None:
                z = self.cells[k]._zero_state(inputs, B)
                return z, z
            if self.mode == "lstm":
                h_all, c_all = initial_states
                return h_all[k], c_all[k]
            return initial_states[k], initial_states[k]

        x = inputs
        h_fin, c_fin = [], []
        for li in range(self.num_layers):
            outs = []
            for di in range(ndir):
                k = li * ndir + di
                h0, c0 = init_for(k)
                y, hT, cT = _run_direction(self.cells[k], x, h0, c0,
                                           di == 1, self.time_major)
                outs.append(y)
                h_fin.append(hT)
                c_fin.append(cT)
            x = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
            if self.dropout and li != self.num_layers - 1 and self.training:
                x = F.dropout(x, p=self.dropout, training=True)
        h_n = torch.stack(h_fin, dim=0)                   # [L*ndir, B, H]
        if self.mode == "lstm":
            return x, (h_n, torch.stack(c_fin, dim=0))
        return x, h_n


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("simple", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("lstm", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("gru", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
