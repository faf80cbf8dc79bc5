"""(Bi)LSTM layers (counterpart of ``audio_only_speech_separation_tpu/ops/rnn.py``).

Parameters carry torch ``nn.LSTM``'s names (``weight_ih_l0`` [4H, in],
``weight_hh_l0`` [4H, H], ``bias_ih_l0``, ``bias_hh_l0`` and the
``_reverse`` set), so look2hear checkpoints load.  The computation takes
them in the JAX package's layout: w_ih [D, in, 4H], w_hh [D, H, 4H] and one
f32 bias [D, 4H], the sum of the two.  Gate order i, f, g, o; the state
starts at zero.

Dispatch: the kernel form for a bf16 input on a CUDA device
(``kernels.kernel_input``) whose hidden width the kernels take
(``lstm_kernel_ok``: H % 16 == 0, 16 <= H <= 256); within it, by the
number B of sequences:

- B > 128 (and an input width that is a multiple of 16): the resident
  kernel K6 (``ops/kernels/lstm.py::resident_bilstm``), the input
  projection inside;
- otherwise: the input projection as a library matmul (the JAX package
  leaves it to XLA), then the recurrence kernel K5 (``fused_bilstm``).

Both kernels run one step (``csrc/lstm.cu``): gates in mma.sync registers,
h exchanged across a cluster of up to four blocks, one barrier a step.
Inside ``ops.kernels.plain_versions()`` the same form runs the kernels'
plain versions.  Anything else (f32, a CPU tensor, a hidden width outside
the envelope) takes the plain path, ``resident_bilstm_reference``: the JAX
package's scan in the input dtype.  The JAX package's TPU gates (T >= 128,
T >= 200, the VMEM tile test) are dropped.  A bidirectional layer can fuse
a following projection (``proj_w``/``proj_b``, with ``proj_act`` applied
before it) into its output, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import kernels
from .kernels.lstm import (
    bilstm_reference,
    fused_bilstm,
    lstm_kernel_ok,
    resident_bilstm,
    resident_bilstm_reference,
)

RESIDENT_ABOVE = 128  # more sequences than this take the resident kernel


def kernel_choice(B: int, Din: int) -> str:
    """The kernel the kernel form takes for B sequences of width Din: "K6"
    (the resident kernel) above ``RESIDENT_ABOVE`` sequences at a width that
    is a multiple of 16, else "K5"."""
    return "K6" if B > RESIDENT_ABOVE and Din % 16 == 0 else "K5"


def lstm_hidden_kernel_form(x, w_ih, w_hh, bias, recurrence=fused_bilstm,
                            resident=resident_bilstm) -> torch.Tensor:
    """Hidden states [T, D, B, H] of a (bi)LSTM on x [B, T, Din] through the
    kernels (``recurrence`` and ``resident`` stand for K5 and K6, chosen by
    ``kernel_choice``): direction 1 runs backward in time, both come out
    time-aligned.  w_ih and w_hh in x's dtype, bias f32 or None."""
    if kernel_choice(x.shape[0], x.shape[2]) == "K6":
        return resident(x.contiguous(), w_ih.contiguous(), w_hh.contiguous(), bias)
    return recurrence_form(x, w_ih, w_hh, bias, recurrence)


def recurrence_form(x, w_ih, w_hh, bias, recurrence=fused_bilstm) -> torch.Tensor:
    """The K5 branch of ``lstm_hidden_kernel_form``: the input product as a
    library matmul, then ``recurrence`` over the pre-projected gates."""
    D = w_hh.shape[0]
    xx = torch.stack([x, x.flip(1)]) if D == 2 else x[None]  # [D, B, T, Din]
    xw = torch.matmul(xx, w_ih[:, None])  # [D, B, T, 4H], f32-accumulated, x's dtype
    if bias is not None:
        xw = (xw.float() + bias[:, None, None, :]).to(x.dtype)
    hs = recurrence(xw.permute(2, 0, 1, 3).contiguous(), w_hh.contiguous())  # [T, D, B, H]
    return torch.stack([hs[:, 0], hs[:, 1].flip(0)], dim=1) if D == 2 else hs


def lstm_hidden(x, w_ih, w_hh, bias) -> torch.Tensor:
    """[T, D, B, H] time-aligned hidden states, dispatched as the module
    docstring says."""
    if kernels.kernel_input(x) and lstm_kernel_ok(w_hh.shape[1]):
        return lstm_hidden_kernel_form(
            x, w_ih, w_hh, bias, kernels.pick(fused_bilstm, bilstm_reference),
            kernels.pick(resident_bilstm, resident_bilstm_reference))
    return resident_bilstm_reference(x, w_ih, w_hh, bias)


def project(hs, proj_w=None, proj_b=None, proj_act=None) -> torch.Tensor:
    """[T, D, B, H] -> [B, T, D*H] (directions concatenated), or with proj_w
    [D*H, P]: act(hs) @ proj_w + proj_b -> [B, T, P], one f32-accumulated
    product over both directions, rounded to hs's dtype."""
    T, D, B, H = hs.shape
    if proj_w is None:
        return hs.permute(2, 0, 1, 3).reshape(B, T, D * H)
    h2 = proj_act(hs) if proj_act is not None else hs
    out = torch.einsum("tkbh,khp->btp", h2, proj_w.to(hs.dtype).reshape(D, H, -1))
    return out + proj_b.to(out.dtype) if proj_b is not None else out


def lstm_scan(x, w_ih, w_hh, bias=None) -> torch.Tensor:
    """One direction: x [B, T, Din], w_ih [Din, 4H], w_hh [H, 4H], bias [4H]
    f32 or None -> [B, T, H]."""
    hs = lstm_hidden(x, w_ih[None], w_hh[None], None if bias is None else bias[None])
    return hs[:, 0].transpose(0, 1)


def bilstm_scan(x, w_ih, w_hh, bias=None, proj_w=None, proj_b=None, proj_act=None):
    """Both directions: x [B, T, Din], w_ih [2, Din, 4H], w_hh [2, H, 4H],
    bias [2, 4H] f32 or None -> [B, T, 2H] (forward ‖ backward), or [B, T, P]
    through the fused projection."""
    return project(lstm_hidden(x, w_ih, w_hh, bias), proj_w, proj_b, proj_act)


class _LSTMParams(nn.Module):
    """One layer's parameters in ``nn.LSTM`` naming, ``directions`` sets;
    torch's default init U(-1/sqrt(H), 1/sqrt(H))."""

    def __init__(self, input_size: int, hidden_size: int, directions: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.suffixes = ("", "_reverse")[:directions]
        self.use_bias = bias
        G = 4 * hidden_size
        for s in self.suffixes:
            setattr(self, f"weight_ih_l0{s}", nn.Parameter(torch.empty(G, input_size, device=device)))
            setattr(self, f"weight_hh_l0{s}", nn.Parameter(torch.empty(G, hidden_size, device=device)))
            if bias:
                setattr(self, f"bias_ih_l0{s}", nn.Parameter(torch.empty(G, device=device)))
                setattr(self, f"bias_hh_l0{s}", nn.Parameter(torch.empty(G, device=device)))
        bound = 1.0 / math.sqrt(hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def stacked(self, dtype):
        """(w_ih [D, in, 4H], w_hh [D, H, 4H]) in ``dtype`` and the summed
        bias [D, 4H] in f32 (or None)."""
        w_ih = torch.stack([getattr(self, f"weight_ih_l0{s}").t() for s in self.suffixes]).to(dtype)
        w_hh = torch.stack([getattr(self, f"weight_hh_l0{s}").t() for s in self.suffixes]).to(dtype)
        bias = None
        if self.use_bias:
            bias = torch.stack([getattr(self, f"bias_ih_l0{s}").float()
                                + getattr(self, f"bias_hh_l0{s}").float() for s in self.suffixes])
        return w_ih, w_hh, bias


class LSTM(_LSTMParams):
    """Unidirectional single-layer LSTM: [B, T, D] -> [B, T, H]."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, device=None):
        super().__init__(input_size, hidden_size, 1, bias, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_ih, w_hh, bias = self.stacked(x.dtype)
        return lstm_scan(x, w_ih[0], w_hh[0], None if bias is None else bias[0])


class BiLSTM(_LSTMParams):
    """Bidirectional single-layer LSTM: [B, T, D] -> [B, T, 2H], or [B, T, P]
    with a fused following projection (``proj_w`` [2H, P], ``proj_b``,
    ``proj_act`` applied before it)."""

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, device=None):
        super().__init__(input_size, hidden_size, 2, bias, device)

    def forward(self, x, proj_w=None, proj_b=None, proj_act=None) -> torch.Tensor:
        return bilstm_scan(x, *self.stacked(x.dtype), proj_w, proj_b, proj_act)


class MultiLayerLSTM(nn.Module):
    """``num_layers`` stacked (bi)LSTMs, ``nn.LSTM(num_layers=L)``'s
    semantics; layer i is ``layers.{i}``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, device=None):
        super().__init__()
        cls = BiLSTM if bidirectional else LSTM
        width = 2 * hidden_size if bidirectional else hidden_size
        self.layers = nn.ModuleList([cls(input_size if i == 0 else width, hidden_size, device=device)
                                     for i in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class ProjRNN(nn.Module):
    """(Bi)LSTM ``rnn`` + Linear ``proj`` back to the input width
    (reference look2hear/models/utils/gc3_basics.py:7-24): [B, T, D] ->
    [B, T, D].  The bidirectional projection is fused into the LSTM's
    output."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False,
                 device=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.rnn = (BiLSTM if bidirectional else LSTM)(input_size, hidden_size, device=device)
        self.proj = nn.Linear(hidden_size * (2 if bidirectional else 1), input_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bidirectional:
            return self.rnn(x, self.proj.weight.t(), self.proj.bias)
        return self.proj(self.rnn(x))
