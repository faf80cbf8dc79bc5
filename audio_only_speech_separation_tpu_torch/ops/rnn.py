"""(Bi)LSTM layers (counterpart of ``audio_only_speech_separation_tpu/ops/rnn.py``).

Parameters carry torch ``nn.LSTM``'s names (``weight_ih_l0`` [4H, in],
``weight_hh_l0`` [4H, H], ``bias_ih_l0``, ``bias_hh_l0`` and the
``_reverse`` set), so look2hear checkpoints load.  The computation takes
them in the JAX package's layout: w_ih [D, in, 4H], w_hh [D, H, 4H] and one
f32 bias [D, 4H], the sum of the two.  Gate order i, f, g, o; the state
starts at zero.

Dispatch: the kernel form for a bf16 input on a CUDA device
(``kernels.kernel_input``) whose hidden width the kernels take
(``lstm_kernel_ok``: H % 16 == 0, 16 <= H <= 256); within it
``kernel_choice`` picks, from the shape, one of:

- the resident kernel K6 (``ops/kernels/lstm.py::resident_bilstm``), the
  input projection inside;
- the input projection as a library matmul (the JAX package leaves it to
  XLA), then the recurrence kernel K5 (``fused_bilstm``): for an input
  width K6 cannot take (Din % 16 != 0), for long sequences (T >= 64) of a
  wide input (Din >= 128) at few sequences (B <= 16), where a K6 step's
  own input product lengthens the chain of T dependent steps more than
  K5's copies around the library product cost, and for narrower inputs
  at T >= 128 and B <= 128 (the JAX package's K5 gate, kept there; see
  ``kernel_choice``).

Both kernels keep a step's gates in mma.sync registers (``csrc/lstm.cu``).
K6, and K5 above 16 sequences, run one step body: h exchanged across a
cluster of up to four blocks, one barrier a step.  K5 at 16 sequences or
fewer runs its own body (``kernels.lstm.small_batch_body``): W_hh^T held in
registers across a cluster of up to eight blocks, the batch as the
product's N, h handed from block to block without a barrier.
Inside ``ops.kernels.plain_versions()`` the same form runs the kernels'
plain versions.  Anything else (f32, a CPU tensor, a hidden width outside
the envelope) takes the plain path, ``resident_bilstm_reference``: the JAX
package's scan in the input dtype.  The JAX package's TPU gates (T >= 128,
T >= 200, the VMEM tile test) are replaced by ``kernel_choice``.  A bidirectional layer can fuse
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

# K5's corners of the shapes (``kernel_choice``): wide inputs at few sequences, measured on an H100; and,
# for narrower inputs, the upper bounds of the JAX package's K5 gate (ops/pallas/lstm.py: T >= 128, at
# most 128 sequences)
WIDE_DIN = 128
WIDE_MIN_T, WIDE_MAX_B = 64, 16
NARROW_MIN_T, NARROW_MAX_B = 128, 128


def kernel_choice(T: int, B: int, Din: int, H: int, D: int) -> str:
    """The kernel the kernel form takes for B sequences of T steps of width
    Din into a (bi)LSTM of width H with D directions: "K5" (the library
    input product, then the recurrence kernel) where Din % 16 != 0; where
    Din >= ``WIDE_DIN``, T >= ``WIDE_MIN_T`` and B <= ``WIDE_MAX_B``; and
    where Din < ``WIDE_DIN``, T >= ``NARROW_MIN_T`` and B <=
    ``NARROW_MAX_B``.  "K6" (the resident kernel) everywhere else.

    Measured: ``scripts/profile_port_lstm_crossover.py``'s grid (T 8-501, B
    1-1048, (Din, H) (32, 64) to (128, 256), D 1 and 2, bf16) on an NVIDIA
    H100 80GB HBM3 at 700 W, tabulated in PERF.md.  There K6 is faster at
    most points, up to 7x at short T and many sequences; K5's path wins,
    by up to 1.27x, at long T and few sequences: T >= 82 and B <= 16 at
    every width (by more than 10 % almost only at Din 128), and at H 256
    with D 1 from T 24 and up to B 64.  H and D set no threshold.

    The last clause is not the grid's: at Din < 128, T >= 128 and 16 < B
    <= 128 K6 is faster (by up to 1.67x at 128 sequences).  Those shapes
    keep the JAX package's gate because sending them to K6 moves the 12 s
    batch-1 DPRNN off the 1.5x rule at its one fixed input (1.57x the plain
    path's error; the card test ``tests/test_torch_port_cuda_paths.py::
    test_served_model_at_published_width``, case "DPRNN B=1 x 12 s", reads
    the rule there), though over 16 inputs the two paths' errors agree
    (median ratio 1.00; PERF.md).  With it, the
    rule takes a path more than 10 % slower than the faster at 62 of the
    grid's 936 points (10 without it), none a shape of ``measure_gates``'
    table."""
    if Din % 16:
        return "K5"
    if Din >= WIDE_DIN:
        return "K5" if T >= WIDE_MIN_T and B <= WIDE_MAX_B else "K6"
    return "K5" if T >= NARROW_MIN_T and B <= NARROW_MAX_B else "K6"


def lstm_hidden_kernel_form(x, w_ih, w_hh, bias, recurrence=fused_bilstm,
                            resident=resident_bilstm) -> torch.Tensor:
    """Hidden states [T, D, B, H] of a (bi)LSTM on x [B, T, Din] through the
    kernels (``recurrence`` and ``resident`` stand for K5 and K6, chosen by
    ``kernel_choice``): direction 1 runs backward in time, both come out
    time-aligned.  w_ih and w_hh in x's dtype, bias f32 or None."""
    B, T, Din = x.shape
    D, H = w_hh.shape[:2]
    if kernel_choice(T, B, Din, H, D) == "K6":
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
