"""(Bi)LSTM recurrence kernels (K5 and K6; counterpart of
``audio_only_speech_separation_tpu/ops/pallas/lstm.py``): the CUDA wrappers
``fused_bilstm`` and ``resident_bilstm``, their plain versions, their launch
counters and their envelope ``lstm_kernel_ok``.

- ``fused_bilstm(xw, w_hh)``: pre-projected gates xw [T, D, B, 4H] ->
  hidden states [T, D, B, H]; the backward direction comes pre-reversed in
  time.
- ``resident_bilstm(x, w_ih, w_hh, bias)``: batch-major x [B, T, Din], the
  input projection inside -> [T, D, B, H], both directions time-aligned.

Torch gate order (i, f, g, o), zero initial state, and the TPU kernels'
rounding (``lstm.py:93-111`` and ``:251-263``): the gate pre-activations
are ``bf16(xw + bf16(h @ W_hh))``, with ``xw = bf16(x @ W_ih + b)`` in the
resident form; sigmoid and tanh in f32; ``c = bf16(f*c + i*g)``,
``h = bf16(o * tanh(f*c + i*g))``.  In f32 every rounding is the identity
and the plain versions are the JAX package's ``_xla_bilstm`` and
``_xla_resident_ref``.

Both kernels live in ``csrc/lstm.cu`` (bf16; the envelope
``lstm_kernel_ok``: H % 16 == 0, 16 <= H <= 256, and for the resident form
Din % 16 == 0).  K6, and K5 at more than 16 sequences, run one step body:
the wrapper packs W_hh (and the resident form W_ih) by
``pack_gate_fragments``, one gather on the device: gate columns
interleaved so that one thread's mma accumulators hold i, f, g and o of its
own cells, in the B-fragment order of ``mma.sync.m16n8k16``, the batch as
the product's M; a step is spread over a thread-block cluster of 1, 2 or 4
blocks.  K5 at 16 sequences or fewer (``small_batch_body``) runs a body of
its own: W_hh^T packed by ``pack_gate_rows`` as the product's A operand
(gate rows interleaved, the batch as N), held in registers across a
cluster of up to 8 blocks, h handed over block to block without a barrier
across the cluster.  ``recurrence_cluster`` and ``resident_cluster`` say
which cluster a shape takes.  Dispatch (``ops/rnn.py``) takes the kernels
only inside the envelope; on a CUDA tensor outside it the wrappers raise.
Their backward recomputes through the plain version under autograd, as
the JAX package's custom VJPs do; no backward kernel exists there to port.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...utils.profiling import span
from . import grad_through_plain
from .convtasnet_block import _check, _check_aligned


def _step(gates_in: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_hh: torch.Tensor):
    """One step on [D, B, *]: gates_in [D, B, 4H] in the state dtype."""
    dt = h.dtype
    H = h.shape[-1]
    hw = torch.matmul(h.float(), w_hh.float()).to(dt)  # [D, B, 4H]
    gates = (gates_in + hw).float()
    i, f, g, o = gates.split(H, dim=-1)
    c32 = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h = (torch.sigmoid(o) * torch.tanh(c32)).to(dt)
    return h, c32.to(dt)


def bilstm_reference(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_bilstm``, same arguments and result."""
    T, D, B, G = xw.shape
    H = G // 4
    h = xw.new_zeros((D, B, H))
    c = xw.new_zeros((D, B, H))
    w_hh = w_hh.to(xw.dtype)
    outs = []
    for t in range(T):
        h, c = _step(xw[t], h, c, w_hh)
        outs.append(h)
    return torch.stack(outs)


def resident_bilstm_reference(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of ``resident_bilstm``, same arguments and result."""
    D = w_hh.shape[0]
    xx = torch.stack([x, x.flip(1)]) if D == 2 else x[None]  # [D, B, T, Din]
    xw = torch.matmul(xx.float(), w_ih.float()[:, None])  # [D, B, T, 4H] f32
    if bias is not None:
        xw = xw + bias.float()[:, None, None, :]
    hs = bilstm_reference(xw.to(x.dtype).permute(2, 0, 1, 3), w_hh)  # [T, D, B, H]
    if D == 2:
        hs = torch.stack([hs[:, 0], hs[:, 1].flip(0)], dim=1)
    return hs


def gate_interleave(H: int) -> torch.Tensor:
    """perm [4H]: packed gate column p is torch-order column perm[p].  In
    each 16 packed columns (an n-tile pair of 8), the first 8 hold (i, f)
    and the next 8 (g, o) of 4 hidden units, as accumulator columns 2q and
    2q + 1 of lane q: column 8*nt + c is gate 2*(nt % 2) + c % 2 of unit
    4*(nt // 2) + c // 2."""
    p = torch.arange(4 * H)
    nt, c = p // 8, p % 8
    return (2 * (nt % 2) + c % 2) * H + 4 * (nt // 2) + c // 2


def _fragment_order(w: torch.Tensor) -> torch.Tensor:
    D, K, G = w.shape
    wp = w[:, :, gate_interleave(G // 4).to(w.device)]
    # k = 16 ks + 8 hi + 2 q + lo, n = 8 nt + r; lane = 4 r + q, e = 2 hi + lo
    wr = wp.reshape(D, K // 16, 2, 4, 2, G // 8, 8)
    return wr.permute(0, 5, 1, 6, 3, 2, 4).reshape(D, G // 8, K // 16, 32, 4)


@functools.lru_cache(maxsize=None)
def _fragment_index(K: int, H: int, device: torch.device) -> torch.Tensor:
    """Flat positions in a [K, 4H] weight of the packed elements, on
    ``device`` (made once, so a call copies nothing from the host)."""
    flat = torch.arange(K * 4 * H).reshape(1, K, 4 * H)
    return _fragment_order(flat).reshape(-1).to(device)


def pack_gate_fragments(w: torch.Tensor) -> torch.Tensor:
    """w [D, K, 4H] (torch gate order) -> [D, 4H/8, K/16, 32, 4]: the gate
    columns interleaved (``gate_interleave``), then each 16 x 8 block in
    the B-fragment order of ``mma.sync.m16n8k16``: lane l of n-tile nt at
    k-step ks holds B[16 ks + 2 (l % 4) + e % 2 + 8 (e // 2)][8 nt + l // 4]
    for e = 0..3.  One gather."""
    D, K, G = w.shape
    idx = _fragment_index(K, G // 4, w.device)
    return w.reshape(D, K * G)[:, idx].reshape(D, G // 8, K // 16, 32, 4)


def unpack_gate_fragments(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_gate_fragments``: [D, 4H/8, K/16, 32, 4] ->
    [D, K, 4H] in torch gate order."""
    D, NT, KS = packed.shape[:3]
    G = 8 * NT
    wr = packed.reshape(D, NT, KS, 8, 4, 2, 2).permute(0, 2, 5, 4, 6, 1, 3)
    wp = wr.reshape(D, 16 * KS, G)
    return wp[:, :, torch.argsort(gate_interleave(G // 4)).to(packed.device)]


def _row_order(w: torch.Tensor) -> torch.Tensor:
    D, K, G = w.shape
    H = G // 4
    # k = 16 ks + 8 khi + 2 q + half; gate column (2 mt + rlo) H + 8 j + g; lane = 4 g + q, e = 4 khi + 2 rlo + half
    wr = w.reshape(D, K // 16, 2, 4, 2, 2, 2, H // 8, 8)
    return wr.permute(0, 7, 5, 1, 8, 3, 2, 6, 4).reshape(D, H // 8, 2, K // 16, 32, 8)


@functools.lru_cache(maxsize=None)
def _row_index(H: int, device: torch.device) -> torch.Tensor:
    """Flat positions in a [H, 4H] weight of the elements ``pack_gate_rows``
    packs, on ``device`` (made once)."""
    flat = torch.arange(H * 4 * H).reshape(1, H, 4 * H)
    return _row_order(flat).reshape(-1).to(device)


def pack_gate_rows(w: torch.Tensor) -> torch.Tensor:
    """w_hh [D, H, 4H] (torch gate order) -> [D, H/8, 2, H/16, 32, 8]: W_hh^T
    as the A operand of ``mma.sync.m16n8k16`` in K5's few-sequence body.
    Slice j (a pair of warps, one a half of the k-steps) holds hidden units
    8j .. 8j + 7 in two 16-row tiles: rows g and g + 8 of tile 0 are gates i
    and f of unit 8j + g, of tile 1 gates g and o.  Lane l of tile mt at
    k-step ks holds, as element e of its four A-fragment registers,
    W_hh[16 ks + 2 (l % 4) + e % 2 + 8 (e // 4), (2 mt + (e // 2) % 2) H +
    8 j + l // 4].  One gather."""
    D, H, G = w.shape
    idx = _row_index(H, w.device)
    return w.reshape(D, H * G)[:, idx].reshape(D, H // 8, 2, H // 16, 32, 8)


def unpack_gate_rows(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_gate_rows``: [D, H/8, 2, H/16, 32, 8] ->
    [D, H, 4H] in torch gate order."""
    D, J, _, KS = packed.shape[:4]
    wr = packed.reshape(D, J, 2, KS, 8, 4, 2, 2, 2).permute(0, 3, 6, 5, 8, 2, 7, 1, 4)
    return wr.reshape(D, 16 * KS, 32 * J)


# K5 takes its few-sequence body up to this many sequences (its two n-tiles of 8)
SMALL_BATCH_MAX_B = 16


def small_batch_body(B: int, D: int, H: int) -> bool:
    """Whether ``fused_bilstm`` runs K5's few-sequence body for B sequences,
    D directions and hidden width H: B <= 16 inside the kernels' envelope.
    There the batch cannot fill the mma's 16 rows, so the weights take that
    role (``pack_gate_rows``); above it K5 runs the step body it shares
    with K6."""
    return 1 <= B <= SMALL_BATCH_MAX_B and D in (1, 2) and lstm_kernel_ok(H)


def lstm_kernel_ok(H: int, Din: Optional[int] = None) -> bool:
    """Whether the kernels take hidden width ``H`` (and, for the resident
    form, input width ``Din``)."""
    return H % 16 == 0 and 16 <= H <= 256 and (Din is None or Din % 16 == 0)


def _check_hidden(H: int) -> None:
    if not lstm_kernel_ok(H):
        raise ValueError(f"kernel takes H % 16 == 0 and 16 <= H <= 256; got H={H}")


def _launch_recurrence(xw, w_hh):
    from ._build import check_launch, load_library

    dev = xw.device
    T, D, B, G = xw.shape
    H = G // 4
    _check_hidden(H)
    if T < 1 or B < 1 or D not in (1, 2) or G != 4 * H:
        raise ValueError(f"kernel takes T >= 1, B >= 1, D in (1, 2); got xw {tuple(xw.shape)}")
    _check("xw", xw, (T, D, B, G), torch.bfloat16, dev)
    _check_aligned("xw", xw)
    _check("w_hh", w_hh, (D, H, G), torch.bfloat16, dev)
    small = small_batch_body(B, D, H)
    whh_p = pack_gate_rows(w_hh) if small else pack_gate_fragments(w_hh)
    out = torch.empty((T, D, B, H), dtype=torch.bfloat16, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_recurrence(xw.data_ptr(), whh_p.data_ptr(), out.data_ptr(), T, D, B, H, int(small), stream)
    check_launch(lib, "lstm_recurrence", rc)
    fused_bilstm.launches += 1
    fused_bilstm.small_batch_launches += small
    return out


def _launch_resident(x, w_ih, w_hh, bias):
    from ._build import check_launch, load_library

    dev = x.device
    B, T, Din = x.shape
    D, H, G = w_hh.shape
    if not lstm_kernel_ok(H, Din) or T < 1 or B < 1 or D not in (1, 2) or G != 4 * H:
        raise ValueError(f"kernel takes H % 16 == 0, 16 <= H <= 256, Din % 16 == 0, T >= 1, B >= 1, "
                         f"D in (1, 2); got x {tuple(x.shape)}, w_hh {tuple(w_hh.shape)}")
    _check("x", x, (B, T, Din), torch.bfloat16, dev)
    _check_aligned("x", x)
    _check("w_ih", w_ih, (D, Din, G), torch.bfloat16, dev)
    _check("w_hh", w_hh, (D, H, G), torch.bfloat16, dev)
    if bias is None:
        bias = torch.zeros((D, G), dtype=torch.float32, device=dev)
    _check("bias", bias, (D, G), torch.float32, dev)
    wih_p, whh_p = pack_gate_fragments(w_ih), pack_gate_fragments(w_hh)
    out = torch.empty((T, D, B, H), dtype=torch.bfloat16, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_resident(x.data_ptr(), wih_p.data_ptr(), whh_p.data_ptr(), bias.data_ptr(),
                               out.data_ptr(), T, D, B, Din, H, stream)
    check_launch(lib, "lstm_resident", rc)
    resident_bilstm.launches += lib.lstm_resident_launches()
    return out


class _Recurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, w_hh):
        ctx.save_for_backward(xw, w_hh)
        return _launch_recurrence(xw, w_hh)

    @staticmethod
    def backward(ctx, g):
        return grad_through_plain(bilstm_reference, ctx.saved_tensors, ctx.needs_input_grad, g)


class _Resident(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_ih, w_hh, bias):
        ctx.save_for_backward(x, w_ih, w_hh, bias)
        return _launch_resident(x, w_ih, w_hh, bias)

    @staticmethod
    def backward(ctx, g):
        return grad_through_plain(resident_bilstm_reference, ctx.saved_tensors,
                                  ctx.needs_input_grad, g)


def fused_bilstm(xw: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """[T, D, B, 4H] pre-projected gates -> [T, D, B, H] hidden states (D
    directions; the backward one pre-reversed in time).

    A CUDA tensor launches the kernel (one launch, added to
    ``fused_bilstm.launches``, and to ``fused_bilstm.small_batch_launches``
    where ``small_batch_body`` holds, after one gather that packs w_hh,
    under the span ``kernels.k5``) or raises; a CPU tensor runs
    ``bilstm_reference``.  Differentiable."""
    if xw.device.type == "cpu":
        return bilstm_reference(xw, w_hh)
    if xw.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {xw.device}")
    with span("kernels.k5"):
        return _Recurrence.apply(xw, w_hh)


fused_bilstm.launches = 0
fused_bilstm.small_batch_launches = 0


def resident_bilstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Whole-sequence (bi)LSTM with the input projection inside: x [B, T, Din]
    bf16, w_ih [D, Din, 4H] bf16, w_hh [D, H, 4H] bf16, bias [D, 4H] f32 or
    None -> [T, D, B, H] bf16, both directions aligned to input time.

    A CUDA tensor launches the kernel (``resident_launches()`` launches,
    added to ``resident_bilstm.launches``, under the span ``kernels.k6``)
    or raises; a CPU tensor runs ``resident_bilstm_reference``.
    Differentiable."""
    if x.device.type == "cpu":
        return resident_bilstm_reference(x, w_ih, w_hh, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {x.device}")
    with span("kernels.k6"):
        return _Resident.apply(x, w_ih, w_hh, bias)


resident_bilstm.launches = 0


def resident_launches() -> int:
    """Launches of one ``resident_bilstm`` call on a CUDA tensor, as the
    library reports them (loads the library)."""
    from ._build import load_library

    return load_library().lstm_resident_launches()


def resident_cluster(B: int, D: int, Din: int, H: int) -> int:
    """The thread-block cluster size (1, 2 or 4) ``resident_bilstm`` takes on
    the current CUDA device for this shape (loads the library)."""
    from ._build import load_library

    cl = load_library().lstm_resident_cluster(B, D, Din, H)
    if cl < 1:
        raise RuntimeError("lstm_resident_cluster: CUDA error")
    return cl


def recurrence_cluster(B: int, D: int, H: int) -> int:
    """The thread-block cluster size ``fused_bilstm`` takes on the current
    CUDA device for this shape (loads the library): 1, 2 or 4 in the step
    body shared with K6, 1, 2, 4 or 8 in the few-sequence body
    (``small_batch_body``)."""
    from ._build import load_library

    cl = load_library().lstm_recurrence_cluster(B, D, H, int(small_batch_body(B, D, H)))
    if cl < 1:
        raise RuntimeError("lstm_recurrence_cluster: CUDA error")
    return cl
