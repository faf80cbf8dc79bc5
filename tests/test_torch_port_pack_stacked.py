"""The fused ConvTasNet train form's weight packing in one stacked pass
(``ops/kernels/convtasnet_block.py::pack_convtasnet_full_params_differentiable``)
against the per-leaf form it replaced, kept here as the reference: each
parameter cast to bf16 on its own (``train.bf16_forward``'s generic casts),
then cast back and folded block by block.

- The nine packed tensors and every leaf's f32 gradient are bit-equal to
  the reference's, with its strides and on 16-byte boundaries, at the LRS3
  widths and at two small sizes (an even and an odd number of blocks), for
  f32 leaves through the fused path (``bf16_forward(fused=True)``) and for
  bf16 casts through the delayed form; the whole fused train forward too.
- The fused form's cast and packing issue a few dozen non-view aten ops
  forward and backward at the LRS3 widths, where the reference issues
  ≈ 800 and ≈ 1,100.

On the card (marker ``cuda``) the packing's comparison runs on CUDA
tensors, bit-equal but for ``cs``'s batched products and the gradients
through them, and the whole fused forward through K2 and K3 repeats its
bits.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_pack_stacked.py
"""

import contextlib
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models import convtasnet
from audio_only_speech_separation_tpu_torch.train import bf16_forward
from audio_only_speech_separation_tpu_torch.train import trainer

BF, F32 = torch.bfloat16, torch.float32
LRS3 = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, num_spks=3)
SMALL = dict(N=128, L=16, B=128, H=128, P=3, X=3, R=2, num_spks=2)
# an odd number of blocks leaves the flat tensor's later parts off a 16-byte boundary
ODD = dict(SMALL, R=1)
SHAPES = {"lrs3": LRS3, "small": SMALL, "odd": ODD}
FORMS = {
    "fused": lambda m: bf16_forward(m, fused=True),
    "delayed": lambda m: bf16_forward(m, apply_fn=convtasnet.make_delayed_train_apply(m)),
}


def _reference_pack(params, R, X, num_spks):
    """The per-leaf packer the stacked one replaced: each leaf cast to f32
    and folded block by block."""

    def p(name):
        return params[name].to(F32)

    w1s, wsgs, vecs, cs, alphas, dils = [], [], [], [], [], []
    for r in range(R):
        for i in range(X):
            pre = f"separation.sep.{r}.tcn.{i}"
            w1s.append(p(f"{pre}.conv1x1.weight")[:, :, 0].t())
            ws = p(f"{pre}.sconv.weight")[:, :, 0].t()
            g2, b2 = p(f"{pre}.norm2.weight"), p(f"{pre}.norm2.bias")
            wsgs.append(ws * g2[:, None])
            cs.append(torch.stack([b2 @ ws + p(f"{pre}.sconv.bias"), g2 @ ws]))
            dw = p(f"{pre}.dwconv.weight")
            vecs.append(torch.stack([
                p(f"{pre}.conv1x1.bias"), p(f"{pre}.dwconv.bias"),
                p(f"{pre}.norm1.weight"), p(f"{pre}.norm1.bias"),
                dw[:, 0, 0], dw[:, 0, 1], dw[:, 0, 2], torch.zeros_like(dw[:, 0, 0]),
            ]))
            alphas.append(torch.cat([p(f"{pre}.prelu1.weight"), p(f"{pre}.prelu2.weight")]))
            dils.append(2**i)

    g, bt = p("bottleneck.0.weight"), p("bottleneck.0.bias")
    wbn = p("bottleneck.1.weight")[:, :, 0].t()
    C, H = w1s[0].shape
    zeros = functools.partial(torch.zeros, dtype=F32, device=wbn.device)
    w1s = torch.cat([zeros((1, C, H)), torch.stack(w1s)]).to(BF)
    wsgs = torch.cat([(wbn * g[:, None])[None], torch.stack(wsgs)]).to(BF)
    vecs = torch.cat([zeros((1, 8, H)), torch.stack(vecs)])
    cs = torch.cat([torch.stack([bt @ wbn + p("bottleneck.1.bias"), g @ wbn])[None], torch.stack(cs)])
    alphas = torch.cat([zeros((1, 2)), torch.stack(alphas)])
    we = p("encoder._filters")[:, 0, :].t().to(BF)
    wm = p("mask.weight")[:, :, 0].t().to(BF)
    bm = p("mask.bias")[None, :]
    wd = p("decoder._filters")[:, 0, :].to(BF)
    return we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, tuple(dils)


def _reference_cast_and_pack(params, R, X, num_spks):
    """``bf16_forward``'s generic casts, one a leaf, then the reference pack."""
    return _reference_pack({k: v.to(BF) for k, v in params.items()}, R, X, num_spks)


def _model(cfg, device="cpu", seed=0):
    """A ConvTasNet with every parameter drawn from a seeded normal (no unit
    norm gains, no zero biases, no 0.25 slopes)."""
    model = ConvTasNet(**cfg, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + 0.05)
    return model


def _wave(model, samples=160):
    return torch.randn(1, samples, generator=torch.Generator().manual_seed(1)).to(next(model.parameters()).device)


def _cotangents(tensors, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(t.shape, generator=gen).to(t.device, t.dtype) for t in tensors]


def _captured_pack(monkeypatch, forward, wav):
    """Runs ``forward(wav)`` and returns the nine tensors its packing made."""
    got = []
    real = convtasnet.pack_convtasnet_full_params_differentiable

    def pack(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]

    monkeypatch.setattr(convtasnet, "pack_convtasnet_full_params_differentiable", pack)
    forward(wav)
    (packed,) = got
    return packed


def _leaf_grads(model, outputs, cotangents):
    model.zero_grad(set_to_none=True)
    torch.autograd.backward(list(outputs), cotangents)
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pack_bit_equal_to_the_per_leaf_pack(monkeypatch, shape, form):
    """The nine packed tensors, and every leaf's f32 gradient from seeded
    cotangents through them, bit for bit: f32 leaves through the fused path
    (one rounding of the flat tensor) and bf16 casts through the delayed
    form (one cast of it to f32), each against the per-leaf casts and
    folds."""
    model = _model(SHAPES[shape])
    packed = _captured_pack(monkeypatch, FORMS[form](model), _wave(model))
    ref = _reference_cast_and_pack(dict(model.named_parameters()), model.R, model.X, model.num_spks)
    assert packed[9] == ref[9]
    for got, want in zip(packed[:9], ref[:9]):
        assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
        assert got.data_ptr() % 16 == 0  # K1 reads bm, and the kernels their weights, in 16-byte loads
        assert torch.equal(got, want)
    cots = _cotangents(ref[:9])
    grads = _leaf_grads(model, packed[:9], cots)
    want = _leaf_grads(model, ref[:9], cots)
    assert len(grads) == 12 * model.R * model.X + 8
    for name, g in grads.items():
        assert g.dtype == F32 and torch.equal(g, want[name]), name


def _fused_forward_and_grads(model, forward, wav):
    model.zero_grad(set_to_none=True)
    est = forward(wav)
    (est.float() * _cotangents([est])[0]).sum().backward()
    return est.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_train_forward_bit_equal_to_the_per_leaf_casts(monkeypatch, shape):
    """The whole fused train forward (the TCN chain's plain versions here):
    its estimate and every leaf's gradient, bit for bit, against the same
    forward on per-leaf casts and the per-leaf pack."""
    model = _model(SHAPES[shape])
    wav = _wave(model)
    est, grads = _fused_forward_and_grads(model, bf16_forward(model, fused=True), wav)
    monkeypatch.setattr(convtasnet, "pack_convtasnet_full_params_differentiable",
                        lambda params, R, X, nspk: _reference_pack(params, R, X, nspk))
    reference = bf16_forward(model, apply_fn=convtasnet.make_kernel_train_apply(model))
    want_est, want = _fused_forward_and_grads(model, reference, wav)
    assert torch.equal(est, want_est)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


class _NonViewOps(TorchDispatchMode):
    """Counts the aten ops that return new tensors (not views: view, slice,
    select, transpose, unsqueeze, squeeze, detach, split, unbind, ...) while
    ``active``."""

    def __init__(self):
        super().__init__()
        self.active, self.count = False, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active and not any(r.alias_info is not None for r in func._schema.returns):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _count_cast_and_pack(monkeypatch, forward, wav):
    """(forward ops inside the ``train.cast`` and ``train.pack`` spans, ops of
    the backward from the packed tensors to the leaves) of one fused train
    forward."""
    counter = _NonViewOps()

    @contextlib.contextmanager
    def span(name):
        before = counter.active
        counter.active = before or name in ("train.cast", "train.pack")
        try:
            yield
        finally:
            counter.active = before

    monkeypatch.setattr(trainer, "span", span)
    monkeypatch.setattr(convtasnet, "span", span)
    with counter:
        packed = _captured_pack(monkeypatch, forward, wav)
    fwd, counter.count = counter.count, 0
    with counter:
        counter.active = True
        torch.autograd.backward(list(packed[:9]), _cotangents(packed[:9]))
    return fwd, counter.count


def test_cast_and_pack_op_count(monkeypatch):
    """At the LRS3 widths the fused form's cast and packing issue at most 64
    non-view ops forward and 160 backward (the per-leaf form: ≈ 800 and
    ≈ 1,100, which the same counter sees on the reference)."""
    model = _model(LRS3)
    fwd, bwd = _count_cast_and_pack(monkeypatch, bf16_forward(model, fused=True), _wave(model))
    assert fwd <= 64 and bwd <= 160, (fwd, bwd)

    with monkeypatch.context() as mp:
        mp.setattr(convtasnet, "pack_convtasnet_full_params_differentiable",
                   lambda params, R, X, nspk: _reference_pack(params, R, X, nspk))
        reference = bf16_forward(model, apply_fn=convtasnet.make_kernel_train_apply(model))
        ref_fwd, ref_bwd = _count_cast_and_pack(mp, reference, _wave(model))
    assert ref_fwd > 700 and ref_bwd > 1000, (ref_fwd, ref_bwd)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the packing on CUDA tensors")
    return torch.device("cuda", 0)


# the leaves whose gradients pass through the products that fold ``cs``
_CS_FOLD_LEAVES = ("norm2.weight", "norm2.bias", "bottleneck.0.weight", "bottleneck.0.bias")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_pack_on_the_card(card, monkeypatch, form):
    """The packing on CUDA tensors at the LRS3 widths against the per-leaf
    form: bit-equal, but for ``cs``, whose two products run as one batched
    product over the blocks where the per-leaf form ran one a block (cuBLAS
    takes another kernel, so the f32 sums round in another order: within 16
    f32 epsilons of the largest element), and for the gradients that come
    back through those products (within one bf16 step of each element, to
    which the cast's backward rounds them)."""
    model = _model(LRS3, card)
    packed = _captured_pack(monkeypatch, FORMS[form](model), _wave(model, 32000))
    ref = _reference_cast_and_pack(dict(model.named_parameters()), model.R, model.X, model.num_spks)
    assert packed[9] == ref[9]
    for i, (got, want) in enumerate(zip(packed[:9], ref[:9])):
        assert got.dtype == want.dtype and got.shape == want.shape and got.stride() == want.stride()
        if i == 4:  # cs
            assert (got - want).abs().max() <= 16 * torch.finfo(F32).eps * want.abs().max()
        else:
            assert torch.equal(got, want), i
    cots = _cotangents(ref[:9])
    grads = _leaf_grads(model, packed[:9], cots)
    want = _leaf_grads(model, ref[:9], cots)
    for name, g in grads.items():
        if name.endswith(_CS_FOLD_LEAVES):
            assert ((g - want[name]).abs() <= 2**-7 * want[name].abs()).all(), name
        else:
            assert torch.equal(g, want[name]), name


@pytest.mark.cuda
def test_fused_train_forward_on_the_card(card):
    """The whole fused train forward through K2 and K3 at the LRS3 widths and
    a 2 s wave: the same bits on a second run, and an estimate within one
    bf16 step (relative l2) of the per-leaf casts and pack's, which differ
    from it only in ``cs``'s rounding (``test_pack_on_the_card``)."""
    model = _model(LRS3, card)
    wav = _wave(model, 32000)
    forward = bf16_forward(model, fused=True)
    est, grads = _fused_forward_and_grads(model, forward, wav)
    again, grads_again = _fused_forward_and_grads(model, forward, wav)
    assert torch.equal(est, again) and all(torch.equal(g, grads_again[n]) for n, g in grads.items())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convtasnet, "pack_convtasnet_full_params_differentiable",
                   lambda params, R, X, nspk: _reference_pack(params, R, X, nspk))
        reference = bf16_forward(model, apply_fn=convtasnet.make_kernel_train_apply(model))
        want, _ = _fused_forward_and_grads(model, reference, wav)
    assert torch.linalg.vector_norm(est - want) <= 2**-7 * torch.linalg.vector_norm(want)
