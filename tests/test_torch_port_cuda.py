"""The whole-separator CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import (
    fused_inference_forward,
    inference_frames,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    convtasnet_separator_reference,
    fused_convtasnet_separator,
    pack_convtasnet_full_params,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(cuda, **kw):
    cfg = dict(N=256, H=256, B=128, L=16, X=3, R=1, num_spks=2, sample_rate=8000)
    cfg.update(kw)
    m = ConvTasNet(**cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():  # random norm affines and slopes, some above 1
        for name, p in m.named_parameters():
            if name.endswith("prelu1.weight") or name.endswith("prelu2.weight"):
                p.fill_(float(rng.uniform(0.05, 1.5)))
            elif "norm" in name or "bottleneck.0" in name:
                p.add_(torch.from_numpy(0.2 * rng.standard_normal(p.shape).astype(np.float32)).to(cuda))
    return m


@pytest.mark.parametrize("act,T", [("relu", 4000), ("sigmoid", 63), ("relu", 1), ("sigmoid", 5001)])
def test_kernel_matches_plain_version(cuda, act, T):
    """Same frames and weights: the kernel against its plain version to
    bf16 output rounding (atol 2e-2 of the frames' scale), bit-identical
    from run to run (no atomics), and 2 + 2*nb launches counted."""
    m = _model(cuda, activate=act)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, max(T, 32))).astype(np.float32)).to(cuda)
    frames = inference_frames(m, x)[:, :T].contiguous()
    *w, dils = pack_convtasnet_full_params(m.state_dict(), m.R, m.X, m.num_spks, device=cuda)
    kw = dict(dilations=dils, nspk=m.num_spks, sigmoid=act == "sigmoid")
    before = fused_convtasnet_separator.launches
    got = fused_convtasnet_separator(frames, *w, **kw)
    again = fused_convtasnet_separator(frames, *w, **kw)
    want = convtasnet_separator_reference(frames, *w, **kw)
    torch.cuda.synchronize()
    assert fused_convtasnet_separator.launches - before == 2 * (2 + 2 * len(dils))
    assert torch.equal(got, again)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * max(scale, 1.0)


def test_served_path_meets_the_validator_rule(cuda):
    """End to end against the f32 module: kernel error <= 1.5 * (plain bf16
    error) + 1e-3 (scripts/validate_pallas.py:148)."""
    m = _model(cuda, num_spks=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 7777)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        ref = m(x)
        got = fused_inference_forward(m, x)
        plain = fused_inference_forward(m, x, separator=convtasnet_separator_reference)
    err = float((got.float() - ref).abs().max())
    plain_err = float((plain.float() - ref).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)
