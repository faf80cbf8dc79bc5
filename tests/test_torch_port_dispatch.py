"""The serving dispatch of every model the port serves: with bf16 on the
card each model is served in bf16 (the whole-separator kernel for a
ConvTasNet inside its envelope, the analytic fast path for a weight-shared
TDANet, else the module cast to bf16, "kernels"); without bf16, or on the
CPU, the module in its own dtype, save the TDANet fast path, which serves
on any device as in the JAX package's CLI."""

import pytest

from audio_only_speech_separation_tpu_torch.models import (
    AFRCNN,
    BSRNN,
    TDANet,
    ConvTasNet,
    Sepformer,
    TasNet,
)
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch

CONVTASNET = dict(L=16, B=128, P=3, X=1, R=1, num_spks=2, sample_rate=8000)
FILTERBANK = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3, sample_rate=8000)


def _models():
    """(label, model, its dispatch with bf16 on the card)."""
    return [
        ("convtasnet_in_envelope", ConvTasNet(N=128, H=128, **CONVTASNET), "fused"),
        ("convtasnet_cLN", ConvTasNet(N=128, H=128, norm="cLN", causal=False, **CONVTASNET), "kernels"),
        ("convtasnet_768", ConvTasNet(N=768, H=768, **CONVTASNET), "kernels"),
        ("dprnn", TasNet(enc_dim=16, bn_dim=16, hidden_dim=16, layer=1, module="DPRNN"), "kernels"),
        ("sepformer", Sepformer(encoder_out_nchannels=16, masknet_chunksize=10, masknet_numlayers=1,
                                intra_numlayers=1, inter_numlayers=1, intra_nhead=2, inter_nhead=2,
                                intra_dffn=16, inter_dffn=16), "kernels"),
        ("bsrnn", BSRNN(feature_dim=16, num_repeat=1, sample_rate=8000), "kernels"),
        ("afrcnn", AFRCNN(enc_kernel_size=1, **FILTERBANK), "kernels"),
        ("tdanet", TDANet(enc_kernel_size=4, **FILTERBANK), "fast_tdanet"),
        ("tdanet_per_block_weights", TDANet(enc_kernel_size=4, unfold=False, **FILTERBANK), "kernels"),
    ]


@pytest.mark.parametrize("index", range(9), ids=[m[0] for m in _models()])
def test_bf16_on_the_card_serves_every_model_in_bf16(index):
    _, model, want = _models()[index]
    assert choose_dispatch(model, True, "cuda") == want


@pytest.mark.parametrize("use_bf16,device", [(False, "cuda"), (True, "cpu"), (False, "cpu")])
def test_no_bf16_or_the_cpu_serves_the_module_itself(use_bf16, device):
    for label, model, _ in _models():
        want = "fast_tdanet" if label == "tdanet" else "eager"
        assert choose_dispatch(model, use_bf16, device) == want, label
