"""Serving loop (counterpart of the eval forward in the JAX package's
``audio_test.py``): pick the forward for a model and device, then separate a
list of utterances in length-sorted, bucket-padded batches.

    from audio_only_speech_separation_tpu_torch.models import from_pretrain
    from audio_only_speech_separation_tpu_torch.serve import serve
    model = from_pretrain("best_model.pth", device="cuda")
    estimates = serve(model, wavs, use_bf16=True, device="cuda")
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .models import ConvTasNet
from .models.convtasnet import fused_forward_eligible, fused_inference_forward
from .ops.kernels.convtasnet_block import pack_convtasnet_full_params


def choose_dispatch(model, use_bf16: bool, device) -> str:
    """The forward for ``model`` on ``device``:

    - "fused": bf16 ConvTasNet through the whole-separator CUDA kernel
      (``fused_forward_eligible``: a CUDA device and the kernel's envelope);
    - "eager": the module itself, in its own dtype.
    """
    if use_bf16 and isinstance(model, ConvTasNet) and fused_forward_eligible(model, device):
        return "fused"
    return "eager"


def serve(model, wavs: Sequence[np.ndarray], use_bf16: bool, device,
          bucket_seconds: float = 1.0, batch_size: int = 1) -> List[np.ndarray]:
    """Separate 1-D utterances; returns one [n_src, T_i] float32 array each,
    in input order.

    Utterances are sorted by length, batched, right-padded with zeros to the
    next multiple of ``bucket_seconds``, run as one forward per batch, and
    cropped back to their own length."""
    device = torch.device(device)
    bucket = max(1, int(bucket_seconds * model.sample_rate))
    dispatch = choose_dispatch(model, use_bf16, device)
    packed = None
    if dispatch == "fused":
        packed = pack_convtasnet_full_params(
            model.state_dict(), model.R, model.X, model.num_spks, device=device
        )

    def forward(mix: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if dispatch == "fused":
                return fused_inference_forward(model, mix.to(torch.bfloat16), packed=packed)
            return model(mix)

    order = sorted(range(len(wavs)), key=lambda i: wavs[i].shape[-1])
    results: List[np.ndarray] = [None] * len(wavs)
    for start in range(0, len(order), batch_size):
        idxs = order[start : start + batch_size]
        T_max = max(wavs[i].shape[-1] for i in idxs)
        T_pad = -(-T_max // bucket) * bucket
        mix_in = np.zeros((len(idxs), T_pad), np.float32)
        for j, i in enumerate(idxs):
            mix_in[j, : wavs[i].shape[-1]] = wavs[i]
        est = forward(torch.from_numpy(mix_in).to(device)).float().cpu().numpy()
        for j, i in enumerate(idxs):
            results[i] = est[j, :, : wavs[i].shape[-1]]
    return results
