"""Serving loop (counterpart of the eval forward in the JAX package's
``audio_test.py``): pick the forward for a model and device, then separate
utterances in length-sorted, bucket-padded batches.

    from audio_only_speech_separation_tpu_torch.models import from_pretrain
    from audio_only_speech_separation_tpu_torch.serve import serve
    model = from_pretrain("best_model.pth", device="cuda")
    estimates = serve(model, wavs, use_bf16=True, device="cuda")

Every forward runs the module in eval mode, as the JAX package's ``apply``
defaults to ``train=False``; the caller's module keeps its own mode.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch

from .models import ConvTasNet
from .models.base import eval_mode
from .models.convtasnet import fused_forward_eligible, fused_inference_forward
from .models.tdanet import fast_forward_eligible, fast_inference_forward
from .ops.kernels.convtasnet_block import pack_convtasnet_full_params


def choose_dispatch(model, use_bf16: bool, device) -> str:
    """The forward for ``model`` on ``device``:

    - "fused": bf16 ConvTasNet through the whole-separator CUDA kernel
      (``fused_forward_eligible``: a CUDA device and the kernel's envelope);
    - "fast_tdanet": a TDANet that ``fast_forward_eligible`` admits, on any
      device, through the analytic-moment eval forward: the module cast to
      bf16 with bf16 on a CUDA device, else in its own dtype;
    - "kernels": with bf16 on a CUDA device, every other model: the module
      cast to bf16, whose attention and LSTM layers call the dual-path
      kernels (K4, K5, K6) from inside ``ops/`` where it has them (a
      ConvTasNet outside K1's envelope has none);
    - "eager": the module itself, in its own dtype (without bf16, or off
      the card, where the JAX package's CLI also keeps float32).
    """
    if use_bf16 and isinstance(model, ConvTasNet) and fused_forward_eligible(model, device):
        return "fused"
    if fast_forward_eligible(model):
        return "fast_tdanet"
    if use_bf16 and torch.device(device).type == "cuda":
        return "kernels"
    return "eager"


DISPATCHES = ("fused", "fast_tdanet", "kernels", "eager")


class Server:
    """The forward of ``serve`` for one model, set up once: the dispatch,
    the packed weights ("fused") or the bf16 copy of the module
    ("kernels", or "fast_tdanet" with bf16 on the card), and the bucket.
    Each call separates one batch.  ``dispatch`` names the forward in place
    of ``choose_dispatch``'s choice (a measurement of one path: the bf16
    module of a ConvTasNet or a TDANet that would take "fused" or
    "fast_tdanet")."""

    def __init__(self, model, use_bf16: bool, device, bucket_seconds: float = 1.0, dispatch=None):
        self.device = torch.device(device)
        self.bucket = max(1, int(bucket_seconds * model.sample_rate))
        if dispatch not in (None,) + DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}; known: {DISPATCHES}")
        self.dispatch = dispatch or choose_dispatch(model, use_bf16, self.device)
        self.model, self.packed = model, None
        bf16 = self.dispatch in ("fused", "kernels") or (
            self.dispatch == "fast_tdanet" and use_bf16 and self.device.type == "cuda")
        self.dtype = torch.bfloat16 if bf16 else None  # None: the model's own
        if self.dispatch == "fused":
            self.packed = pack_convtasnet_full_params(
                model.state_dict(), model.R, model.X, model.num_spks, device=self.device
            )
        elif bf16:
            self.model = copy.deepcopy(model).to(device=self.device, dtype=torch.bfloat16)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), eval_mode(self.model):
            if self.dtype is not None:
                mix = mix.to(self.dtype)
            if self.dispatch == "fused":
                return fused_inference_forward(self.model, mix, packed=self.packed)
            if self.dispatch == "fast_tdanet":
                return fast_inference_forward(self.model, mix)
            return self.model(mix)

    def __call__(self, wavs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """One batch of 1-D utterances, right-padded with zeros to the next
        multiple of the bucket, one forward, each estimate cropped back to
        its utterance's length: [n_src, T_i] float32 arrays, in order."""
        T_max = max(w.shape[-1] for w in wavs)
        T_pad = -(-T_max // self.bucket) * self.bucket
        mix_in = np.zeros((len(wavs), T_pad), np.float32)
        for j, w in enumerate(wavs):
            mix_in[j, : w.shape[-1]] = w
        est = self.forward(torch.from_numpy(mix_in).to(self.device)).float().cpu().numpy()
        return [est[j, :, : w.shape[-1]] for j, w in enumerate(wavs)]


def serve(model, wavs: Sequence[np.ndarray], use_bf16: bool, device,
          bucket_seconds: float = 1.0, batch_size: int = 1) -> List[np.ndarray]:
    """Separate 1-D utterances; returns one [n_src, T_i] float32 array each,
    in input order.

    Utterances are sorted by length (stable), batched, right-padded with
    zeros to the next multiple of ``bucket_seconds``, run as one forward per
    batch, and cropped back to their own length."""
    server = Server(model, use_bf16, device, bucket_seconds)
    order = sorted(range(len(wavs)), key=lambda i: wavs[i].shape[-1])
    results: List[np.ndarray] = [None] * len(wavs)
    for start in range(0, len(order), batch_size):
        idxs = order[start : start + batch_size]
        for i, est in zip(idxs, server([wavs[i] for i in idxs])):
            results[i] = est
    return results
