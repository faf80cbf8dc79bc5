"""Two-step train CLI of the port (counterpart of the JAX package's
``audio_train_twostep.py``; reference audio_train_twostep.py).

Step 1 trains on ``LRS2TwoStepDataModule``, which yields (target, target),
so the model learns to reproduce its input; step 2 warm-starts the
separation module from step 1's best_model.pth by copying only the
parameters of the top-level modules named with the prefix "sm" (TDANet's
``sm``; reference audio_train_twostep.py:38-49), then trains as
``audio_train`` does.  The copy is fed through ``audio_train.WARM_START``
and made by ``Trainer.fit`` before the first step of a run that does not
resume.

    python -m audio_only_speech_separation_tpu_torch.audio_train_twostep --conf-dir=configs/tdanet_lrs2.yml \\
        [--pretrained Experiments/checkpoint/<exp>/best_model.pth]

Trains on the CUDA card, or on several under torchrun as ``audio_train``
does; ``main`` takes the parsed config as a dict and
``device="cpu"`` for the CPU.  YAML is read only when this runs as a
program.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from . import audio_train
from .models import from_pretrain
from .parallel import init_distributed
from .utils.console import print_only


def update_parameter(model: torch.nn.Module, pretrained_state: dict, prefix: str = "sm") -> int:
    """Copy the parameters and buffers of every top-level module of
    ``model`` whose name starts with ``prefix`` from ``pretrained_state``
    (a state dict), where the pretrained model has that module; returns how
    many top-level modules it copied."""
    own = model.state_dict()
    tops = sorted({k.split(".")[0] for k in own if k.split(".")[0].startswith(prefix)})
    copied = 0
    with torch.no_grad():
        for top in tops:
            keys = [k for k in own if k.split(".")[0] == top]
            if not any(k in pretrained_state for k in keys):
                continue
            for k in keys:
                own[k].copy_(torch.as_tensor(pretrained_state[k]))
            copied += 1
    print_only(f"warm-started {copied} top-level modules with prefix {prefix!r}")
    return copied


def main(config: dict, pretrained: Optional[str] = None, device="cuda") -> str:
    """Train from a config dict on ``device``, warm-started from the
    best_model.pth at ``pretrained`` when it is given; returns the
    experiment directory."""
    if pretrained:
        # the checkpoint must load before the (long) training run
        state = from_pretrain(pretrained, device="cpu").state_dict()
        print_only(f"Loaded warm-start weights from {pretrained}")
        audio_train.WARM_START = (state, update_parameter)
    try:
        return audio_train.main(config, device=device)
    finally:
        audio_train.WARM_START = None


if __name__ == "__main__":
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir", default="configs/tdanet_lrs2.yml")
    parser.add_argument("--pretrained", default=None,
                        help="best_model.pth to warm-start the separation module from")
    args, rest = parser.parse_known_args(sys.argv[1:])
    init_distributed()
    main(audio_train.config_from_cli([f"--conf-dir={args.conf_dir}", *rest]), pretrained=args.pretrained)
