"""Parameters and forward FLOPs of one config (counterpart of the root
``evaluated_mac_params.py``; reference evaluated_mac_params.py:17-67).

    python -m audio_only_speech_separation_tpu_torch.evaluated_mac_params --conf-dir configs/tdanet_lrs2.yml
    python -m audio_only_speech_separation_tpu_torch.evaluated_mac_params --conf-dir ... --device cpu

Builds the config's model from the port registry on ``--device`` (the card
unless ``cpu``), counts its parameters (``utils.profiling.count_params``)
and one f32 forward's FLOPs and bytes on ``--seconds`` of zeros
(``utils.profiling.estimate_cost``, which counts the products' FLOPs and
eager PyTorch's bytes, not XLA's: see its module docstring).
"""

from __future__ import annotations

import argparse

import torch

from . import models
from .utils.profiling import count_params, estimate_cost


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--conf-dir", default="configs/tdanet_lrs2.yml")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args(argv)
    import yaml

    with open(args.conf_dir) as f:
        config = yaml.safe_load(f)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluated_mac_params: no CUDA device; pass --device cpu to count on the CPU")
    sr = config["datamodule"]["data_config"]["sample_rate"]
    name = config["audionet"]["audionet_name"]
    model = models.get(name)(sample_rate=sr, **(config["audionet"]["audionet_config"] or {}), device=dev).eval()
    x = torch.zeros((1, int(args.seconds * sr)), device=dev)
    params = count_params(model)
    cost = estimate_cost(model, x)
    print(f"model: {name}")
    print(f"params: {params / 1e6:.3f} M")
    print(f"forward flops ({args.seconds}s audio): {cost['flops'] / 1e9:.3f} G")
    print(f"bytes accessed: {cost['bytes_accessed'] / 1e6:.1f} MB")
    return {"model": name, "params": params, **cost}


if __name__ == "__main__":
    main()
