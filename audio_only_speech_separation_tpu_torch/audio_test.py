"""Eval CLI of the port (counterpart of the JAX package's ``audio_test.py``;
reference audio_test.py:30-101).

    python -m audio_only_speech_separation_tpu_torch.audio_test --conf-dir=<exp>/conf.yml --bf16

Reloads ``best_model.pth`` through the registry onto one device (the CUDA
card unless ``main`` is given ``device="cpu"``), separates the raw test set
through ``serve.Server`` (so ``serve.choose_dispatch`` picks the forward:
"fused" for a ConvTasNet inside K1's envelope, "kernels" for a TasNet or
Sepformer, with ``--bf16`` on the card; the module in its own dtype
otherwise, so on the CPU ``--bf16`` runs float32) and streams SI-SNR(i) /
SDR(i), and with ``--pesq`` the ``pesq_est`` column, to
``<exp_dir>/results/metrics.csv``.

The batches are the JAX CLI's: utterances ordered by their manifest length
(stable), ``--batch-size`` at a time, right-padded to the next multiple of
``--bucket-seconds``; each estimate is cropped back to its utterance before
scoring.  Bucket padding enters every gLN's global statistics, so other
batches would give other estimates.  The test set is always built with
``segment=None``.  YAML is read only when this runs as a program; ``main``
takes the parsed config as a dict.
"""

from __future__ import annotations

import argparse
import os

import torch

from . import data as datas
from . import models
from .metrics import MetricsTracker
from .serve import Server


def main(config: dict, bucket_seconds: float = 1.0, batch_size: int = 1, device="cuda") -> str:
    """Score ``config``'s experiment on its test set; returns the CSV's
    path.  Raises when ``device`` is CUDA and there is no card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("audio_test: no CUDA device; pass device=\"cpu\" to evaluate on the CPU")
    models.get(config["audionet"]["audionet_name"])  # an unported model fails here, before any data
    exp_dir = config["main_args"]["exp_dir"]
    model_path = os.path.join(exp_dir, "best_model.pth")
    print(f"Loading model from {model_path}")
    sr = config["datamodule"]["data_config"]["sample_rate"]
    model = models.from_pretrain(model_path, device, sample_rate=sr,
                                 **(config["audionet"]["audionet_config"] or {}))

    data_config = dict(config["datamodule"]["data_config"])
    data_config["segment"] = None  # full-utterance eval, explicitly
    datamodule = datas.get(config["datamodule"]["data_name"])(**data_config)
    datamodule.setup()
    _, _, test_set = datamodule.make_sets

    results_dir = os.path.join(exp_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    csv_path = os.path.join(results_dir, "metrics.csv")
    metrics = MetricsTracker(save_file=csv_path,
                             compute_pesq=bool(config["main_args"].get("pesq")) and sr in (8000, 16000),
                             sample_rate=sr)
    server = Server(model, bool(config["main_args"].get("bf16")), device, bucket_seconds)
    print(f"Dispatch: {server.dispatch}")

    order = sorted(range(len(test_set)), key=lambda i: test_set.mix[i][1])
    done = 0
    for start in range(0, len(order), batch_size):
        items = [test_set[i] for i in order[start : start + batch_size]]
        for (mix, sources, key), est in zip(items, server([mix for mix, _, _ in items])):
            metrics(mix, sources, est, key)
            done += 1
            if done % 50 == 0:
                print(f"[{done}/{len(test_set)}] {metrics.update()}")
    metrics.final()
    print(f"Results written to {csv_path}")
    return csv_path


if __name__ == "__main__":
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir", type=str, required=True, help="Path to the experiment conf.yml")
    parser.add_argument("--bucket-seconds", type=float, default=1.0)
    parser.add_argument(
        "--pesq", action="store_true",
        help="add a pesq_est column (P.862-STRUCTURE estimator, 8/16 kHz only; NOT "
        "ITU-conformant: do not compare against published PESQ numbers)",
    )
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument(
        "--bf16", action="store_true",
        help="bf16 inference on the card through the kernels (K1 for ConvTasNet, K4-K6 for "
        "TasNet and Sepformer); the CPU runs float32",
    )
    args = parser.parse_args()
    with open(args.conf_dir) as f:
        config = yaml.safe_load(f)
    config.setdefault("main_args", {})
    config["main_args"].setdefault("exp_dir", os.path.dirname(args.conf_dir))
    config["main_args"]["pesq"] = args.pesq
    config["main_args"]["bf16"] = args.bf16
    main(config, bucket_seconds=args.bucket_seconds, batch_size=args.batch_size)
