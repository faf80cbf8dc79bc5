"""The training-quality studies of the port (counterpart of the JAX
package's ``scripts/validate_pallas.py::kernel_train_quality`` and
``::bf16_quality_study``).

A full-width ConvTasNet (N 512, L 16, B 128, H 512, P 3, X 8, R 3, gLN,
relu, 2 speakers, 8 kHz) is trained from one seeded initialisation on the
script's synthetic task: 4 mixtures of 16000 samples, each two sources, a
sine chirped at 2 Hz (220, 330, 440 or 550 Hz) and Gaussian noise at 0.3
(numpy's generator seeded 3).  Adam at 1e-3 for ``steps`` steps on PIT over
``pairwise_neg_snr``, in three arms:

- ``f32``: the f32 module;
- ``bf16_plain``: the Trainer's bf16 cast policy (``train.bf16_forward``),
  the module on bf16 casts of its f32 parameters;
- ``bf16_kernel``: the same casts through the TCN chain's kernels (K2
  forward, K3 backward; ``make_kernel_train_apply``).

One more arm can be asked for, ``bf16_plain_chain``: the kernel arm's
function with the chain's plain version under autograd
(``tcn_chain_reference``), which tells the kernels' numerics from the
fused path's dtype policy.

Each arm's model is scored by the PIT SI-SDR improvement of its f32
forward over the mixtures (the script's ``_si_sdr``): after the last step
(the script's reading), and averaged over the models of the last ``tail``
steps (50).  The bf16 arms are trained from each of ``seeds`` initial
weights (six by default), the f32 arm from the first.  The gates are the
script's thresholds: |bf16_plain - bf16_kernel| < 0.3 dB (its :535) on the
mean over the seeds of each seed's difference of tail averages, and the f32
arm's final model served in bf16 through the whole-separator kernel (K1,
``fused_inference_forward``) within 0.1 dB of its own f32 forward (its
:384; the script trains a separate f32 model for that on other noise, here
the f32 arm's model serves).

The script gates one reading of one run.  That reading is a lottery: Adam
at 1e-3 leaves the loss oscillating, and a change at the level of f32
rounding moves it by up to 2.4 dB on the card, a run's tail average by
0.1-0.25 dB (``scripts/profile_port_train_quality.py``, PERF.md section
6).  So the gate reads the mean over seeds, whose standard error
(``train_gate_se_db``) is printed beside it.  The script's own reading at
the first seed is reported too (``script_reading_delta_db``); no gate reads
it.

    python -m audio_only_speech_separation_tpu_torch.validate [--steps 300]

runs on the CUDA card (raises without one) and prints one JSON object; the
exit code is 1 when a gate fails.  On a CPU (``device="cpu"``) the kernels
run as their plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .losses import PITLossWrapper, pairwise_neg_snr
from .models import ConvTasNet
from .models.convtasnet import fused_inference_forward
from .ops.kernels.convtasnet_block import tcn_chain_reference
from .train import bf16_forward

CONVTASNET = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=2, activate="relu",
                  causal=False, sample_rate=8000)
ARMS = ("f32", "bf16_plain", "bf16_kernel")
CONTROL_ARM = "bf16_plain_chain"
TRAIN_GATE_DB = 0.3  # |bf16_plain - bf16_kernel|
TAIL = 50  # the steps whose models' scores a run's tail average takes
SEEDS = (0, 1, 2, 3, 4, 5)  # the initial weights of the bf16 arms' runs
SERVE_GATE_DB = 0.1  # |bf16 through K1 - f32|, the f32 arm's model


def study_data(samples: int = 16000, sr: int = 8000, seed: int = 3):
    """The script's task: (mix [4, samples], sources [4, 2, samples]) f32."""
    t = np.arange(samples) / sr
    rng = np.random.default_rng(seed)
    srcs = np.stack([
        np.stack([np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(2 * np.pi * 2 * t))),
                  rng.normal(size=samples) * 0.3], 0)
        for f0 in (220.0, 330.0, 440.0, 550.0)]).astype(np.float32)
    return srcs.sum(1), srcs


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB of one estimate (the script's ``_si_sdr``)."""
    ref = ref - ref.mean()
    est = est - est.mean()
    a = np.dot(est, ref) / np.dot(ref, ref)
    target = a * ref
    noise = est - target
    return float(10 * np.log10(np.dot(target, target) / np.dot(noise, noise)))


def pit_si_sdri(est: np.ndarray, srcs: np.ndarray, mix: np.ndarray) -> float:
    """Mean over the batch of the best permutation's mean SI-SDR less the
    mixture's, for two sources (the script's ``pit_si_sdri``)."""
    vals = []
    for b in range(est.shape[0]):
        best = max(np.mean([si_sdr(est[b, i], srcs[b, j]) for i, j in enumerate(pm)])
                   for pm in [(0, 1), (1, 0)])
        base = np.mean([si_sdr(mix[b], srcs[b, j]) for j in range(2)])
        vals.append(best - base)
    return float(np.mean(vals))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh_model(cfg: dict, device, seed: int = 0) -> ConvTasNet:
    """A ``cfg`` ConvTasNet in training mode, its initial weights from ``seed``."""
    return ConvTasNet(**cfg, device=device, generator=torch.Generator().manual_seed(seed)).train()


def arm_forward(arm: str, model: ConvTasNet):
    """est = forward(mix) in f32 as ``arm`` trains ``model``."""
    if arm == "f32":
        return model
    if arm == CONTROL_ARM:
        return bf16_forward(model, fused=True, chain=tcn_chain_reference)
    return bf16_forward(model, fused=arm == "bf16_kernel")


def train_arm(arm: str, cfg: dict, mix: torch.Tensor, srcs: torch.Tensor, steps: int, seed: int, tail: int):
    """Train a fresh ``cfg`` ConvTasNet (initial weights from ``seed``) for
    ``steps`` Adam steps in ``arm``; returns (model, final loss, seconds,
    the last ``tail`` steps' scores) (``train``)."""
    model = fresh_model(cfg, mix.device, seed)
    return (model.eval(), *train(model, arm_forward(arm, model), mix, srcs, steps, tail))


def train(model: ConvTasNet, forward, mix: torch.Tensor, srcs: torch.Tensor, steps: int, tail: int = 0):
    """``steps`` Adam steps (lr 1e-3) of ``model`` on PIT over
    ``pairwise_neg_snr`` of forward(mix); returns (final loss, seconds),
    and with ``tail`` also the PIT SI-SDRi (the f32 forward's) of the
    models after each of the last ``tail`` steps (not in the seconds)."""
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)
    mix_np, srcs_np = mix.cpu().numpy(), srcs.cpu().numpy()
    scores, scoring = [], 0.0
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    _sync(mix.device)
    t0 = time.perf_counter()
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(forward(mix), srcs)
        loss.backward()
        opt.step()
        if step >= steps - tail:
            t1 = time.perf_counter()
            with torch.no_grad():
                scores.append(pit_si_sdri(model(mix).float().cpu().numpy(), srcs_np, mix_np))
            scoring += time.perf_counter() - t1
    _sync(mix.device)
    seconds = time.perf_counter() - t0 - scoring
    return (float(loss.detach()), seconds, scores) if tail else (float(loss.detach()), seconds)


def train_gate(deltas) -> dict:
    """The training gate on the seeds' differences of tail averages
    (bf16_plain - bf16_kernel, dB): their mean, its standard error (0 for
    one seed) and whether |mean| < TRAIN_GATE_DB."""
    deltas = np.asarray(deltas, dtype=np.float64)
    mean = float(deltas.mean())
    se = float(deltas.std(ddof=1) / np.sqrt(len(deltas))) if len(deltas) > 1 else 0.0
    return {"train_gate_delta_db": mean, "train_gate_se_db": se, "train_gate_ok": bool(abs(mean) < TRAIN_GATE_DB)}


def kernel_train_quality(steps: int = 300, device="cuda", cfg: dict = CONVTASNET, samples: int = 16000,
                         seeds=SEEDS, control: bool = False, tail: int = TAIL) -> dict:
    """The three arms and both gates on ``device``: the f32 arm from the
    initial weights of ``seeds[0]`` (the script's PRNGKey(0) stands for
    0), the bf16 arms (and with ``control`` the ``bf16_plain_chain`` arm,
    which no gate reads) from each seed's.  Returns, for each seed
    (``per_seed``) and arm, the SI-SDRi (dB) after the last step and
    averaged over the last ``tail`` steps' models (``{arm}_tail``), the
    final loss and the seconds; for each arm (``{arm}_tail``) the mean of
    its seeds' tail averages, the first seed's reading (``{arm}``), loss and
    the mean seconds a run; the gates (``train_gate``, and the bf16 serving
    study of the f32 arm's model) and ``ok``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("validate: no CUDA device; pass device=\"cpu\" to run on the CPU")
    tail = min(tail, steps)
    if not tail >= 1:
        raise ValueError(f"validate: a run's tail takes 1 to {steps} steps, got {tail}")
    mix_np, srcs_np = study_data(samples, cfg["sample_rate"])
    mix, srcs = torch.from_numpy(mix_np).to(device), torch.from_numpy(srcs_np).to(device)
    results = {"train_steps": steps, "seeds": list(seeds), "tail_steps": tail, "per_seed": []}
    f32_model = None
    for seed in seeds:
        row = {"seed": seed}
        arms = (ARMS if seed == seeds[0] else ARMS[1:]) + ((CONTROL_ARM,) if control else ())
        for arm in arms:
            model, loss, seconds, scores = train_arm(arm, cfg, mix, srcs, steps, seed, tail)
            with torch.no_grad():
                row[arm] = pit_si_sdri(model(mix).float().cpu().numpy(), srcs_np, mix_np)
            row[f"{arm}_tail"] = float(np.mean(scores))
            row[f"{arm}_final_loss_db"] = loss
            row[f"{arm}_seconds"] = seconds
            if arm == "f32":
                f32_model = model
        row["tail_delta_db"] = row["bf16_plain_tail"] - row["bf16_kernel_tail"]
        results["per_seed"].append(row)
    rows = results["per_seed"]
    for arm in ARMS + ((CONTROL_ARM,) if control else ()):
        runs = [r for r in rows if arm in r]
        results[arm] = runs[0][arm]
        results[f"{arm}_tail"] = float(np.mean([r[f"{arm}_tail"] for r in runs]))
        results[f"{arm}_final_loss_db"] = runs[0][f"{arm}_final_loss_db"]
        results[f"{arm}_seconds"] = float(np.mean([r[f"{arm}_seconds"] for r in runs]))
    results["script_reading_delta_db"] = rows[0]["bf16_plain"] - rows[0]["bf16_kernel"]
    results.update(train_gate([r["tail_delta_db"] for r in rows]))
    with torch.no_grad():
        est_bf16 = fused_inference_forward(f32_model, mix).float().cpu().numpy()
    results["serve_f32_db"] = results["f32"]
    results["serve_bf16_fused_db"] = pit_si_sdri(est_bf16, srcs_np, mix_np)
    results["serve_delta_db"] = results["serve_f32_db"] - results["serve_bf16_fused_db"]
    results["serve_gate_ok"] = bool(abs(results["serve_delta_db"]) < SERVE_GATE_DB)
    results["ok"] = results["train_gate_ok"] and results["serve_gate_ok"]
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS),
                        help="seeds of the initial weights (the f32 arm takes the first)")
    parser.add_argument("--control", action="store_true", help=f"also train the {CONTROL_ARM} arm")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 arm in full f32
    torch.backends.cudnn.allow_tf32 = False
    results = kernel_train_quality(args.steps, seeds=args.seeds, control=args.control)
    if torch.cuda.is_available():
        results["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(results, indent=2))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
