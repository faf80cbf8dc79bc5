"""Per-utterance metric trackers with CSV streaming (counterpart of
``audio_only_speech_separation_tpu/metrics/wrapper.py``).

Contract parity with the reference (metrics/wrapper.py:18-81,
splitwrapper.py:22-120): SI-SNR + SI-SNRi (PIT, mixture baseline) and
SDR + SDRi, streamed to ``results/metrics.csv`` per utterance with avg/std
footer rows.  The SI-SNR terms run through the port's ``losses`` on CPU
float32 tensors; SDR is the numpy ``sdr_pit``.
"""

from __future__ import annotations

import csv
import itertools

import numpy as np
import torch

from ..losses import PairwiseNegSDR, PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
from .pesq import pesq as pesq_score
from .sdr import sdr_pit


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


class MetricsTracker:
    """``compute_pesq=True`` adds a best-permutation-averaged ``pesq_est``
    column (metrics/pesq.py — a P.862-*structure* estimator, NOT the ITU
    conformant implementation; the column is named ``pesq_est`` so scores
    are never confused with published PESQ numbers).  Requires
    ``sample_rate`` of 8 or 16 kHz.  Off by default: ~10× costlier than
    SDR."""

    def __init__(self, save_file: str = "", compute_pesq: bool = False,
                 sample_rate: int = 8000):
        self.all_sdrs = []
        self.all_sdrs_i = []
        self.all_sisnrs = []
        self.all_sisnrs_i = []
        self.all_pesq = []
        self.compute_pesq = compute_pesq
        self.sample_rate = sample_rate
        csv_columns = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i"]
        if compute_pesq:
            csv_columns.append("pesq_est")
        self.results_csv = open(save_file, "w")
        self.writer = csv.DictWriter(self.results_csv, fieldnames=csv_columns)
        self.writer.writeheader()
        self.pit_sisnr = PITLossWrapper(
            PairwiseNegSDR("sisdr", zero_mean=True), pit_from="pw_mtx",
            threshold_byloss=False,
        )

    def __call__(self, mix, clean, estimate, key: str):
        """mix [T], clean [n_src, T], estimate [n_src, T] (numpy or CPU tensors)."""
        mix = np.asarray(mix)
        clean = np.asarray(clean)
        estimate = np.asarray(estimate)
        n_src = clean.shape[0]
        mix_rep = np.stack([mix] * n_src, 0)

        sisnr = float(self.pit_sisnr(_t(estimate[None]), _t(clean[None])))
        sisnr_base = float(self.pit_sisnr(_t(mix_rep[None]), _t(clean[None])))
        sisnr_i = sisnr - sisnr_base

        sdr = float(sdr_pit(clean, estimate).mean())
        sdr_base = float(sdr_pit(mix_rep, clean).mean())
        sdr_i = sdr - sdr_base

        row = {
            "snt_id": key,
            "sdr": sdr,
            "sdr_i": sdr_i,
            "si-snr": -sisnr,
            "si-snr_i": -sisnr_i,
        }
        if self.compute_pesq:
            # score the best (SI-SNR-optimal is close enough to PESQ-optimal)
            # permutation: average PESQ over sources under each pairing, take
            # the max
            best = max(
                np.mean(
                    [
                        pesq_score(clean[j], estimate[i], self.sample_rate)
                        for i, j in enumerate(perm)
                    ]
                )
                for perm in itertools.permutations(range(n_src))
            )
            row["pesq_est"] = best
            self.all_pesq.append(best)
        self.writer.writerow(row)
        self.all_sdrs.append(sdr)
        self.all_sdrs_i.append(sdr_i)
        self.all_sisnrs.append(-sisnr)
        self.all_sisnrs_i.append(-sisnr_i)

    def update(self):
        return {
            "sdr_i": float(np.mean(self.all_sdrs_i)),
            "si-snr_i": float(np.mean(self.all_sisnrs_i)),
        }

    def final(self):
        for stat, fn in (("avg", np.mean), ("std", np.std)):
            row = {
                "snt_id": stat,
                "sdr": fn(self.all_sdrs),
                "sdr_i": fn(self.all_sdrs_i),
                "si-snr": fn(self.all_sisnrs),
                "si-snr_i": fn(self.all_sisnrs_i),
            }
            if self.compute_pesq and self.all_pesq:
                row["pesq_est"] = fn(self.all_pesq)
            self.writer.writerow(row)
        self.results_csv.close()


class SPlitMetricsTracker:
    """3-source split scoring: PIT-reorder with SNR, then score sources
    [0:2] (speakers) and [2] (noise/other) separately
    (reference splitwrapper.py:49-101)."""

    def __init__(self, save_file: str = ""):
        self.acc = {k: [] for k in (
            "one_snr", "one_snr_i", "one_sisnr", "one_sisnr_i",
            "two_snr", "two_snr_i", "two_sisnr", "two_sisnr_i",
        )}
        csv_columns = [
            "snt_id",
            "one_snr", "one_snr_i", "one_si-snr", "one_si-snr_i",
            "two_snr", "two_snr_i", "two_si-snr", "two_si-snr_i",
        ]
        self.results_csv = open(save_file, "w")
        self.writer = csv.DictWriter(self.results_csv, fieldnames=csv_columns)
        self.writer.writeheader()
        self.pit_sisnr = PITLossWrapper(pairwise_neg_sisdr, pit_from="pw_mtx", threshold_byloss=False)
        self.pit_snr = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=False)

    def __call__(self, mix, clean, estimate, key: str):
        mix = np.asarray(mix)
        clean = np.asarray(clean)
        estimate = np.asarray(estimate)
        n_src = clean.shape[0]
        _, ests = self.pit_snr(_t(estimate[None]), _t(clean[None]), return_ests=True)
        ests = ests.numpy()
        mix_rep = np.stack([mix] * n_src, 0)[None]
        clean = clean[None]

        def score(wrapper, a, b):
            return float(wrapper(_t(a), _t(b)))

        vals = {}
        for name, wrapper in (("sisnr", self.pit_sisnr), ("snr", self.pit_snr)):
            two = score(wrapper, ests[:, 0:2], clean[:, 0:2])
            one = score(wrapper, ests[:, 2:3], clean[:, 2:3])
            two_b = score(wrapper, mix_rep[:, 0:2], clean[:, 0:2])
            one_b = score(wrapper, mix_rep[:, 2:3], clean[:, 2:3])
            vals[f"two_{name}"] = -two
            vals[f"two_{name}_i"] = -(two - two_b)
            vals[f"one_{name}"] = -one
            vals[f"one_{name}_i"] = -(one - one_b)

        row = {
            "snt_id": key,
            "one_snr": vals["one_snr"], "one_snr_i": vals["one_snr_i"],
            "one_si-snr": vals["one_sisnr"], "one_si-snr_i": vals["one_sisnr_i"],
            "two_snr": vals["two_snr"], "two_snr_i": vals["two_snr_i"],
            "two_si-snr": vals["two_sisnr"], "two_si-snr_i": vals["two_sisnr_i"],
        }
        self.writer.writerow(row)
        for k in self.acc:
            self.acc[k].append(vals[k])

    def final(self):
        row = {"snt_id": "avg"}
        row.update({
            "one_snr": np.mean(self.acc["one_snr"]),
            "one_snr_i": np.mean(self.acc["one_snr_i"]),
            "one_si-snr": np.mean(self.acc["one_sisnr"]),
            "one_si-snr_i": np.mean(self.acc["one_sisnr_i"]),
            "two_snr": np.mean(self.acc["two_snr"]),
            "two_snr_i": np.mean(self.acc["two_snr_i"]),
            "two_si-snr": np.mean(self.acc["two_sisnr"]),
            "two_si-snr_i": np.mean(self.acc["two_sisnr_i"]),
        })
        self.writer.writerow(row)
        self.results_csv.close()
