"""The port's offline evaluation against the JAX package on the CPU: the
SDR and PESQ copies, the CSV trackers, and the eval CLI
(``audio_test.main``) on the same manifests and the same JAX-written
checkpoint for a tiny ConvTasNet, DPTNet and Sepformer."""

import csv
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu import metrics as jax_metrics
from audio_only_speech_separation_tpu.data.audio_io import write_wav
from audio_only_speech_separation_tpu.models import ConvTasNet as JConvTasNet
from audio_only_speech_separation_tpu.models import Sepformer as JSepformer
from audio_only_speech_separation_tpu.models import TasNet as JTasNet
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu_torch import audio_test
from audio_only_speech_separation_tpu_torch import metrics as port_metrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000


def _sources(seed, n_src, T=4000):
    """(mix, clean, estimate): random sources, their sum, and a noisy
    estimate in swapped order."""
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((n_src, T))).astype(np.float32)
    est = (clean[::-1] + 0.05 * rng.standard_normal((n_src, T))).astype(np.float32)
    return clean.sum(0), clean, np.ascontiguousarray(est)


@pytest.mark.parametrize("n_src", [2, 3])
def test_sdr_matches_jax(n_src):
    _, clean, est = _sources(n_src, n_src)
    assert np.array_equal(port_metrics.sdr_matrix(clean, est), jax_metrics.sdr_matrix(clean, est))
    assert np.array_equal(port_metrics.sdr_pit(clean, est), jax_metrics.sdr_pit(clean, est))


@pytest.mark.parametrize("sr", [8000, 16000])
def test_pesq_matches_jax(sr):
    _, clean, est = _sources(sr, 2, T=sr)
    assert port_metrics.pesq(clean[0], est[1], sr) == jax_metrics.pesq(clean[0], est[1], sr)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _same_rows(got, want, atol):
    """Same header, same keys in the same order, every number within atol."""
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0]
        np.testing.assert_allclose(np.array(g[1:], float), np.array(w[1:], float), rtol=0, atol=atol)


@pytest.mark.parametrize("compute_pesq", [False, True])
def test_metrics_tracker_csv_matches_jax(tmp_path, compute_pesq):
    """The same (mix, clean, estimate) sequence: the same CSV rows (avg and
    std footers included) and the same ``update()`` within 1e-4."""
    trackers = [m.MetricsTracker(str(tmp_path / f"{i}.csv"), compute_pesq=compute_pesq, sample_rate=SR)
                for i, m in enumerate((port_metrics, jax_metrics))]
    for seed in range(3):
        mix, clean, est = _sources(10 + seed, 2)
        for tr in trackers:
            tr(mix, clean, est, f"utt{seed}.wav")
    got, want = (tr.update() for tr in trackers)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in got], rtol=0, atol=1e-4)
    for tr in trackers:
        tr.final()
    _same_rows(_read_csv(tmp_path / "0.csv"), _read_csv(tmp_path / "1.csv"), 1e-4)


def test_split_metrics_tracker_csv_matches_jax(tmp_path):
    trackers = [m.SPlitMetricsTracker(str(tmp_path / f"{i}.csv"))
                for i, m in enumerate((port_metrics, jax_metrics))]
    for seed in range(3):
        mix, clean, est = _sources(20 + seed, 3)
        for tr in trackers:
            tr(mix, clean, est, f"utt{seed}.wav")
    for tr in trackers:
        tr.final()
    _same_rows(_read_csv(tmp_path / "0.csv"), _read_csv(tmp_path / "1.csv"), 1e-4)


def _jax_audio_test():
    """The JAX package's eval CLI (the root ``audio_test.py``), loaded from
    its file."""
    spec = importlib.util.spec_from_file_location("jax_audio_test", os.path.join(REPO, "audio_test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# tiny models of the three families the eval CLI serves
MODELS = {
    "ConvTasNet": (JConvTasNet, dict(N=16, L=8, B=8, H=8, P=3, X=1, R=1, num_spks=2)),
    "TasNet": (JTasNet, dict(enc_dim=16, bn_dim=16, hidden_dim=16, layer=1, module="DPTNet",
                             block_size=10)),
    "Sepformer": (JSepformer, dict(encoder_out_nchannels=16, masknet_chunksize=10, masknet_numlayers=1,
                                   intra_numlayers=1, inter_numlayers=1, intra_nhead=2, inter_nhead=2,
                                   intra_dffn=32, inter_dffn=32)),
}
# utterance lengths (samples at 8 kHz), out of order, over two 0.5 s buckets;
# at batch size 2 the last pair, [4000, 5200], is padded to 8000 together
LENGTHS = (3500, 2400, 3100, 4000, 2400, 5200)


@pytest.fixture(scope="module")
def test_manifests(tmp_path_factory):
    """LRS2-layout manifests (mix.json, s1.json, s2.json) written as the
    JAX package's CLI tests write them; the test split has utterances of
    several lengths."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(30)
    for split, lengths in (("tr", (2400,)), ("cv", (2400,)), ("tt", LENGTHS)):
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            (root / split / c).mkdir(parents=True)
        for i, n in enumerate(lengths):
            s = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                path = str(root / split / c / f"u{i}.wav")
                write_wav(path, wav, SR)
                infos[c].append([path, n])
        for c, lst in infos.items():
            (root / split / f"{c}.json").write_text(json.dumps(lst))
    return root


def _config(name, data_root, exp_dir, bf16):
    return {
        "audionet": {"audionet_name": name, "audionet_config": dict(MODELS[name][1])},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": dict(
            train_dir=str(data_root / "tr"), valid_dir=str(data_root / "cv"),
            test_dir=str(data_root / "tt"), n_src=2, sample_rate=SR, segment=0.25,
            normalize_audio=False, batch_size=1, num_workers=1)},
        "main_args": {"exp_dir": str(exp_dir), "bf16": bf16},
    }


@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_cli_matches_jax(tmp_path, test_manifests, name, batch_size):
    """One JAX-written checkpoint scored by both CLIs on the CPU: the same
    rows in the same order within 1e-3 dB.  At batch size 2 the batches
    must be the JAX CLI's, since bucket padding enters every gLN's
    statistics; there ``--bf16`` is set, which the CPU runs in float32 in
    both packages."""
    cls, cfg = MODELS[name]
    jm = cls(**cfg, sample_rate=SR)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(31), np.zeros((1, 800), np.float32)))
    # the decoder tied to the encoder, so that the estimates correlate with
    # the sources (SI-SNR about -10 to 0 dB): a random decoder leaves them
    # near -35 dB, where float32 rounding alone moves a row by 1e-3 dB
    params["params"]["decoder"]["kernel"] = params["params"]["encoder"]["kernel"].T.copy()
    dirs = [tmp_path / "jax", tmp_path / "port"]
    dirs[0].mkdir()
    jax_save(jax_serialize(jm, params), str(dirs[0] / "best_model.pth"))
    shutil.copytree(dirs[0], dirs[1])
    bf16 = batch_size == 2
    _jax_audio_test().main(_config(name, test_manifests, dirs[0], bf16), bucket_seconds=0.5,
                           batch_size=batch_size)
    audio_test.main(_config(name, test_manifests, dirs[1], bf16), bucket_seconds=0.5,
                    batch_size=batch_size, device="cpu")
    want, got = (_read_csv(d / "results" / "metrics.csv") for d in dirs)
    assert len(got) == 1 + len(LENGTHS) + 2 and [r[0] for r in got[-2:]] == ["avg", "std"]
    _same_rows(got, want, 1e-3)


def test_eval_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """No card: ``main`` raises unless the caller passes ``device="cpu"``;
    an unported model fails at the registry's lookup, before any data is
    read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = tmp_path / "missing"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_test.main(_config("ConvTasNet", missing, tmp_path, False))
    tdanet = dict(_config("ConvTasNet", missing, tmp_path, False),
                  audionet={"audionet_name": "TDANet", "audionet_config": {}})
    with pytest.raises(KeyError, match="TDANet"):
        audio_test.main(tdanet, device="cpu")
