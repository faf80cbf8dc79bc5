"""The port's paths on the card at the published configurations' widths,
where ``test_torch_port_cuda.py`` holds each kernel and small models:
serving (every family through ``Server``'s dispatch with exact launches,
no plain version called, the validator's 1.5x rule, each kernel against
its plain version at the shapes the call gave it; from a checkpoint), the
eval CLI, ``audio_train.main``, train steps, the two-step entry, the data
modules, a process group of one, chunked separation, ConvTasNet's train
forms, ``sp`` on two gloo ranks, the layer blocks, and the measurement
entry points once each.  Marker ``cuda``: they skip without a GPU and
import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda_paths.py
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_card import (  # noqa: E402
    EVAL_SECONDS,
    FAMILIES,
    LRS3,
    SEPFORMER_K4,
    SR,
    TDANET_K4,
    TSR,
    WSJ0_TASNET,
    convtasnet_model,
    counters,
    counting,
    counting_plain_versions,
    cuda,  # noqa: F401 (the fixture)
    dualpath_paths,
    flat,
    gradients_meet_the_rule,
    kernels_match_plain_at,
    max_err,
    meets_the_rule,
    noting_calls,
    recording_kernel_shapes,
    redrawn_norms,
    scalars,
    seeded_model,
    tasnet_model,
    waves,
    write_manifests,
)

from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as k1  # noqa: E402

pytestmark = pytest.mark.cuda


def _k1_within_its_plain_version(got, plain):
    """K1's separator output within ``bench.K1_PLAIN_REL`` of its plain
    version's largest magnitude (the two bf16 chains round at different
    points over 24 blocks)."""
    from audio_only_speech_separation_tpu_torch.bench import K1_PLAIN_REL

    assert max_err(got, plain) <= K1_PLAIN_REL * float(plain.float().abs().max()), max_err(got, plain)


# ---------------------------------------------------------------------------
# ConvTasNet-LRS3 through K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["lrs3", "odd"])
def test_k1_at_the_published_width(cuda, case):
    """K1 at configs/convtasnet_lrs3.yml's width on the frames of B=2 x 2 s
    ("lrs3") and of 9999 samples with 2 speakers and a sigmoid mask
    ("odd"): against its plain version within ``K1_PLAIN_REL``,
    bit-identical from run to run; the whole path under the 1.5x rule
    against the f32 module."""
    from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward, inference_frames

    cfg, T = {"lrs3": (LRS3, 2 * SR), "odd": (dict(LRS3, num_spks=2, n_src=2, activate="sigmoid"), 9999)}[case]
    model = convtasnet_model(cfg, 1, cuda)
    packed = k1.pack_convtasnet_full_params(model.state_dict(), cfg["R"], cfg["X"], cfg["num_spks"], device=cuda)
    x = waves(cuda, 2, 2, T)
    *w, dils = packed
    kw = dict(dilations=dils, nspk=cfg["num_spks"], sigmoid=cfg["activate"] == "sigmoid")
    with torch.no_grad():
        ref = model(x)
        got = fused_inference_forward(model, x, packed=packed)
        plain = fused_inference_forward(model, x, packed=packed, separator=k1.convtasnet_separator_reference)
        frames = inference_frames(model, x)
        sep_k, sep_again = (k1.fused_convtasnet_separator(frames, *w, **kw) for _ in range(2))
        sep_p = k1.convtasnet_separator_reference(frames, *w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sep_k, sep_again)
    _k1_within_its_plain_version(sep_k, sep_p)
    meets_the_rule(got, ref, plain)


def _serves_lrs3_through_k1(model, dev):
    """Five requests (1.3-4 s) through ``serve`` with bf16 in 1 s buckets,
    two a batch: 3 K1 calls of 50 launches; each estimate under the 1.5x
    rule against f32 serving, with K1's plain version on the same batches
    as the margin."""
    from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward
    from audio_only_speech_separation_tpu_torch.serve import serve

    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(int(s * SR)).astype(np.float32) for s in (1.3, 2.0, 2.0, 3.7, 4.0)]
    with counting((k1.fused_convtasnet_separator,)) as launched:
        est = serve(model, wavs, use_bf16=True, device=dev, bucket_seconds=1.0, batch_size=2)
        torch.cuda.synchronize()
        assert launched() == (3 * k1.convtasnet_separator_launches(model.R * model.X),)
    ref = serve(model, wavs, use_bf16=False, device=dev, bucket_seconds=1.0, batch_size=2)
    packed = k1.pack_convtasnet_full_params(model.state_dict(), model.R, model.X, model.num_spks, device=dev)
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
    for start in range(0, len(order), 2):  # the plain version on serve's batches
        idxs = order[start : start + 2]
        mix = np.zeros((len(idxs), -(-max(len(wavs[i]) for i in idxs) // SR) * SR), np.float32)
        for j, i in enumerate(idxs):
            mix[j, : len(wavs[i])] = wavs[i]
        with torch.no_grad():
            plain = fused_inference_forward(model, torch.from_numpy(mix).to(dev), packed=packed,
                                            separator=k1.convtasnet_separator_reference).float().cpu()
        for j, i in enumerate(idxs):
            assert est[i].shape == (model.num_spks, len(wavs[i])), i
            meets_the_rule(est[i], ref[i], plain[j, :, : len(wavs[i])], f"request {i}")


@pytest.mark.parametrize("family", ["ConvTasNet-LRS3", "DPTNet", "DPRNN"])
def test_served_from_a_checkpoint(cuda, tmp_path, family):
    """A checkpoint written with ``serialize`` and loaded with
    ``from_pretrain`` on the card serves five requests under the 1.5x rule
    against f32 serving: ConvTasNet-LRS3 through K1 (exact launches), the
    wsj0 TasNets (1.3-12 s at 8 kHz, batch 1) against ``plain_versions()``,
    K5 (the columns of 8 s and more) and K6 each launched, K4 by DPTNet
    alone."""
    from audio_only_speech_separation_tpu_torch.models import from_pretrain, save_serialized, serialize
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.serve import serve

    model = convtasnet_model(LRS3, 3, cuda) if family == "ConvTasNet-LRS3" else tasnet_model(family, 21, cuda)
    save_serialized(serialize(model), str(tmp_path / "best_model.pth"))
    served = from_pretrain(str(tmp_path / "best_model.pth"), device=cuda).eval()
    if family == "ConvTasNet-LRS3":
        _serves_lrs3_through_k1(served, cuda)
        return
    rng = np.random.default_rng(24)
    wavs = [rng.standard_normal(int(s * TSR)).astype(np.float32) for s in (1.3, 2.0, 4.0, 7.5, 12.0)]
    kw = dict(device=cuda, bucket_seconds=1.0, batch_size=1)
    with counting() as launched:
        est = serve(served, wavs, use_bf16=True, **kw)
        torch.cuda.synchronize()
        n4, n5, n6 = launched()
    assert (n4 > 0) == (family == "DPTNet") and n5 > 0 and n6 > 0, (n4, n5, n6)
    ref = serve(served, wavs, use_bf16=False, **kw)
    with plain_versions():
        plain = serve(served, wavs, use_bf16=True, **kw)
    for i, wav in enumerate(wavs):
        assert est[i].shape == (2, len(wav))
        meets_the_rule(est[i], ref[i], plain[i], f"request {i}")


# ---------------------------------------------------------------------------
# Every served family at its published width
# ---------------------------------------------------------------------------


SEEDS = {"DPTNet": 21, "DPRNN": 22, "Sepformer": 31, "BSRNN": 41, "TDANet": 42, "AFRCNN": 43, "Sandglasset": 92,
         "DPRNNTasNet": 93}


def _model(family, dev):
    """The served families at their published widths, seeded; "TasNet
    <module> G<group size>" the wsj0 TasNet with that core and group size."""
    if family in ("DPTNet", "DPRNN"):
        return tasnet_model(family, SEEDS[family], dev)
    if family in SEEDS:
        name, cfg, sr = FAMILIES[family][:3]
        return seeded_model(name, cfg, sr, SEEDS[family], dev)
    module, group = family.split()[1], int(family.split()[2][1:])
    return seeded_model("TasNet", dict(WSJ0_TASNET, module=module, group_size=group), TSR, 94, dev)


def _stated_shapes(family, batch):
    """The kernels' shapes in a call at B=batch x 2 s x 8 kHz: Sandglasset's
    K4 [BH, dh, T] (blocks 0/5 attend over the 131 chunks with the 250
    positions batched, 1/4 with 62 pooled, 2/3 15) and K6 (T, B, Din, H, D);
    DPRNNTasNet's K6 over its rows (128 chunks of 32 frames an utterance)
    and columns (32 sequences of 128 chunks)."""
    if family == "Sandglasset":
        return {"K4": {(batch * 250 * 8, 16, 131), (batch * 62 * 8, 16, 131), (batch * 15 * 8, 16, 131)},
                "K5": set(), "K6": {(250, batch * 131, 128, 128, 2)}}
    return {"K4": set(), "K5": set(), "K6": {(32, batch * 128, 128, 256, 2), (128, batch * 32, 128, 256, 2)}}


# (family, batch, seconds, sample rate, K4, K5, K6 launches a call).  The
# wsj0 TasNets' LSTMs are 64 wide: rows of 100 frames and 2 s columns (42
# chunks) take K6, the 12 s columns (242 chunks over 100 sequences) K5
# (ops/rnn.py::kernel_choice; the 12 s DPRNN is the input its held-back
# clause keeps on the 1.5x rule); Sepformer 32 attentions through K4's packed
# entry; BSRNN's band RNNs (8B sequences of 501 frames, 128 wide) K5 at B=1
# and K6 at B=4, its band-comm RNNs K6; Sandglasset one attention (two in the
# 4-D form) and one intra BiLSTM a block; DPRNNTasNet's rows and columns K6;
# the grouped TasNet modules' context GC_RNNs and cores K6, DPTNet's
# attention (dh 8) K4, TCN and SudoRM-RF none
SERVED = [("DPTNet", 2, 2.0, TSR, (12, 0, 12)), ("DPTNet", 1, 12.0, TSR, (12, 6, 6)),
          ("DPRNN", 2, 2.0, TSR, (0, 0, 12)), ("DPRNN", 1, 12.0, TSR, (0, 6, 6)),
          ("Sepformer", 2, 2.0, SR, (SEPFORMER_K4, 0, 0)), ("Sepformer", 1, 8.0, SR, (SEPFORMER_K4, 0, 0)),
          ("BSRNN", 1, 4.0, TSR, (0, 8, 8)), ("BSRNN", 4, 4.0, TSR, (0, 0, 16)),
          ("AFRCNN", 1, 2.0, SR, (0, 0, 0)),
          ("Sandglasset", 8, 2.0, TSR, (6, 0, 6)), ("Sandglasset", 1, 2.0, TSR, (6, 0, 6)),
          ("DPRNNTasNet", 8, 2.0, TSR, (0, 0, 12)), ("DPRNNTasNet", 1, 2.0, TSR, (0, 0, 12)),
          ("TasNet TCN G1", 8, 2.0, TSR, (0, 0, 0)), ("TasNet SudoRMRF G1", 8, 2.0, TSR, (0, 0, 0)),
          ("TasNet GC_TCN G2", 8, 2.0, TSR, (0, 0, 4)), ("TasNet GC_SudoRMRF G2", 8, 2.0, TSR, (0, 0, 4)),
          ("TasNet DPRNN G2", 8, 2.0, TSR, (0, 0, 16)), ("TasNet DPTNet G2", 8, 2.0, TSR, (12, 0, 16))]


@pytest.mark.parametrize("family,batch,secs,sr,launched", SERVED,
                         ids=[f"{f} B={b} x {s:g} s" for f, b, s, _, _ in SERVED])
def test_served_model_at_published_width(cuda, family, batch, secs, sr, launched):
    """``Server``'s "kernels" dispatch on the family at its published width
    and depth: the K4, K5 and K6 launches a call stated above (Sepformer's
    all through the packed entry), no plain version of a kernel called, a
    finite output within 1.5 x the plain bf16 path's error + 1e-3 of the
    f32 module's; then each kernel against its plain version at every shape
    the call gave it (Sandglasset's and DPRNNTasNet's as stated)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import fused_attention_bdt

    model = _model(family, cuda)
    kernel, plain, f32 = dualpath_paths(model)
    x = waves(cuda, {"DPTNet": 23, "DPRNN": 23}.get(family, 90 + batch), batch, int(secs * sr))
    bdt = fused_attention_bdt.launches
    with counting() as n, counting_plain_versions() as plain_calls, recording_kernel_shapes() as shapes:
        got = kernel(x)
        torch.cuda.synchronize()
        assert n() == launched and not any(plain_calls.values()), (n(), plain_calls)
    if family == "Sepformer":
        assert fused_attention_bdt.launches == bdt
    meets_the_rule(got, f32(x), plain(x))
    if family in ("Sandglasset", "DPRNNTasNet"):
        assert {g: shapes[g] for g in ("K4", "K5", "K6")} == _stated_shapes(family, batch)
    kernels_match_plain_at(cuda, shapes)


@pytest.mark.parametrize("batch", [1, 2])
def test_tdanet_fast_path_and_module_path_at_published_width(cuda, batch):
    """TDANet (tdanet_lrs2) at B x 2 s x 16 kHz: ``serve`` takes
    "fast_tdanet", which launches no K4 and is within 1e-4 of the f32
    module's scale in f32 and above 20 dB SNR in bf16 (the JAX package's
    tests/test_tdanet_fast.py bound); the bf16 module path launches K4 once
    a block (16) and meets the 1.5x rule against the plain bf16 module; K4
    against its plain version at the module path's shapes."""
    from audio_only_speech_separation_tpu_torch.models.tdanet import fast_inference_forward
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.serve import Server

    model = _model("TDANet", cuda)
    server = Server(model, True, cuda)
    assert server.dispatch == "fast_tdanet"
    module = copy.deepcopy(model).to(torch.bfloat16)
    x = waves(cuda, 34, batch, 2 * SR)
    with torch.no_grad():
        with counting() as n, recording_kernel_shapes() as shapes:
            got = module(x.to(torch.bfloat16))
            torch.cuda.synchronize()
            assert n() == (TDANET_K4, 0, 0)
        with counting() as n:
            fast = server.forward(x)
            torch.cuda.synchronize()
            assert n() == (0, 0, 0)
        with plain_versions():
            plain = module(x.to(torch.bfloat16))
        ref, fast32 = model(x), fast_inference_forward(model, x)
    scale = float(ref.abs().max())
    assert max_err(fast32, ref) <= 1e-4 * scale
    err = (fast.double() - ref.double()).square().sum()
    assert float(10 * torch.log10(ref.double().square().sum() / err)) > 20.0
    meets_the_rule(got, ref, plain)
    kernels_match_plain_at(cuda, shapes)


# ---------------------------------------------------------------------------
# The eval CLI on every family
# ---------------------------------------------------------------------------

# family: (kernels that must launch, kernels that must not, ``serve``'s dispatch)
EVAL_CLI = {"ConvTasNet-LRS3": (("K1",), ("K4", "K5", "K6"), "fused"), "DPTNet": (("K4", "K5", "K6"), (), "kernels"),
            "Sepformer": (("K4",), ("K5", "K6"), "kernels"), "BSRNN": (("K5", "K6"), ("K4",), "kernels"),
            "TDANet": ((), ("K4", "K5", "K6"), "fast_tdanet"), "AFRCNN": ((), ("K4", "K5", "K6"), "kernels"),
            "Sandglasset": (("K4", "K6"), ("K5",), "kernels"), "DPRNNTasNet": (("K6",), ("K4", "K5"), "kernels"),
            "TasNet DPTNet G2": (("K4", "K6"), ("K5",), "kernels")}


@pytest.mark.parametrize("family", list(EVAL_CLI))
def test_eval_cli_matches_the_tracker_on_serve(cuda, tmp_path, family):
    """``audio_test.main(config, device="cuda")`` with --bf16 on a seeded
    checkpoint of the family at its published width, over five synthetic
    utterances of 1.3-8 s: one CSV row per utterance plus avg and std,
    every value finite and within 1e-3 dB of ``MetricsTracker`` on
    ``serve()``'s estimates of the same model in the CLI's order; the
    dispatch and the kernels launched as stated."""
    from audio_only_speech_separation_tpu_torch import audio_test
    from audio_only_speech_separation_tpu_torch import data as datas
    from audio_only_speech_separation_tpu_torch.metrics import MetricsTracker
    from audio_only_speech_separation_tpu_torch.models import from_pretrain, save_serialized, serialize
    from audio_only_speech_separation_tpu_torch.serve import Server, serve

    wanted, absent, dispatch = EVAL_CLI[family]
    name, audionet_config, sr = FAMILIES[family][:3]
    audionet = {"audionet_name": name, "audionet_config": dict(audionet_config)}
    n_src = 3 if family == "ConvTasNet-LRS3" else 2
    data_name = "LRS3DataModule" if n_src == 3 else "LRS2DataModule"
    model = convtasnet_model(LRS3, 5, cuda) if family == "ConvTasNet-LRS3" else _model(family, cuda)
    exp_dir = tmp_path / "exp"
    exp_dir.mkdir()
    save_serialized(serialize(model), str(exp_dir / "best_model.pth"))
    tt = str(tmp_path / "data" / "tt")
    write_manifests(str(tmp_path / "data"), {"tt": [int(s * sr) for s in EVAL_SECONDS]}, 40,
                    mix="mix_noise" if n_src == 3 else "mix", n_src=n_src, sr=sr)
    config = {"audionet": audionet,
              "datamodule": {"data_name": data_name, "data_config": {
                  "train_dir": tt, "valid_dir": tt, "test_dir": tt, "n_src": n_src, "sample_rate": sr,
                  "segment": 2.0}},
              "main_args": {"exp_dir": str(exp_dir), "bf16": True}}
    named = dict(zip(("K1", "K4", "K5", "K6"), (k1.fused_convtasnet_separator, *counters())))
    with counting(tuple(named.values())) as n:
        csv_path = audio_test.main(config, device="cuda")
        torch.cuda.synchronize()
        launched = dict(zip(named, n()))
    assert all(launched[g] > 0 for g in wanted) and not any(launched[g] for g in absent), launched
    with open(csv_path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    served = from_pretrain(str(exp_dir / "best_model.pth"), cuda, sample_rate=sr, **audionet["audionet_config"])
    assert Server(served, True, cuda).dispatch == dispatch
    test_set = datas.get(data_name)(**dict(config["datamodule"]["data_config"], segment=None))
    test_set.setup()
    test_set = test_set.make_sets[2]
    order = sorted(range(len(test_set)), key=lambda j: test_set.mix[j][1])
    items = [test_set[j] for j in order]
    ests = serve(served, [mix for mix, _, _ in items], use_bf16=True, device=cuda)
    tracker = MetricsTracker(save_file=str(tmp_path / "ref.csv"), sample_rate=sr)
    for (mix, sources, key), est in zip(items, ests):
        tracker(mix, sources, est, key)
    tracker.final()
    with open(tmp_path / "ref.csv") as f:
        want = [line.split(",") for line in f.read().splitlines()]
    values = np.array([r[1:] for r in rows[1:]], float)
    assert len(rows) == len(EVAL_SECONDS) + 3 and [r[0] for r in rows[-2:]] == ["avg", "std"]
    assert np.isfinite(values).all() and [r[0] for r in rows] == [r[0] for r in want]
    assert float(np.abs(values - np.array([r[1:] for r in want[1:]], float)).max()) <= 1e-3


# ---------------------------------------------------------------------------
# Training at the published widths
# ---------------------------------------------------------------------------

# K4, K5, K6 launches of one bf16 forward at the train shape, in a train step
# (dropout on) and in eval: DPRNN's rows (164 chunks of 100 frames) and
# columns (200 sequences of 82 chunks) take K6, 6 layers; DPTNet's MHA has no
# dropout (12 K4); BSRNN's band RNNs (32 sequences) and band-comm RNNs (2004)
# K6, 8 repeats each; Sepformer's and TDANet's attention has dropout 0.1, so
# K4 only in eval; Sandglasset's intra BiLSTMs (262 sequences) K6 and its six
# attentions K4 (dropout 0); DPRNNTasNet's rows (256 sequences) and columns
# (64) K6
TRAIN_LAUNCHES = {"DPRNN": ((0, 0, 12), (0, 0, 12)), "DPTNet": ((12, 0, 12), (12, 0, 12)),
                  "BSRNN": ((0, 0, 16), (0, 0, 16)), "Sepformer": ((0, 0, 0), (SEPFORMER_K4, 0, 0)),
                  "TDANet": ((0, 0, 0), (TDANET_K4, 0, 0)), "AFRCNN": ((0, 0, 0), (0, 0, 0)),
                  "Sandglasset": ((6, 0, 6), (6, 0, 6)), "DPRNNTasNet": ((0, 0, 12), (0, 0, 12))}
TRAIN_STEPS = 2  # optimizer steps of a training run (one epoch)


def _pit(sdr_type, threshold_byloss):
    return {"loss_func": "PITLossWrapper", "sdr_type": sdr_type,
            "config": {"pit_from": "pw_mtx", "threshold_byloss": threshold_byloss}}


def _train_config(family, data_root, exp_name):
    """The family's config with the data under data_root, one epoch and bf16
    training; ConvTasNet-LRS3 through K2 and K3 (``fused_forward``) from
    LRS3's layout (3 speakers)."""
    name, audionet, sr, batch, secs, by_loss = FAMILIES[family]
    lrs3 = family == "ConvTasNet-LRS3"
    return {
        "audionet": {"audionet_name": name, "audionet_config": dict(audionet)},
        "loss": {"train": _pit("pairwise_neg_snr", by_loss), "val": _pit("pairwise_neg_sisdr", False)},
        "training": {"epochs": 1, "precision": "bfloat16", "fused_forward": lrs3,
                     "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min", "patience": 30}},
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 15, "factor": 0.5}},
        "datamodule": {"data_name": "LRS3DataModule" if lrs3 else "LRS2DataModule", "data_config": {
            "train_dir": os.path.join(data_root, "tr"), "valid_dir": os.path.join(data_root, "cv"),
            "test_dir": os.path.join(data_root, "tt"), "n_src": 3 if lrs3 else 2, "sample_rate": sr, "fps": 25,
            "segment": secs, "normalize_audio": False, "batch_size": batch, "num_workers": 8,
            "pin_memory": True, "persistent_workers": False, "audio_only": True}},
        "exp": {"exp_name": exp_name},
    }


def _manifests(family, data_root, seed, steps):
    """``steps`` train batches and one validation and one test batch of the
    family's segment, in its data module's layout."""
    sr, batch, secs = FAMILIES[family][2:5]
    n, lrs3 = int(secs * sr), family == "ConvTasNet-LRS3"
    write_manifests(data_root, {"tr": [n] * steps * batch, "cv": [n] * batch, "tt": [n] * batch}, seed,
                    mix="mix_noise" if lrs3 else "mix", n_src=3 if lrs3 else 2, sr=sr)


def _chain_launches(steps):
    """K2 and K3 launches of a three-step LRS3 run: one K2 a train step (no
    recomputation on the fused path, remat or not), one a cv and a tt batch;
    one K3 a train step."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import tcn_backward_launches

    return (steps + 2) * k1.tcn_separator_launches(24), steps * tcn_backward_launches(24)


@pytest.mark.parametrize("family", ["ConvTasNet-LRS3", "ConvTasNet-LRS3 remat lamb cosine", "DPRNN", "DPTNet",
                                    "BSRNN", "Sepformer", "TDANet", "AFRCNN"])
def test_audio_train_main_then_serves_best_model(cuda, tmp_path, monkeypatch, family):
    """``audio_train.main`` with bf16 at the family's published width, batch
    and segment on synthetic manifests, one epoch: finite train, val and
    test losses and exact launches.  ConvTasNet-LRS3 (3 steps of B=12 x 2
    s through K2 and K3) then serves its best_model.pth through K1 under the
    1.5x rule; with ``remat``, lamb and CosineAnnealingLR the same launches
    and the scheduled learning rate.  The dual-path families (2 steps) launch
    K4-K6 as TRAIN_LAUNCHES states a train step and an eval batch, and their
    best_model.pth serves five requests on the card."""
    from audio_only_speech_separation_tpu_torch import audio_train
    from audio_only_speech_separation_tpu_torch.models import from_pretrain
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import fused_tcn_backward
    from audio_only_speech_separation_tpu_torch.serve import serve

    data = str(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    if family.startswith("ConvTasNet"):
        _manifests("ConvTasNet-LRS3", data, 10, 3)
        config = _train_config("ConvTasNet-LRS3", data, "lrs3")
        if family != "ConvTasNet-LRS3":
            config["training"]["remat"] = True
            config["optimizer"]["optim_name"] = "lamb"
            config["scheduler"] = {"sche_name": "CosineAnnealingLR", "sche_config": {"T_max": 10}}
        with counting((k1.fused_tcn_separator, fused_tcn_backward)) as n:
            exp_dir = audio_train.main(config)
            torch.cuda.synchronize()
            assert n() == _chain_launches(3)
        got = scalars(str(tmp_path), "lrs3")
        assert all(np.isfinite(got[k]) for k in ("train_loss", "val_loss", "test_loss")), got
        if family == "ConvTasNet-LRS3":
            _serves_lrs3_through_k1(from_pretrain(os.path.join(exp_dir, "best_model.pth"), device=cuda).eval(),
                                    cuda)
        else:
            assert abs(got["learning_rate"] - 0.5 * 1e-3 * (1 + np.cos(np.pi / 10))) <= 1e-9
        return
    _manifests(family, data, 60, TRAIN_STEPS)
    with counting() as n:
        exp_dir = audio_train.main(_train_config(family, data, family))
        torch.cuda.synchronize()
        train_fwd, eval_fwd = TRAIN_LAUNCHES[family]
        assert n() == tuple(TRAIN_STEPS * t + 2 * e for t, e in zip(train_fwd, eval_fwd))
    got = scalars(str(tmp_path), family)
    assert all(np.isfinite(got.get(k, float("nan"))) for k in ("train_loss", "val_loss", "test_loss")), got
    rng = np.random.default_rng(70)
    wavs = [rng.standard_normal(int(s * FAMILIES[family][2])).astype(np.float32) for s in EVAL_SECONDS]
    est = serve(from_pretrain(os.path.join(exp_dir, "best_model.pth"), device=cuda), wavs, use_bf16=True,
                device=cuda)
    assert all(e.shape == (2, len(w)) and np.isfinite(e).all() for e, w in zip(est, wavs))


def _train_paths(model, exp_dir, dev):
    """{path: (a context to run the step in, the forward)}: ``Trainer``'s
    bf16 forward (the module on bf16 casts of its f32 parameters), the same
    inside ``plain_versions()``, and its f32 forward."""
    import contextlib

    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer

    def forward(precision):
        return Trainer(exp_dir, precision=precision, device=dev,
                       logger=CSVLogger(os.path.join(exp_dir, "logs")))._make_forward(model)

    bf16 = forward("bfloat16")
    return {"kernel path": (contextlib.nullcontext, bf16), "plain bf16 path": (plain_versions, bf16),
            "f32 module": (contextlib.nullcontext, forward("float32"))}


@pytest.mark.parametrize("family", ["DPRNN", "DPTNet", "BSRNN", "Sandglasset", "DPRNNTasNet"])
def test_bf16_train_step_three_ways(cuda, tmp_path, family):
    """One bf16 train step at the family's published width, batch and
    segment through the kernels, inside ``plain_versions()`` and in f32: all
    gradients as one vector under PERF.md section 2's rule; the forward
    launches TRAIN_LAUNCHES' K4, K5 and K6 exactly, the backward none (it
    runs autograd through the plain versions)."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    name, cfg, sr, batch, secs, by_loss = FAMILIES[family]
    model = (tasnet_model(family, 51, cuda) if name == "TasNet" else seeded_model(name, cfg, sr, 51, cuda)).train()
    srcs = torch.from_numpy((0.3 * np.random.default_rng(52).standard_normal(
        (batch, 2, int(secs * sr)))).astype(np.float32)).to(cuda)
    mix = srcs.sum(1)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=by_loss)
    grads = {}
    for path, (context, forward) in _train_paths(model, str(tmp_path), cuda).items():
        with context(), counting() as n:
            loss = loss_fn(forward(mix), srcs)
            torch.cuda.synchronize()
            fwd = n()
            grads[path] = flat(torch.autograd.grad(loss, list(model.parameters())))
            torch.cuda.synchronize()
            assert (fwd, n()) == ((TRAIN_LAUNCHES[family][0],) * 2 if path == "kernel path" else ((0, 0, 0),) * 2)
    gradients_meet_the_rule(grads["kernel path"], grads["plain bf16 path"], grads["f32 module"])


def test_lrs3_train_step_through_the_kernels(cuda):
    """One train step of ConvTasNet-LRS3 at its width (B=2 x 2 s, 3
    speakers) through K2 + K3 against the same step through the chain's
    plain versions: each parameter tensor's gradient within rel-l2 0.1, the
    48 scalar PReLU slopes as one vector (each alone is a sum of B*T'*H
    terms that cancel, noise in bf16) within 0.1; all gradients under
    PERF.md section 2's rule against the f32 module."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.models.convtasnet import make_kernel_train_apply

    model = convtasnet_model(LRS3, 8, cuda).train()
    params = dict(model.named_parameters())
    rng = np.random.default_rng(9)
    mix = torch.from_numpy(rng.standard_normal((2, 2 * SR)).astype(np.float32)).to(cuda)
    srcs = torch.from_numpy(rng.standard_normal((2, 3, 2 * SR)).astype(np.float32)).to(cuda)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=True)

    def grads(fn, bf16):
        p = {k: v.to(torch.bfloat16) for k, v in params.items()} if bf16 else params
        loss = loss_fn(fn(p, mix.to(torch.bfloat16) if bf16 else mix).float(), srcs)
        return torch.autograd.grad(loss, list(params.values()))

    g_k = grads(make_kernel_train_apply(model), True)
    g_p = grads(make_kernel_train_apply(model, chain=k1.tcn_chain_reference), True)
    g_f = grads(lambda p, m: model(m), False)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / (a.float().norm() + 1e-9))

    slopes = [i for i, n in enumerate(params) if ".prelu" in n]
    for i, name in enumerate(params):
        if i not in slopes:
            assert rel(g_p[i], g_k[i]) < 0.1, (name, rel(g_p[i], g_k[i]))
    assert rel(flat([g_p[i] for i in slopes]), flat([g_k[i] for i in slopes])) < 0.1
    gradients_meet_the_rule(flat(g_k), flat(g_p), flat(g_f))


def test_two_step_entry_warm_starts_sm(cuda, tmp_path, monkeypatch):
    """The two-step entry at tdanet_lrs2's width (B=2 x 2 s x 16 kHz): step
    1 ``audio_train.main`` for two steps, then ``audio_train_twostep.main``
    warm-started from step 1's best_model.pth: one top-level module copied,
    the fresh model's ``sm`` parameters step 1's bit for bit after the
    merge, another parameter left as it was."""
    from audio_only_speech_separation_tpu_torch import audio_train, audio_train_twostep
    from audio_only_speech_separation_tpu_torch.models import from_pretrain

    data = str(tmp_path / "data")
    _manifests("TDANet", data, 92, TRAIN_STEPS)
    merged, real = {}, audio_train_twostep.update_parameter

    def recording(model, state, prefix="sm"):
        merged["copied"] = real(model, state, prefix)
        merged.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        return merged["copied"]

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(audio_train_twostep, "update_parameter", recording)
    pretrained = os.path.join(audio_train.main(_train_config("TDANet", data, "twostep1")), "best_model.pth")
    audio_train_twostep.main(_train_config("TDANet", data, "twostep2"), pretrained=pretrained)
    first = {k: v.cpu() for k, v in from_pretrain(pretrained, device=cuda).state_dict().items()}
    sm = [k for k in first if k.startswith("sm.")]
    assert merged["copied"] == 1 and sm and all(torch.equal(merged[k], first[k]) for k in sm)
    assert any(not torch.equal(merged[k], first[k]) for k in first if not k.startswith("sm."))


def test_wsj0_datamodule_training_step(cuda, tmp_path, monkeypatch):
    """One DPRNN step (dprnn_wsj0: full width, batch 2 x 4 s x 8 kHz)
    through ``audio_train.main`` from ``WSJ0DataModule`` manifests with 3
    validation and 1 test utterance: finite losses; K6 at the batch of 2
    (the step, a validation batch) and at the batches of 1, 12 launches a
    forward and no K4 or K5; K6 against its plain version at the shapes the
    run gave it."""
    from audio_only_speech_separation_tpu_torch import audio_train

    sr, batch, secs = FAMILIES["DPRNN"][2:5]
    n = int(secs * sr)
    data = str(tmp_path / "data")
    write_manifests(data, {"tr": [n] * batch, "cv": [n] * 3, "tt": [n]}, 88, sr=sr)
    config = _train_config("DPRNN", data, "wsj0")
    config["datamodule"]["data_name"] = "WSJ0DataModule"
    monkeypatch.chdir(tmp_path)
    with counting() as launched, recording_kernel_shapes() as shapes:
        audio_train.main(config, device=cuda)
        torch.cuda.synchronize()
        assert launched() == (0, 0, 4 * 12)  # the step, cv's batch of 2, cv's and tt's batches of 1
    got = scalars(str(tmp_path), "wsj0")
    assert all(np.isfinite(got.get(k, float("nan"))) for k in ("train_loss", "val_loss", "test_loss")), got
    kernels_match_plain_at(cuda, shapes)


def test_audio_train_main_under_a_process_group_of_one(cuda, tmp_path, monkeypatch):
    """``audio_train.main`` under a process group of one rank over NCCL
    (torchrun's environment) on the LRS3 config at full width with
    ``fused_forward``, three steps: K2 and K3 launched as counted, the
    manifests read through the native wav reader built into build/wavio,
    and rank 0's artifacts written."""
    import torch.distributed as dist

    from audio_only_speech_separation_tpu_torch import audio_train, parallel
    from audio_only_speech_separation_tpu_torch.data import native
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import fused_tcn_backward

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_ddp import free_port

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    data = str(tmp_path / "data")
    _manifests("ConvTasNet-LRS3", data, 86, 3)
    monkeypatch.chdir(tmp_path)
    reads = []
    assert parallel.init_distributed(device=cuda) == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        with noting_calls([(native, "read_window", lambda *a: reads.append(a))]), \
                counting((k1.fused_tcn_separator, fused_tcn_backward)) as n:
            exp_dir = audio_train.main(_train_config("ConvTasNet-LRS3", data, "lrs3"), device=cuda)
            torch.cuda.synchronize()
            assert n() == _chain_launches(3)
    finally:
        dist.destroy_process_group()
    lib = native.library_path()
    assert reads and lib.exists() and lib.parent.name == "wavio"
    assert {"conf.yml", "last.ckpt", "best_k_models.json", "best_model.pth"} <= set(os.listdir(exp_dir))


# ---------------------------------------------------------------------------
# Chunked separation, ConvTasNet's train forms, sequence parallelism, layers
# ---------------------------------------------------------------------------


def test_chunked_separation_at_published_width(cuda, monkeypatch):
    """``chunked_separate`` on a 20 s, 16 kHz mixture at convtasnet_lrs3's
    width, 8 s windows with a 1 s overlap: one K1 call over the 3 windows,
    the output (3, 20 s) within the 1.5x rule of f32 against the plain bf16
    path (K1's plain version); K1 within ``K1_PLAIN_REL`` of its plain
    version on the windows' frames."""
    import functools

    from audio_only_speech_separation_tpu_torch import serve as serve_module
    from audio_only_speech_separation_tpu_torch.models.convtasnet import inference_frames
    from audio_only_speech_separation_tpu_torch.utils.chunked_inference import chunked_separate

    model = convtasnet_model(LRS3, 89, cuda)
    wav = (0.3 * np.random.default_rng(89).standard_normal(20 * SR)).astype(np.float32)
    kw = dict(window_seconds=8.0, overlap_seconds=1.0, sample_rate=SR, device=cuda)
    with counting((k1.fused_convtasnet_separator,)) as n:
        got = chunked_separate(model, wav, use_bf16=True, **kw)
        assert n() == (k1.convtasnet_separator_launches(24),)
    ref = chunked_separate(model, wav, use_bf16=False, **kw)
    with monkeypatch.context() as mp:
        mp.setattr(serve_module, "fused_inference_forward", functools.partial(
            serve_module.fused_inference_forward, separator=k1.convtasnet_separator_reference))
        plain = chunked_separate(model, wav, use_bf16=True, **kw)
    assert got.shape == (3, len(wav))
    meets_the_rule(got, ref, plain)
    hop = 7 * SR
    windows = np.stack([np.pad(wav, (0, 2 * hop + 8 * SR - len(wav)))[k * hop : k * hop + 8 * SR] for k in range(3)])
    *w, dils = k1.pack_convtasnet_full_params(model.state_dict(), model.R, model.X, model.num_spks, device=cuda)
    with torch.no_grad():
        frames = inference_frames(model, torch.from_numpy(windows).to(cuda))
        _k1_within_its_plain_version(k1.fused_convtasnet_separator(frames, *w, dilations=dils, nspk=3),
                                     k1.convtasnet_separator_reference(frames, *w, dilations=dils, nspk=3))


def test_convtasnet_train_forms_at_published_width(cuda):
    """ConvTasNet-LRS3 at its width, B=4 x 2 s, one loss and its gradients
    five ways: the f32 module, the plain bf16 module (the Trainer's cast
    policy), the fused train form (K1 as the primal, one call of 50
    launches), the delayed form and the channels-last module on bf16 casts;
    each bf16 form's output and gradients under the 1.5x rule against f32
    with the plain bf16 module as the margin; K1 on the fused form's frames
    within ``K1_PLAIN_REL`` of its plain version."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet
    from audio_only_speech_separation_tpu_torch.models.convtasnet import (
        inference_frames,
        make_delayed_train_apply,
        make_fused_train_apply,
    )
    from audio_only_speech_separation_tpu_torch.train import bf16_forward

    model = convtasnet_model(LRS3, 91, cuda).train()
    cl = ConvTasNet(**LRS3, channels_last=True).to(cuda).train()
    cl.load_state_dict(model.state_dict())
    srcs = torch.from_numpy((0.3 * np.random.default_rng(92).standard_normal((4, 3, 2 * SR))).astype(
        np.float32)).to(cuda)
    mix = srcs.sum(1)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=True)
    arms = {"f32": (model, model), "plain bf16": (model, bf16_forward(model)),
            "fused": (model, bf16_forward(model, apply_fn=make_fused_train_apply(model))),
            "delayed": (model, bf16_forward(model, apply_fn=make_delayed_train_apply(model))),
            "channels last": (cl, bf16_forward(cl))}
    out = {}
    for name, (m, forward) in arms.items():
        with counting((k1.fused_convtasnet_separator,)) as n:
            est = forward(mix)
            grads = torch.autograd.grad(loss_fn(est, srcs), list(m.parameters()))
            torch.cuda.synchronize()
            assert n() == ((k1.convtasnet_separator_launches(24) if name == "fused" else 0),), name
        out[name] = (est.detach().float(), flat(grads))
    for name in ("fused", "delayed", "channels last"):
        meets_the_rule(out[name][0], out["f32"][0], out["plain bf16"][0], name)
        gradients_meet_the_rule(out[name][1], out["plain bf16"][1], out["f32"][1], name)
    params = {k: p.detach().to(torch.bfloat16) for k, p in model.named_parameters()}
    with torch.no_grad():
        *w, dils = (t.contiguous() if torch.is_tensor(t) else t for t in
                    k1.pack_convtasnet_full_params_differentiable(params, model.R, model.X, model.num_spks))
        frames = inference_frames(model, mix.to(torch.bfloat16))
        _k1_within_its_plain_version(k1.fused_convtasnet_separator(frames, *w, dilations=dils, nspk=3),
                                     k1.convtasnet_separator_reference(frames, *w, dilations=dils, nspk=3))


def test_sequence_parallel_kernel_path_on_two_gloo_ranks(cuda, tmp_path):
    """``sp`` = 2 as two gloo ranks on the one card against one process, at
    the published widths in bf16 through K4-K6: TasNet-DPRNN (dprnn_wsj0,
    B=2 x 4 s) forward and a train step, Sepformer (sepformer_base, B=1 x 2
    s x 16 kHz) forward, BSRNN (bsrnn_wsj0, B=1 x 4 s) forward and a train
    step.  Each rank's and the one process's output under the 1.5x rule
    against f32 with the plain bf16 path as the margin, and their gradients
    under PERF.md section 2's rule; each forward launches a kernel; each
    kernel against its plain version at every shape the ranks gave it."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_ddp import SP_CARD, launch, sp_card_batch, sp_card_model, sp_card_runs

    ranks = [res for res, _ in launch("sp_card", str(tmp_path), one_card=True, timeout=900)]
    one = sp_card_runs(cuda, str(tmp_path))
    shapes = {"K4": set(), "K4 packed": set(), "K5": set(), "K6": set()}
    for family, (_, _, _, step) in SP_CARD.items():
        model = sp_card_model(family, cuda)
        mix, srcs = sp_card_batch(family, cuda)
        _, plain, f32 = dualpath_paths(model)
        ref, pl = f32(mix), plain(mix)
        arms = {"one process": one[family], "rank 0": ranks[0][family], "rank 1": ranks[1][family]}
        for arm, r in arms.items():
            assert any(r["launches"]), (family, arm)
            meets_the_rule(r["out"].to(cuda), ref, pl, f"{family} {arm}")
            for g in shapes:
                shapes[g] |= {tuple(s) for s in r["shapes"][g]} | {tuple(s) for s in r.get("step_shapes", {}).get(g, [])}
        if step:
            grads = {}
            for path in ("plain bf16 path", "f32 module"):
                context, forward = _train_paths(model.train(), str(tmp_path / family), cuda)[path]
                with context():
                    loss = PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)(forward(mix), srcs)
                    grads[path] = flat(torch.autograd.grad(loss, list(model.parameters())))
            for arm, r in arms.items():
                gradients_meet_the_rule(r["grads"].to(cuda), grads["plain bf16 path"], grads["f32 module"],
                                        f"{family} {arm}")
        del model
    kernels_match_plain_at(cuda, shapes)


def _layer_cases():
    """(block, its input, K4, K5, K6 launches a call) of the layer library's
    kernel blocks at the published widths: DPRNN (N 64, hidden 128, 6
    repeats) on TasNet-DPRNN's chunked tensor at B=8 and B=1 x 2 s x 8 kHz
    (K6: the input is 64 wide), one-direction DPRNNBlock columns (K6, D =
    1), the 501-step LSTMs of width 128 over 8 sequences (K5, D = 2 and 1),
    DPRNNLinear (K6), TransformerBlockTF at Sepformer's intra shape (K4)."""
    from audio_only_speech_separation_tpu_torch import layers
    from audio_only_speech_separation_tpu_torch.ops.chunk import split_feature

    rng = np.random.default_rng(97)

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    chunks = {b: split_feature(rand((b, 64, 2001)), 100)[0].contiguous() for b in (8, 1)}
    S = chunks[8].shape[-1]
    torch.manual_seed(97)
    dprnn, one_way = layers.DPRNN(64, 128, n_repeats=6), layers.DPRNNBlock(64, 128, bidirectional=False)
    return {
        "DPRNN B=8": (dprnn, chunks[8], (0, 0, 12)), "DPRNN B=1": (dprnn, chunks[1], (0, 0, 12)),
        "DPRNNBlock one-direction B=8": (one_way, chunks[8], (0, 0, 2)),
        "DPRNNBlock one-direction B=1": (one_way, chunks[1], (0, 0, 2)),
        "LSTMBlockTF(128, 256)": (layers.LSTMBlockTF(128, 256), rand((8, 501, 128)), (0, 1, 0)),
        "SingleRNN(128, 256) one direction": (layers.SingleRNN(128, 256), rand((8, 501, 128)), (0, 1, 0)),
        "DPRNNLinear B=8": (layers.DPRNNLinear(64, 128, S), chunks[8], (0, 0, 1)),
        "TransformerBlockTF(256, 8, 1024)": (layers.TransformerBlockTF(256, 8, 1024), rand((68, 250, 256)),
                                             (1, 0, 0)),
    }


LAYER_CASES = ["DPRNN B=8", "DPRNN B=1", "DPRNNBlock one-direction B=8", "DPRNNBlock one-direction B=1",
               "LSTMBlockTF(128, 256)", "SingleRNN(128, 256) one direction", "DPRNNLinear B=8",
               "TransformerBlockTF(256, 8, 1024)"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_block_at_published_width(cuda, case):
    """The block in bf16 on the card: the launches stated, no plain version
    called, within the 1.5x rule of the f32 block against the same bf16
    block inside ``plain_versions()``; each kernel against its plain
    version at every shape the block gave it."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions

    block, x, launched = _layer_cases()[case]
    block = redrawn_norms(block.to(cuda).eval(), 98)
    bf = copy.deepcopy(block).to(torch.bfloat16)
    x = x.to(cuda)
    with torch.no_grad():
        with counting() as n, counting_plain_versions() as plain_calls, recording_kernel_shapes() as shapes:
            got = bf(x.to(torch.bfloat16))
            torch.cuda.synchronize()
            assert n() == launched and not any(plain_calls.values()), (n(), plain_calls)
        ref = block(x)
        with plain_versions():
            plain = bf(x.to(torch.bfloat16))
    meets_the_rule(got, ref, plain)
    kernels_match_plain_at(cuda, shapes)


# ---------------------------------------------------------------------------
# The measurement entry points, each once at its smallest count
# ---------------------------------------------------------------------------

# bench_all's kernel launches a call, by row (none for a row not named)
BENCH_ALL_LAUNCHES = {"ConvTasNet (lrs3) fused": {"K1": 50}, "TasNet-DPRNN (wsj0)": {"K6": 12},
                      "TasNet-DPTNet (wsj0)": {"K4": 12, "K6": 12}, "Sepformer (base)": {"K4": 32},
                      "TDANet (lrs2)": {"K4": 16}, "Sandglasset (defaults)": {"K4": 6, "K6": 6},
                      "DPRNNTasNet (legacy)": {"K6": 12}, "BSRNN (wsj0)": {"K6": 16},
                      "K2 alone (ConvTasNet lrs3 TCN chain)": {"K2": 49}}


@pytest.mark.parametrize("entry", ["bench_train", "bench_all", "measure_gates", "profile_trace_ops",
                                   "wav_file_separate"])
def test_measurement_entry_point_on_the_card(cuda, tmp_path, entry):
    """Each entry point runs to its end on the card.  ``bench_train --only
    ConvTasNet --iters 1``: all 8 ConvTasNet cases, none failing, K1, K2 and
    K3 launched as counted; ``bench_all --iters 1``: every row, each row's
    launches a call as stated; ``measure_gates``: every row timed (its
    misroutes are findings, not failures); ``profile_trace_ops sandglasset
    --iters 1``: the "kernels" dispatch, K4 and K6 in the device table and 6
    launches each in each of its 3 calls; ``wav_file_separate`` on a 4 s, 16
    kHz wav through ConvTasNet-LRS3: three finite files as long as the
    input."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
        fused_tcn_backward,
        tcn_backward_launches,
    )

    if entry == "bench_train":
        from audio_only_speech_separation_tpu_torch import bench_train

        with counting((k1.fused_convtasnet_separator, k1.fused_tcn_separator, fused_tcn_backward)) as n:
            results = bench_train.main(["--only", "ConvTasNet", "--iters", "1"])
            steps = bench_train.WARMUP + 1
            assert n() == (steps * k1.convtasnet_separator_launches(24), 2 * steps * k1.tcn_separator_launches(24),
                           2 * steps * tcn_backward_launches(24))
        assert len(results) == 8 and not [r for r in results if "failed" in r]
    elif entry == "bench_all":
        from audio_only_speech_separation_tpu_torch import bench_all

        rows = bench_all.main(["--iters", "1"])
        assert len(rows) == len(bench_all.CASES)
        for r in rows:
            assert {k: v for k, v in r["launches"].items() if v} == BENCH_ALL_LAUNCHES.get(r["name"], {}), r["name"]
    elif entry == "measure_gates":
        from audio_only_speech_separation_tpu_torch import measure_gates

        rows, _ = measure_gates.measure()
        assert len(rows) == len(measure_gates.ATTENTION) + len(measure_gates.LSTM)
        assert all(np.isfinite(v) and v > 0 for r in rows for v in [*r["times"].values(), *r["info"].values()])
    elif entry == "profile_trace_ops":
        from audio_only_speech_separation_tpu_torch import profile_trace_ops

        k4, _, k6 = counters()
        with counting((k4, k6)) as n:
            result = profile_trace_ops.main(["sandglasset", "--iters", "1", "--top", "15"])
            assert n() == (6 * 3, 6 * 3)
        names = " ".join(name for name, _, _ in result["ops"])
        assert result["dispatch"] == "kernels" and result["busy"] > 0 and result["wall"] > 0
        assert "attention_kernel" in names and "lstm_resident_kernel" in names
    else:
        from audio_only_speech_separation_tpu_torch.data.audio_io import read_wav, write_wav
        from audio_only_speech_separation_tpu_torch.utils.separator import wav_file_separate

        wav = (0.3 * np.random.default_rng(100).standard_normal(4 * SR)).astype(np.float32)
        write_wav(str(tmp_path / "mix.wav"), wav, SR)
        paths = wav_file_separate(convtasnet_model(LRS3, 101, cuda), str(tmp_path / "mix.wav"), str(tmp_path / "est"))
        outs = [read_wav(p) for p in paths]
        assert len(outs) == 3
        assert all(len(o) == len(wav) and np.isfinite(o).all() and np.abs(o).max() > 0 for o in outs)
