"""Helpers of the card tests (``test_torch_port_cuda*.py``) and of
``chip_smoke.py``, which re-exports them for the profile scripts: the published
configurations written out (the card machine has no YAML reader), seeded
models at those widths, the validator's 1.5x rule on outputs and on
gradients, the dual-path kernels' launch counters, a record of the shapes
the models' dispatch hands each kernel, each kernel against its plain
version at recorded shapes, and synthetic wav manifests.  Imports no JAX.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

SR, TSR = 16000, 8000
# configs/convtasnet_lrs3.yml:3-15 (audionet_config); 16 kHz, batch 12
LRS3 = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=3, activate="relu", causal=False,
            n_src=3, sample_rate=SR)
TRAIN_B = 12
# configs/dptnet_wsj0.yml and configs/dprnn_wsj0.yml audionet_config (they differ only in ``module``); 8 kHz
WSJ0_TASNET = dict(enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2, group_size=1,
                   block_size=100, unfold=False)
# configs/sepformer_base.yml audionet_config; 16 kHz
SEPFORMER = dict(encoder_kernel_size=16, encoder_in_nchannels=1, encoder_out_nchannels=256,
                 masknet_chunksize=250, masknet_numlayers=2, masknet_norm="gLN", masknet_numspks=2,
                 intra_numlayers=8, inter_numlayers=8, intra_nhead=8, inter_nhead=8, intra_dffn=1024,
                 inter_dffn=1024, intra_use_positional=True, inter_use_positional=True,
                 intra_norm_before=True, inter_norm_before=True, intra_causal=False, inter_causal=False)
SEPFORMER_K4 = 2 * (8 + 8)  # K4's packed entry a call: 2 dual blocks x (8 intra + 8 inter) attentions
SEPFORMER_K8 = 2 * 2 * (1 + 2 * 8)  # K8 a call: 4 stacks x (positions + 2 sites a layer)
# configs/bsrnn_wsj0.yml audionet_config; 8 kHz (8 bands)
BSRNN_WSJ0 = dict(win=256, stride=64, feature_dim=128, num_spks=2, num_layer=1, num_repeat=8, context=0,
                  dropout=0.0, bi_comm=True)
# configs/tdanet_lrs2.yml and configs/afrcnn_lrs2.yml audionet_config; 16 kHz
TDANET_LRS2 = dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=5, enc_kernel_size=4,
                   num_sources=2)
AFRCNN_LRS2 = dict(out_channels=512, in_channels=512, num_blocks=16, upsampling_depth=5, enc_kernel_size=1,
                   num_sources=2)
TDANET_K4 = 16  # K4 a module-path TDANet call: one global attention a block
# Sandglasset at its constructor defaults (models/sandglasset.py), 8 kHz as
# bench_all runs it: 2 s give S = 131 chunks of K = 250, D 128, 8 heads of
# dh 16, 6 blocks pooling 1, 4, 16, 16, 4, 1
SANDGLASSET = dict(n_feats=64, bn_chan=128, hid_size=128, chunk_size=250, hop_size=125, n_repeats=6, n_head=8,
                   kernel_size=2)
# DPRNNTasNet at its defaults (models/dprnn_old.py), 8 kHz as bench_all runs
# it: 2006 frames at 2 s, 128 chunks of 32 an utterance
DPRNN_TASNET = dict(feature_dim=128, hidden_dim=256, win=4, layer=6, segment_size=32)
EVAL_SECONDS = (1.3, 2.0, 4.0, 6.5, 8.0)  # utterances of the eval CLI tests
# Each family's configs/*.yml as the card tests run it: registry name,
# audionet config, sample rate, train batch, segment (s), threshold_byloss of
# the train loss; "TasNet DPTNet G2" is the wsj0 DPTNet with group size 2
FAMILIES = {
    "ConvTasNet-LRS3": ("ConvTasNet", {k: v for k, v in LRS3.items() if k != "sample_rate"}, SR, TRAIN_B, 2.0,
                        True),
    "DPRNN": ("TasNet", dict(WSJ0_TASNET, module="DPRNN"), TSR, 2, 4.0, False),
    "DPTNet": ("TasNet", dict(WSJ0_TASNET, module="DPTNet"), TSR, 2, 4.0, False),
    "BSRNN": ("BSRNN", BSRNN_WSJ0, TSR, 4, 4.0, False),
    "Sepformer": ("Sepformer", SEPFORMER, SR, 1, 2.0, True),
    "TDANet": ("TDANet", TDANET_LRS2, SR, 2, 2.0, True),
    "AFRCNN": ("AFRCNN", AFRCNN_LRS2, SR, 6, 2.0, True),
    "Sandglasset": ("Sandglasset", SANDGLASSET, TSR, 2, 2.0, False),
    "DPRNNTasNet": ("DPRNNTasNet", DPRNN_TASNET, TSR, 2, 2.0, False),
    "TasNet DPTNet G2": ("TasNet", dict(WSJ0_TASNET, module="DPTNet", group_size=2), TSR, 2, 2.0, False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references are full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def counters():
    """The launch counters of K4 (both entries), K5 and K6."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import k4_launches
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import fused_bilstm, resident_bilstm

    return k4_launches, fused_bilstm, resident_bilstm


@contextlib.contextmanager
def counting(counted=None):
    """Inside the block, the launches of ``counted`` (default K4, K5, K6)
    since the block began: ``with counting() as n: ...; n()``."""
    counted = counted or counters()
    before = [c.launches for c in counted]
    yield lambda: tuple(c.launches - b for c, b in zip(counted, before))


def max_err(a, b) -> float:
    return float((torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs().max())


def meets_the_rule(got, ref, plain, label=""):
    """The JAX package's validator rule (scripts/validate_pallas.py:148):
    the kernel path's error against f32 within 1.5 x the plain bf16 path's
    + 1e-3; the output finite and of the f32 output's shape."""
    got, ref, plain = (torch.as_tensor(t) for t in (got, ref, plain))
    assert got.shape == ref.shape == plain.shape and bool(torch.isfinite(got.float()).all()), label
    err, plain_err = max_err(got, ref), max_err(plain, ref)
    assert err <= 1.5 * plain_err + 1e-3, (label, err, plain_err)


def gradients_meet_the_rule(g, g_plain, g_f32, label=""):
    """PERF.md section 2's rule on all gradients as one vector:
    |g - g_f32| <= 1.5 |g_plain - g_f32| + 1e-3 |g_f32|."""
    e, e_plain, n = (float(v.norm()) for v in (g - g_f32, g_plain - g_f32, g_f32))
    assert bool(torch.isfinite(g).all()) and e <= 1.5 * e_plain + 1e-3 * n, (label, e, e_plain, n)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.flatten().float() for t in tensors])


def rand_maker(seed, dev):
    """rand(shape, scale, dtype): seeded normal tensors on ``dev``."""
    rng = np.random.default_rng(seed)

    def rand(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)

    return rand


def waves(dev, seed, B, T):
    """Seeded unit-normal [B, T] on ``dev``."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((B, T)).astype(np.float32)).to(dev)


def convtasnet_model(cfg, seed, dev):
    """ConvTasNet of ``cfg`` on ``dev`` in eval mode: the seeded init with
    its norm affines and bottleneck moved and its PReLU slopes redrawn, some
    above 1."""
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet

    m = ConvTasNet(**cfg, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("prelu1.weight") or name.endswith("prelu2.weight"):
                p.fill_(float(rng.uniform(0.05, 1.5)))
            elif "norm" in name or "bottleneck.0" in name:
                p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.to(dev).eval()


def tasnet_model(module, seed, dev):
    """A wsj0 TasNet (``module`` core) at full width and depth: the seeded
    init, with the norm affines and biases redrawn."""
    from audio_only_speech_separation_tpu_torch.models import TasNet

    m = TasNet(**WSJ0_TASNET, sample_rate=TSR, module=module, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if ("norm" in name or name.startswith("bottleneck.0")) and p.ndim == 1:
                p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.to(dev).eval()


def redrawn_norms(m, seed):
    """``m`` with every gLN and LayerNorm affine moved by seeded 0.2-scaled
    normal noise."""
    from audio_only_speech_separation_tpu_torch.ops.norms import GlobalLayerNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (GlobalLayerNorm, torch.nn.LayerNorm)):
                for p in (mod.weight, mod.bias):
                    p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)).to(p.device))
    return m


def seeded_model(name, cfg, sr, seed, dev):
    """The registry's ``name`` at ``cfg`` with seeded weights and redrawn
    norms, in eval mode."""
    from audio_only_speech_separation_tpu_torch import models

    m = models.get(name)(**cfg, sample_rate=sr, generator=torch.Generator().manual_seed(seed))
    return redrawn_norms(m, seed).to(dev).eval()


def dualpath_paths(model):
    """(kernel path, plain bf16 path, f32 module) of a model ``serve``
    serves as "kernels": ``Server``'s forward, the same inside
    ``plain_versions()``, and the f32 module."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.serve import Server

    server = Server(model, True, next(model.parameters()).device)
    assert server.dispatch == "kernels", server.dispatch

    def plain(x):
        with plain_versions():
            return server.forward(x)

    def f32(x):
        with torch.no_grad():
            return model(x)

    return server.forward, plain, f32


@contextlib.contextmanager
def noting_calls(targets):
    """Each (module, name, note) of ``targets``: inside the block,
    module.name calls note(*args) and then what it was."""
    originals = [getattr(mod, name) for mod, name, _ in targets]

    def noted(fn, note):
        def run(*args):
            note(*args)
            return fn(*args)
        return run

    for (mod, name, note), fn in zip(targets, originals):
        setattr(mod, name, noted(fn, note))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(targets, originals):
            setattr(mod, name, fn)


def _dispatch_modules():
    from audio_only_speech_separation_tpu_torch.ops import attention, rnn

    return attention, rnn


@contextlib.contextmanager
def counting_plain_versions():
    """{"K4", "K5", "K6": calls} of the kernels' plain versions made through
    the models' dispatch (``ops/attention.py``, ``ops/rnn.py``) inside the
    block: a kernel path inside the envelopes makes none."""
    attention, rnn = _dispatch_modules()
    calls = {"K4": 0, "K5": 0, "K6": 0}

    def count(label):
        return lambda *args: calls.__setitem__(label, calls[label] + 1)

    with noting_calls([(attention, "attention_bdt_reference", count("K4")),
                       (attention, "attention_packed_reference", count("K4")),
                       (rnn, "bilstm_reference", count("K5")), (rnn, "resident_bilstm_reference", count("K6"))]):
        yield calls


@contextlib.contextmanager
def recording_kernel_shapes():
    """{"K4": {[BH, dh, T]}, "K4 packed": {(B, T, 3E, heads)}, "K5": {(T, D,
    B, H)}, "K6": {(T, B, Din, H, D)}}: the shapes the models' dispatch
    hands each kernel's wrapper inside the block; a call of K4's packed
    entry is noted under "K4" too, as its [BH, dh, T]."""
    attention, rnn = _dispatch_modules()
    shapes = {"K4": set(), "K4 packed": set(), "K5": set(), "K6": set()}

    def k4_packed(qkv, heads):
        B, T, E3 = qkv.shape
        shapes["K4"].add((B * heads, E3 // (3 * heads), T))
        shapes["K4 packed"].add((B, T, E3, heads))

    def k5(xw, w_hh):
        T, D, B, gates = xw.shape
        shapes["K5"].add((T, D, B, gates // 4))

    def k6(x, w_ih, w_hh, bias):
        B, T, Din = x.shape
        shapes["K6"].add((T, B, Din, w_hh.shape[1], w_hh.shape[0]))

    with noting_calls([(attention, "fused_attention_bdt", lambda q, k, v: shapes["K4"].add(tuple(q.shape))),
                       (attention, "fused_attention_packed", k4_packed),
                       (rnn, "fused_bilstm", k5), (rnn, "resident_bilstm", k6)]):
        yield shapes


def kernel_cases(dev, shapes, seed=91):
    """(kernel, shape, wrapper, plain version, inputs, max abs limit) of K4
    (both entries: "attention_bdt", "attention_packed"), K5
    ("lstm_recurrence") and K6 ("lstm_resident") at every shape of
    ``shapes`` (``recording_kernel_shapes``' record), on the JAX validator's
    inputs: unit-normal q, k, v (limit 2e-2); xw * 0.3, w_hh * 0.05 for K5
    and x * 0.5, w_ih * 0.08, w_hh * 0.05, an f32 bias * 0.05 for K6 (limit
    1e-2)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        attention_packed_reference,
        fused_attention_bdt,
        fused_attention_packed,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        resident_bilstm,
        resident_bilstm_reference,
    )

    rand = rand_maker(seed, dev)
    cases = [("attention_bdt", s, fused_attention_bdt, attention_bdt_reference, [rand(s) for _ in range(3)], 2e-2)
             for s in sorted(shapes.get("K4", ()))]
    cases += [("attention_packed", (B, T, E3, h), lambda a, h=h: fused_attention_packed(a, h),
               lambda a, h=h: attention_packed_reference(a, h), [rand((B, T, E3))], 2e-2)
              for B, T, E3, h in sorted(shapes.get("K4 packed", ()))]
    cases += [("lstm_recurrence", (T, D, B, H), fused_bilstm, bilstm_reference,
               [rand((T, D, B, 4 * H), 0.3), rand((D, H, 4 * H), 0.05)], 1e-2)
              for T, D, B, H in sorted(shapes.get("K5", ()))]
    cases += [("lstm_resident", (T, B, Din, H, D), resident_bilstm, resident_bilstm_reference,
               [rand((B, T, Din), 0.5), rand((D, Din, 4 * H), 0.08), rand((D, H, 4 * H), 0.05),
                rand((D, 4 * H), 0.05, torch.float32)], 1e-2)
              for T, B, Din, H, D in sorted(shapes.get("K6", ()))]
    return cases


def kernels_match_plain_at(dev, shapes, seed=91):
    """Each of ``kernel_cases``: the wrapper within its limit of its plain
    version, two wrapper runs bit-identical."""
    for _, shape, kernel, plain, args, limit in kernel_cases(dev, shapes, seed):
        with torch.no_grad():
            got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and bool(torch.isfinite(got.float()).all()), shape
        assert max_err(got, want) < limit, (shape, max_err(got, want))


def write_manifests(root, lengths_per_split, seed, mix="mix", n_src=2, sr=TSR):
    """Synthetic manifests (``<mix>.json``, s1.json ..., lists of [wav path,
    samples]) of random speakers and their sum; ``lengths_per_split`` maps
    each split to its utterances' lengths in samples.  LRS3's layout is
    mix_noise and 3 speakers."""
    from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    for split, lengths in lengths_per_split.items():
        infos = {c: [] for c in (mix, *(f"s{j + 1}" for j in range(n_src)))}
        for c in infos:
            os.makedirs(os.path.join(root, split, c), exist_ok=True)
        for i, n in enumerate(lengths):
            srcs = (0.1 * rng.standard_normal((n_src, n))).astype(np.float32)
            for c, wav in zip(infos, (srcs.sum(0), *srcs)):
                path = os.path.join(root, split, c, f"u{i}.wav")
                write_wav(path, wav, sr)
                infos[c].append([path, n])
        for c, lst in infos.items():
            with open(os.path.join(root, split, f"{c}.json"), "w") as f:
                json.dump(lst, f)


def scalars(work, exp_name):
    """{name: last value} of a training run's scalars.csv, the run started
    in ``work``."""
    with open(os.path.join(work, "Experiments", "tensorboard_logs", exp_name, "scalars.csv")) as f:
        return {row.split(",")[1]: float(row.split(",")[2]) for row in f.read().splitlines()[1:]}
