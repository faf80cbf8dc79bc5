"""Training every served family with the port on the CPU, against the JAX
package: the bf16 cast policy of ``Trainer`` (the JAX Trainer's), seeded
dropout, each family's f32 loss and gradients against
``jax.value_and_grad`` of the JAX model in train mode, and one
``audio_train.main`` epoch of each family that serves its best_model.pth.

The kernels K4-K6 run here as their plain versions; on the card
``test_torch_port_cuda_paths.py`` drives the same train steps through
them."""

import copy
import json
import os
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_only_speech_separation_tpu.models as jmodels
from audio_only_speech_separation_tpu import losses as jlosses
from audio_only_speech_separation_tpu.models import tdanet as jax_tdanet
from audio_only_speech_separation_tpu.train.trainer import Trainer as JTrainer
from audio_only_speech_separation_tpu.utils.torch_import import convert, convert_tasnet
from audio_only_speech_separation_tpu_torch import audio_train, losses, models, serve
from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav
from audio_only_speech_separation_tpu_torch.models import tdanet as port_tdanet
from audio_only_speech_separation_tpu_torch.ops import dropout as port_dropout
from audio_only_speech_separation_tpu_torch.train import Trainer, loggers
from audio_only_speech_separation_tpu_torch.utils.parser_utils import split_dotted_overrides
from torch_port_helpers import perturbed, state_numpy

torch.set_num_threads(2)

# Small widths and depth of every served family but ConvTasNet (whose
# training test_torch_port_train{,_kernels}.py cover): the port's and the
# JAX package's constructor arguments, the sample rate, and the keyword
# arguments of the JAX package's ``convert`` for the model.
SR8, SR16 = 8000, 16000
TASNET = dict(enc_dim=32, bn_dim=32, hidden_dim=32, win=16, layer=2, num_spk=2, block_size=24)
FAMILIES = {
    "DPRNN": ("TasNet", dict(TASNET, module="DPRNN"), SR8, dict(module="DPRNN", layer=2)),
    "DPTNet": ("TasNet", dict(TASNET, module="DPTNet"), SR8, dict(module="DPTNet", layer=2)),
    "BSRNN": ("BSRNN", dict(win=256, stride=64, feature_dim=16, num_spks=2, num_layer=1, num_repeat=2),
              SR8, {}),
    "Sepformer": ("Sepformer", dict(encoder_kernel_size=16, encoder_out_nchannels=32, masknet_chunksize=20,
                                    masknet_numlayers=1, masknet_numspks=2, intra_numlayers=1,
                                    inter_numlayers=1, intra_nhead=4, inter_nhead=4, intra_dffn=64,
                                    inter_dffn=64),
                  SR8, dict(masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1)),
    "TDANet": ("TDANet", dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
                              enc_kernel_size=4, num_sources=2), SR16, {}),
    "AFRCNN": ("AFRCNN", dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
                              enc_kernel_size=1, num_sources=2), SR16, {}),
}
# [B, T] of each family's parity batch
SHAPES = {"DPRNN": (2, 1600), "DPTNet": (2, 1600), "BSRNN": (2, 1600), "Sepformer": (2, 1600),
          "TDANet": (1, 3200), "AFRCNN": (2, 3200)}


def port_model(family, seed, **overrides):
    name, cfg, sr, _ = FAMILIES[family]
    cfg = dict(cfg, sample_rate=sr, **overrides)
    return perturbed(models.get(name)(**cfg, generator=torch.Generator().manual_seed(seed)), seed)


def jax_model(family, **overrides):
    name, cfg, sr, _ = FAMILIES[family]
    return getattr(jmodels, name)(**dict(cfg, sample_rate=sr, **overrides))


def to_jax(family, model, sd):
    """A port state dict (name -> numpy) of ``model`` in the JAX package's
    parameter tree, through the JAX package's converters."""
    name = FAMILIES[family][0]
    if name == "TasNet":
        return convert_tasnet(sd, **FAMILIES[family][3])
    if name == "BSRNN":
        return convert(name, sd, nband=model.nband, num_repeat=model.num_repeat,
                       num_layer=model.num_layer, bi_comm=model.bi_comm)
    if name in ("TDANet", "AFRCNN"):
        return convert(name, sd, upsampling_depth=model.upsampling_depth)
    return convert(name, sd, **FAMILIES[family][3])


def jax_params(family, model):
    """The JAX package's parameter tree of the port ``model``'s weights."""
    return to_jax(family, model, state_numpy(model))


def grads_as_jax_tree(family, model, grads):
    """The port's gradients (name -> tensor) in the JAX package's tree.
    ``convert`` sums an LSTM's bias_ih and bias_hh into one bias, whose
    gradient each of the two carries: bias_hh's are zeroed first (and
    checked equal to bias_ih's), so every other leaf is a layout move."""
    g = {}
    for name, t in grads.items():
        t = t.detach().float().numpy()
        if ".bias_hh_l0" in name:
            np.testing.assert_array_equal(t, g[name.replace("bias_hh", "bias_ih")])
            t = np.zeros_like(t)
        g[name] = t
    return to_jax(family, model, g)


def port_grads(model):
    """name -> gradient; zeros for a parameter the forward never reaches
    (TDANet's deepest fusion, which the reference's collapse skips)."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def batch(seed, B, T, n_src=2):
    rng = np.random.default_rng(seed)
    sources = (0.3 * rng.standard_normal((B, n_src, T))).astype(np.float32)
    return sources.sum(1), sources


class _NoDropout(flax_nn.Module):
    """flax's ``nn.Dropout`` at rate 0: the JAX TDANet builds its dropout
    and DropPath at 0.1 with no argument to change it."""

    rate: float = 0.0
    deterministic: bool = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """Dropout and DropPath at rate 0 in the JAX package, train mode kept."""
    monkeypatch.setattr(flax_nn, "Dropout", _NoDropout)
    monkeypatch.setattr(jax_tdanet, "DropPath", lambda rate, name=None: _NoDropout(name=name))


def bf16_forward(model, tmp_path, precision="bfloat16"):
    """The forward that ``Trainer`` trains ``model`` with at ``precision``."""
    trainer = Trainer(str(tmp_path / "exp"), precision=precision, device="cpu",
                      logger=loggers.CSVLogger(str(tmp_path / "logs")))
    return trainer._make_forward(model)


def without_dropout(model):
    """The port ``model`` with every Dropout and DropPath at rate 0, in train
    mode (the parity tests' setting: the two packages' masks differ)."""
    for m in model.modules():
        if isinstance(m, port_dropout._Draws):
            m.rate = 0.0
    return model.train()


# ---------------------------------------------------------------------------
# Part 0: the bf16 cast policy and seeded dropout
# ---------------------------------------------------------------------------


def test_bf16_train_forward_equals_the_served_bf16_copy(tmp_path, monkeypatch):
    """With precision="bfloat16" the train forward of a DPRNN in eval mode
    is the forward of the bf16 copy that ``serve.Server`` builds for
    "kernels" (forced here: off the card ``choose_dispatch`` gives
    "eager"), bit for bit.  The copy casts every float buffer too; DPRNN
    has none, so nothing is left out of the comparison.  In train mode the
    f32 parameters' gradients are the bf16 copy's gradients cast to f32,
    bit for bit: forward and backward run in bf16, the f32 masters only
    receive."""
    model = port_model("DPRNN", 1).eval()
    assert not list(model.buffers())
    mix, sources = (torch.from_numpy(a) for a in batch(2, 2, 1200))
    forward = bf16_forward(model, tmp_path)
    monkeypatch.setattr(serve, "choose_dispatch", lambda *args: "kernels")
    server = serve.Server(model, use_bf16=True, device="cpu")
    assert server.model is not model and next(server.model.parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        got, want = forward(mix), server.forward(mix)
    assert got.dtype == torch.float32 and want.dtype == torch.bfloat16
    assert torch.equal(got, want.float())

    loss_fn = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")
    model.train()
    copy_bf16 = server.model.train()
    loss_fn(forward(mix), sources).backward()
    loss_fn(copy_bf16(mix.to(torch.bfloat16)).float(), sources).backward()
    for (name, p), q in zip(model.named_parameters(), copy_bf16.parameters()):
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, q.grad.float()), name


def _jax_trainer_grads(jm, params, mix, sources, precision, tmp_path):
    """The JAX Trainer's own train step at ``precision``, with SGD at rate 1
    as the optimizer: its gradients are the parameters' change."""
    loss = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, pit_from="pw_mtx")
    system = types.SimpleNamespace(audio_model=jm, optimizer=optax.sgd(1.0),
                                   loss_func={"train": loss, "val": loss})
    trainer = JTrainer(str(tmp_path / f"jax_{precision}"), precision=precision, donate=False,
                       logger=types.SimpleNamespace(close=lambda: None))
    train_step, _ = trainer._build_steps(system)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    new, _, lval = train_step(p, system.optimizer.init(p), (jnp.asarray(mix), jnp.asarray(sources)), 0)
    return float(lval), leaves(jax.tree_util.tree_map(lambda a, b: a - b, p, new))


def test_bf16_train_step_gradients_match_the_jax_trainer(tmp_path):
    """An AFRCNN's bf16 train step, port against the JAX Trainer's own
    (``_build_steps``) on shared weights.  The two round at other points
    inside an op (convolutions, reductions), so the bound is the rule of
    PERF.md section 2 with the JAX bf16 gradients in the plain path's place:
    all gradients as one vector, |g_port - g_jax_f32| <= 1.5 |g_jax_bf16 -
    g_jax_f32| + 1e-3 |g_jax_f32|, and the loss within 1e-3 relative of the
    JAX bf16 loss.  (The JAX package's bf16 backward of the models with
    LSTMs, and of Sepformer, does not run on XLA's CPU runtime, which lacks
    a bf16 x bf16 -> f32 dot there.)"""
    model = port_model("AFRCNN", 3)
    jm, params = jax_model("AFRCNN"), jax_params("AFRCNN", model)
    mix, sources = batch(4, *SHAPES["AFRCNN"])
    forward = bf16_forward(model.train(), tmp_path)
    loss_fn = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")
    loss = loss_fn(forward(torch.from_numpy(mix)), torch.from_numpy(sources))
    loss.backward()
    port = leaves(grads_as_jax_tree("AFRCNN", model, port_grads(model)))
    l_b, jb = _jax_trainer_grads(jm, params, mix, sources, "bfloat16", tmp_path)
    _, jf = _jax_trainer_grads(jm, params, mix, sources, "float32", tmp_path)
    assert set(port) == set(jb)
    flat = {n: np.concatenate([g[k].ravel() for k in sorted(g)]) for n, g in
            (("port", port), ("bf16", jb), ("f32", jf))}
    e_port = np.linalg.norm(flat["port"] - flat["f32"])
    e_jax = np.linalg.norm(flat["bf16"] - flat["f32"])
    assert abs(float(loss.detach()) - l_b) <= 1e-3 * abs(l_b)
    assert 0 < e_port <= 1.5 * e_jax + 1e-3 * np.linalg.norm(flat["f32"]), (e_port, e_jax)


def _manifests(root, sr, seconds=0.3, splits=(("tr", 4), ("cv", 2), ("tt", 2))):
    """LRS2-layout manifests of two random speakers and their sum."""
    rng = np.random.default_rng(5)
    n = int(seconds * sr)
    for split, count in splits:
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            os.makedirs(os.path.join(root, split, c), exist_ok=True)
        for i in range(count):
            s = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                path = os.path.join(root, split, c, f"u{i}.wav")
                write_wav(path, wav, sr)
                infos[c].append([path, n])
        for c, lst in infos.items():
            with open(os.path.join(root, split, f"{c}.json"), "w") as f:
                json.dump(lst, f)
    return root


def train_config(family, root, sr, exp_name, precision="bfloat16", seed=None, **overrides):
    name, cfg, _, _ = FAMILIES[family]
    training = {"epochs": 1, "precision": precision,
                "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min", "patience": 10}}
    if seed is not None:
        training["seed"] = seed
    pit = {"loss_func": "PITLossWrapper", "config": {"pit_from": "pw_mtx", "threshold_byloss": False}}
    return {
        "audionet": {"audionet_name": name, "audionet_config": dict(cfg, **overrides)},
        "loss": {"train": dict(pit, sdr_type="pairwise_neg_snr"),
                 "val": dict(pit, sdr_type="pairwise_neg_sisdr")},
        "training": training,
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 5, "factor": 0.5}},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": dict(
            train_dir=os.path.join(root, "tr"), valid_dir=os.path.join(root, "cv"),
            test_dir=os.path.join(root, "tt"), n_src=2, sample_rate=sr, segment=0.25, batch_size=2,
            num_workers=2)},
        "exp": {"exp_name": exp_name},
    }


@pytest.fixture
def no_tensorboard(monkeypatch):
    """CSV logging only: importing tensorboard here pulls in TensorFlow."""
    def unavailable(*args, **kwargs):
        raise ImportError("tensorboard not used in this test")

    monkeypatch.setattr(loggers, "TensorBoardLogger", unavailable)


def scalars(cwd, exp_name):
    path = os.path.join(cwd, "Experiments", "tensorboard_logs", exp_name, "scalars.csv")
    with open(path) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    return {r[1]: float(r[2]) for r in rows}


def test_seeded_dropout_repeats_a_run(tmp_path, monkeypatch, no_tensorboard):
    """Two ``audio_train.main`` runs of a small Sepformer with dropout 0.1
    and the same seed log the same train_loss, bit for bit; a third run with
    another seed logs a different one.  Every mask comes from the modules'
    own generators, which ``Trainer.fit`` seeds from ``training.seed``."""
    root = _manifests(str(tmp_path / "data"), SR8)
    monkeypatch.chdir(tmp_path)
    got = {}
    for run, seed in (("a", 7), ("b", 7), ("c", 8)):
        torch.manual_seed(100 + ord(run))  # the process-wide generator must not matter
        audio_train.main(train_config("Sepformer", root, SR8, f"sep_{run}", precision="float32",
                                      seed=seed, dropout=0.1), device="cpu")
        got[run] = scalars(str(tmp_path), f"sep_{run}")["train_loss"]
    assert np.isfinite(got["a"]) and got["a"] == got["b"] and got["c"] != got["a"], got


def test_dropout_module_draws_from_its_own_seeded_generator():
    """``Dropout`` zeroes about ``rate`` of the elements and scales the rest,
    is the identity in eval mode, repeats after ``seed_generators``, and
    keeps no state in the state dict; a deep copy starts again from the
    module's seed."""
    x = torch.ones(64, 32)
    model = torch.nn.Sequential(port_dropout.Dropout(0.25), port_dropout.DropPath(0.5))
    assert model.state_dict() == {} and model.eval()(x) is x
    assert port_dropout.seed_generators(model.train(), 3) == 2
    first = model(x)
    copied = copy.deepcopy(model)
    port_dropout.seed_generators(model, 3)
    assert torch.equal(model(x), first)
    kept = first != 0
    assert torch.equal(first[kept], torch.full_like(first[kept], 1.0) / 0.75 / 0.5)
    assert 0.15 < float((first == 0).float().mean()) < 0.85
    assert copied[0].generator is None
    port_dropout.seed_generators(model, 4)
    assert not torch.equal(model(x), first)


# ---------------------------------------------------------------------------
# Every family: f32 gradients against the JAX package, and one epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_f32_loss_and_gradients_match_jax(family, no_jax_dropout):
    """The port's f32 PIT loss (pairwise neg-SNR) and every gradient against
    ``jax.value_and_grad`` of the JAX model's ``apply(train=True)`` on
    shared weights, with dropout and drop path at 0 in both: the loss within
    1e-5 relative, each parameter's gradient within 1e-3 relative l2 of
    its own norm or 1e-5 of the norm of all of them (a few gradients, such
    as a softmax-shifted bias's, are near zero), all of them together
    within 1e-4.  TDANet attends over the batch axis, so it runs one
    utterance."""
    overrides = dict(dropout=0.0) if family == "Sepformer" else {}
    model = without_dropout(port_model(family, 11, **overrides))
    jm, params = jax_model(family, **overrides), jax_params(family, model)
    mix, sources = batch(12, *SHAPES[family])
    jloss = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, pit_from="pw_mtx")
    key = jax.random.PRNGKey(0)

    def jax_loss(p):
        return jloss(jm.apply(p, jnp.asarray(mix), train=True, rngs={"dropout": key}), jnp.asarray(sources))

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, params))
    loss_fn = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")
    loss = loss_fn(model(torch.from_numpy(mix)), torch.from_numpy(sources))
    loss.backward()
    got = leaves(grads_as_jax_tree(family, model, port_grads(model)))
    want = leaves(want)
    assert set(got) == set(want)
    assert sum(v.size for v in want.values()) == sum(
        p.numel() for k, p in model.named_parameters() if ".bias_hh_l0" not in k)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    total = np.sqrt(sum(np.sum(v * v) for v in want.values()))
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= max(1e-3 * np.linalg.norm(want[k]), 1e-5 * total), (k, err, np.linalg.norm(want[k]))
    flat = [np.concatenate([g[k].ravel() for k in sorted(want)]) for g in (got, want)]
    assert rel_l2(*flat) <= 1e-4


@pytest.mark.parametrize("family", list(FAMILIES))
def test_audio_train_main_trains_a_bf16_epoch_and_serves(family, tmp_path, monkeypatch, no_tensorboard):
    """One bf16 epoch (two steps) of ``audio_train.main`` on the CPU logs
    finite losses and writes best_model.pth, which ``from_pretrain`` loads
    and ``serve`` separates with."""
    sr = FAMILIES[family][2]
    root = _manifests(str(tmp_path / "data"), sr)
    monkeypatch.chdir(tmp_path)
    exp_dir = audio_train.main(train_config(family, root, sr, family), device="cpu")
    got = scalars(str(tmp_path), family)
    assert all(np.isfinite(got[k]) for k in ("train_loss", "val_loss", "test_loss")), got
    model = models.from_pretrain(os.path.join(exp_dir, "best_model.pth"), device="cpu")
    assert type(model).__name__ == FAMILIES[family][0]
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32) for i, n in
            enumerate((int(0.3 * sr), int(0.45 * sr)))]
    for est, w in zip(serve.serve(model, wavs, use_bf16=True, device="cpu"), wavs):
        assert est.shape == (2, len(w)) and np.isfinite(est).all()


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_trainer_never_takes_the_tdanet_fast_path(precision, tmp_path, monkeypatch):
    """``Trainer`` trains and evaluates a weight-shared TDANet, the model
    that ``serve`` sends to the analytic fast path, on its module path:
    the fast path raises here if anything calls it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fast path was taken")

    monkeypatch.setattr(port_tdanet, "fast_inference_forward", refuse)
    monkeypatch.setattr(port_tdanet, "_uconv_fast", refuse)
    model = port_model("TDANet", 13)
    assert port_tdanet.fast_forward_eligible(model)
    forward = bf16_forward(model, tmp_path, precision)
    mix = torch.from_numpy(batch(14, 1, 1600)[0])
    for mode in (True, False):
        model.train(mode)
        out = forward(mix)
        assert out.shape == (1, 2, 1600) and out.dtype == torch.float32


def test_dotted_cli_overrides():
    """``--training.precision bfloat16`` (and ``--group.leaf=value``) set
    keys that the YAML file need not have; the rest goes to the parser."""
    overrides, rest = split_dotted_overrides(
        ["--conf-dir", "c.yml", "--training.precision", "bfloat16", "--training.seed=7",
         "--lr", "0.01", "--training.fused_forward", "true"])
    assert rest == ["--conf-dir", "c.yml", "--lr", "0.01"]
    assert overrides == {("training", "precision"): "bfloat16", ("training", "seed"): 7,
                         ("training", "fused_forward"): True}


# ---------------------------------------------------------------------------
# Dropout masks per (seed, step), remat and the two-step warm start
# ---------------------------------------------------------------------------


def scalar_rows(cwd, exp_name):
    """Every (step, tag, value) row a run's CSV logger wrote, in order."""
    path = os.path.join(cwd, "Experiments", "tensorboard_logs", exp_name, "scalars.csv")
    with open(path) as f:
        return [(int(r[0]), r[1], float(r[2])) for r in (line.split(",") for line in f.read().splitlines()[1:])]


def test_resumed_run_with_dropout_logs_the_straight_runs_losses(tmp_path, monkeypatch, no_tensorboard):
    """A small Sepformer at dropout 0.1 (f32, CPU, seed 7): three epochs
    straight and one epoch then a resume to three log the same losses, bit
    for bit.  The masks of a step come from (seed, global step), and
    last.ckpt keeps the global step."""
    root = _manifests(str(tmp_path / "data"), SR8)
    monkeypatch.chdir(tmp_path)

    def run(exp, epochs):
        config = train_config("Sepformer", root, SR8, exp, precision="float32", seed=7, dropout=0.1)
        config["training"]["epochs"] = epochs
        audio_train.main(config, device="cpu")

    run("straight", 3)
    run("resumed", 1)
    run("resumed", 3)
    straight, resumed = scalar_rows(str(tmp_path), "straight"), scalar_rows(str(tmp_path), "resumed")
    assert [r for r in straight if r[1] != "learning_rate"] == [r for r in resumed if r[1] != "learning_rate"]
    assert len([r for r in straight if r[1] == "train_loss"]) == 3


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_gives_the_steps_loss_and_gradients(rate, tmp_path):
    """One train step of a small Sepformer (f32, dropout ``rate``) through
    ``Trainer``'s train forward with and without ``remat``: the same loss
    and gradients, bit for bit, and under remat the forward runs twice (the
    recomputation in the backward draws the first pass's masks)."""
    model = port_model("Sepformer", 11, dropout=rate).train()
    mix, sources = (torch.from_numpy(a) for a in batch(12, 2, 1600))
    loss_fn = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")
    calls = []
    first_layer = next(m for m in model.modules() if type(m).__name__ == "SBTransformerLayer")
    first_layer.register_forward_hook(lambda *args: calls.append(1))
    got = {}
    for remat in (False, True):
        trainer = Trainer(str(tmp_path / f"exp{remat}"), device="cpu", remat=remat, seed=7,
                          logger=loggers.CSVLogger(str(tmp_path / "logs")))
        forward = trainer.train_module(model)
        model.zero_grad(set_to_none=True)
        calls.clear()
        loss = loss_fn(forward(mix, 5), sources)
        loss.backward()
        got[remat] = (loss.detach(), [p.grad.clone() for p in model.parameters()], len(calls))
    assert torch.equal(got[False][0], got[True][0])
    assert all(torch.equal(a, b) for a, b in zip(got[False][1], got[True][1]))
    assert (got[False][2], got[True][2]) == (1, 2)


def test_remat_through_the_tcn_chain(tmp_path, capsys):
    """The bf16 ConvTasNet step through ``make_kernel_train_apply`` (the
    chain's plain versions on the CPU) with and without ``remat``: the same
    loss and gradients, bit for bit; the chain's forward runs once either
    way, since remat recomputes nothing on the fused path (as the JAX
    Trainer's fused path bypasses its checkpoint), and the Trainer says so
    once."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_backward

    model = models.ConvTasNet(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2, sample_rate=SR8,
                              generator=torch.Generator().manual_seed(3)).train()
    mix, sources = (torch.from_numpy(a) for a in batch(13, 2, 800))
    loss_fn = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")
    chain_forwards = []
    real = convtasnet_backward.fused_tcn_separator

    def counting(*args, **kwargs):
        chain_forwards.append(1)
        return real(*args, **kwargs)

    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convtasnet_backward, "fused_tcn_separator", counting)
        for remat in (False, True):
            trainer = Trainer(str(tmp_path / f"exp{remat}"), device="cpu", precision="bfloat16",
                              fused_forward=True, remat=remat, logger=loggers.CSVLogger(str(tmp_path / "logs")))
            forward = trainer.train_module(model)
            said = capsys.readouterr().out
            assert said.count("remat: nothing to recompute on the fused ConvTasNet path") == int(remat)
            model.zero_grad(set_to_none=True)
            chain_forwards.clear()
            loss = loss_fn(forward(mix, 0), sources)
            loss.backward()
            got[remat] = (loss.detach(), [p.grad.clone() for p in model.parameters()], len(chain_forwards))
    assert torch.equal(got[False][0], got[True][0])
    assert all(torch.equal(a, b) for a, b in zip(got[False][1], got[True][1]))
    assert (got[False][2], got[True][2]) == (1, 1)


def test_audio_train_reads_remat(tmp_path, monkeypatch, no_tensorboard):
    """``training.remat`` reaches the Trainer (it was dropped before)."""
    seen = []
    real = Trainer.__init__

    def record(self, *args, **kwargs):
        seen.append(kwargs.get("remat"))
        real(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "__init__", record)
    root = _manifests(str(tmp_path / "data"), SR8)
    monkeypatch.chdir(tmp_path)
    config = train_config("DPRNN", root, SR8, "remat", precision="float32")
    config["training"]["remat"] = True
    audio_train.main(config, device="cpu")
    assert seen == [True]


def test_two_step_warm_start_copies_the_sm_parameters(tmp_path, monkeypatch, no_tensorboard):
    """``update_parameter`` copies TDANet's ``sm`` parameters and nothing
    else; ``audio_train_twostep.main`` feeds it through
    ``audio_train.WARM_START`` to ``Trainer.fit``, which merges step 1's
    best_model.pth into the fresh model before the first step (and clears
    the hook after)."""
    from audio_only_speech_separation_tpu_torch import audio_train_twostep

    donor, target = port_model("TDANet", 1), port_model("TDANet", 2)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    assert audio_train_twostep.update_parameter(target, donor.state_dict()) == 1
    for k, v in target.state_dict().items():
        want = donor.state_dict()[k] if k.startswith("sm.") else before[k]
        assert torch.equal(v, want), k
    assert any(k.startswith("sm.") for k in before) and any(not k.startswith("sm.") for k in before)

    root = _manifests(str(tmp_path / "data"), SR16, seconds=0.3)
    monkeypatch.chdir(tmp_path)
    step1 = audio_train.main(train_config("TDANet", root, SR16, "step1", precision="float32"), device="cpu")
    pretrained = os.path.join(step1, "best_model.pth")
    merged, real = {}, audio_train_twostep.update_parameter

    def recording(model, state, prefix="sm"):
        n = real(model, state, prefix)
        merged.update({k: v.clone() for k, v in model.state_dict().items()})
        return n

    monkeypatch.setattr(audio_train_twostep, "update_parameter", recording)
    audio_train_twostep.main(train_config("TDANet", root, SR16, "step2", precision="float32"),
                             pretrained=pretrained, device="cpu")
    assert audio_train.WARM_START is None
    step1_sd = models.from_pretrain(pretrained, device="cpu").state_dict()
    assert merged and all(torch.equal(merged[k], step1_sd[k]) for k in merged if k.startswith("sm."))
