"""The port's training loop on the CPU: the optimizer and scheduler against
the JAX package's, and ``Trainer.fit`` / ``audio_train.main`` end to end
on tiny synthetic manifests, with resume and a best_model.pth that
``from_pretrain`` loads."""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_only_speech_separation_tpu.train.optimizers as jopt
import audio_only_speech_separation_tpu.train.schedulers as jsched
from audio_only_speech_separation_tpu_torch import audio_train
from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav
from audio_only_speech_separation_tpu_torch.models import ConvTasNet, from_pretrain
from audio_only_speech_separation_tpu_torch.train import (
    AudioLightningModule,
    CSVLogger,
    Trainer,
    get_learning_rate,
    loggers,
    make_optimizer,
    make_scheduler,
    set_learning_rate,
)

torch.set_num_threads(2)
SR = 8000
TINY = dict(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2)


# ---------------------------------------------------------------------------
# Optimizer and schedulers
# ---------------------------------------------------------------------------


# Every name the port's registry builds, and a parameter set with a zero
# tensor (the trust ratios' zero branch), a 1-element one, and two whose two
# largest dimensions are >= 128 (adafactor factors them)
OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adamax", "radam", "lamb", "novograd", "yogi",
              "lars", "sm3", "adafactor", "adabelief")
OPT_SHAPES = [(4, 3), (7,), (2, 2, 2), (160, 128), (3, 128, 144), (1,)]


def _optimizer_case(seed=0):
    """Initial parameters and three steps' gradients: the global norms about
    20, 1.5 and 47 (clipped at 5.0, not, clipped)."""
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in OPT_SHAPES]
    p0[1][:] = 0.0
    total = sum(int(np.prod(s)) for s in OPT_SHAPES)
    grads = [[(scale * np.sqrt(27 / total) * rng.standard_normal(s)).astype(np.float32) for s in OPT_SHAPES]
             for scale in (4.0, 0.3, 9.0)]
    return p0, grads


@pytest.mark.parametrize("name,wd", [(n, wd) for n in OPTIMIZERS for wd in (0.0, 0.01)] + [("adamw", 0.05)])
def test_optimizer_matches_optax(name, wd):
    """Three steps with global-norm clipping at 5.0 (two gradients above
    it, one below) and an LR change after the second, against the JAX
    package's optax chain: parameters within 1e-5 relative."""
    p0, grads = _optimizer_case()
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(tparams, optim_name=name, lr=1e-2, weight_decay=wd, grad_clip=5.0)
    tx = jopt.make_optimizer(name, lr=1e-2, weight_decay=wd, grad_clip=5.0)
    jparams = [jnp.asarray(p) for p in p0]
    state = tx.init(jparams)
    for i, g in enumerate(grads):
        if i == 2:
            set_learning_rate(opt, 3e-3)
            state = jopt.set_learning_rate(state, 3e-3)
        for p, gi in zip(tparams, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        updates, state = tx.update([jnp.asarray(gi) for gi in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for a, b, a0 in zip(jparams, tparams, p0):
            a = np.asarray(a)
            assert np.linalg.norm(b.detach().numpy() - a) <= 1e-5 * np.linalg.norm(a), (name, i, a.shape)
    assert any(not np.array_equal(np.asarray(a), a0) for a, a0 in zip(jparams, p0))
    assert get_learning_rate(opt) == pytest.approx(3e-3)
    assert jopt.get_learning_rate(state) == pytest.approx(3e-3)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_state_round_trips_mid_run(name):
    """Two steps, the state through ``state_dict`` and a pickle (as
    last.ckpt keeps it) into a new optimizer over copies of the parameters,
    then a third step on both: the same parameters, bit for bit."""
    import pickle

    p0, grads = _optimizer_case(seed=1)
    first = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(first, optim_name=name, lr=1e-2, weight_decay=0.01, grad_clip=5.0)
    for g in grads[:2]:
        for p, gi in zip(first, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
    blob = pickle.dumps(opt.state_dict())
    second = [torch.nn.Parameter(p.detach().clone()) for p in first]
    resumed = make_optimizer(second, optim_name=name, lr=1e-2, weight_decay=0.01, grad_clip=5.0)
    resumed.load_state_dict(pickle.loads(blob))
    for o, params in ((opt, first), (resumed, second)):
        for p, gi in zip(params, grads[2]):
            p.grad = torch.from_numpy(gi.copy())
        o.step()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_optimizer_names():
    """Every name of the JAX registry builds but ranger, which raises and
    names the reference's own fault; an unknown name raises ValueError."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    for name in OPTIMIZERS:
        make_optimizer(p, optim_name=name, lr=1e-3)
    with pytest.raises(NotImplementedError, match="LookaheadParams"):
        make_optimizer(p, optim_name="ranger")
    with pytest.raises(ValueError):
        make_optimizer(p, optim_name="no_such_optimizer")


def test_jax_ranger_fails_at_its_first_update():
    """The fault the port's ranger names: the JAX package's ranger
    (optax.lookahead over radam) builds and inits, then fails at its first
    update on the plain parameters its Trainer passes."""
    tx = jopt.make_optimizer("ranger", lr=1e-3, grad_clip=5.0)
    params = [jnp.ones(3)]
    state = tx.init(params)
    with pytest.raises(AttributeError, match="fast"):
        tx.update([jnp.ones(3)], state, params)


@pytest.mark.parametrize("name,cfg", [
    ("ReduceLROnPlateau", dict(patience=2, factor=0.5, cooldown=1, min_lr=1e-4)),
    ("StepLR", dict(step_size=3, gamma=0.5)),
    ("ExponentialLR", dict(gamma=0.8)),
    ("CosineAnnealingLR", dict(T_max=6, eta_min=1e-5)),
])
def test_scheduler_lr_sequence_matches_jax(name, cfg):
    """The same metric sequence gives the same LR sequence, and a state
    round trip resumes it."""
    metrics = [5.0, 4.0, 4.1, 4.2, 4.0, 3.99995, 4.5, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 2.0]
    jsch = jsched.make_scheduler(name, lr=1e-3, **cfg)
    tsch = make_scheduler(name, lr=1e-3, **cfg)
    want = [jsch.step(m) for m in metrics]
    got = []
    for i, m in enumerate(metrics):
        if i == 7:  # resume mid-way from a saved state
            state = tsch.state_dict()
            tsch = make_scheduler(name, lr=5.0, **cfg)
            tsch.load_state_dict(state)
        got.append(tsch.step(m))
    assert got == want
    assert len(set(want)) > 1


def test_noam_lr_sequence_matches_jax():
    jsch = jsched.make_scheduler("NoamLR", lr=1e-3, d_model=64, warmup_steps=5)
    tsch = make_scheduler("NoamLR", lr=1e-3, d_model=64, warmup_steps=5)
    assert [tsch.step_batch() for _ in range(12)] == [jsch.step_batch() for _ in range(12)]


# ---------------------------------------------------------------------------
# Trainer and the training CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def manifests(tmp_path):
    """LRS2-layout manifests (mix.json, s1.json, s2.json) of 0.3 s
    utterances: 4 train, 2 cv, 2 tt."""
    root = tmp_path / "data"
    rng = np.random.default_rng(5)
    for split, n in (("tr", 4), ("cv", 2), ("tt", 2)):
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            (root / split / c).mkdir(parents=True)
        for i in range(n):
            s = (0.1 * rng.standard_normal((2, 2400))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                path = str(root / split / c / f"u{i}.wav")
                write_wav(path, wav, SR)
                infos[c].append([path, 2400])
        for c, lst in infos.items():
            (root / split / f"{c}.json").write_text(json.dumps(lst))
    return root


def _config(root, epochs, precision="bfloat16", fused=True):
    return {
        "audionet": {"audionet_name": "ConvTasNet", "audionet_config": dict(TINY)},
        "loss": {
            "train": {"loss_func": "PITLossWrapper", "sdr_type": "pairwise_neg_snr",
                      "config": {"pit_from": "pw_mtx", "threshold_byloss": True}},
            "val": {"loss_func": "PITLossWrapper", "sdr_type": "pairwise_neg_sisdr",
                    "config": {"pit_from": "pw_mtx", "threshold_byloss": False}},
        },
        "training": {"epochs": epochs, "precision": precision, "fused_forward": fused,
                     "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min",
                                    "patience": 10}},
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 5, "factor": 0.5}},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": dict(
            train_dir=str(root / "tr"), valid_dir=str(root / "cv"), test_dir=str(root / "tt"),
            n_src=2, sample_rate=SR, segment=0.25, batch_size=2, num_workers=2)},
        "exp": {"exp_name": "tiny"},
    }


@pytest.fixture
def no_tensorboard(monkeypatch):
    """CSV logging only: importing tensorboard here pulls in TensorFlow."""
    def unavailable(*args, **kwargs):
        raise ImportError("tensorboard not used in this test")

    monkeypatch.setattr(loggers, "TensorBoardLogger", unavailable)


def test_audio_train_main_trains_resumes_and_serves(manifests, tmp_path, monkeypatch, capsys,
                                                    no_tensorboard):
    """bf16 through make_kernel_train_apply (the chain's plain versions on
    the CPU): one epoch writes the checkpoint layout; a second run with two
    epochs resumes from last.ckpt and trains only epoch 1; best_model.pth
    loads through from_pretrain and separates."""
    monkeypatch.chdir(tmp_path)
    exp_dir = audio_train.main(_config(manifests, epochs=1), device="cpu")
    files = set(os.listdir(exp_dir))
    assert {"conf.yml", "last.ckpt", "epoch=0.ckpt", "best_k_models.json", "best_model.pth"} <= files
    assert json.loads(open(os.path.join(exp_dir, "conf.yml")).read())["training"]["fused_forward"]
    capsys.readouterr()

    audio_train.main(_config(manifests, epochs=2), device="cpu")
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "epoch 0:" not in out
    assert "epoch=1.ckpt" in os.listdir(exp_dir)
    rows = open(tmp_path / "Experiments" / "tensorboard_logs" / "tiny" / "scalars.csv").read().splitlines()
    train = [float(r.split(",")[2]) for r in rows[1:] if r.split(",")[1] == "train_loss"]
    assert len(train) == 2 and np.isfinite(train).all()

    model = from_pretrain(os.path.join(exp_dir, "best_model.pth"), device="cpu").eval()
    assert isinstance(model, ConvTasNet) and model.num_spks == 2
    with torch.no_grad():
        est = model(torch.randn(1, 2400, generator=torch.Generator().manual_seed(0)))
    assert est.shape == (1, 2, 2400) and torch.isfinite(est).all()


@pytest.mark.parametrize("precision,fused", [("float32", False), ("bfloat16", False)])
def test_trainer_fit_other_precisions_and_resume_restores_weights(manifests, tmp_path, precision, fused):
    """The f32 module and the module on bf16 casts of its parameters each
    train an epoch; a new Trainer on the same directory restores the weights of
    last.ckpt into a freshly built model."""
    from audio_only_speech_separation_tpu_torch import data as datas
    from audio_only_speech_separation_tpu_torch import losses

    def system(seed):
        dm = datas.get("LRS2DataModule")(train_dir=str(manifests / "tr"), valid_dir=str(manifests / "cv"),
                                         test_dir=str(manifests / "tt"), n_src=2, sample_rate=SR,
                                         segment=0.25, batch_size=2, num_workers=2)
        dm.setup()
        model = ConvTasNet(**TINY, sample_rate=SR, generator=torch.Generator().manual_seed(seed))
        loss = losses.PITLossWrapper(losses.pairwise_neg_snr)
        return AudioLightningModule(
            audio_model=model, loss_func={"train": loss, "val": loss},
            optimizer=make_optimizer(model.parameters(), lr=1e-3, grad_clip=5.0),
            train_loader=dm.train_dataloader(), val_loader=dm.val_dataloader(),
            test_loader=dm.test_dataloader(), scheduler=None)

    exp = str(tmp_path / "exp")
    first = system(seed=1)
    before = {k: v.clone() for k, v in first.audio_model.state_dict().items()}
    Trainer(exp, epochs=1, precision=precision, fused_forward=fused, device="cpu",
            logger=CSVLogger(str(tmp_path / "logs"))).fit(first)
    trained = first.audio_model.state_dict()
    assert any(not torch.equal(before[k], trained[k]) for k in before)

    second = system(seed=2)
    Trainer(exp, epochs=1, precision=precision, fused_forward=fused, device="cpu",
            logger=CSVLogger(str(tmp_path / "logs"))).fit(second)
    for k, v in second.audio_model.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_data_layer_matches_jax(manifests):
    """The port's data layer, built on the same manifests as the JAX
    package's, yields the same train, val and test batches: the same random
    crops, order and keys, for two epochs; ``WSJ0DataModule`` (the same
    mix.json/s1/s2 layout) too."""
    import audio_only_speech_separation_tpu.data as jdatas
    from audio_only_speech_separation_tpu_torch import data as datas

    kw = dict(train_dir=str(manifests / "tr"), valid_dir=str(manifests / "cv"),
              test_dir=str(manifests / "tt"), n_src=2, sample_rate=SR, segment=0.25,
              batch_size=2, num_workers=2)
    for name in ("LRS2DataModule", "WSJ0DataModule"):
        ours, theirs = datas.get(name)(**kw), jdatas.get(name)(**kw)
        ours.setup()
        theirs.setup()
        for epoch in (0, 1):
            for a, b in zip(ours.make_loader, theirs.make_loader):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                got, want = list(a), list(b)
                assert len(got) == len(want) > 0
                for (m1, s1, k1), (m2, s2, k2) in zip(got, want):
                    assert np.array_equal(m1, m2) and np.array_equal(s1, s2) and k1 == k2


def test_trainer_and_main_default_to_the_card(manifests, tmp_path, monkeypatch):
    """Without a card, ``Trainer`` and ``audio_train.main`` raise unless the
    caller asks for the CPU: nothing trains on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(str(tmp_path / "exp"), logger=CSVLogger(str(tmp_path / "logs")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_train.main(_config(manifests, epochs=1))
    assert Trainer(str(tmp_path / "exp"), device="cpu",
                   logger=CSVLogger(str(tmp_path / "logs"))).device.type == "cpu"


def test_make_logger_kinds_match_jax(tmp_path, monkeypatch):
    """``make_logger`` by kind, beside the JAX package's: "csv" writes the
    same ``scalars.csv``; "tensorboard" hands its keyword arguments to
    ``TensorBoardLogger`` and, where that raises ImportError, falls back to
    a ``CSVLogger`` in the same directory; "comet" raises ImportError
    without ``comet_ml`` (in ``CometLogger``'s constructor); any other kind
    raises ValueError.  (A stand-in takes TensorBoardLogger's place: the
    real one would import TensorFlow here.)"""
    import audio_only_speech_separation_tpu.train.loggers as jloggers

    for i, mod in enumerate((loggers, jloggers)):
        d = tmp_path / f"csv{i}"
        lg = mod.make_logger("csv", str(d))
        lg.log_scalar("loss", 0.5, 3)
        lg.log_hyperparams({"lr": 1e-3})
        lg.close()
    for name in ("scalars.csv", "hparams.json"):
        assert (tmp_path / "csv0" / name).read_text() == (tmp_path / "csv1" / name).read_text()
    for mod in (loggers, jloggers):
        seen = []
        monkeypatch.setattr(mod, "TensorBoardLogger", lambda *a, **k: seen.append((a, k)) or "tb")
        assert mod.make_logger("tensorboard", str(tmp_path / "tb"), name="run", version="1") == "tb"
        assert seen == [((str(tmp_path / "tb"),), {"name": "run", "version": "1"})]

        def unavailable(*args, **kwargs):
            raise ImportError("no tensorboard")

        monkeypatch.setattr(mod, "TensorBoardLogger", unavailable)
        fallback = mod.make_logger("tensorboard", str(tmp_path / "fallback"))
        assert type(fallback).__name__ == "CSVLogger" and fallback.path == str(tmp_path / "fallback" / "scalars.csv")
        with pytest.raises(ImportError):
            mod.make_logger("comet", str(tmp_path), project_name="p")
        with pytest.raises(ValueError, match="unknown logger kind"):
            mod.make_logger("wandb", str(tmp_path))
    from audio_only_speech_separation_tpu_torch.train import CometLogger, make_logger

    assert make_logger is loggers.make_logger and CometLogger is loggers.CometLogger
    with pytest.raises(ImportError):
        CometLogger(project_name="p")

