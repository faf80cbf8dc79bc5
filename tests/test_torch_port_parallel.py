"""Data-parallel training with the port on the CPU (gloo): two ranks with
half the batch each against one process with all of it, and both against
the JAX package's single-device step on the same weights, for a tiny
ConvTasNet and a tiny TasNet-DPRNN (JAX's own tolerances,
``__graft_entry__.py:140-152``); the exact evaluation mean over unequal
shards; ``audio_train.main`` as two processes against one and against the
JAX Trainer (the final val_loss within 1e-3, as ``tests/test_multihost.py``
holds it); rank-0-only artifacts and console output; ``make_mesh`` and
chunked separation under a process group.

The ranks run ``tests/torch_port_ddp.py`` in processes of their own, with
timeouts on the group and on each process."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_only_speech_separation_tpu.data as jdatas
import audio_only_speech_separation_tpu.models as jmodels
from audio_only_speech_separation_tpu import losses as jlosses
from audio_only_speech_separation_tpu.train import CSVLogger as JCSVLogger
from audio_only_speech_separation_tpu.train import AudioSystem as JAudioSystem
from audio_only_speech_separation_tpu.train import Trainer as JTrainer
from audio_only_speech_separation_tpu.train import make_optimizer as jmake_optimizer
from audio_only_speech_separation_tpu.parallel import make_mesh as jmake_mesh
from audio_only_speech_separation_tpu.parallel import shard_batch as jshard_batch
from audio_only_speech_separation_tpu.utils.torch_import import convert, convert_tasnet
from audio_only_speech_separation_tpu_torch import audio_train, parallel
from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.train import loggers
from audio_only_speech_separation_tpu_torch.utils import print_only
from torch_port_ddp import (
    FAMILIES,
    FAMILY_RUNS,
    SR,
    chunked,
    eval_batches,
    eval_loss,
    family_model,
    family_runs,
    launch,
    step_batch,
    train_step,
)

torch.set_num_threads(2)


def jax_tree(family, model, initial=None):
    """``model``'s weights in the JAX package's tree.  JAX's LSTMs have one
    bias where the port has bias_ih and bias_hh, and an optimizer step
    moves each of the port's two by the step of the one: with ``initial``
    (a state dict) bias_hh is taken from it, so the JAX bias reads the
    step once."""
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    if initial is not None:
        sd.update({k: initial[k].numpy().copy() for k in sd if ".bias_hh" in k})
    return convert_state(family, model, sd)


def convert_state(family, model, sd):
    if family == "DPRNN":
        return convert_tasnet(sd, module="DPRNN", layer=2)
    return convert("ConvTasNet", sd, X=model.X, R=model.R)


def jax_grads(family, model, grads):
    """The port's gradients (by parameter name) in the JAX package's tree:
    the gradient of JAX's one LSTM bias is that of bias_ih (bias_hh's is the
    same), so bias_hh's is left out of the converter's sum."""
    sd = {k: np.zeros(v.shape, np.float32) if ".bias_hh" in k else grads[k]
          for k, v in model.state_dict().items()}
    return convert_state(family, model, sd)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ``step`` job on two gloo ranks: [(result, stdout)] by rank."""
    return launch("step", str(tmp_path_factory.mktemp("ddp_step")))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_ranks_match_one_process_and_the_jax_step(family, two_ranks, tmp_path):
    """Two ranks with half the batch each (DDP's gradient mean, the clip
    after it, Adam) give one process's loss and updated parameters with
    the whole batch, and both match the JAX package's step (value_and_grad
    of the global-batch loss, the optax chain) on the converted weights:
    the loss within 1e-5 relative, the gradients (DDP's mean over the
    ranks, so a sum would fail) and the parameters within rtol 2e-4 and
    atol 2e-5.  Both ranks hold the same reduced gradients."""
    mix, sources = step_batch()
    model = family_model(family, seed=0)
    params0 = jax_tree(family, model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    one_loss, one_params, one_grads = train_step(family, model, mix, sources, str(tmp_path))
    ddp_loss, ddp_params, ddp_grads = two_ranks[0][0][family]
    assert two_ranks[0][0][f"{family} replicated"] and two_ranks[1][0][f"{family} replicated"]
    assert one_grads.keys() == ddp_grads.keys() == {k for k, _ in model.named_parameters()}
    for k, v in ddp_grads.items():
        np.testing.assert_array_equal(two_ranks[1][0][family][2][k], v, err_msg=k)
        np.testing.assert_allclose(v, one_grads[k], rtol=2e-4, atol=2e-5, err_msg=k)

    name, cfg = FAMILIES[family]
    jm = getattr(jmodels, name)(**cfg, sample_rate=SR)
    loss_fn = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, threshold_byloss=False)
    tx = jmake_optimizer("adam", lr=1e-3, grad_clip=5.0)

    def loss(p):
        return loss_fn(jm.apply(p, jnp.asarray(mix)), jnp.asarray(sources))

    j_loss, grads = jax.value_and_grad(loss)(params0)
    updates, _ = tx.update(grads, tx.init(params0), params0)
    j_params = optax.apply_updates(params0, updates)
    j_loss = float(j_loss)

    for got in (one_loss, ddp_loss):
        assert abs(got - j_loss) <= 1e-5 * max(1.0, abs(j_loss)), (family, got, j_loss)
    for arm in (one_grads, ddp_grads):
        for want, got in zip(*(jax.tree_util.tree_leaves(t) for t in (grads, jax_grads(family, model, arm)))):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4, atol=2e-5)
    assert abs(ddp_loss - one_loss) <= 1e-5 * max(1.0, abs(one_loss))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in one_params.items()})
    one_tree = jax_tree(family, model, initial)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ddp_params.items()})
    ddp_tree = jax_tree(family, model, initial)
    for k, v in one_params.items():  # the two ranks' step is the one process's in the port's own layout
        np.testing.assert_allclose(ddp_params[k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    moved = False
    for want, a, b, p0 in zip(*(jax.tree_util.tree_leaves(t) for t in (j_params, one_tree, ddp_tree, params0))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(want), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(np.asarray(b), np.asarray(want), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-4, atol=2e-5)
        moved |= not np.array_equal(np.asarray(want), np.asarray(p0))
    assert moved


def test_eval_mean_is_exact_over_unequal_shards(two_ranks, tmp_path):
    """Five eval items split 3 / 2 over two ranks (batches 2 + 1 and 2):
    the reduced (Σ loss·n) / (Σ n) on each rank is one process's mean over
    all five."""
    assert [len(eval_batches(r, 2)) for r in (0, 1)] == [2, 1]
    want = eval_loss(family_model("ConvTasNet", 3), 0, 1, str(tmp_path))
    for res, _ in two_ranks:
        assert res["eval"] == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_print_only_and_the_mesh_under_a_group(two_ranks, capsys):
    """Rank 0 prints and rank 1 does not; without a group every process
    prints.  ``make_mesh`` is the 1-D ``dp`` mesh over both ranks, or with
    ("dp", "sp") the 2-D mesh of the shape asked for; it refuses any other
    axis and a shape that does not cover the ranks; ``local_shard_info`` is
    (rank, 2)."""
    (r0, out0), (r1, out1) = two_ranks
    assert "print_only from rank 0" in out0 and "print_only from rank" not in out1
    assert (r0["shard"], r1["shard"]) == ((0, 2), (1, 2))
    assert r0["mesh"] == r1["mesh"] == (("dp",), 2, 2)
    assert r0["sp"] == r1["sp"] == (("dp", "sp"), 1, 2)
    assert r0["mesh ('dp', 'tp') (1, 2)"] == "NotImplementedError"
    assert r0["mesh ('dp', 'sp') (2, 2)"] == "ValueError"
    print_only("no group")
    assert capsys.readouterr().out == "no group\n"
    assert parallel.local_shard_info() == (0, 1)
    assert parallel.init_distributed(device="cpu") == (0, 1)  # no torchrun environment: nothing to join


def test_chunked_separation_gathers_on_rank_0(two_ranks):
    """Under a group each rank separates its share of the windows and rank
    0 gathers and stitches them: the one process's result; rank 1 gets
    None."""
    want = chunked(family_model("ConvTasNet", 4))
    assert two_ranks[1][0]["chunked"] is None
    np.testing.assert_allclose(two_ranks[0][0]["chunked"], want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    """The ``families`` job on one gloo rank (DDP at a world size of 1), and
    the same runs in this process without a group."""
    work = str(tmp_path_factory.mktemp("ddp_families"))
    return launch("families", work, world=1)[0][0], family_runs(work)


@pytest.mark.parametrize("run", FAMILY_RUNS, ids=["-".join(map(str, r)) for r in FAMILY_RUNS])
def test_every_family_trains_under_ddp(run, one_rank_runs):
    """Each model family (and Sepformer with dropout and remat, TDANet in
    bf16, ConvTasNet's fused path under remat) takes three steps under DDP
    with the step of the one process without a group: the same loss and
    parameters within JAX's tolerances (DDP at a world size of 1 only
    averages over one rank; the two processes' thread counts may order
    float sums differently), and the first step's gradients within the
    same.  TDANet has parameters its forward never reaches; DDP's static
    graph takes them."""
    (loss, params, grads), want = one_rank_runs[0][run], one_rank_runs[1][run]
    assert np.isfinite(loss) and loss == pytest.approx(want[0], rel=1e-5)
    assert grads.keys() == want[2].keys()
    for k, v in want[2].items():
        np.testing.assert_allclose(grads[k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    for k, v in want[1].items():
        np.testing.assert_allclose(params[k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_init_distributed_raises_without_a_card(monkeypatch):
    """Under torchrun's environment with no card, joining on the card
    raises instead of training on the CPU."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed()


# ---------------------------------------------------------------------------
# audio_train.main end to end
# ---------------------------------------------------------------------------

MAIN_ITEMS = {"tr": 8, "cv": 5, "tt": 3}


def write_manifests(root):
    rng = np.random.default_rng(11)
    for split, n in MAIN_ITEMS.items():
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            os.makedirs(os.path.join(root, split, c), exist_ok=True)
        for i in range(n):
            s = (0.1 * rng.standard_normal((2, 2400))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                path = os.path.join(root, split, c, f"u{i}.wav")
                write_wav(path, wav, SR)
                infos[c].append([path, 2400])
        for c, lst in infos.items():
            with open(os.path.join(root, split, f"{c}.json"), "w") as f:
                json.dump(lst, f)


def main_config(root, batch_size):
    data = dict(train_dir=os.path.join(root, "tr"), valid_dir=os.path.join(root, "cv"),
                test_dir=os.path.join(root, "tt"), n_src=2, sample_rate=SR, segment=0.25,
                batch_size=batch_size, num_workers=2)
    pit = {"loss_func": "PITLossWrapper", "config": {"pit_from": "pw_mtx", "threshold_byloss": False}}
    return {
        "audionet": {"audionet_name": "ConvTasNet", "audionet_config": dict(FAMILIES["ConvTasNet"][1])},
        "loss": {"train": dict(pit, sdr_type="pairwise_neg_snr"), "val": dict(pit, sdr_type="pairwise_neg_sisdr")},
        "training": {"epochs": 2, "precision": "float32",
                     "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min", "patience": 30}},
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 15, "factor": 0.5}},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": data},
        "exp": {"exp_name": "tiny_ddp"},
    }


def val_losses(exp_root):
    with open(os.path.join(exp_root, "Experiments", "tensorboard_logs", "tiny_ddp", "scalars.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    return [float(v) for _, tag, v in rows if tag == "val_loss"]


def test_audio_train_main_on_two_ranks_matches_one_process_and_jax(tmp_path, monkeypatch):
    """``audio_train.main`` as two gloo processes at batch 1 each, as one
    process at batch 2, and the JAX Trainer at batch 2 on one device from
    the same initial weights, two epochs on the same manifests (unequal
    val shards: 3 and 2 items): every epoch's val_loss within 1e-3 of the
    one process's, which is within 1e-3 of JAX's.  Rank 0 writes every
    artifact and prints the epoch lines; rank 1, in a working directory of
    its own, writes no file and prints none."""
    root = str(tmp_path / "data")
    write_manifests(root)
    conf = str(tmp_path / "conf.pkl")
    with open(conf, "wb") as f:
        pickle.dump(main_config(root, batch_size=1), f)
    (r0, out0), (r1, out1) = launch("main", str(tmp_path), args=(conf,))
    assert "epoch 1:" in out0 and "epoch" not in out1 and "Instantiating" not in out1

    rank0 = tmp_path / "rank0"
    exp0 = rank0 / "Experiments" / "checkpoint" / "tiny_ddp"
    assert r0["exp_dir"] == str(exp0)
    assert {"conf.yml", "last.ckpt", "best_k_models.json", "best_model.pth"} <= set(os.listdir(exp0))
    assert [f for _, _, files in os.walk(tmp_path / "rank1") for f in files] == []

    monkeypatch.setattr(loggers, "TensorBoardLogger", lambda *a, **k: (_ for _ in ()).throw(ImportError()))
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    audio_train.main(main_config(root, batch_size=2), device="cpu")

    # the JAX Trainer on one device from the port's initial weights (the
    # port's constructor draws them from seed 0)
    init = ConvTasNet(**FAMILIES["ConvTasNet"][1], sample_rate=SR)
    dm = jdatas.get("LRS2DataModule")(**main_config(root, 2)["datamodule"]["data_config"])
    dm.setup()
    train, val, test = dm.make_loader
    jm = jmodels.ConvTasNet(**FAMILIES["ConvTasNet"][1], sample_rate=SR)
    system = JAudioSystem(
        audio_model=jm,
        loss_func={"train": jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, threshold_byloss=False),
                   "val": jlosses.PITLossWrapper(jlosses.pairwise_neg_sisdr, threshold_byloss=False)},
        optimizer=jmake_optimizer("adam", lr=1e-3, grad_clip=5.0), train_loader=train, val_loader=val,
        test_loader=test, scheduler=None)
    system.warm_start = (jax_tree("ConvTasNet", init), lambda params, pre: pre)
    JTrainer(str(tmp_path / "jax"), epochs=2, mesh=jmake_mesh(1), donate=False,
             logger=JCSVLogger(str(tmp_path / "jax" / "logs"))).fit(system)
    with open(tmp_path / "jax" / "logs" / "scalars.csv") as f:
        jax_val = [float(r.split(",")[2]) for r in f.read().splitlines()[1:] if r.split(",")[1] == "val_loss"]

    two, single = val_losses(rank0), val_losses(one)
    assert len(two) == len(single) == len(jax_val) == 2
    np.testing.assert_allclose(two, single, atol=1e-3)
    np.testing.assert_allclose(single, jax_val, atol=1e-3)


def test_shard_batch_puts_a_nested_batch_on_the_device():
    """``shard_batch`` of a nested batch (a dict of a numpy array, a tuple
    of an array and a tensor, and a list) returns the same nesting as
    tensors on the rank's device, equal to the JAX function's arrays on its
    8-device dp mesh; a mesh without the axis is refused."""
    rng = np.random.default_rng(40)
    batch = {"mix": rng.standard_normal((8, 5)).astype(np.float32),
             "pair": (rng.standard_normal((8, 2, 3)).astype(np.float32), torch.arange(8)),
             "lengths": [np.arange(8, dtype=np.int64)]}
    got = parallel.shard_batch(batch, torch.device("cpu"))
    want = jshard_batch({"mix": batch["mix"], "pair": (batch["pair"][0], batch["pair"][1].numpy()),
                         "lengths": [batch["lengths"][0]]}, jmake_mesh())
    assert isinstance(got["pair"], tuple) and isinstance(got["lengths"], list)
    for g, w in ((got["mix"], want["mix"]), (got["pair"][0], want["pair"][0]), (got["pair"][1], want["pair"][1]),
                 (got["lengths"][0], want["lengths"][0])):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert parallel.shard_batch(batch["mix"], "cpu").dtype == torch.float32

    class Mesh:
        mesh_dim_names, device_type = ("dp", "sp"), "cpu"

    np.testing.assert_array_equal(parallel.shard_batch(batch["mix"], Mesh()).numpy(), batch["mix"])
    with pytest.raises(ValueError, match="no axis"):
        parallel.shard_batch(batch["mix"], Mesh(), axis="tp")

