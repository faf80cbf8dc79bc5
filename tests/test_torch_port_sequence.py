"""Sequence parallelism, the ``sp`` mesh axis of the port (counterpart of
``tests/test_sequence_parallel.py``), on gloo processes on the CPU: the
identity off a mesh; each rank's intra pass on its own share of the chunks;
the forward of TasNet-DPRNN, TasNet-DPTNet, Sepformer and BSRNN on three
ranks, whose shares of S (and of K, and of BSRNN's bands and frames) are
uneven, against the one process's and the JAX package's single-device
forward; a train step of TasNet-DPRNN and BSRNN on a (1, 2) and a (2, 2)
mesh against the one process's and ``jax.value_and_grad``, comparing the
gradients themselves (each rank's partial gradients summed over its sp
group, and the reduced ones DDP leaves on every rank).

The ranks run ``tests/torch_port_ddp.py`` in processes of their own, with
timeouts on the group and on each process.  S, the chunk count of
``split_feature``, is always even (two half-shifted segmentations
interleaved), so the forward runs on three ranks for an uneven split of it;
the chunks are K = 7 positions, so two ranks split K unevenly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_only_speech_separation_tpu.models as jmodels
from audio_only_speech_separation_tpu import losses as jlosses
from audio_only_speech_separation_tpu.utils.torch_import import convert, convert_tasnet
from audio_only_speech_separation_tpu_torch import parallel
from audio_only_speech_separation_tpu_torch.ops.norms import global_moments
from audio_only_speech_separation_tpu_torch.parallel import sequence
from audio_only_speech_separation_tpu_torch.train import Trainer
from torch_port_ddp import (
    SP_B,
    SP_FAMILIES,
    SP_TRAIN,
    SR,
    family_model,
    intra_module,
    launch,
    sp_batch,
    train_step,
)

torch.set_num_threads(2)


def jax_params(family, model, sd=None):
    """``model``'s weights (or the state dict ``sd``) in the JAX package's
    tree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()} if sd is None else sd
    name, cfg = SP_FAMILIES[family]
    if name == "TasNet":
        return convert_tasnet(sd, module=cfg["module"], layer=cfg["layer"])
    if name == "BSRNN":
        return convert("BSRNN", sd, nband=model.nband, num_repeat=model.num_repeat, num_layer=model.num_layer,
                       bi_comm=model.bi_comm)
    return convert("Sepformer", sd, masknet_numlayers=cfg["masknet_numlayers"],
                   intra_numlayers=cfg["intra_numlayers"], inter_numlayers=cfg["inter_numlayers"])


def jax_model(family):
    name, cfg = SP_FAMILIES[family]
    return getattr(jmodels, name)(**cfg, sample_rate=SR)


def test_identity_off_a_mesh():
    """Without a mesh (or with none active) every sharding function returns
    its input itself, the gLN moments are the one-pass ones, and the axes
    are empty: the JAX package's ``maybe_shard`` off a mesh."""
    x = torch.randn(2, 3, 5, 4)
    assert sequence.current_mesh_axes() == () and sequence.sp_group() is None
    with sequence.use_mesh(None):
        assert sequence.shard(x, 3) is x
        assert sequence.exchange(x, 2, 3, 4) is x
        assert sequence.gather(x, 2, 5) is x
        assert sequence.share_replicated(x) is x
    mean, var = global_moments(x)
    np.testing.assert_allclose(mean.flatten(), x.reshape(2, -1).mean(1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.flatten(), x.reshape(2, -1).var(1, unbiased=False), rtol=1e-5, atol=1e-6)


def test_shard_chunks_is_the_identity_off_a_mesh():
    """``shard_chunks`` returns its input itself without an active mesh, or
    under one without the axis: the JAX function's no-op off an sp mesh."""
    x = torch.randn(2, 3, 5, 4)
    assert parallel.shard_chunks(x) is x and parallel.shard_chunks(x, chunk_axis=2, axis_name="sp") is x
    with sequence.use_mesh(None):
        assert parallel.shard_chunks(x, axis_name="dp") is x


def test_shard_chunks_gives_each_rank_its_share(tmp_path):
    """On two gloo ranks of a (1, 2) mesh, each rank's ``shard_chunks`` is
    ``shard``'s share of the chunk axis (S = 7: 4 and 3 chunks; K = 5
    through ``chunk_axis=2``: 3 and 2), and the shares make up the tensor;
    off the mesh, and for an axis the mesh lacks, the tensor itself."""
    ranks = [res for res, _ in launch("sp_shard", str(tmp_path), world=2)]
    x = np.random.default_rng(41).standard_normal((2, 3, 5, 7)).astype(np.float32)
    assert [r["chunks"].shape[-1] for r in ranks] == [4, 3] and [r["positions"].shape[2] for r in ranks] == [3, 2]
    np.testing.assert_array_equal(np.concatenate([r["chunks"] for r in ranks], axis=-1), x)
    np.testing.assert_array_equal(np.concatenate([r["positions"] for r in ranks], axis=2), x)
    assert all(r["off the mesh"] and r["other axis"] for r in ranks)


def test_split_sizes_are_uneven_and_refuse_empty_shares():
    assert sequence.split_sizes(7, 2) == [4, 3]
    assert sequence.split_sizes(26, 3) == [9, 9, 8]
    assert sequence.split_sizes(6, 3) == [2, 2, 2]
    with pytest.raises(ValueError, match="cannot be shared"):
        sequence.split_sizes(2, 3)


def test_sp_needs_a_process_group_and_a_dividing_world(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        parallel.dp_shard_info(2)  # one process: a world of 1
    assert parallel.dp_shard_info(1) == (0, 1)
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(str(tmp_path), device="cpu", sp=2)


@pytest.fixture(scope="module")
def sp_forward(tmp_path_factory):
    """The ``sp_forward`` job on three gloo ranks, a (1, 3) mesh."""
    return launch("sp_forward", str(tmp_path_factory.mktemp("sp_forward")), world=3, args=("3",))


@pytest.fixture(scope="module")
def one_process_forward():
    """Each family's forward in this process, without a mesh, and the shape
    its first intra pass took."""
    mix = torch.from_numpy(sp_batch()[0][:2])
    res = {}
    for family in SP_FAMILIES:
        model = family_model(family, 11).eval()
        seen = []
        hook = intra_module(family, model).register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape)))
        with torch.no_grad():
            res[family] = model(mix).numpy()
        hook.remove()
        res[f"{family} intra"] = seen
    return res


def test_the_mesh_axes(sp_forward):
    for res, _ in sp_forward:
        assert res["axes off the mesh"] == ()
        assert res["axes"] == ("dp", "sp") and res["sp size"] == 3


@pytest.mark.parametrize("family", list(SP_FAMILIES))
def test_each_rank_runs_its_share_of_the_intra_pass(family, sp_forward, one_process_forward):
    """Rank r's first intra (row) pass takes its share of the B x S chunks
    (BSRNN: of the B x nband band sequences), the first ``n % 3`` ranks one
    more, and the shares add up to the one process's batch."""
    whole = one_process_forward[f"{family} intra"][0]
    batch = [res[f"{family} intra"][0] for res, _ in sp_forward]
    B = 2
    n = whole[0] // B
    assert [b[0] for b in batch] == [B * k for k in sequence.split_sizes(n, 3)]
    assert len({b[0] for b in batch}) > 1  # uneven shares
    assert all(b[1:] == whole[1:] for b in batch)


@pytest.mark.parametrize("family", list(SP_FAMILIES))
def test_sharded_forward_equals_one_process_and_jax(family, sp_forward, one_process_forward):
    """Every rank's output is the one process's within f32 tolerance (the
    gLN moments combined across the ranks sum in another order; 2e-5 of the
    output's scale), and so the JAX package's single-device forward on the
    converted weights (1e-4 of the scale, the port's f32 parity
    tolerance)."""
    want = one_process_forward[family]
    scale = np.abs(want).max()
    model = family_model(family, 11)
    ref = np.asarray(jax.jit(jax_model(family).apply)(jax_params(family, model), jnp.asarray(sp_batch()[0][:2])))
    for res, _ in sp_forward:
        got = res[family]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-5 * scale
        assert np.abs(got - ref).max() <= 1e-4 * scale


@pytest.fixture(scope="module")
def sp_steps(tmp_path_factory):
    """The ``sp_train`` job on a (1, 2) mesh (two ranks) and on a (2, 2)
    mesh (four ranks)."""
    from concurrent.futures import ThreadPoolExecutor

    work = tmp_path_factory.mktemp("sp_train")
    with ThreadPoolExecutor(2) as pool:  # the two meshes' processes at once
        runs = {(dp, 2): pool.submit(launch, "sp_train", str(work / f"{dp}2"), world=2 * dp, args=("2",),
                                     timeout=300) for dp in (1, 2)}
        return {shape: run.result() for shape, run in runs.items()}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per family of SP_TRAIN: the one process's step on the whole batch and
    its gradients on each half, and ``jax.value_and_grad`` of the JAX
    model's loss on the whole batch."""
    work = str(tmp_path_factory.mktemp("sp_references"))
    mix, sources = sp_batch()
    loss_fn = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, threshold_byloss=False)
    out = {}
    for family in SP_TRAIN:
        def step(items):
            return train_step(family, family_model(family, 12), mix[items], sources[items], work)

        jm = jax_model(family)
        out[family] = {
            "whole": step(slice(None)),
            "halves": [step(slice(h * SP_B // 2, (h + 1) * SP_B // 2))[2] for h in range(2)],
            "jax": jax.jit(jax.value_and_grad(lambda p: loss_fn(jm.apply(p, jnp.asarray(mix)),
                                                                jnp.asarray(sources))))(
                jax_params(family, family_model(family, 12))),
        }
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("family", SP_TRAIN)
def test_train_step_matches_one_process_and_jax(family, shape, sp_steps, references):
    """On a (dp, sp) mesh: the partial gradients of an sp group's ranks sum
    to the one process's on that group's dp shard; after DDP's reduction
    (sum over sp, mean over dp) every rank holds the one process's
    gradients on the whole batch, and after the clip and Adam its
    parameters; the loss is the one process's and all of them
    ``jax.value_and_grad``'s on the converted weights (the loss within
    1e-5 relative, gradients and parameters rtol 2e-4, atol 2e-5, the
    tolerances of ``__graft_entry__.py:140-152``).  A mean over every rank
    in place of the sum over sp would halve the gradients, which Adam
    would hide: the gradients are compared themselves."""
    dp, sp = shape
    ranks = [res for res, _ in sp_steps[shape]]
    ref = references[family]
    tol = dict(rtol=2e-4, atol=2e-5)
    assert [r["coords"] for r in ranks] == [(i // sp, dp) for i in range(dp * sp)]
    one_loss, one_params, one_grads = ref["whole"]
    for d in range(dp):
        want = one_grads if dp == 1 else ref["halves"][d]
        group = ranks[d * sp:(d + 1) * sp]
        for k, v in want.items():
            np.testing.assert_allclose(sum(r[f"{family} partial"][k] for r in group), v, err_msg=k, **tol)

    for r in ranks:
        loss, params, grads = r[family]
        assert abs(loss - one_loss) <= 1e-5 * max(1.0, abs(one_loss))
        for k, v in one_grads.items():
            np.testing.assert_allclose(grads[k], v, err_msg=k, **tol)
        for k, v in one_params.items():
            np.testing.assert_allclose(params[k], v, err_msg=k, **tol)

    j_loss, j_grads = ref["jax"]
    assert abs(float(j_loss) - one_loss) <= 1e-5 * max(1.0, abs(float(j_loss)))
    # JAX's one LSTM bias takes the gradient of bias_ih (bias_hh's is the same)
    model = family_model(family, 12)
    grads = ranks[0][family][2]
    sd = {k: np.zeros(v.shape, np.float32) if ".bias_hh" in k else grads[k] for k, v in model.state_dict().items()}
    for want, got in zip(*(jax.tree_util.tree_leaves(t) for t in (j_grads, jax_params(family, model, sd)))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_audio_train_main_with_sp_matches_one_process(tmp_path, monkeypatch):
    """``audio_train.main`` with ``training.sp: 2`` on two gloo ranks (a (1,
    2) mesh: both ranks read the one dp shard, the whole batch) against one
    process without sp, a TasNet-DPRNN two epochs on the same manifests:
    every epoch's train and val loss within 1e-4 (the sharded path sums in
    another order)."""
    import json
    import os
    import pickle

    from audio_only_speech_separation_tpu_torch import audio_train
    from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav
    from audio_only_speech_separation_tpu_torch.train import loggers

    root = tmp_path / "data"
    rng = np.random.default_rng(21)
    for split, n in {"tr": 4, "cv": 3, "tt": 2}.items():
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            os.makedirs(root / split / c)
        for i in range(n):
            s = (0.1 * rng.standard_normal((2, 2400))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                write_wav(str(root / split / c / f"u{i}.wav"), wav, SR)
                infos[c].append([str(root / split / c / f"u{i}.wav"), 2400])
        for c, lst in infos.items():
            with open(root / split / f"{c}.json", "w") as f:
                json.dump(lst, f)

    def config(sp):
        data = dict(train_dir=str(root / "tr"), valid_dir=str(root / "cv"), test_dir=str(root / "tt"), n_src=2,
                    sample_rate=SR, segment=0.25, batch_size=2, num_workers=0)
        pit = {"loss_func": "PITLossWrapper", "config": {"pit_from": "pw_mtx", "threshold_byloss": False}}
        return {"audionet": {"audionet_name": "TasNet", "audionet_config": dict(SP_FAMILIES["TasNet-DPRNN"][1])},
                "loss": {"train": dict(pit, sdr_type="pairwise_neg_snr"),
                         "val": dict(pit, sdr_type="pairwise_neg_sisdr")},
                "training": {"epochs": 2, "precision": "float32", "sp": sp},
                "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
                "datamodule": {"data_name": "LRS2DataModule", "data_config": data},
                "exp": {"exp_name": "tiny_sp"}}

    def losses(exp_root):
        with open(os.path.join(exp_root, "Experiments", "tensorboard_logs", "tiny_sp", "scalars.csv")) as f:
            rows = [r.split(",") for r in f.read().splitlines()[1:]]
        return {tag: [float(v) for _, t, v in rows if t == tag] for tag in ("train_loss", "val_loss")}

    conf = str(tmp_path / "conf.pkl")
    with open(conf, "wb") as f:
        pickle.dump(config(2), f)
    launch("main", str(tmp_path), args=(conf,), timeout=300)
    monkeypatch.setattr(loggers, "TensorBoardLogger", lambda *a, **k: (_ for _ in ()).throw(ImportError()))
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    audio_train.main(config(1), device="cpu")
    got, want = losses(tmp_path / "rank0"), losses(one)
    assert len(want["val_loss"]) == len(want["train_loss"]) == 2
    for tag in want:
        np.testing.assert_allclose(got[tag], want[tag], atol=1e-4, err_msg=tag)
