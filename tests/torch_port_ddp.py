"""Rank processes of the data-parallel CPU tests
(``test_torch_port_parallel.py``): each runs one job of the port under a
gloo process group that ``parallel.init_distributed`` joins from
torchrun's environment, and writes what it computed to a pickle.  The
port only: no JAX here.

    python tests/torch_port_ddp.py <job> <out.pkl> [<work dir>] [<job arguments>]

``launch`` starts the ranks with the environment set, a free port, a
timeout on the group and on each process, and kills them all on a
failure.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
# the tiny models of the step job: (registry name, constructor arguments)
FAMILIES = {
    "ConvTasNet": ("ConvTasNet", dict(N=32, L=16, B=32, H=32, P=3, X=2, R=1, num_spks=2)),
    "DPRNN": ("TasNet", dict(enc_dim=16, bn_dim=16, hidden_dim=32, win=16, layer=2, num_spk=2, module="DPRNN",
                             block_size=8)),
}
# every other family at a tiny width, for the families job (one rank)
TASNET = dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=1, num_spk=2, block_size=24)
OTHER_FAMILIES = {
    "DPTNet": ("TasNet", dict(TASNET, module="DPTNet")),
    "BSRNN": ("BSRNN", dict(win=256, stride=64, feature_dim=16, num_spks=2, num_layer=1, num_repeat=1)),
    "Sepformer": ("Sepformer", dict(encoder_kernel_size=16, encoder_out_nchannels=16, masknet_chunksize=20,
                                    masknet_numlayers=1, masknet_numspks=2, intra_numlayers=1, inter_numlayers=1,
                                    intra_nhead=2, inter_nhead=2, intra_dffn=32, inter_dffn=32, dropout=0.1)),
    "TDANet": ("TDANet", dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3, enc_kernel_size=4,
                              num_sources=2)),
    "AFRCNN": ("AFRCNN", dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3, enc_kernel_size=1,
                              num_sources=2)),
    "Sandglasset": ("Sandglasset", dict(n_feats=16, out_chan=16, bn_chan=16, hid_size=16, chunk_size=20, hop_size=10,
                                        n_head=2)),
    "DPRNNTasNet": ("DPRNNTasNet", dict(feature_dim=16, hidden_dim=16, layer=2, segment_size=20)),
    # inside the TCN chain kernels' envelope (H % 128 == 0, B = 128, L = 16): the fused path
    "ConvTasNet-fused": ("ConvTasNet", dict(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2)),
}
# the sequence-parallel jobs' tiny models: chunks of K = 7 positions, so the
# columns' shares of K are uneven; S = 2 x (the half-shifted segments) is
# even, so 3 ranks share it unevenly (BSRNN: 8 bands)
SP_TASNET = dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=2, num_spk=2, block_size=7)
SP_FAMILIES = {
    "TasNet-DPRNN": ("TasNet", dict(SP_TASNET, module="DPRNN")),
    "TasNet-DPTNet": ("TasNet", dict(SP_TASNET, module="DPTNet")),
    "Sepformer": ("Sepformer", dict(encoder_kernel_size=16, encoder_out_nchannels=16, masknet_chunksize=7,
                                    masknet_numlayers=2, masknet_numspks=2, intra_numlayers=1, inter_numlayers=1,
                                    intra_nhead=2, inter_nhead=2, intra_dffn=32, inter_dffn=32, dropout=0.0)),
    "BSRNN": ("BSRNN", dict(win=256, stride=64, feature_dim=8, num_spks=2, num_layer=1, num_repeat=2)),
}
SP_B, SP_T = 4, 1664  # the sp jobs' global batch: S = 62 chunks, 27 BSRNN frames
SP_TRAIN = ("TasNet-DPRNN", "BSRNN")
STEP_B, STEP_T = 4, 1600  # the global batch of the step job
EVAL_SIZES = 5  # eval items, split 3 / 2 over the two ranks


def step_batch():
    rng = np.random.default_rng(0)
    sources = (0.3 * rng.standard_normal((STEP_B, 2, STEP_T))).astype(np.float32)
    return sources.sum(1), sources


def family_model(family, seed):
    from audio_only_speech_separation_tpu_torch import models

    name, cfg = {**FAMILIES, **OTHER_FAMILIES, **SP_FAMILIES}[family]
    model = models.get(name)(**cfg, sample_rate=SR)
    rng = np.random.default_rng(seed)  # seeded weights for any constructor
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return model


def train_step(family, model, mix, sources, work, steps=1, device="cpu", module=None, **trainer_kw):
    """``steps`` steps of ``Trainer``'s train forward (under DDP when a
    group is up; ``module(mix, step)`` in its place when given) on one batch
    on ``device``: PIT neg-SNR loss, backward, Adam with the global-norm
    clip at 5.0.  Returns (the last loss over the global batch, the updated
    parameters, the first step's gradients before the clip (under DDP its
    mean over the ranks)), on the CPU."""
    import torch.distributed as dist

    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer, make_optimizer

    model.to(device).train()
    if module is None:
        trainer = Trainer(os.path.join(work, family), device=device, logger=CSVLogger(os.path.join(work, "logs")),
                          **trainer_kw)
        module = trainer.train_module(model)
    mix, sources = torch.from_numpy(mix).to(device), torch.from_numpy(sources).to(device)
    opt = make_optimizer(model.parameters(), optim_name="adam", lr=1e-3, grad_clip=5.0)
    grads = None
    for step in range(steps):
        opt.zero_grad()
        loss = PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)(module(mix, step), sources)
        loss.backward()
        if grads is None:
            grads = {k: p.grad.detach().cpu().numpy().copy() for k, p in model.named_parameters()
                     if p.grad is not None}
        opt.step()
    loss = loss.detach()
    if dist.is_initialized():
        dist.all_reduce(loss)
        loss /= dist.get_world_size()
    return float(loss), {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}, grads


def eval_batches(rank, world):
    """The eval items of this rank's strided shard, in batches of 2 (the
    last one short): 5 items give rank 0 batches of 2 and 1, rank 1 one of
    2."""
    rng = np.random.default_rng(1)
    sources = (0.3 * rng.standard_normal((EVAL_SIZES, 2, STEP_T))).astype(np.float32)
    idx = np.arange(EVAL_SIZES)[rank::world]
    return [(sources[b].sum(1), sources[b], [str(i) for i in b]) for b in (idx[i : i + 2] for i in range(0, len(idx), 2))]


def eval_loss(model, rank, world, work):
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer

    trainer = Trainer(os.path.join(work, "eval"), device="cpu", logger=CSVLogger(os.path.join(work, "logs")))
    return trainer._eval_epoch(model.eval(), PITLossWrapper(pairwise_neg_sisdr), eval_batches(rank, world))


def long_wave():
    return (0.3 * np.random.default_rng(2).standard_normal(5 * SR)).astype(np.float32)


def chunked(model):
    from audio_only_speech_separation_tpu_torch.utils.chunked_inference import chunked_separate

    return chunked_separate(model, long_wave(), window_seconds=1.0, overlap_seconds=0.25, sample_rate=SR,
                            device="cpu", use_bf16=False)


def job_step(out, work):
    """replicate, one DDP train step of each family, the exact eval
    reduction, print_only, make_mesh and chunked separation on 2 ranks."""
    from audio_only_speech_separation_tpu_torch import parallel
    from audio_only_speech_separation_tpu_torch.utils import print_only

    rank, world = parallel.init_distributed(device="cpu")
    res = {"shard": (rank, world)}
    mix, sources = step_batch()
    share = STEP_B // world
    for family in FAMILIES:
        model = family_model(family, seed=rank)  # each rank its own weights until replicate
        parallel.replicate(model)
        want = family_model(family, seed=0).state_dict()
        res[f"{family} replicated"] = all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
        sl = slice(rank * share, (rank + 1) * share)
        res[family] = train_step(family, model, mix[sl], sources[sl], work)
    res["eval"] = eval_loss(family_model("ConvTasNet", 3), rank, world, work)
    print_only(f"print_only from rank {rank}")
    mesh = parallel.make_mesh("cpu")
    res["mesh"] = (tuple(mesh.mesh_dim_names), mesh.size(), mesh.get_group("dp").size())
    mesh = parallel.make_mesh("cpu", ("dp", "sp"), (1, 2))
    res["sp"] = (tuple(mesh.mesh_dim_names), mesh.get_group("dp").size(), mesh.get_group("sp").size())
    for axes, shape in ((("dp", "tp"), (1, 2)), (("dp", "sp"), (2, 2))):
        try:
            parallel.make_mesh("cpu", axes, shape)
            res[f"mesh {axes} {shape}"] = "built"
        except (NotImplementedError, ValueError) as e:
            res[f"mesh {axes} {shape}"] = type(e).__name__
    res["chunked"] = chunked(family_model("ConvTasNet", 4))
    return res


# the families job's settings: (family, precision, remat)
FAMILY_RUNS = [(f, "float32", False) for f in OTHER_FAMILIES] + [
    ("Sepformer", "float32", True), ("TDANet", "bfloat16", False), ("ConvTasNet-fused", "bfloat16", True)]


def family_runs(work):
    """Three steps of each run of FAMILY_RUNS on the step job's batch
    (the first two items at 8 kHz): {run: (loss, parameters, the first
    step's gradients)}."""
    mix, sources = step_batch()
    torch.manual_seed(0)
    return {run: train_step(run[0], family_model(run[0], 5), mix[:2], sources[:2], work, steps=3,
                            precision=run[1], remat=run[2], fused_forward=True)
            for run in FAMILY_RUNS}


def job_families(out, work):
    """Every family trains three steps under DDP at a world size of 1:
    TDANet's never-used parameters, remat and the fused path included."""
    from audio_only_speech_separation_tpu_torch import parallel

    parallel.init_distributed(device="cpu")
    return family_runs(work)


def card_steps(work):
    """One step of the fused-envelope ConvTasNet on the card in f32 and in
    bf16 through K2 + K3, on this rank's share of the step batch:
    {precision: (loss, parameters, gradients)}.  Without a group also the
    "plain bf16" step: bf16 with the TCN chain's plain versions under
    autograd in place of K2 + K3 (the margin a bf16 arm is held to)."""
    import torch.distributed as dist

    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import tcn_chain_reference
    from audio_only_speech_separation_tpu_torch.train import bf16_forward

    mix, sources = step_batch()
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    sl = slice(rank * STEP_B // world, (rank + 1) * STEP_B // world)
    steps = {precision: train_step("ConvTasNet-fused", family_model("ConvTasNet-fused", 6), mix[sl], sources[sl],
                                   work, device="cuda", precision=precision, fused_forward=True)
             for precision in ("float32", "bfloat16")}
    if world == 1:
        model = family_model("ConvTasNet-fused", 6).to("cuda").train()
        forward = bf16_forward(model, True, chain=tcn_chain_reference)
        steps["plain bf16"] = train_step("ConvTasNet-fused", model, mix, sources, work, device="cuda",
                                         module=lambda m, step: forward(m))
    return steps


def job_card(out, work):
    """``card_steps`` on two ranks over gloo on one card (NCCL refuses two
    ranks on one device)."""
    from audio_only_speech_separation_tpu_torch import parallel

    parallel.init_distributed(device="cuda", backend="gloo")
    return card_steps(work)


def job_main(out, work, conf_path):
    """``audio_train.main`` on this rank's shard, in this rank's own
    working directory (so what rank 1 wrote, if anything, stays apart)."""
    from audio_only_speech_separation_tpu_torch import audio_train, parallel
    from audio_only_speech_separation_tpu_torch.train import loggers

    def no_tensorboard(*args, **kwargs):
        raise ImportError("CSV logging only")

    loggers.TensorBoardLogger = no_tensorboard
    rank, _ = parallel.init_distributed(device="cpu")
    with open(conf_path, "rb") as f:
        config = pickle.load(f)
    rank_dir = os.path.join(work, f"rank{rank}")
    os.makedirs(rank_dir, exist_ok=True)
    os.chdir(rank_dir)
    return {"exp_dir": audio_train.main(config, device="cpu")}


def sp_batch():
    rng = np.random.default_rng(7)
    sources = (0.3 * rng.standard_normal((SP_B, 2, SP_T))).astype(np.float32)
    return sources.sum(1), sources


def intra_module(family, model):
    """The module of ``model``'s first intra-chunk (row) pass, or BSRNN's
    first band RNN."""
    if family == "Sepformer":
        return model.masknet.dual_mdl[0].intra_mdl
    if family == "BSRNN":
        return model.separator[0].band_rnn[0]
    core = model.seq_model.seq_model
    return core.row_rnn[0] if family == "TasNet-DPRNN" else core.row_xfmr[0]


def job_sp_forward(out, work, sp):
    """Each family of SP_FAMILIES forward on the first two items of the sp
    batch on a (1, ``sp``) mesh: each rank's output and the shapes its first
    intra pass (BSRNN: band RNN) took."""
    from audio_only_speech_separation_tpu_torch import parallel

    rank, world = parallel.init_distributed(device="cpu")
    mesh = parallel.make_mesh("cpu", ("dp", "sp"), (world // int(sp), int(sp)))
    mix = torch.from_numpy(sp_batch()[0][:2])
    res = {"axes off the mesh": parallel.current_mesh_axes()}
    with parallel.use_mesh(mesh):
        res["axes"], res["sp size"] = parallel.current_mesh_axes(), parallel.sp_group().size()
    for family in SP_FAMILIES:
        model = family_model(family, 11).eval()
        seen = []
        hook = intra_module(family, model).register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape)))
        with torch.no_grad(), parallel.use_mesh(mesh):
            res[family] = model(mix).numpy()
        hook.remove()
        res[f"{family} intra"] = seen
    return res


def job_sp_shard(out, work):
    """``shard_chunks`` of a seeded [B, N, K, S] tensor (S = 7, K = 5) on a
    (1, world) mesh: this rank's share of the chunk axis (the last, and K
    through ``chunk_axis=2``), and the tensor itself off the mesh and for
    an axis the mesh lacks."""
    from audio_only_speech_separation_tpu_torch import parallel

    parallel.init_distributed(device="cpu")
    mesh = parallel.make_mesh("cpu", ("dp", "sp"), (1, dist.get_world_size()))
    x = torch.from_numpy(np.random.default_rng(41).standard_normal((2, 3, 5, 7)).astype(np.float32))
    res = {"off the mesh": parallel.shard_chunks(x) is x}
    with parallel.use_mesh(mesh):
        res["chunks"], res["positions"] = parallel.shard_chunks(x).numpy(), parallel.shard_chunks(x, 2).numpy()
        res["other axis"] = parallel.shard_chunks(x, axis_name="tp") is x
    return res


def job_sp_train(out, work, sp, device="cpu"):
    """On a (world / ``sp``, ``sp``) mesh, each rank on its dp shard of the
    sp batch, for TasNet-DPRNN and BSRNN in f32 on ``device`` (gloo on the
    card too): the train forward's gradients without any reduction (each
    rank's partial ones), then one step of ``Trainer(sp=sp)``'s train module
    (DDP summing over sp and averaging over dp, the clip, Adam)."""
    from audio_only_speech_separation_tpu_torch import parallel
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train.trainer import TrainForward

    parallel.init_distributed(device=device, backend="gloo")
    sp = int(sp)
    dp_rank, dp = parallel.dp_shard_info(sp)
    mesh = parallel.make_mesh(device, ("dp", "sp"), (dp, sp))
    mix, sources = sp_batch()
    share = SP_B // dp
    sl = slice(dp_rank * share, (dp_rank + 1) * share)
    res = {"coords": (dp_rank, dp)}
    for family in SP_TRAIN:
        model = family_model(family, 12).to(device).train()
        est = TrainForward(model, model, 42, dp_rank, False, mesh)(torch.from_numpy(mix[sl]).to(device), 0)
        PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)(
            est, torch.from_numpy(sources[sl]).to(device)).backward()
        res[f"{family} partial"] = {k: p.grad.cpu().numpy().copy() for k, p in model.named_parameters()}
        res[family] = train_step(family, family_model(family, 12), mix[sl], sources[sl], work, device=device,
                                 sp=sp)
    return res


# the sp card job's families at their published widths: (batch, seconds, sample rate, a train step too)
SP_CARD = {"TasNet-DPRNN": (2, 4.0, 8000, True), "Sepformer": (1, 2.0, 16000, False), "BSRNN": (1, 4.0, 8000, True)}


def sp_card_model(family, dev):
    import torch_port_card as card

    if family == "TasNet-DPRNN":
        return card.tasnet_model("DPRNN", 61, dev)
    if family == "Sepformer":
        return card.seeded_model("Sepformer", card.SEPFORMER, card.SR, 62, dev)
    return card.seeded_model("BSRNN", card.BSRNN_WSJ0, card.TSR, 63, dev)


def sp_card_batch(family, dev):
    batch, secs, sr, _ = SP_CARD[family]
    sources = (0.3 * np.random.default_rng(64).standard_normal((batch, 2, int(secs * sr)))).astype(np.float32)
    return torch.from_numpy(sources.sum(1)).to(dev), torch.from_numpy(sources).to(dev)


def sp_card_runs(dev, work, mesh=None):
    """Each family of SP_CARD on the kernel path (under ``mesh`` if given):
    the bf16 forward and, where SP_CARD says, one bf16 train step's
    gradients (``Trainer(sp=2)`` on the mesh), with the launches and shapes."""
    import torch_port_card as card

    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.parallel import use_mesh
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer

    res = {}
    for family, (_, _, _, step) in SP_CARD.items():
        model = sp_card_model(family, dev)
        mix, sources = sp_card_batch(family, dev)
        kernel = card.dualpath_paths(model)[0]
        with card.counting() as n, card.recording_kernel_shapes() as shapes, use_mesh(mesh):
            entry = {"out": kernel(mix).float().cpu(), "launches": n()}
        entry["shapes"] = {g: sorted(v) for g, v in shapes.items()}
        if step:
            trainer = Trainer(os.path.join(work, family), precision="bfloat16", sp=1 if mesh is None else 2,
                              device=dev, logger=CSVLogger(os.path.join(work, family, "logs")))
            module = trainer.train_module(model.train())
            with card.recording_kernel_shapes() as step_shapes:
                PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)(module(mix, 0), sources).backward()
                torch.cuda.synchronize()
            entry.update(step_shapes={g: sorted(v) for g, v in step_shapes.items()},
                         grads=torch.cat([p.grad.flatten().float() for p in model.parameters()]).cpu())
        res[family] = entry
        del model
    return res


def job_sp_card(out, work):
    """``sp_card_runs`` on a (1, world) mesh of gloo ranks on one card."""
    from audio_only_speech_separation_tpu_torch import parallel

    parallel.init_distributed(device="cuda", backend="gloo")
    mesh = parallel.make_mesh("cuda", ("dp", "sp"), (1, dist.get_world_size()))
    return sp_card_runs(torch.device("cuda"), work, mesh)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job, work, world=2, timeout=120, args=(), one_card=False):
    """Run ``job`` on ``world`` gloo ranks (all on card 0 with
    ``one_card``); returns [(result, stdout)] by rank.  Raises, with every
    rank's output, if a rank fails or outlives ``timeout`` seconds (all are
    killed then)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0" if one_card else str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS=str(torch.get_num_threads()))  # the caller's float sums, in its order
        out = os.path.join(work, f"{job}{rank}.pkl")
        cmd = [sys.executable, os.path.abspath(__file__), job, out, work, *args]
        procs.append((out, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    logs = []
    try:
        for _, p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for _, p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(f"--- rank {r}:\n{log[-4000:]}" for r, log in enumerate(logs)))
    results = []
    for (out, _), log in zip(procs, logs):
        with open(out, "rb") as f:
            results.append((pickle.load(f), log))
    return results


if __name__ == "__main__":
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 on the card, as the tests' own process
    torch.backends.cudnn.allow_tf32 = False
    job, out, work = sys.argv[1:4]
    res = {"step": job_step, "main": job_main, "families": job_families, "card": job_card,
           "sp_forward": job_sp_forward, "sp_shard": job_sp_shard, "sp_train": job_sp_train,
           "sp_card": job_sp_card}[job](
        out, work, *sys.argv[4:])
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
