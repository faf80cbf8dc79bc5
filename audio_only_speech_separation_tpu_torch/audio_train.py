"""Train CLI of the port (counterpart of the JAX package's ``audio_train.py``;
reference audio_train.py:33-163).

    python -m audio_only_speech_separation_tpu_torch.audio_train --conf-dir=configs/convtasnet_lrs3.yml
    python -m audio_only_speech_separation_tpu_torch.audio_train --conf-dir=configs/bsrnn_wsj0.yml \
        --training.precision bfloat16

Config -> registries -> AudioSystem -> Trainer, on the CUDA card unless
``main`` is given ``device="cpu"``.  On several cards, one process a card
under torchrun (data parallel; ``parallel.init_distributed`` joins the
group that torchrun describes):

    torchrun --nproc_per_node=N -m audio_only_speech_separation_tpu_torch.audio_train \
        --conf-dir=configs/convtasnet_lrs3.yml
    torchrun --nproc_per_node=4 -m audio_only_speech_separation_tpu_torch.audio_train \
        --conf-dir=configs/dprnn_wsj0.yml --training.sp 2

The config's ``batch_size`` is per card (the reference's per-GPU batch
under DDP, as the JAX package reads it), each rank loads its own shard of
the data, and rank 0 writes the artifacts and prints.  Every YAML leaf is a CLI
flag (``utils/parser_utils``), and ``--<group>.<leaf> value`` sets any
key (``training.precision``, ``training.seed``: the dropout masks' seed,
42 by default, as in the JAX package; ``training.remat``: recompute the
train forward's activations in the backward; ``training.sp``: ranks that
share each sample's chunks, sequence parallel on a (world / sp, sp) mesh,
1 by default).  Artifacts land in
``Experiments/checkpoint/<exp_name>/`` under the working directory
(conf.yml, top-5 and last checkpoints, best_k_models.json,
best_model.pth), logs in ``Experiments/tensorboard_logs/<exp_name>``.

The datamodule comes from the port's data layer (``data/``).  YAML is read
only when this runs as a program; ``main`` takes the parsed config as a
dict.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from . import data as datas
from . import losses, models
from .parallel import dp_shard_info, init_distributed, local_shard_info
from .train import AudioSystem, Trainer, make_optimizer, make_scheduler
from .utils.console import print_only

# The warm-start hook that audio_train_twostep sets: a (pretrained state
# dict, merge_fn) pair, merged into the model before the first step.
WARM_START = None


def build_loss(loss_conf: dict):
    wrapper_cls = losses.get(loss_conf["loss_func"])
    sdr = losses.get(loss_conf["sdr_type"])
    return wrapper_cls(sdr, **(loss_conf.get("config") or {}))


def main(config: dict, device="cuda") -> str:
    """Train from a config dict (the YAML schema of ``configs/``) on
    ``device``, this process's shard of the data under a process group;
    returns the experiment directory.  Raises when ``device`` is CUDA and
    there is no card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("audio_train: no CUDA device; pass device=\"cpu\" to train on the CPU")
    print_only("Instantiating datamodule <{}>".format(config["datamodule"]["data_name"]))
    sp = int(config["training"].get("sp", 1))
    rank = local_shard_info()[0]
    shard_id, num_shards = dp_shard_info(sp)  # the ranks of one sp group read the same shard
    # batch_size is per card: one process a card loads that many items a step
    datamodule = datas.get(config["datamodule"]["data_name"])(**config["datamodule"]["data_config"],
                                                              shard_id=shard_id, num_shards=num_shards)
    datamodule.setup()
    train_loader, val_loader, test_loader = datamodule.make_loader

    print_only("Instantiating AudioNet <{}>".format(config["audionet"]["audionet_name"]))
    model = models.get(config["audionet"]["audionet_name"])(
        sample_rate=config["datamodule"]["data_config"]["sample_rate"],
        **(config["audionet"]["audionet_config"] or {}),
    )

    print_only("Instantiating optimizer <{}>".format(config["optimizer"]["optim_name"]))
    optimizer = make_optimizer(
        model.parameters(),
        optim_name=config["optimizer"]["optim_name"],
        lr=config["optimizer"]["lr"],
        weight_decay=config["optimizer"].get("weight_decay", 0.0),
        grad_clip=5.0,  # Lightning gradient_clip_val=5.0 (reference audio_train.py:123)
    )
    scheduler = None
    if config.get("scheduler") and config["scheduler"].get("sche_name"):
        print_only("Instantiating scheduler <{}>".format(config["scheduler"]["sche_name"]))
        scheduler = make_scheduler(config["scheduler"]["sche_name"], lr=config["optimizer"]["lr"],
                                   **(config["scheduler"].get("sche_config") or {}))

    # experiment dir + config snapshot (reference audio_train.py:59-63); the
    # snapshot is JSON, which YAML readers also read
    exp_dir = os.path.join(os.getcwd(), "Experiments", "checkpoint", config["exp"]["exp_name"])
    os.makedirs(exp_dir, exist_ok=True)
    config["main_args"] = dict(config.get("main_args") or {}, exp_dir=exp_dir)
    if rank == 0:
        with open(os.path.join(exp_dir, "conf.yml"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    print_only("Instantiating losses <{}>".format(config["loss"]["train"]["loss_func"]))
    loss_func = {"train": build_loss(config["loss"]["train"]), "val": build_loss(config["loss"]["val"])}
    system = AudioSystem(audio_model=model, loss_func=loss_func, optimizer=optimizer,
                         train_loader=train_loader, val_loader=val_loader,
                         test_loader=test_loader, scheduler=scheduler, config=config)
    if WARM_START is not None:
        system.warm_start = WARM_START
    trainer = Trainer(
        exp_dir=exp_dir,
        epochs=config["training"]["epochs"],
        early_stop=config["training"].get("early_stop"),
        logger_dir=os.path.join(os.getcwd(), "Experiments", "tensorboard_logs",
                                config["exp"]["exp_name"]),
        checkpoint={"monitor": "val_loss/dataloader_idx_0", "mode": "min", "save_top_k": 5},
        precision=config["training"].get("precision", "float32"),
        seed=config["training"].get("seed", 42),
        fused_forward=bool(config["training"].get("fused_forward", False)),
        remat=bool(config["training"].get("remat", False)),
        sp=sp,
        device=device,
    )
    trainer.fit(system)
    print_only(f"Training finished; artifacts in {exp_dir}")
    return exp_dir


def config_from_cli(argv) -> dict:
    """The config of ``--conf-dir`` (a YAML file) with the command line's
    overrides: ``--<leaf> value`` for a leaf of the file, and
    ``--<group>.<leaf> value`` for any key (``--training.precision
    bfloat16``)."""
    import yaml

    from .utils.parser_utils import parse_args_as_dict, prepare_parser_from_dict, split_dotted_overrides

    dotted, argv = split_dotted_overrides(list(argv))
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf-dir", default="configs/convtasnet_lrs3.yml",
                        help="YAML config of the experiment")
    args, _ = parser.parse_known_args(argv)
    with open(args.conf_dir) as f:
        def_conf = yaml.safe_load(f)
    parser = prepare_parser_from_dict(def_conf, parser=parser)
    arg_dic = parse_args_as_dict(parser, args=argv)
    # the nested config with the CLI overrides applied
    config = {group: leaves for group, leaves in arg_dic.items()}
    for group in def_conf:
        config.setdefault(group, def_conf[group])
    for (group, leaf), value in dotted.items():
        config.setdefault(group, {})[leaf] = value
    return config


if __name__ == "__main__":
    import sys

    init_distributed()
    main(config_from_cli(sys.argv[1:]))
