"""AudioSystem, the training-system container (counterpart of
``audio_only_speech_separation_tpu/train/system.py``).

The analog of the reference's ``AudioLightningModule``
(look2hear/system/audio_litmodule.py:37-209): holds model, train/val loss
dict, optimizer transformation, loaders, scheduler and config.  Exported
under both names so YAML configs with ``system: AudioLightningModule`` run
unchanged.  Unlike Lightning, this object is pure state — the explicit
Trainer owns the loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class AudioSystem:
    def __init__(
        self,
        audio_model=None,
        loss_func: Optional[Dict[str, Any]] = None,
        optimizer=None,
        train_loader=None,
        val_loader=None,
        test_loader=None,
        scheduler=None,
        config: Optional[dict] = None,
    ):
        self.audio_model = audio_model
        self.loss_func = loss_func or {}
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.scheduler = scheduler
        self.config = config or {}
        # sanitized flat view for hparam logging (Lightning's save_hyperparameters)
        self.hparams = self.config_to_hparams(self.config)
        # Lightning-parity default monitor key (audio_litmodule.py:61)
        self.default_monitor = "val_loss/dataloader_idx_0"

    @staticmethod
    def config_to_hparams(dic: dict) -> dict:
        """Flatten the nested config and sanitize values for hparam logging
        (reference audio_litmodule.py:14-34,190-209): nested keys join with
        "_", ``None`` becomes the string "None", lists/tuples become numpy
        arrays (the reference converts to torch.Tensor for SummaryWriter)."""
        import numpy as np

        def flatten(d: dict, parent: str = "") -> dict:
            items: dict = {}
            for k, v in d.items():
                key = f"{parent}_{k}" if parent else str(k)
                if isinstance(v, dict):
                    items.update(flatten(v, key))
                else:
                    items[key] = v
            return items

        flat = flatten(dict(dic))
        for k, v in flat.items():
            if v is None:
                flat[k] = "None"
            elif isinstance(v, (list, tuple)):
                flat[k] = np.asarray(v)
        return flat


# API-parity alias: configs say `system: AudioLightningModule`
AudioLightningModule = AudioSystem
