"""The port's serving slice end to end against the JAX package: a
checkpoint the JAX package wrote, loaded by the port, served in buckets,
and the port's imports free of JAX."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import torch
from torch_port_helpers import make_pair

from audio_only_speech_separation_tpu.models import TasNet as JTasNet
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.utils.separator import separate as jax_separate
from audio_only_speech_separation_tpu_torch.models import from_pretrain
from audio_only_speech_separation_tpu_torch.serve import serve
from audio_only_speech_separation_tpu_torch.utils.separator import separate

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want):
    """float32 in both packages: max error <= 1e-4 of the output's scale."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_jax_checkpoint_serves_through_the_port(tmp_path):
    jm, params, _ = make_pair(seed=11)
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    model = from_pretrain(ckpt, device="cpu").eval()
    assert model.model_args()["num_spks"] == jm.num_spks

    rng = np.random.default_rng(12)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (9100, 3000, 5555)]
    est = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=2)
    # the JAX model on the same batches: sorted by length, padded to 1 s
    # (8000 samples) multiples: [3000, 5555] -> 8000, [9100] -> 16000
    apply = jax.jit(jm.apply)
    for idxs, T_pad in (([1, 2], 8000), ([0], 16000)):
        mix = np.zeros((len(idxs), T_pad), np.float32)
        for j, i in enumerate(idxs):
            mix[j, : len(wavs[i])] = wavs[i]
        want = np.asarray(apply(params, mix))
        for j, i in enumerate(idxs):
            _close(est[i], want[j, :, : len(wavs[i])])

    for wav in (wavs[1], np.stack([wavs[1], wavs[1][::-1].copy()])):
        _close(separate(model, wav), np.asarray(jax_separate(jm, params, wav)))


_GUARD = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml")
    JAX_PKG = "audio_only_speech_separation_tpu"
    ALLOWED = ()  # no module of the JAX package, not even a JAX-free one

    def jax_package_module(name):
        return name == JAX_PKG or name.startswith(JAX_PKG + ".")

    def allowed(name):
        return name in ALLOWED

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError("blocked import: " + name)
            if jax_package_module(name) and not allowed(name):
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import torch
    import audio_only_speech_separation_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    import chip_smoke
    import audio_only_speech_separation_tpu_torch.data as datas
    assert datas.get("LRS3DataModule").__module__.startswith(pkg.__name__ + ".data")
    assert datas.get("LRS2DataModule") is not None
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet, from_pretrain
    assert from_pretrain(sys.argv[1], device="cpu").num_spks == 2  # a JAX-written checkpoint
    tasnet = from_pretrain(sys.argv[2], device="cpu").eval()  # a JAX-written TasNet (DPTNet) checkpoint
    with torch.no_grad():
        assert tasnet(torch.zeros(1, 900)).shape == (1, 2, 900)
    from audio_only_speech_separation_tpu_torch.models.convtasnet import (
        fused_inference_forward, make_kernel_train_apply)
    model = ConvTasNet(N=128, H=128, X=2, R=1).eval()
    x = torch.randn(1, 1000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert model(x).shape == (1, 2, 1000)
        assert fused_inference_forward(model, x).shape == (1, 2, 1000)
    # one bf16 train step through the training path (the chain's plain
    # versions on the CPU)
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train import make_optimizer
    opt = make_optimizer(model.parameters(), lr=1e-3, grad_clip=5.0)
    apply_fn = make_kernel_train_apply(model)
    params = dict(model.named_parameters())
    src = torch.randn(1, 2, 1000, generator=torch.Generator().manual_seed(1))
    est = apply_fn({k: v.to(torch.bfloat16) for k, v in params.items()},
                   src.sum(1).to(torch.bfloat16))
    loss = PITLossWrapper(pairwise_neg_snr)(est.float(), src)
    loss.backward()
    before = params["mask.weight"].detach().clone()
    opt.step()
    assert torch.isfinite(loss) and not torch.equal(before, params["mask.weight"])
    assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
    assert all(allowed(n) for n in sys.modules if jax_package_module(n))
    print("ok")
    """
)


def test_port_imports_no_jax(tmp_path):
    """Every module of the port, and chip_smoke.py, imports, loads
    checkpoints the JAX package wrote (a ConvTasNet and a TasNet), runs tiny
    forwards and one bf16 train step, with jax, jaxlib, flax, optax, yaml and
    every module of the JAX package blocked (its data layer too: the port
    has its own)."""
    jm, params, _ = make_pair(seed=13)
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    jt = JTasNet(enc_dim=16, bn_dim=16, hidden_dim=16, layer=1, module="DPTNet", block_size=10,
                 sample_rate=8000)
    tasnet_ckpt = str(tmp_path / "tasnet.pth")
    jax_save(jax_serialize(jt, jt.init(jax.random.PRNGKey(0), np.zeros((1, 200), np.float32))),
             tasnet_ckpt)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _GUARD, ckpt, tasnet_ckpt], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
