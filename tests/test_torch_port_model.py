"""The port's eager ConvTasNet, weight round trip, packers and envelope,
against the JAX package."""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, make_pair, waves

from audio_only_speech_separation_tpu.ops.pallas import convtasnet_block as jblock
from audio_only_speech_separation_tpu.utils.torch_import import convert_convtasnet
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward
from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as tblock
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "overrides,T",
    [
        ({}, 4000),
        ({"activate": "sigmoid", "num_spks": 3}, 3999),
        ({"activate": "softmax", "norm": "cLN", "N": 64, "H": 96, "B": 48}, 1001),
        ({"causal": True, "N": 64, "H": 96, "B": 48}, 1001),
    ],
)
def test_eager_model_matches_jax(overrides, T):
    """Same weights, same input: relative error <= 1e-4 of the output's
    scale (float32 in both; summation orders differ)."""
    jm, params, tm = make_pair(seed=1, **overrides)
    x = waves(2, 2, T)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale, (np.abs(got - want).max(), scale)


def test_state_dict_round_trips_to_the_jax_tree():
    """The look2hear key names let the JAX package's converter turn the
    port's state_dict back into the JAX tree, exactly."""
    _, params, tm = make_pair(seed=2)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_convtasnet(sd, X=tm.X, R=tm.R)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want), err_msg=str(path))


def test_full_packer_matches_jax():
    """bf16 arrays equal exactly; f32 folds agree to 1e-6 (both fold in f64,
    one rounding to f32 each)."""
    _, params, tm = make_pair(seed=3, num_spks=3)
    want = jblock.pack_convtasnet_full_params(params, tm.R, tm.X, tm.num_spks)
    got = tblock.pack_convtasnet_full_params(tm.state_dict(), tm.R, tm.X, tm.num_spks)
    names = ["we", "w1s", "wsgs", "vecs", "cs", "alphas", "wm", "bm", "wd"]
    for name, w, g in zip(names, want[:9], got[:9]):
        w = np.asarray(w.astype(np.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, name
        if name in ("we", "w1s", "wsgs", "wm", "wd"):  # bf16
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6, err_msg=name)
    assert got[9] == tuple(want[9])


@pytest.mark.parametrize(
    "overrides",
    [{"norm": "cLN"}, {"causal": True}, {"P": 5}, {"activate": "softmax"}, {"N": 64, "H": 64}, {"L": 8}],
)
def test_envelope_raises_and_dispatch_goes_eager(overrides):
    """Outside the kernel's envelope the fused forward raises (no quiet
    fallback), and the serving dispatch picks the module."""
    tm = ConvTasNet(**dict(SMALL, **overrides))
    with pytest.raises(ValueError, match="envelope"):
        fused_inference_forward(tm, torch.zeros(1, 800))
    assert choose_dispatch(tm, use_bf16=True, device="cuda") == "eager"
    assert choose_dispatch(tm, use_bf16=True, device="cpu") == "eager"


def test_dispatch_inside_envelope():
    _, _, tm = make_pair(seed=5)
    assert choose_dispatch(tm, use_bf16=True, device="cuda") == "fused"
    assert choose_dispatch(tm, use_bf16=False, device="cuda") == "eager"
    assert choose_dispatch(tm, use_bf16=True, device="cpu") == "eager"


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """On a non-CPU tensor the wrapper launches the kernel or raises; it
    never quietly runs the plain version.  A meta tensor stands in for a
    device tensor here: the wrapper must refuse it before any launch."""
    _, _, tm = make_pair(seed=6)
    *w, dils = tblock.pack_convtasnet_full_params(tm.state_dict(), tm.R, tm.X, tm.num_spks)
    frames = torch.empty((1, 100, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no separator kernel"):
        tblock.fused_convtasnet_separator(frames, *w, dilations=dils, nspk=2)
