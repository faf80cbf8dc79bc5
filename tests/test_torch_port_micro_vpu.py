"""K7, the elementwise probe, on the CPU: the plain version that the port's
wrapper runs for a CPU tensor, against the JAX package's Pallas body
(``scripts/micro_vpu.py::make_kernel``) run through ``pl.pallas_call`` in
interpret mode, at [64, 128] for f32 and bf16, with and without stats.
The CUDA kernel itself is held against the plain version on the card
(``test_torch_port_cuda.py``, ``chip_smoke.py``)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_only_speech_separation_tpu_torch.ops.kernels.micro_vpu import (
    micro_vpu,
    micro_vpu_reference,
    ops_per_element,
)

torch.set_num_threads(2)

_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "micro_vpu.py")


def _script():
    spec = importlib.util.spec_from_file_location("micro_vpu_script", _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("with_stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_pallas_body_in_interpret_mode(dtype, with_stats):
    """f32: max abs error within 1e-5 of the output's magnitude (XLA and
    torch round the 64 multiply-adds differently: up to a dozen f32 ulps
    were seen).  bf16: within one bf16 ulp of the output's magnitude
    (2**-7 of it); a is 1 in bf16, so both round x + b once a step and
    agree exactly, which the test also reports."""
    script = _script()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(7).normal(size=(64, 128)).astype(np.float32)
    body = pl.pallas_call(script.make_kernel(jdt, with_stats),
                          out_shape=jax.ShapeDtypeStruct(x.shape, jdt), interpret=True)
    want = np.asarray(body(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = micro_vpu(torch.from_numpy(x).to(tdt), with_stats)
    assert got.dtype == tdt and got.shape == x.shape
    err = float(np.abs(got.float().numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0**-7) * scale, (err, scale)
    if dtype == "bfloat16":
        assert err == 0.0


def test_stats_and_the_script_op_count():
    """With ``return_stats`` the plain version also gives the f32 sum of
    squares of the 64 steps; adding it at 1e-30 leaves the output as without
    stats.  The op count is the script's: 64 x 5, 64 x 8 with stats."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(16, 32)).astype(np.float32))
    out, acc = micro_vpu_reference(x, with_stats=True, return_stats=True)
    y = x
    want = torch.zeros((), dtype=torch.float64)
    for _ in range(64):
        y = y * np.float32(1.0009) + np.float32(0.999)
        y = torch.where(y >= 0, y, np.float32(1.0009) * y)
        want += (y.double() ** 2).sum()
    assert abs(float(acc) - float(want)) <= 1e-5 * float(want)
    assert torch.equal(out, micro_vpu_reference(x))
    assert (ops_per_element(False), ops_per_element(True)) == (320, 512)


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused: there is
    no quiet fallback to the plain version."""
    with pytest.raises(ValueError, match="no micro_vpu kernel"):
        micro_vpu(torch.zeros(8, device="meta"))
