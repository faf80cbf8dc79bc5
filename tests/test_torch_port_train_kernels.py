"""The training slice's kernels on the CPU, where their wrappers run the
plain versions: the differentiable packer, the TCN chain's forward (K2)
and backward (K3), and ``make_kernel_train_apply``, each against the JAX
package on the same seeded inputs.  The CUDA kernels themselves are held
against these plain versions on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, as_numpy, make_pair

from audio_only_speech_separation_tpu.models import ConvTasNet as JConvTasNet
from audio_only_speech_separation_tpu.models.convtasnet import make_delayed_train_apply
from audio_only_speech_separation_tpu.ops.pallas.convtasnet_backward import tcn_chain_xla
from audio_only_speech_separation_tpu.ops.pallas.convtasnet_block import (
    pack_convtasnet_full_params_jnp,
)
from audio_only_speech_separation_tpu.utils.torch_import import convert_convtasnet
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import make_kernel_train_apply
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
    fused_tcn_backward,
    tcn_backward_reference,
    tcn_chain,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    fused_tcn_separator,
    pack_convtasnet_full_params_differentiable,
    tcn_separator_reference,
)
from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

torch.set_num_threads(2)
NAMES = ("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas")


def _rel(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.linalg.norm(want - got) / (np.linalg.norm(want) + 1e-9))


def _leaves(tree):
    return sorted(jax.tree_util.tree_flatten_with_path(tree)[0], key=lambda kv: str(kv[0]))


def _port_grads_as_jax_tree(names, grads, R, X):
    sd = {n: g.detach().float().numpy() for n, g in zip(names, grads)}
    return convert_convtasnet(sd, X=X, R=R)


# ---------------------------------------------------------------------------
# The differentiable packer
# ---------------------------------------------------------------------------


def test_differentiable_packer_matches_jnp_packer():
    """Values: the f32 outputs within 1e-5 relative, the bf16 ones within
    one bf16 rounding (the f32 folds sum in different orders).  VJP: the
    same random cotangents through both packers give the same parameter
    gradients, within 1e-5 relative, once the port's are mapped back
    through utils/torch_import.convert_convtasnet."""
    jm, params, tm = make_pair(seed=21)
    R, X, nspk = tm.R, tm.X, tm.num_spks
    names = [n for n, _ in tm.named_parameters()]
    tparams = {n: p.detach().clone().requires_grad_() for n, p in tm.named_parameters()}

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, vjp = jax.vjp(lambda p: pack_convtasnet_full_params_jnp(p, R, X, nspk)[:9], jp)
    got = pack_convtasnet_full_params_differentiable(tparams, R, X, nspk)
    assert got[9] == tuple(2**i for i in range(X)) * R
    rng = np.random.default_rng(22)
    cots_j, cots_t = [], []
    for w, g in zip(want, got[:9]):
        assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype)), (g.shape, w.shape)
        wf, gf = np.asarray(w, np.float32), g.detach().float().numpy()
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(gf, wf, rtol=2**-8, atol=1e-6)
        else:
            np.testing.assert_allclose(gf, wf, rtol=1e-5, atol=1e-5 * np.abs(wf).max())
        c = rng.standard_normal(w.shape).astype(np.float32)
        cots_j.append(jnp.asarray(c, w.dtype))
        cots_t.append(torch.from_numpy(c).to(g.dtype))
    (gj,) = vjp(tuple(cots_j))
    gt = torch.autograd.grad(got[:9], [tparams[n] for n in names], grad_outputs=cots_t)
    gt = _port_grads_as_jax_tree(names, gt, R, X)
    for (kj, a), (kt, b) in zip(_leaves(gj), _leaves(gt)):
        assert str(kj) == str(kt)
        assert _rel(a, b) < 1e-5, (str(kj), _rel(a, b))


# ---------------------------------------------------------------------------
# The chain: forward (K2's plain version) and backward (K3's)
# ---------------------------------------------------------------------------


def _chain_setup(nb=4, C=128, H=256, B=2, T=300, seed=0):
    """The JAX package's backward-test inputs (tests/test_tcn_backward.py:36)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w1s = (rng.normal(size=(nb, C, H)) * 0.1).astype(np.float32)
    wsgs = (rng.normal(size=(nb, H, C)) * 0.1).astype(np.float32)
    vecs = (rng.normal(size=(nb, 8, H)) * 0.3).astype(np.float32)
    vecs[:, 7] = 0.0
    cs = (rng.normal(size=(nb, 2, C)) * 0.1).astype(np.float32)
    alphas = (np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(B, T, C)).astype(np.float32)
    return (x, w1s, wsgs, vecs, cs, alphas), tuple(2**i for i in range(nb)), g


def _as_jax(args):
    bf = jnp.bfloat16
    x, w1s, wsgs, vecs, cs, alphas = args
    return (jnp.asarray(x, bf), jnp.asarray(w1s, bf), jnp.asarray(wsgs, bf), jnp.asarray(vecs),
            jnp.asarray(cs), jnp.asarray(alphas))


def _as_torch(args):
    bf = torch.bfloat16
    x, w1s, wsgs, vecs, cs, alphas = (torch.from_numpy(a) for a in args)
    return x.to(bf), w1s.to(bf), wsgs.to(bf), vecs, cs, alphas


@pytest.fixture(scope="module")
def jax_chain():
    """jax.vjp of the JAX oracle at the shape of tests/test_tcn_backward.py:36."""
    args, dils, g = _chain_setup()
    y, vjp = jax.vjp(lambda *a: tcn_chain_xla(*a, dils), *_as_jax(args))
    return args, dils, g, np.asarray(y, np.float32), vjp(jnp.asarray(g, jnp.bfloat16))


def test_chain_forward_matches_jax_oracle(jax_chain):
    """tcn_separator_reference (what fused_tcn_separator runs on a CPU
    tensor) against tcn_chain_xla: y, and each y_hist[:, b] against the JAX
    chain cut after b blocks, to bf16 rounding (atol 5e-2, rtol 2e-2, the
    JAX package's kernel-vs-oracle tolerance); the statistics are those
    of the plain block on each saved input."""
    args, dils, _, y_want, _ = jax_chain
    ta = _as_torch(args)
    T = ta[0].shape[1]
    y, y_hist, stats = fused_tcn_separator(*ta, dils, save_state=True)
    assert y_hist.shape == (2, 4, 320, 128) and stats.shape == (2, 4, 4)
    assert torch.equal(y_hist[:, 0, :T], ta[0]) and not y_hist[:, :, T:].any()
    np.testing.assert_allclose(y.float().numpy(), y_want, atol=5e-2, rtol=2e-2)
    ja = _as_jax(args)
    for b in range(1, len(dils)):
        cut = tcn_chain_xla(ja[0], *(a[:b] for a in ja[1:]), dils[:b])
        np.testing.assert_allclose(y_hist[:, b, :T].float().numpy(), np.asarray(cut, np.float32),
                                   atol=5e-2, rtol=2e-2)
    for b in range(len(dils)):
        one = [t[b : b + 1] for t in ta[1:]]
        _, _, st = tcn_separator_reference(y_hist[:, b, :T], *one, dils[b : b + 1], save_state=True)
        assert torch.equal(st[:, 0], stats[:, b])


def test_chain_backward_matches_jax_vjp(jax_chain):
    """TCNChain on CPU tensors (the plain forward and backward) against
    jax.vjp(tcn_chain_xla): rel-l2 < 6e-2 for each of the six cotangents,
    dalphas included (tests/test_tcn_backward.py:99-104); dvecs row 7
    exactly zero; the launch counters untouched on the CPU."""
    args, dils, g, _, want = jax_chain
    ta = [t.requires_grad_() for t in _as_torch(args)]
    counts = fused_tcn_separator.launches, fused_tcn_backward.launches
    y = tcn_chain(*ta, dils)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert (fused_tcn_separator.launches, fused_tcn_backward.launches) == counts
    for name, w, t in zip(NAMES, want, ta):
        assert t.grad.dtype == t.dtype
        assert _rel(w, t.grad.float().numpy()) < 6e-2, (name, _rel(w, t.grad.float().numpy()))
    assert bool((ta[3].grad[:, 7] == 0).all())


def test_backward_wrapper_is_its_plain_version_on_cpu():
    """fused_tcn_backward on CPU tensors is tcn_backward_reference, with
    the kernel's output dtypes (dx bf16, the rest f32); any other device
    raises."""
    args, dils, g = _chain_setup(nb=2, H=128, T=130)
    ta = _as_torch(args)
    y, y_hist, stats = fused_tcn_separator(*ta, dils, save_state=True)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    got = fused_tcn_backward(gt, y_hist, y, stats, *ta[1:], dils)
    want = tcn_backward_reference(gt, y_hist, y, stats, *ta[1:], dils)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in (gt, y_hist, y, stats, *ta[1:])]
    with pytest.raises(ValueError):
        fused_tcn_backward(*meta, dils)
    with pytest.raises(ValueError):
        fused_tcn_separator(*(t.to("meta") for t in ta), dils)


# ---------------------------------------------------------------------------
# The training forward
# ---------------------------------------------------------------------------


def test_kernel_train_apply_matches_jax_delayed_apply():
    """make_kernel_train_apply (the chain as TCNChain, here its plain
    versions) against the JAX package's make_delayed_train_apply, the plain
    XLA form of the same algebra, on a tiny ConvTasNet (N=H=128, X=2, R=1,
    2 speakers, T=3210) with the JAX model's own initial weights: loss
    within 5e-3 and gradients within rel-l2 0.1, the scalar PReLU slopes by
    sign and 0.5, the setting and bounds of tests/test_tcn_backward.py:
    149-176.  (The delayed form runs its tap chain in bf16, the port's
    chain in f32, so the slopes' gradients differ most.)"""
    jm = JConvTasNet(**SMALL)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3210)).astype(np.float32)
    tgt = rng.normal(size=(2, 2, 3210)).astype(np.float32)
    params = as_numpy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = ConvTasNet(**SMALL)
    sd = convtasnet_from_jax(params, tm.R, tm.X)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})

    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    fn_d = make_delayed_train_apply(jm)

    def loss_j(pp):
        est = fn_d(pp, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
        return jnp.mean((est - tgt) ** 2)

    ld, gd = jax.value_and_grad(loss_j)(pb)

    names = [n for n, _ in tm.named_parameters()]
    tparams = [p for _, p in tm.named_parameters()]
    fn_k = make_kernel_train_apply(tm)
    est = fn_k({n: p.to(torch.bfloat16) for n, p in zip(names, tparams)},
               torch.from_numpy(x).to(torch.bfloat16))
    assert est.dtype == torch.bfloat16 and est.shape == (2, 2, 3210)
    lk = ((est.float() - torch.from_numpy(tgt)) ** 2).mean()
    gk = _port_grads_as_jax_tree(names, torch.autograd.grad(lk, tparams), tm.R, tm.X)
    lk = float(lk.detach())
    assert abs(lk - float(ld)) < 5e-3 * max(1.0, abs(float(ld))), (lk, float(ld))
    for (kd, a), (kk, b) in zip(_leaves(gd), _leaves(gk)):
        assert str(kd) == str(kk)
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(b).all(), str(kd)
        if a.size <= 2:
            assert np.sign(a.sum()) == np.sign(b.sum()) and _rel(a, b) < 0.5, str(kd)
        else:
            assert _rel(a, b) < 0.1, (str(kd), _rel(a, b))


@pytest.mark.parametrize("bad", [dict(activate="softmax"), dict(causal=True), dict(norm="cLN"),
                                 dict(N=256, H=128)])
def test_kernel_train_apply_raises_outside_the_envelope(bad):
    """The JAX package treats any non-relu mask as sigmoid and returns None
    outside its envelope; the port raises."""
    cfg = dict(N=128, H=128, B=128, L=16, X=2, R=1, num_spks=2)
    cfg.update(bad)
    with pytest.raises(ValueError):
        make_kernel_train_apply(ConvTasNet(**cfg))
