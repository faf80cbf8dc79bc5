"""The port offers every public name of the JAX package.

One case per module of ``audio_only_speech_separation_tpu/``: both packages
are parsed with ``ast`` (neither is imported), and each public top-level
``def``/``class`` name, public module-level alias (a name bound to another
name or attribute), UPPER-case constant and, in an ``__init__.py``, each
name of ``__all__`` must be defined or imported at the top level of the
port module at the same path (``ops/pallas/`` is ``ops/kernels/``), or be
listed in ``MOVED`` (held by another port module, under the name given
there) or in ``NOT_PORTED`` (with the reason it is not carried over).
A second test holds both maps to the two packages.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "audio_only_speech_separation_tpu"
PORT_PKG = ROOT / "audio_only_speech_separation_tpu_torch"

# (JAX module, name) -> (port module, name there): held outside the port
# module at the JAX module's path, or under another name
MOVED = {
    ("ops/pallas/__init__.py", "fused_tcn_separator"): ("ops/kernels/convtasnet_block.py", "fused_tcn_separator"),
    # the chain with the fused forward and backward: the dilations are an argument, not bound by a factory
    ("ops/pallas/convtasnet_backward.py", "make_tcn_chain"): ("ops/kernels/convtasnet_backward.py", "tcn_chain"),
    # the chain's XLA oracle sits beside the forward kernel it checks
    ("ops/pallas/convtasnet_backward.py", "tcn_chain_xla"): ("ops/kernels/convtasnet_block.py",
                                                             "tcn_chain_reference"),
    # the kernel's eligibility predicate; the TPU padding rules in the JAX one do not apply to K4
    ("ops/pallas/attention.py", "attention_eligible"): ("ops/kernels/attention.py", "attention_kernel_ok"),
}

_TPU_LAYOUT = "a TPU layout constant or VMEM knob of the Pallas kernel; the CUDA kernel has its own tiling"
_SHARDING = ("builds a NamedSharding or a with_sharding_constraint annotation for XLA's partitioner; the port "
             "has none: DDP ranks hold their shard, replicate() wraps the module, the collectives are written out")
# a JAX module (path) or a public name, wherever the JAX package offers it ->
# why the port does not carry it over
NOT_PORTED = {
    "TILE": _TPU_LAYOUT,
    "PAD": _TPU_LAYOUT,
    "CHUNK": _TPU_LAYOUT,
    "MAX_BT": _TPU_LAYOUT,
    "RES_VMEM_BUDGET": _TPU_LAYOUT,
    "HEADS_PER_BLOCK": _TPU_LAYOUT,
    "MAX_T_PAD": _TPU_LAYOUT,
    "fused_vmem_bytes": "the kernel's VMEM budget on a TPU core",
    "widen_wsgs_for_sum_dot": "a weight layout for the TPU kernel's sum-dot",
    "pack_convtasnet_full_params_jnp": "a jnp copy of the weight packing, for packing inside jit; the port "
                                       "packs once with torch",
    "bilstm_eligible": "the TPU gate of K5, replaced by ops/rnn.py::kernel_choice, measured on the H100 "
                       "(scripts/profile_port_lstm_crossover.py)",
    "resident_eligible": "the TPU gate of K6, replaced by ops/rnn.py::kernel_choice, measured on the H100 "
                         "(scripts/profile_port_lstm_crossover.py)",
    "utils/kernel_hashes.py": "pins the Pallas sources to a validation run on a TPU; the port rebuilds its "
                              "library whenever a source's hash changes (ops/kernels/_build.py)",
    "utils/torch_import.py": "converts look2hear torch checkpoints for the JAX models; the port's modules "
                             "take those state_dicts as they are",
    "batch_sharding": _SHARDING,
    "replicated_sharding": _SHARDING,
    "maybe_shard": _SHARDING,
}

JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def port_path(jax_module: str) -> str:
    """The port module at a JAX module's path."""
    return jax_module.replace("ops/pallas/", "ops/kernels/")


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _all_names(tree: ast.Module) -> set:
    """The strings of ``__all__ = [...]`` and ``__all__ += [...]``."""
    names = set()
    for node in tree.body:
        target = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
        if isinstance(node, (ast.Assign, ast.AugAssign)) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in target):
            names |= {e.value for e in node.value.elts if isinstance(e, ast.Constant)}
    return names


def public_names(tree: ast.Module, is_init: bool) -> set:
    """The names a JAX module offers (see the module docstring)."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and (t.id.isupper() or isinstance(node.value, (ast.Name, ast.Attribute))):
                    names.add(t.id)
    if is_init:
        names |= _all_names(tree)
    return {n for n in names if not n.startswith("_")}


def defined_names(tree: ast.Module) -> set:
    """Every name a module binds at its top level, in conditional and try
    blocks too: definitions, assignments and imports."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for h in getattr(node, "handlers", []):
                    visit(h.body)
                visit(getattr(node, "finalbody", []))

    visit(tree.body)
    return names


def test_package_root_matches_jax():
    """The port's package root has the JAX package's ``__version__`` and
    its lazy subpackages: each of the nine loads at first access, ``dir``
    lists them, any other name raises AttributeError."""
    import importlib

    import audio_only_speech_separation_tpu as jax_pkg
    import audio_only_speech_separation_tpu_torch as port

    assert port.__version__ == jax_pkg.__version__
    assert port._SUBPACKAGES == jax_pkg._SUBPACKAGES
    for name in port._SUBPACKAGES:
        assert name in dir(port)
        assert getattr(port, name) is importlib.import_module(f"audio_only_speech_separation_tpu_torch.{name}")
    with pytest.raises(AttributeError):
        port.not_a_subpackage


def test_jax_modules_found():
    assert len(JAX_MODULES) >= 77 and "__init__.py" in JAX_MODULES


@pytest.mark.parametrize("jax_module", JAX_MODULES)
def test_port_offers_every_public_name(jax_module):
    if jax_module in NOT_PORTED:  # a module left out whole: the port has no module there
        assert not (PORT_PKG / port_path(jax_module)).exists()
        return
    wanted = public_names(_tree(JAX_PKG / jax_module), jax_module.endswith("__init__.py"))
    port = PORT_PKG / port_path(jax_module)
    have = defined_names(_tree(port)) if port.exists() else set()
    missing = sorted(n for n in wanted - have if (jax_module, n) not in MOVED and n not in NOT_PORTED)
    assert port.exists() or not wanted, f"no port module {port_path(jax_module)} for {sorted(wanted)}"
    assert not missing, (f"the port's {port_path(jax_module)} lacks {missing}: port them, or list them in "
                         "MOVED or NOT_PORTED with the reason")


def test_moved_and_not_ported_are_honest():
    """Every MOVED target exists and holds its name; no NOT_PORTED entry
    exists in the port; every entry names what the JAX package has, and
    what a module case would otherwise ask for."""
    for (jax_module, name), (port_module, port_name) in MOVED.items():
        assert name in public_names(_tree(JAX_PKG / jax_module), jax_module.endswith("__init__.py")), (
            jax_module, name)
        assert port_module != port_path(jax_module) or port_name != name, (jax_module, name)
        assert port_name in defined_names(_tree(PORT_PKG / port_module)), (port_module, port_name)
    offered = {n for m in JAX_MODULES for n in public_names(_tree(JAX_PKG / m), m.endswith("__init__.py"))}
    port_names = {n for p in PORT_PKG.rglob("*.py") for n in defined_names(_tree(p))}
    for key in NOT_PORTED:
        if key.endswith(".py"):
            assert (JAX_PKG / key).exists(), key
            assert not (PORT_PKG / port_path(key)).exists(), f"{key} exists in the port"
        else:
            assert key in offered, f"NOT_PORTED lists {key}, which the JAX package does not offer"
            assert key not in port_names, f"NOT_PORTED lists {key}, which the port defines"
