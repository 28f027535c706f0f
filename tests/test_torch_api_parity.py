"""Every public name of the JAX package has its counterpart in the port.

Both trees are read with ``ast``; neither package is imported.  For each
module that both packages have (the same path under ``cometbft_tpu/``
and ``cometbft_tpu_torch/``), the JAX module's public names are

  * its top-level functions and classes (no leading underscore),
  * the public methods and the dunder methods of those classes,
  * its constants: ALL-CAPS assignments and ``__version__``,

counting those under a top-level ``if`` or ``try`` too (not under an
``except``: a stand-in there replaces an import).  Each must be
defined in the port's module of the same path (a def, a class, an
assignment or an import there; a method on the class, on a base class
of the same module, or made by ``@dataclass``), or stand in NOT_PORTED.
A JAX module with no port module of the same path must stand in
NOT_PORTED as well.

To leave a name out on purpose, add it to NOT_PORTED as
``"path/in/the/package.py:Name"`` (a class covers its methods; a bare
path covers a whole module) with its reason, and add the same line to
ROADMAP.md's "Deliberately not ported" list.  The guard does not judge
the names the port adds.
"""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "cometbft_tpu"
PORT_PKG = REPO / "cometbft_tpu_torch"

_BREAKER = ("a circuit breaker to the CPU, which the no-fallback rule "
            "excludes")
_CPU_BATCH = "a CPU ed25519 batch path"
_PALLAS = "the Pallas layout does not exist in the port"

NOT_PORTED = {
    # whole modules
    "crypto/_aead_fallback.py":
        "copied as cometbft_tpu_torch/crypto/_aead_ref.py",
    "crypto/_native_loader.py":
        "the port builds its own host libraries (ops/_build.py)",
    "libs/breaker.py": _BREAKER,
    "ops/aot.py": "AOT export for the TPU",
    "tools/tpu_probe.py": "the pooled-TPU prober",
    "ops/ed25519_jax.py":
        "the XLA kernel; its counterpart is B1's plain version "
        "(ops/ed25519_kernel.py)",
    "ops/ed25519_pallas.py":
        "B1, ported as ops/ed25519_kernel.py over "
        "ops/csrc/ed25519_verify.cu",
    "ops/ed25519_pallas8.py":
        "B2, ported as ops/ed25519_kernel8.py over "
        "ops/csrc/ed25519_verify8.cu",
    "ops/field24.py":
        "the Pallas B1's limb schedule; the CUDA B1 has its own field "
        "(ops/field.py, ops/csrc/ed25519_field.cuh)",
    # names
    "crypto/batch.py:GuardedTpuBatchVerifier": _BREAKER,
    "crypto/batch.py:tpu_breaker": _BREAKER,
    "crypto/batch.py:reset_tpu_breaker": _BREAKER,
    "crypto/batch.py:get_backend":
        "the port chooses its device with device=, and the CPU backend "
        "is not ported",
    "crypto/batch.py:set_backend":
        "the port chooses its device with device=, and the CPU backend "
        "is not ported",
    "crypto/batch.py:register_pad_bucket_fn":
        "the port's pad_bucket reads its own ladder (ops/ed25519._bucket)",
    "crypto/ed25519.py:CpuBatchVerifier": _CPU_BATCH,
    "crypto/pipeline.py:verify_items_pipelined": _CPU_BATCH,
    "ops/microbench.py:generate": "AOT export for the TPU",
    "ops/microbench.py:LIMBS": _PALLAS,
    "ops/microbench.py:BLOCK": _PALLAS,
    "parallel/report.py:R4_MEASURED":
        "a TPU measurement, which may not carry over",
    "parallel/mesh.py:BATCH_AXIS":
        "the port's mesh is a list of CUDA devices with no axis names",
}


def _modules(pkg: Path) -> set:
    return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")}


SHARED = sorted(_modules(JAX_PKG) & _modules(PORT_PKG))


def _top_level(body):
    """Top-level statements, through ``if`` and ``try`` blocks; not
    through ``except`` blocks, whose stand-ins replace an import."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for block in (node.body, node.orelse, node.finalbody):
                yield from _top_level(block)
        else:
            yield node


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if getattr(f, "id", getattr(f, "attr", None)) == "dataclass":
            return True
    return False


def _methods(cls: ast.ClassDef) -> set:
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def jax_names(path: Path) -> set:
    """The public names of a JAX module: ``name`` or ``Class.method``."""
    out = set()
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            out |= {f"{node.name}.{m}" for m in _methods(node)
                    if not m.startswith("_") or _is_dunder(m)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= {n for n in _targets(node)
                    if (n.isupper() and not n.startswith("_"))
                    or n == "__version__"}
    return out


def port_names(path: Path) -> set:
    """Every name a port module defines or imports, and every method of
    its classes (with those of base classes in the same module)."""
    out, classes = set(), {}
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            classes[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out |= set(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}

    def methods(name, seen=()):
        cls = classes.get(name)
        if cls is None or name in seen:
            return set()
        got = _methods(cls)
        if _is_dataclass(cls):
            got |= {"__init__", "__repr__", "__eq__"}
        for base in cls.bases:
            got |= methods(getattr(base, "id", None), seen + (name,))
        return got

    for name in classes:
        out |= {f"{name}.{m}" for m in methods(name)}
    return out


def _not_ported(module: str, name: str) -> bool:
    return f"{module}:{name.split('.')[0]}" in NOT_PORTED


@pytest.mark.parametrize("module", SHARED)
def test_every_public_name_of_the_jax_module_is_in_the_port(module):
    missing = sorted(
        n for n in jax_names(JAX_PKG / module) - port_names(PORT_PKG / module)
        if not _not_ported(module, n))
    assert not missing, (
        f"cometbft_tpu/{module} has public names that "
        f"cometbft_tpu_torch/{module} lacks: {missing}; port them or add "
        f"each to NOT_PORTED with its reason (and to ROADMAP.md)")


def test_every_jax_module_has_a_port_module_or_a_reason():
    missing = sorted(_modules(JAX_PKG) - _modules(PORT_PKG) - set(NOT_PORTED))
    assert not missing, (
        f"JAX modules with no port module of the same path: {missing}")


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_every_not_ported_entry_names_what_the_port_lacks(entry):
    """A NOT_PORTED line names a JAX module or name that exists and that
    the port does not have: a stale line would hide nothing but mislead."""
    module, _, name = entry.partition(":")
    assert (JAX_PKG / module).exists()
    if not name:
        assert not (PORT_PKG / module).exists()
        return
    assert name in jax_names(JAX_PKG / module)
    assert name not in port_names(PORT_PKG / module)
