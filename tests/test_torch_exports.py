"""repro_torch's subpackages export what the JAX package's export.

Every name that ``src/repro/{core,kernels,runtime,configs,models,data,
optim,checkpoint}/__init__.py`` imports must import from the port's
counterpart; the JAX ``launch`` package exports nothing, so its modules
(``mesh``, ``serve``, ``train``, ``sharding``, ``roofline``,
``hlo_cost``, ``dryrun``) and ``models.pshint`` are held name for name.
No module of the port raises ``NotImplementedError`` naming a ROADMAP
item. Importing the subpackages builds no CUDA kernel and loads neither
JAX nor the JAX package.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "kernels", "runtime", "configs", "models", "data",
               "launch", "optim", "checkpoint")
# every export is ported
NOT_YET_PORTED = set()
# modules of the JAX launch package the port carries whole (and pshint)
LAUNCH_MODULES = ("mesh", "serve", "train", "sharding", "roofline",
                  "hlo_cost", "dryrun")
OTHER_MODULES = ("models/pshint", "core/filtering", "core/variants")


def _reference_names(sub: str):
    """The names the JAX package's ``__init__`` imports, by parsing it (so
    this test imports no JAX)."""
    tree = ast.parse((ROOT / "src" / "repro" / sub / "__init__.py")
                     .read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


CASES = [(sub, name) for sub in SUBPACKAGES
         for name in _reference_names(sub)]


def test_reference_exports_are_parsed():
    """The parse sees the JAX package's exports (a guard against an empty
    parametrization passing vacuously)."""
    assert len(CASES) >= 50
    assert {"ReconService", "standard_geometry", "backproject_ref",
            "ModelConfig", "build_model", "ByteTokenizer"} <= {
        n for _, n in CASES}
    assert {"make_mesh", "BatchedServer", "make_train_step",
            "TrainState"} <= {n for _, n in LAUNCH_CASES}
    assert {"TokenPipeline", "adamw_update", "Checkpointer"} <= {
        n for _, n in CASES}


def _reference_definitions(module: str):
    """The public functions and classes a JAX package module defines."""
    tree = ast.parse((ROOT / "src" / "repro" / f"{module}.py").read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")]


LAUNCH_CASES = [(mod, name) for mod in LAUNCH_MODULES
                for name in _reference_definitions(f"launch/{mod}")]
OTHER_CASES = [(mod, name) for mod in OTHER_MODULES
               for name in _reference_definitions(mod)]


@pytest.mark.parametrize("mod, name", LAUNCH_CASES,
                         ids=[f"launch.{m}.{n}" for m, n in LAUNCH_CASES])
def test_reference_launch_names_in_port(mod, name):
    port = importlib.import_module(f"repro_torch.launch.{mod}")
    assert callable(getattr(port, name, None)), \
        f"repro_torch.launch.{mod} lacks {name}"


@pytest.mark.parametrize("mod, name", OTHER_CASES,
                         ids=[f"{m}.{n}" for m, n in OTHER_CASES])
def test_reference_module_names_in_port(mod, name):
    """Every public function and class of these reference modules has its
    counterpart (``fdk_preweight_and_filter`` and ``uses_symmetry`` were
    the last two)."""
    port = importlib.import_module("repro_torch." + mod.replace("/", "."))
    assert callable(getattr(port, name, None)), \
        f"repro_torch.{mod} lacks {name}"


def test_no_module_raises_naming_a_roadmap_item():
    """No source of the port raises NotImplementedError (the marker of a
    path not ported yet), and the helper that built it is gone."""
    src = ROOT / "src" / "repro_torch"
    hits = [str(p.relative_to(src)) for p in src.rglob("*.py")
            if "NotImplementedError" in p.read_text()
            or "_unported" in p.read_text()]
    assert not hits, hits


@pytest.mark.parametrize("sub, name", CASES,
                         ids=[f"{s}.{n}" for s, n in CASES])
def test_reference_export_imports_from_port(sub, name):
    mod = importlib.import_module(f"repro_torch.{sub}")
    if (sub, name) in NOT_YET_PORTED:
        assert name not in vars(mod), f"{name} is ported: drop it from " \
            "NOT_YET_PORTED"
        return
    assert hasattr(mod, name), f"repro_torch.{sub} does not export {name}"


def test_runtime_keeps_the_autotune_submodule():
    """As in the JAX package, the autotune FUNCTION is not re-exported:
    it would shadow the submodule."""
    import repro_torch.runtime as rt
    assert rt.autotune.__name__ == "repro_torch.runtime.autotune"
    assert callable(rt.autotune.autotune)


def test_kernel_names_are_modules_with_entry_points_in_ops():
    """``from repro_torch.kernels import backproject_subline`` gives the
    kernel module (wrappers, counters, plain versions); the entry point
    the JAX package exports under that name is the one in ``ops``, and
    it runs on the CPU."""
    import types

    import numpy as np
    import torch
    from repro_torch.core import projection_matrices, standard_geometry
    from repro_torch.kernels import (backproject_banded, backproject_onehot,
                                     backproject_ref, backproject_subline,
                                     ops)
    geom = standard_geometry(n=8, n_det=12, n_proj=4)
    img = torch.from_numpy(np.random.default_rng(0).random(
        (4, geom.nw, geom.nh), dtype=np.float32))
    mats = projection_matrices(geom, "cpu")
    want = backproject_ref(img, mats, geom.volume_shape_xyz)
    for mod in (backproject_subline, backproject_onehot, backproject_banded):
        assert isinstance(mod, types.ModuleType) and not callable(mod)
        assert hasattr(mod, "LAUNCHES")
        entry = getattr(ops, mod.__name__.rpartition(".")[2])
        got = entry(img, mats, geom.volume_shape_xyz, nb=2, device="cpu")
        assert got.shape == want.shape
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_importing_subpackages_builds_nothing():
    """A fresh process imports the subpackages: no kernel library is built
    or loaded, and no JAX module comes with them."""
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.kernels, repro_torch.runtime\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.data\n"
        "import repro_torch.launch.mesh, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.optim\n"
        "import repro_torch.launch.sharding, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.roofline, repro_torch.launch.hlo_cost\n"
        "import repro_torch.models.pshint\n"
        "import repro_torch.checkpoint\n"
        "from repro_torch.kernels import _build, backproject_subline as ks\n"
        "from repro_torch.kernels import forward_project as kf\n"
        "assert _build._loaded == {} and _build.build_log == {}\n"
        "assert ks._LIB is None and kf._LIB is None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
