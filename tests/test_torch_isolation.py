"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import repro_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(_modules()) >= 20


@pytest.mark.parametrize("module", ["repro_torch.fleet", "repro_torch.sim",
                                    "repro_torch.launch.serve",
                                    "repro_torch.launch.fleet",
                                    "repro_torch.kvstore.sim",
                                    "repro_torch.prefixcache",
                                    "repro_torch.prefixcache.index",
                                    "repro_torch.scale",
                                    "repro_torch.scale.state",
                                    "repro_torch.scheduling.registry",
                                    "repro_torch.training",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.train_small",
                                    "repro_torch.meshserve",
                                    "repro_torch.meshserve.world",
                                    "repro_torch.sharding",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.quickstart",
                                    "repro_torch.launch.serve_cluster",
                                    "repro_torch.roofline",
                                    "repro_torch.core.opcount",
                                    "repro_torch.roofline.analysis",
                                    "repro_torch.roofline.report"])
def test_fleet_sim_and_launch_import_alone(module):
    """The fleet layer, the simulator, the launchers, the simulator's
    store, the prefix cache, the scale layer (whose kernels the registry
    imports), the training substrate, the dry run and the roofline import
    on their own without JAX or the JAX package."""
    assert module in _modules()
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no card, entry points that default to CUDA raise."""
    from repro_torch.configs import get_config
    from repro_torch.kvstore import PagedStore
    from repro_torch.models import init_params, init_state
    from repro_torch.serving import InstanceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        InstanceEngine(cfg, params, num_slots=2, kv_capacity=16)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedStore(cfg, 2, 16)
    from repro_torch.fleet import FixedFleet, FleetController, KillInstance
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.scheduling.live import LiveCluster
    with pytest.raises(RuntimeError, match="cuda"):
        LiveCluster(cfg, params, 2, 2, 16, "accellm", fleet=FleetController(
            FixedFleet((KillInstance(1.0, 1),))))
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--arch", "starcoder2-3b", "--instances", "2",
                    "--requests", "1"])


def test_mesh_entry_points_refuse_cpu_fallback(monkeypatch):
    """The mesh entry points default to the card too: without one they
    raise unless given ``device="cpu"``; with fewer cards than ranks the
    launcher raises ``MeshError`` (one process per card)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.meshserve import MeshError, MeshPlacement, carve_slices
    from repro_torch.models import init_params
    from repro_torch.serving import InstanceEngine
    cfg = get_config("starcoder2-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    (sl,) = carve_slices(1, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MeshPlacement.carve(2, tp=1, world=2)
    with pytest.raises(RuntimeError, match="cuda"):
        InstanceEngine(cfg, params, num_slots=2, kv_capacity=16, mesh=sl)
    argv = ["--arch", "starcoder2-3b", "--instances", "2", "--requests",
            "1", "--mesh-tp", "2"]
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(MeshError, match="4 cards"):
        serve_main(argv)
    assert InstanceEngine(cfg, params, num_slots=2, kv_capacity=16,
                          mesh=sl, device="cpu").mesh is sl


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when no
    card is visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_times_refuses_without_cuda(tmp_path):
    """``kernel_times.py`` exits non-zero and prints no timing when no card
    is visible."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "kernel_times.py")],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert '"kernel"' not in res.stdout
