"""The port's boundary: it stands alone, and it never runs on the host
unless asked to.

* No module of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax``
  or anything of the reference package ``repro`` (an AST scan).
* ``import repro_torch`` (every module) succeeds where ``jax`` and
  ``repro`` cannot be imported at all (a subprocess with an import
  blocker).
* Entry points called without ``device=`` raise on a host without CUDA
  instead of quietly running the plain versions on the CPU.
"""

import argparse
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import e2e_accuracy
from repro_torch.core.calibration import calibrate_identity
from repro_torch.core.mapping import parallel_map
from repro_torch.core.noise import NoiseModel
from repro_torch.hw import make_twin
from repro_torch.configs import smoke_config
from repro_torch.quickstart import run
from repro_torch.serving import GatewayConfig, ServingGateway
from repro_torch.serving import gateway

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _absolute_imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"assert not any(m.split('.')[0] in {FORBIDDEN!r} "
        "for m in sys.modules)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_the_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    gen = torch.Generator().manual_seed(0)
    model = NoiseModel()
    w = torch.from_numpy(np.ones((9, 9), np.float32))
    calls = [lambda: resolve_device(None),
             lambda: make_twin(gen, 4, 9, model),
             lambda: calibrate_identity(gen, 4, 9, model),
             lambda: parallel_map(gen, w, 9, model),
             run,
             lambda: gateway.run(argparse.Namespace(
                 arch="smoke:qwen3-4b", seed=0, requests=1, rate=1.0,
                 prompt_len_range=(2, 3), max_new=(1, 2), eos_id=None,
                 slots=1, page_size=4, pages=4, max_pages_per_slot=2)),
             lambda: ServingGateway(smoke_config("qwen3-4b"), {},
                                    GatewayConfig()),
             e2e_accuracy.main]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    """Without CUDA it exits non-zero and prints no result; alone in a
    directory (no repository beside it) likewise."""
    script = REPO / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for path in (script, alone):
        out = subprocess.run([sys.executable, str(path)], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=path.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
