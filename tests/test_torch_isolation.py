"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro``, and the
port's entry points refuse to run on a missing GPU unless the caller asks
for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20          # every module was actually imported
    assert bad == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    found = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
             for p in files for line, mod in _imports(p)
             if _is_forbidden(mod)]
    assert found == []


def test_port_modules_mirror_the_reference_layout():
    for rel in ("configs/base.py", "configs/gemma_2b.py",
                "configs/minitron_4b.py", "core/lora.py", "models/common.py",
                "models/transformer.py", "models/model.py",
                "obs/metrics.py", "serve/pages.py", "serve/registry.py",
                "serve/oracle.py", "serve/engine.py", "serve/spec.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/bgmv.py",
                "kernels/paged_attn.py", "kernels/flash_attn.py",
                "kernels/verify.py", "kernels/lora_matmul.py",
                "configs/roberta_large.py", "data/synthetic.py",
                "data/partition.py", "optim/optimizers.py",
                "optim/schedules.py", "fed/client.py", "fed/simulation.py"):
        assert (PORT / rel).exists(), rel
        assert (ROOT / "src" / "repro" / rel).exists(), rel


def test_entry_points_refuse_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    from repro_torch.configs import get_reduced
    from repro_torch.models import model
    from repro_torch.serve import AdapterRegistry, ServeEngine
    cfg = get_reduced("gemma-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        AdapterRegistry(cfg)
    params = model.init_params(cfg, device="cpu")
    registry = AdapterRegistry(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg, registry)
    ServeEngine(params, cfg, registry, device="cpu")     # asked for: fine


def test_training_entry_points_refuse_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    from repro_torch.configs import get_reduced
    from repro_torch.fed import (evaluate, make_cohort_train,
                                 make_local_train)
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg = get_reduced("roberta-large")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_local_train(cfg, adamw(1e-3))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_cohort_train(cfg, adamw(1e-3))
    params = model.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros(2, 4, dtype=torch.int32),
             "labels": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(params, batch, cfg)
    assert set(evaluate(params, batch, cfg, device="cpu")) == {"loss", "acc"}
    make_local_train(cfg, adamw(1e-3), device="cpu")    # asked for: fine


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
