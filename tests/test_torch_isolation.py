"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's examples ``examples/lm_pretrain_torch.py``,
``examples/fed_finetune_torch.py`` and ``examples/serve_adapters_torch.py``
import neither JAX nor anything of the reference package ``repro``, and the
port's entry points refuse to run on a missing GPU unless the caller asks
for the CPU."""
import ast
import importlib.util
import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = [ROOT / "examples" / "lm_pretrain_torch.py",
            ROOT / "examples" / "fed_finetune_torch.py",
            ROOT / "examples" / "serve_adapters_torch.py"]


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
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + EXAMPLES)
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
                "optim/schedules.py", "fed/client.py", "fed/simulation.py",
                "kernels/recon_agg.py", "core/svd.py", "core/aggregate.py",
                "core/agg_engine.py", "core/seeds.py", "core/rank.py",
                "fed/strategies.py", "fed/messages.py", "fed/session.py",
                "fed/schedulers.py", "fed/server.py", "fed/async_server.py",
                "util.py", "checkpoint/store.py",
                "launch/train.py", "obs/recorder.py", "obs/export.py",
                "obs/timeseries.py", "obs/slo.py", "obs/collect.py",
                "obs/report.py", "fed/compress.py", "fed/population.py",
                "fed/topology.py", "models/moe.py", "configs/olmoe_1b_7b.py",
                "configs/llama4_maverick_400b_a17b.py"):
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


def test_lm_example_refuses_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_bigram_lm
    from repro_torch.models import model
    spec = importlib.util.spec_from_file_location("lm_pretrain_torch",
                                                  EXAMPLES[0])
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = get_reduced("gemma-2b")
    params = model.init_params(cfg, device="cpu")
    data = make_bigram_lm(8, 6, cfg.vocab_size)
    kw = dict(steps=1, batch=2, lr=1e-3, remat=True, q_chunk=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        example.train(cfg, params, data, device=None, **kw)
    _, losses = example.train(cfg, params, data, device="cpu", **kw)
    assert len(losses) == 1                              # asked for: fine


def test_fed_example_refuses_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    import argparse
    from repro_torch.configs import get_reduced
    from repro_torch.fed import SimConfig
    spec = importlib.util.spec_from_file_location("fed_finetune_torch",
                                                  EXAMPLES[1])
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--population", "20", "--sample-rate", "0.1", "--rounds", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(argv)
    args = example.parse_args(argv + ["--codec", "int8"])
    assert args.device is None and args.codec == "int8"
    with pytest.raises(RuntimeError, match="CUDA"):
        example.run_population(get_reduced("roberta-large"), SimConfig(),
                               args)
    with pytest.raises(SystemExit):
        example.make_scheduler("async", 4, 2, edges=2)
    assert isinstance(example.make_scheduler("sync", 4, 2, 2).topology,
                      example.HierarchicalTopology)
    assert example.parse_args(["--device", "cpu"]).device == "cpu"
    assert isinstance(args, argparse.Namespace)


def test_serve_example_refuses_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    from repro_torch.configs import get_reduced
    spec = importlib.util.spec_from_file_location("serve_adapters_torch",
                                                  EXAMPLES[2])
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        example.make_fixture(get_reduced("gemma-2b"))
    assert example.parse_args([]).device is None
    fx = example.make_fixture(get_reduced("gemma-2b"), "cpu")   # asked for
    assert fx.params.embed.device.type == fx.registry.device.type == "cpu"


def test_federated_trainers_default_to_no_remat_as_the_reference_does():
    """The reference's ``loss_fn`` recomputes each layer by default and its
    federated trainers turn that off; the port's pass the same defaults on
    (otherwise every step would launch the lora forward kernels twice)."""
    from repro.fed import client as j_client
    from repro.fed import simulation as j_sim
    from repro.models import model as j_model
    from repro_torch.fed import client, simulation
    from repro_torch.models import model

    def defaults(fn):
        params = inspect.signature(fn).parameters
        return {k: p.default for k, p in params.items()
                if k in ("remat", "q_chunk")}

    for fn in (client.make_local_train, client.make_cohort_train,
               client.loss_and_grads, simulation.pretrain_loss_and_grads):
        assert defaults(fn) == {"remat": False, "q_chunk": 1024}, fn
    for fn, ref in ((client.make_local_train, j_client.make_local_train),
                    (client.make_cohort_train, j_client.make_cohort_train)):
        assert defaults(fn) == defaults(ref)
        assert list(inspect.signature(fn).parameters)[:4] == list(
            inspect.signature(ref).parameters)[:4]
    for fn, ref in ((model.loss_fn, j_model.loss_fn),
                    (model.forward, j_model.forward)):
        assert defaults(fn) == defaults(ref) == {"remat": True,
                                                 "q_chunk": 1024}
    assert "remat=False" in inspect.getsource(j_sim.pretrain_backbone)


def test_round_entry_points_refuse_a_missing_gpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    from repro_torch.configs import get_reduced
    from repro_torch.fed import (FedSession, ServerConfig, SimConfig,
                                 run_centralized, run_experiment)
    from repro_torch.models import model
    cfg = get_reduced("roberta-large")
    params = model.init_params(cfg, device="cpu")
    scfg = ServerConfig(num_clients=4, clients_per_round=2)
    sim = SimConfig(num_examples=64, eval_examples=8, rounds=1,
                    local_steps=1, local_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FedSession(cfg, scfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment(cfg, sim, scfg, base_params=params)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_centralized(cfg, sim, base_params=params)
    FedSession(cfg, scfg, params, device="cpu")          # asked for: fine
    hist = run_experiment(cfg, sim, scfg, base_params=params, device="cpu")
    assert hist["round"] == [0] and hist["uplink_bytes"][0] > 0


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
