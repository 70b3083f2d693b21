"""The port's training driver (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU, at roberta-reduced with
tiny flags (4 clients, 2 a round, 1 local step of 4 rows, 64 examples, 1
pretraining step, 2 rounds).

Both drivers pretrain from the reference's seed-0 weights: the port's
``init_params`` is patched inside this module to return them (carried by
``interop.params_from_jax``). Both packages' backbone caches are emptied
before the module and after it (the reference's own entries put back), and
hold the one backbone between its tests, as a process running the driver
twice would.

- ``--strategy centralized``: the round lines, the returned history and
  ``history.json`` within ``tests/test_torch_pretrain.py``'s tolerances
  (losses rtol 1e-4 / atol 1e-5; eval accuracy equal up to examples whose
  logit margin, the port's, is below 1e-3; a printed value also within
  1e-4, its two roundings to 4 decimals); each package's checkpoint read
  by the other's store, column for column, bit for bit.
- ``--strategy hlora`` under each ``--svd-method``: the cohorts, ranks,
  byte columns and health rows equal the reference driver's run exactly
  (its history is captured through its ``run_experiment`` name, because its
  ``--ckpt-dir`` raises ``TypeError`` on the ``health`` column, which is
  checked too); the port driver's history equals a direct
  ``run_experiment`` call; its checkpoint holds every numeric column and
  ``health`` by key.
- The refusals: a config without labels with the reference's message, and
  ``device=None`` without CUDA. ``python -m repro_torch.launch.train``
  runs ``--strategy naive`` with ``--ckpt-dir`` in a subprocess.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.fed import schedulers as j_sched
from repro.fed import simulation as j_sim
from repro.launch import train as j_train
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.checkpoint import store as t_store
from repro_torch.configs import get_reduced
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from test_torch_session import LOSS, MARGIN, _recording

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--rounds", "2", "--clients", "4", "--cohort", "2",
        "--local-steps", "1", "--local-batch", "4", "--examples", "64",
        "--pretrain-steps", "1"]
PRINTED = 1e-4          # two values each rounded to 4 decimals
ROUND_LINE = re.compile(
    r"^  round +(\d+): train_loss=([0-9.]+) eval_acc=([0-9.]+)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_weights():
    """The port's ``init_params`` returns the reference's seed-0 weights,
    and both backbone caches start and end empty."""
    jcfg = j_get_reduced("roberta-large")
    jparams = jax.tree.map(np.asarray, j_model.init_params(
        jax.random.PRNGKey(0), jcfg))

    def init(cfg, seed=0, dtype=torch.float32, device=None):
        assert seed == 0
        return interop.params_from_jax(jparams, cfg, device=device)

    saved = dict(j_sim._PRETRAIN_STORE)
    j_sim._PRETRAIN_STORE.clear()
    t_sim._PRETRAIN_STORE.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_sim.model_lib, "init_params", init)
        yield
    t_sim._PRETRAIN_STORE.clear()
    j_sim._PRETRAIN_STORE.clear()
    j_sim._PRETRAIN_STORE.update(saved)


def _reference_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    j_train.main()


def _round_lines(out):
    return [(int(r), float(l), float(a)) for r, l, a in
            ROUND_LINE.findall(out)]


def _printed(history):
    """The round lines the driver prints for ``history``."""
    return [(r, float(f"{l:.4f}"), float(f"{a:.4f}")) for r, (l, a) in
            enumerate(zip(history["train_loss"], history["eval_acc"]))]


def _as_json(history):
    return json.loads(json.dumps(history))


def _hold_columns(tree, history, what):
    """A checkpoint's ``history`` tree against the history: every column a
    float64 array of its values, ``health`` one array a key."""
    cols = tree["history"]
    assert sorted(cols) == sorted(history), what
    for col, values in history.items():
        if col == "health":
            assert sorted(cols[col]) == sorted(values[0]), what
            for k, got in cols[col].items():
                want = np.asarray([row[k] for row in values], np.float64)
                got = np.asarray(got)
                assert got.dtype == np.float64, (what, col, k)
                np.testing.assert_array_equal(got, want, err_msg=f"{what} "
                                              f"health {k}")
            continue
        got = cols[col]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == np.float64, (what, col)
        np.testing.assert_array_equal(
            got, np.asarray(values, np.float64), err_msg=f"{what} {col}")


def test_centralized_driver_matches_reference(monkeypatch, capsys,
                                              tmp_path):
    argv = TINY + ["--strategy", "centralized"]
    jdir, tdir = str(tmp_path / "reference"), str(tmp_path / "port")
    _reference_main(monkeypatch, argv + ["--ckpt-dir", jdir])
    jout = capsys.readouterr().out
    with open(os.path.join(jdir, "history.json")) as f:
        jhist = json.load(f)

    margins, evaluate = [], t_sim.evaluate

    def evaluate_logged(params, batch, cfg, device=None):
        with torch.no_grad():
            logits = t_model.forward(params, batch, cfg)
        margins.append((logits[:, 1] - logits[:, 0]).abs().numpy())
        return evaluate(params, batch, cfg, device=device)

    monkeypatch.setattr(t_sim, "evaluate", evaluate_logged)
    thist = t_train.main(argv + ["--ckpt-dir", tdir, "--device", "cpu"])
    tout = capsys.readouterr().out

    assert tout.splitlines()[0] == jout.splitlines()[0]
    assert tout.splitlines()[-1] == f"[train] history saved to {tdir}"
    assert thist["round"] == jhist["round"] == [0, 1]
    for k in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(thist[k], jhist[k], **LOSS, err_msg=k)
    n = t_sim.SimConfig().eval_examples
    flips = []
    for i, margin in enumerate(margins):
        assert margin.shape == (n,)
        flips.append(round(abs(thist["eval_acc"][i] - jhist["eval_acc"][i])
                           * n))
        assert flips[i] <= int((margin < MARGIN).sum()), (i, flips)
    # the round lines: the port's print its history; each value within the
    # tolerances above of the reference's line, plus the print's rounding
    tlines, jlines = _round_lines(tout), _round_lines(jout)
    assert tlines == _printed(thist) and jlines == _printed(jhist)
    for (r, tl, ta), (jr, jl, ja), flip in zip(tlines, jlines, flips):
        assert r == jr
        assert abs(tl - jl) <= LOSS["rtol"] * abs(jl) + LOSS["atol"] \
            + PRINTED, (r, tl, jl)
        assert abs(ta - ja) <= flip / n + PRINTED, (r, ta, ja)
    # history.json as returned; each checkpoint read by the other package
    with open(os.path.join(tdir, "history.json")) as f:
        assert json.load(f) == _as_json(thist)
    of_ref, ref_meta = t_store.restore(jdir, device="cpu")
    _hold_columns(of_ref, jhist, "the reference's, read by the port")
    of_port, port_meta = j_store.restore(tdir)
    _hold_columns(of_port, thist, "the port's, read by the reference")
    assert ref_meta["step"] == port_meta["step"] == 2
    port_args, ref_args = dict(port_meta["args"]), dict(ref_meta["args"])
    assert port_args.pop("device") == "cpu"
    assert port_args.pop("ckpt_dir") == tdir
    assert ref_args.pop("ckpt_dir") == jdir
    assert port_args == ref_args


@pytest.mark.parametrize("method", ["factored", "exact", "randomized"])
def test_federated_driver_matches_reference(monkeypatch, capsys, tmp_path,
                                            method):
    argv = TINY + ["--strategy", "hlora", "--svd-method", method]
    jrec, jrun = _recording(j_sched.SyncRound), {}

    def reference_run(cfg, sim, scfg, base_params=None):
        jrun["hist"] = j_sim.run_experiment(
            cfg, sim, scfg, base_params=base_params, scheduler=jrec,
            engine=j_engine.AggregationEngine(use_pallas=False))
        return jrun["hist"]

    monkeypatch.setattr(j_train, "run_experiment", reference_run)
    # the reference converts every column with float(): health's dicts
    # raise once the rounds are done and printed
    with pytest.raises(TypeError, match="float"):
        _reference_main(monkeypatch, argv + ["--ckpt-dir",
                                             str(tmp_path / "reference")])
    jout, jhist = capsys.readouterr().out, jrun["hist"]

    trec, trun = _recording(t_sched.SyncRound), {}

    def port_run(*args, **kw):
        trun["hist"] = t_sim.run_experiment(*args, scheduler=trec, **kw)
        return trun["hist"]

    monkeypatch.setattr(t_train, "run_experiment", port_run)
    tdir = str(tmp_path / "port")
    thist = t_train.main(argv + ["--ckpt-dir", tdir, "--device", "cpu"])
    tout = capsys.readouterr().out
    assert thist is trun["hist"]

    assert len(trec.log) == len(jrec.log) == 2
    for want, got in zip(jrec.log, trec.log):
        for k in ("cohort", "ranks", "post_ranks", "target_ranks"):
            assert got[k] == want[k], k
    for k in ("round", "downlink_bytes", "uplink_bytes", "health"):
        assert thist[k] == jhist[k], k
    assert _round_lines(tout) == _printed(thist)
    assert len(_round_lines(jout)) == 2

    # the driver's history is a direct run_experiment's, from the cached
    # backbone
    direct = t_sim.run_experiment(
        get_reduced("roberta-large"),
        t_sim.SimConfig(num_examples=64, rounds=2, local_steps=1,
                        local_batch=4, dirichlet_alpha=0.3, pretrain_steps=1),
        t_session.ServerConfig(num_clients=4, clients_per_round=2,
                               strategy="hlora", svd_method=method),
        device="cpu")
    assert len(t_sim._PRETRAIN_STORE) == 1
    assert direct == thist

    tree, meta = t_store.restore(tdir, device="cpu")
    _hold_columns(tree, thist, "the port's")
    assert sorted(tree["history"]["health"]) == sorted(
        ["round", "version", "downlink_bytes", "uplink_bytes", "stragglers",
         "updates_merged", "updates_dropped", "staleness_p50",
         "staleness_p99", "anomalies"])
    assert meta["step"] == 2 and meta["args"]["svd_method"] == method
    with open(os.path.join(tdir, "history.json")) as f:
        assert json.load(f) == _as_json(thist)


def test_driver_refuses_a_config_without_labels(monkeypatch):
    argv = ["--arch", "gemma-2b", "--device", "cpu"]
    with pytest.raises(SystemExit) as port:
        t_train.main(argv)
    with pytest.raises(SystemExit) as reference:
        _reference_main(monkeypatch, argv[:2])
    assert str(port.value.code) == str(reference.value.code)
    assert "classification pipeline" in str(port.value.code)


def test_driver_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(TINY)
    assert t_train.parse_args([]).device is None


def test_driver_runs_as_a_module(tmp_path):
    """``python -m repro_torch.launch.train`` with the port's own weights
    (no pretraining step), ``--strategy naive``, saving."""
    ckpt = str(tmp_path / "naive")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--strategy",
         "naive", "--rounds", "1", "--clients", "4", "--cohort", "2",
         "--local-steps", "1", "--local-batch", "4", "--examples", "64",
         "--pretrain-steps", "0", "--device", "cpu", "--ckpt-dir", ckpt],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == ("[train] arch=roberta-reduced task=mrpc "
                        "strategy=naive rank_policy=random r∈[2,8]")
    assert len(_round_lines(out.stdout)) == 1
    assert lines[-1] == f"[train] history saved to {ckpt}"
    with open(os.path.join(ckpt, "history.json")) as f:
        hist = json.load(f)
    tree, meta = t_store.restore(ckpt, device="cpu")
    _hold_columns(tree, hist, "naive")
    assert meta["step"] == 1 and meta["args"]["strategy"] == "naive"
    assert sorted(os.listdir(ckpt)) == ["history.json", "step_00000001"]
