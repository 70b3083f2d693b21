"""``examples/serve_adapters_torch.py`` on the CPU, against its oracles and
against the reference's engine on the same traffic.

Each scenario runs on a fixture of reduced Gemma-2B built from the
reference's weights and demo adapters (``repro_torch.interop``), as phase
14 (d) of ``chip_smoke.py`` runs them on full-width ones. Every oracle
match must be full: 8/8 against the merged-weight oracle and the hot-swap's
request against the scaled adapter's, 12/12 oversubscribed, the
speculative replay byte-identical to plain decode 8/8. The reference's
engine then serves the prompts each scenario drew, with the scenario's
settings: the tokens, deferrals, preemptions, speculative dispatches and
acceptance must be equal. ``main(argv)`` runs all four on its own reduced
fixtures and writes its files under ``results/`` of the working directory,
never the reference's names.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import AdapterRegistry as JRegistry
from repro.serve import ScriptedDrafter as JScripted
from repro.serve import ServeEngine as JEngine
from repro_torch.serve import AdapterRegistry
from test_torch_serve import Fixture

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "serve_adapters_torch", ROOT / "examples" / "serve_adapters_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both():
    return Fixture("gemma-2b")


def _port_fixture(example, fx):
    """The example's fixture on the reference's weights, with its own copy
    of the adapters' leaf dicts (``main`` rebinds client1's B)."""
    adapters = {aid: {t: dict(leaf) for t, leaf in tree.items()}
                for aid, tree in fx.tadapters.items()}
    registry = AdapterRegistry(fx.tcfg, capacity=len(adapters),
                               device="cpu")
    for aid, tree in adapters.items():
        registry.register(aid, tree)
    return example.Fixture(fx.tcfg, fx.tparams, registry, adapters,
                           torch.device("cpu"))


def _reference(fx, **kw):
    reg = JRegistry(fx.jcfg, capacity=len(fx.jadapters))
    for aid, tree in fx.jadapters.items():
        reg.register(aid, tree)
    return JEngine(fx.jparams, fx.jcfg, reg, use_pallas=False, **kw)


def _serve(engine, prompts, steps, **kw):
    uids = [engine.submit(p, f"client{i % 4}", max_new_tokens=steps,
                          **({"slo_class": kw["classes"][i % 2]}
                             if "classes" in kw else {}))
            for i, p in enumerate(prompts)]
    done = engine.run()
    return uids, [done[u] for u in uids]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_main_scenario_matches_oracle_and_reference(example, both):
    res = example.multi_lora(_port_fixture(example, both))
    assert res["match"] == res["requests"] == 8
    assert res["swap_loads"] == 1 and res["swap_equal"] is True
    ref = _reference(both, max_batch=8,
                     max_seq=example.PROMPT_LEN + example.STEPS)
    _, want = _serve(ref, res["prompts"], example.STEPS)
    _same(res["tokens"], want)
    assert res["steps"] == ref.steps


def test_oversubscribed_defers_like_reference(example, both):
    res = example.oversubscribed(_port_fixture(example, both))
    assert res["match"] == res["requests"] == 12
    ref = _reference(both, max_batch=12, max_seq=56, page_size=8,
                     num_pages=24, prefill_chunk=16)
    _, want = _serve(ref, res["prompts"], 8)
    _same(res["tokens"], want)
    assert res["deferrals"] > 0
    assert (res["deferrals"], res["preemptions"]) == (ref.deferrals,
                                                      ref.preemptions)
    assert res["dense_rows_same_memory"] == 3
    assert res["kv_bytes"] == ref.kv_cache_bytes()


def test_speculative_replay_counts_like_reference(example, both):
    res = example.speculative(_port_fixture(example, both))
    assert res["exact"] == res["requests"] == 8
    _same(res["tokens"]["replay"], res["tokens"]["plain"])
    prompts = res["prompts"]
    kw = dict(max_batch=8, max_seq=prompts.shape[1] + 16)
    _, plain = _serve(_reference(both, **kw), prompts, 16)
    _same(res["tokens"]["plain"], plain)
    drafter = JScripted()
    ref = _reference(both, drafter=drafter, spec_k=4, **kw)
    for _ in range(2):                    # the example's warm-up, then timed
        before = ref.spec_stats()
        uids = [ref.submit(p, f"client{i % 4}", max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for u, prev in zip(uids, plain):
            drafter.set(u, prev)
        done = ref.run()
    after = ref.spec_stats()
    _same(res["tokens"]["replay"], [done[u] for u in uids])
    for k in ("dispatches", "drafted", "accepted", "rollback_pages"):
        assert res[k] == after[k] - before[k], k
    assert res["acceptance"] == 1.0 and res["dispatches"] < 16


def test_observability_records_like_reference(example, both, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = example.observability(_port_fixture(example, both))
    for f in res["files"]:
        assert (tmp_path / f).is_file(), f
    assert not (tmp_path / "results" / "serve_trace.json").exists()
    assert {"prefill_chunk", "decode_step", "verify_step", "preempt",
            "replay", "defer"} <= set(res["covered"])
    ref = _reference(both, max_batch=8, max_seq=24, page_size=4,
                     num_pages=10, prefill_chunk=4,
                     slo_ttft_s={"interactive": 60.0, "batch": 600.0})
    _, want = _serve(ref, res["prompts"], 16,
                     classes=("interactive", "batch"))
    _same(res["tokens"], want)
    assert res["preemptions"] > 0 and res["deferrals"] > 0
    assert (res["preemptions"], res["deferrals"]) == (ref.preemptions,
                                                      ref.deferrals)
    drafter = JScripted()
    spec = _reference(both, max_batch=4, max_seq=24, drafter=drafter,
                      spec_k=4)
    uids = [spec.submit(p, f"client{i % 4}", max_new_tokens=16)
            for i, p in enumerate(res["prompts"][:4])]
    for u, prev in zip(uids, want):
        drafter.set(u, prev)
    done = spec.run()
    _same(res["spec_tokens"], [done[u] for u in uids])
    assert res["spec_dispatches"] == spec.spec_dispatches
    assert res["acceptance"] == spec.accepted_tokens / max(
        spec.drafted_tokens, 1)


def test_main_argv_runs_every_scenario_on_the_cpu(example, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = example.main(["--device", "cpu"])
    assert list(out) == ["main", "oversubscribed", "speculative",
                         "observability"]
    assert out["main"]["match"] == 8 and out["main"]["swap_equal"]
    assert out["oversubscribed"]["match"] == 12
    assert out["speculative"]["exact"] == 8
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == [
        "serve_torch.events.jsonl", "serve_torch.trace.json",
        "serve_torch_report.html"]
