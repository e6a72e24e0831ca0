"""Checkpoints and telemetry of the port (``ft/checkpoint.py``, ``obs/``,
``launch/train.py``'s ``--ckpt-dir``/``--ckpt-every``/``--resume`` and
``--obs-trace``/``--obs-metrics``, the rest of ``ft/straggler.py``) against
the JAX package on the same inputs, made from a seed with numpy.

Checkpoints: a port ``TrainState`` survives ``save`` -> ``restore`` bit for
bit, into the template's own tensors; a tree of dicts, a list and a
NamedTuple with bf16, fp32, int32 and 0-d leaves crosses from either
package's ``save`` to the other's ``restore`` with equal bits, and both
packages write equal manifests.

``launch.train``: one experiment file (the reduced gemma-2b of ``--smoke``,
with an entropy bonus so that every step moves the weights) runs through
both packages' entry points with the same flags (module-scoped: one JAX
compile a run). The printed lines are equal but for the metric values and
the wall times, which come from different weights; the resumed run numbers
its iterations from the saved step, and its first generation (sync, and
async at staleness 1) runs on the restored weights. The JSONL records and
the Chrome trace have the keys and span names of JAX's.

The copies (``obs/sinks.py``, ``obs/aggregate.py``, ``launch/obs_report.py``
and the straggler functions) give JAX's outputs on the same inputs.
"""
import contextlib
import io
import json
import os
import re
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as jax_ckpt
from repro.ft import straggler as jax_straggler
from repro.launch import obs_report as jax_obs_report
from repro.launch import train as jax_train
from repro.obs import StdoutSink as JaxStdoutSink
from repro.obs import aggregate as jax_aggregate
from repro.obs import iteration_record as jax_iteration_record
from repro_torch import tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import ObsConfig
from repro_torch.ft import checkpoint, straggler
from repro_torch.launch import obs_report, train
from repro_torch.obs import (
    NULL_TRACER,
    JSONLSink,
    StdoutSink,
    Tracer,
    aggregate,
    get_tracer,
    iteration_record,
    set_tracer,
)
from repro_torch.rl import rollout as rollout_mod

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

SMALL = ["--smoke", "--device", "cpu", "--prompts-per-iter", "2", "--group-size", "4",
         "--max-new-tokens", "6"]
# RLConfig's defaults but two: an entropy bonus gives every step a gradient
# (the rewards of a random policy are 0), and the lr moves bf16 weights
RL = {"entropy_coef": 0.01, "lr": 1e-3}
SAVED_AT = 2  # run A: 2 iterations, a checkpoint after the second


@pytest.fixture(autouse=True)
def _isolated_tracer():
    """Every test starts from the disabled global tracer and restores it
    (an enabled pipeline installs its tracer for the rest of the process)."""
    prev = set_tracer(None)
    yield
    set_tracer(prev)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
class Pair(NamedTuple):
    params: Any
    step: Any


def numpy_tree(seed: int):
    """A tree of dicts, a list and a NamedTuple: bf16 (as 16-bit patterns of
    finite numbers), fp32, int32 and 0-d leaves."""
    rng = np.random.default_rng(seed)

    def bf16_bits(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16)

    return Pair(params={"embed": bf16_bits(6, 4),
                        "blocks": [{"w": rng.standard_normal((3, 5)).astype(np.float32),
                                    "b": rng.integers(-9, 9, (4,), dtype=np.int32),
                                    "norm": bf16_bits(5)} for _ in range(2)],
                        "scale": np.float32(rng.standard_normal())},
                step=np.int32(rng.integers(1, 100)))


def as_port(t):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return Pair(params={k: tree.map(leaf, v) for k, v in t.params.items()}, step=leaf(t.step))


def as_jax(t):
    def leaf(a):
        a = np.asarray(a)
        return jnp.asarray(a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a)

    return jax.tree.map(leaf, t)


def port_bits(t):
    return [x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else x.dtype)
            .numpy().tobytes() for x in tree.leaves(t)]


def jax_bits(t, order):
    """Leaf bytes in the walk order of the port's tree ``order`` (JAX
    flattens dicts in sorted key order)."""
    by_key = {jax.tree_util.keystr(p): np.asarray(a).tobytes()
              for p, a in jax.tree_util.tree_leaves_with_path(t)}
    return [by_key[k] for k, _ in tree.leaves_with_keys(order)]


def test_leaf_keys_are_jax_keystr():
    t = numpy_tree(0)
    keys = [k for k, _ in tree.leaves_with_keys(t)]
    jax_keys = [jax.tree_util.keystr(p)
                for p, _ in jax.tree_util.tree_leaves_with_path(as_jax(t))]
    assert sorted(keys) == sorted(jax_keys) and len(keys) == len(tree.leaves(t))
    assert keys[:2] == [".params['embed']", ".params['blocks'][0]['w']"]
    assert keys[-1] == ".step"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, direction):
    """Either package's ``save`` restores bit for bit through the other's
    ``restore`` (bf16 leaves included: a uint16 file would restore as wrong
    numbers through JAX's), and the two manifests are equal."""
    t = numpy_tree(1)
    jt, tt = as_jax(t), as_port(t)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save(jdir, jt, step=7, extra={"note": "x"})
    checkpoint.save(tdir, tt, step=7, extra={"note": "x"})
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[1]["leaves"][".params['embed']"]["dtype"] == "bfloat16"
    if direction == "jax_to_port":
        template = tree.map(torch.zeros_like, tt)
        restored, step = checkpoint.restore(jdir, template)
        assert port_bits(restored) == port_bits(tt)
        assert [x.dtype for x in tree.leaves(restored)] == [x.dtype for x in tree.leaves(tt)]
    else:
        restored, step = jax_ckpt.restore(tdir, jax.tree.map(jnp.zeros_like, jt))
        assert jax_bits(restored, tt) == port_bits(tt)
        assert [a.dtype for a in jax.tree.leaves(restored)] == [
            a.dtype for a in jax.tree.leaves(jt)]
    assert step == 7


def test_restore_writes_into_the_template_and_refuses_a_mismatch(tmp_path):
    tt = as_port(numpy_tree(2))
    checkpoint.save(str(tmp_path), tt, step=3)
    template = tree.map(torch.zeros_like, tt)
    ptrs = [x.data_ptr() for x in tree.leaves(template)]
    restored, step = checkpoint.restore(str(tmp_path), template)
    assert restored is template and step == 3
    assert [x.data_ptr() for x in tree.leaves(template)] == ptrs
    assert port_bits(template) == port_bits(tt)
    wrong = Pair(params=dict(template.params, scale=torch.zeros((), dtype=torch.float64)),
                 step=template.step)
    with pytest.raises(ValueError, match=r"\.params\['scale'\] is float32"):
        checkpoint.restore(str(tmp_path), wrong)
    # onto a mesh of one device (no world): every leaf whole, bit for bit
    from repro_torch.core.databuffer import DeviceMesh

    onto = tree.map(torch.zeros_like, tt)
    checkpoint.restore(str(tmp_path), onto, mesh=DeviceMesh("cpu"))
    assert port_bits(onto) == port_bits(tt)


# --------------------------------------------------------------------------- #
# launch.train: checkpoints, resume and telemetry, beside JAX's entry point
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def generated_params():
    """While open, keeps a copy of every leaf of the params each lockstep
    ``generate`` runs."""
    seen = []
    generate = rollout_mod.generate

    def kept(model, params, *args, **kw):
        seen.append([x.clone() for x in tree.leaves(params)])
        return generate(model, params, *args, **kw)

    rollout_mod.generate = kept
    try:
        yield seen
    finally:
        rollout_mod.generate = generate


def run_printing(main, argv, root):
    """(main's result, its printed lines with ``root`` written as <dir>)."""
    buf = io.StringIO()
    prev = get_tracer()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
    finally:
        set_tracer(prev)
    return out, buf.getvalue().replace(str(root), "<dir>").splitlines()


def run_flags(root, run):
    a = [f"--ckpt-dir={root}/ckpt", "--ckpt-every", "2", f"--obs-trace={root}/trace.json",
         f"--obs-metrics={root}/metrics.jsonl"]
    return {"A": ["--iters", str(SAVED_AT)] + a,
            "B": ["--iters", "3", f"--resume={root}/ckpt"],
            "C": ["--iters", "3", f"--resume={root}/ckpt", "--max-staleness", "1"]}[run]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs A (2 iterations, a checkpoint after the second, telemetry on), B
    (resumed to 3) of both packages and C (B at staleness 1) of the port, on
    one experiment file."""
    base = tmp_path_factory.mktemp("runs")
    exp = base / "exp.json"
    train.main(SMALL + ["--dump-experiment", str(exp)])
    d = json.loads(exp.read_text())
    d["rl"].update(RL)
    exp.write_text(json.dumps(d))
    out = {}
    for pkg, main, extra in (("jax", jax_train.main, []),
                             ("port", train.main, ["--device", "cpu"])):
        root = base / pkg
        root.mkdir()
        for run in ("A", "B", "C") if pkg == "port" else ("A", "B"):
            with generated_params() as params:
                res, lines = run_printing(
                    main, ["--experiment", str(exp)] + extra + run_flags(root, run), root)
            out[pkg, run] = {"result": res, "lines": lines, "generated": params}
            if run == "A":
                out[pkg, run]["trace"] = json.loads((root / "trace.json").read_text())
                out[pkg, run]["records"] = [
                    json.loads(ln) for ln in (root / "metrics.jsonl").read_text().splitlines()]
    return out


def masked(lines):
    """A progress line as its iteration and sorted metric keys (the values
    and wall times come from each package's own weights); other lines as
    they are."""
    out = []
    for ln in lines:
        m = re.fullmatch(r"\[train\] it=(\d+) \d+\.\d\ds (\{.*\})", ln)
        out.append(("it", int(m.group(1)), sorted(json.loads(m.group(2))))
                   if m else ln)
    return out


@pytest.mark.parametrize("run", ["A", "B"])
def test_train_lines_equal_jax_lines(runs, run):
    """Same flags, same lines: the progress lines (iteration and keys), the
    checkpoint, resume, trace and buffer-stats lines."""
    port, jax_lines = masked(runs["port", run]["lines"]), masked(runs["jax", run]["lines"])
    assert port == jax_lines
    if run == "A":
        assert "[train] checkpoint @ 2 -> <dir>/ckpt" in port
        assert "[train] wrote trace <dir>/trace.json (10 events)" in port
    else:
        assert port[0] == "[train] resumed from <dir>/ckpt at iteration 2"
        assert port[1][:2] == ("it", 2)


@pytest.mark.parametrize("run", ["B", "C"])
def test_resume_restores_the_state_and_generates_from_it(runs, run):
    """The resumed run restores A's final state, runs iterations 2.. (one
    here), and its first generation runs on the restored weights, not on the
    initial ones; under ``--max-staleness 1`` that is the version 0 the async
    worker publishes at its first dispatch."""
    a = runs["port", "A"]
    saved = tree.leaves(a["result"]["pipeline"].ctx.actor_state)
    res = runs["port", run]["result"]
    assert len(res["history"]) == len(res["seconds"]) == 1
    first = runs["port", run]["generated"][0]
    final_params = tree.leaves(a["result"]["pipeline"].ctx.actor_state.params)
    assert all(torch.equal(x, y) for x, y in zip(first, final_params))
    assert not all(torch.equal(x, y) for x, y in zip(first, a["generated"][0]))
    state = res["pipeline"].ctx.actor_state
    if run == "B":  # trained one step on top of the restored state
        assert int(state.opt.step) == SAVED_AT + 1
        assert "actor/loss" in res["history"][0]
    else:  # the first tick only generates: the restored state, untouched
        assert "actor/loss" not in res["history"][0]
        assert all(torch.equal(x, y) for x, y in zip(tree.leaves(state), saved))
        version0 = tree.leaves(res["pipeline"].worker.weights.current.params)
        assert all(torch.equal(x, y) for x, y in zip(version0, final_params))


def test_telemetry_files_have_jax_keys_and_spans(runs):
    """Run A's JSONL has one record an iteration with JAX's record and
    metric keys; its Chrome trace JAX's span names, event keys and span
    attributes; its registry saw both iterations."""
    port, jx = runs["port", "A"], runs["jax", "A"]
    assert [r["iteration"] for r in port["records"]] == [0, 1]
    for r, j in zip(port["records"], jx["records"]):
        assert sorted(r) == sorted(j) and r["kind"] == "iteration"
        assert sorted(r["metrics"]) == sorted(j["metrics"])
    assert [r["metrics"] for r in port["records"]] == [
        {k: float(v) for k, v in m.items()} for m in port["result"]["history"]]

    def spans(doc):
        return sorted((e["name"], e["ph"], e.get("cat", ""), sorted(e),
                       sorted(e.get("args", {})))
                      for e in doc["traceEvents"])

    assert spans(port["trace"]) == spans(jx["trace"])
    pipe = port["result"]["pipeline"]
    nodes = sorted(f"node/{n}" for n in pipe.plan.order)
    assert sorted(e["name"] for e in port["trace"]["traceEvents"]
                  if e["ph"] == "X") == sorted(nodes * SAVED_AT)
    assert pipe.ctx.obs.registry.histograms["train/step_s"].count == SAVED_AT


def tiny_spec(obs=None, seed=3):
    from repro_torch.configs import get_config, reduced
    from repro_torch.rl import RLConfig

    return ExperimentSpec(model=reduced(get_config("gemma-2b"), vocab_size=260, num_layers=2),
                          rl=RLConfig(group_size=2, max_new_tokens=4, lr=1e-4),
                          prompts_per_iter=2, seed=seed, **({"obs": obs} if obs else {}))


def test_telemetry_switch():
    """Disabled telemetry (the default, or ``enabled=False``) installs no
    tracer and leaves every metric bitwise what telemetry on gives; enabled,
    ``ctx.obs`` holds the installed tracer and a registry that records every
    iteration's metrics, and each node of each iteration has its span. (The
    tracer is process-global, so the disabled pipelines run first.)"""
    hist = {}
    for name, obs in (("plain", None), ("off", ObsConfig(enabled=False))):
        pipe = tiny_spec(obs).compile(device="cpu")
        assert pipe.ctx.obs is None and get_tracer() is NULL_TRACER
        hist[name] = pipe.run(2)
    on = tiny_spec(ObsConfig(enabled=True)).compile(device="cpu")
    assert on.ctx.obs.tracer is get_tracer() and on.ctx.obs.tracer.enabled
    hist["on"] = []
    for it in range(2):
        hist["on"].append(on.worker.run_iteration())
        assert on.ctx.obs.registry.as_flat_dict() == hist["on"][-1]
        names = [e["name"] for e in on.ctx.obs.tracer.to_events()]
        assert sorted(names) == sorted(f"node/{n}" for n in on.plan.order * (it + 1))
    for name in ("off", "on"):
        for m, want in zip(hist[name], hist["plain"]):
            assert list(m) == list(want)
            assert all(repr(m[k]) == repr(want[k]) for k in m if not k.startswith("time/"))


def test_train_state_round_trips_bit_for_bit(tmp_path):
    """The twin of ``tests/test_pipeline.py::test_checkpoint_roundtrip_bf16``:
    a ``TrainState`` after one GRPO iteration (bf16 params, fp32 moments, the
    0-d int32 step) through ``save`` -> ``restore``."""
    pipe = tiny_spec().compile(device="cpu")
    pipe.run(1)
    state = pipe.ctx.actor_state
    checkpoint.save(str(tmp_path), state, step=1)
    restored, step = checkpoint.restore(str(tmp_path), tree.map(torch.zeros_like, state))
    assert step == 1
    assert torch.bfloat16 in {x.dtype for x in tree.leaves(state.params)}
    assert {x.dtype for x in tree.leaves(state.opt.m)} == {torch.float32}
    assert state.opt.step.dtype == torch.int32 and state.opt.step.dim() == 0
    assert int(restored.opt.step) == 1
    assert port_bits(restored) == port_bits(state)


# --------------------------------------------------------------------------- #
# the copies: sinks, aggregation, obs_report, straggler
# --------------------------------------------------------------------------- #
def test_stdout_sink_and_record_equal_jax(capsys, tmp_path):
    metrics = {"actor/loss": 0.123456789, "rollout/tokens": 16.0, "time/train": 0.5,
               "reward/mean": -0.0, "actor/kl": 1e-5, "n": 3}
    StdoutSink().emit_iteration(7, metrics, 1.234)
    port = capsys.readouterr().out
    JaxStdoutSink().emit_iteration(7, metrics, 1.234)
    assert port == capsys.readouterr().out
    metrics["actor/kl"] = np.float32(1e-5)  # records take numpy scalars too
    rec, jrec = iteration_record(3, metrics, 0.5), jax_iteration_record(3, metrics, 0.5)
    assert {k: v for k, v in rec.items() if k != "time"} == {
        k: v for k, v in jrec.items() if k != "time"}
    with JSONLSink(str(tmp_path / "m.jsonl")) as sink:
        sink.write(rec)
    assert json.loads((tmp_path / "m.jsonl").read_text()) == rec


def snapshot_dir(root, seed: int):
    """``<root>/obs/host*/it*.json`` as a fleet publishes them (3 hosts, 4
    iterations, seeded stage times) and one torn write."""
    rng = np.random.default_rng(seed)
    for h in range(3):
        os.makedirs(root / "obs" / f"host{h}")
        for it in range(4):
            t = float(rng.uniform(0.1, 3.0))
            payload = {"host": h, "iteration": it, "time": 0.0,
                       "metrics": {"time/generate": t * 0.7, "time/train": t * 0.3,
                                   "actor/loss": float(rng.standard_normal())}}
            (root / "obs" / f"host{h}" / f"it{it:06d}.json").write_text(json.dumps(payload))
    (root / "obs" / "host1" / "it000099.json").write_text('{"host": 1, "iter')
    traces = []
    for h in range(2):
        t = Tracer(enabled=True, host=h)
        with t.span("node/gen", cat="dag", node="gen"):
            t.instant("tick", cat="dag", it=h)
        traces.append(t.export_chrome(str(root / f"trace.host{h}.json")))
    return traces


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregation_equals_jax(tmp_path, seed):
    """``collect_snapshots`` (skipping the torn write), ``straggler_report``,
    ``render_report`` and ``merge_traces`` give JAX's outputs."""
    traces = snapshot_dir(tmp_path, seed)
    snaps = aggregate.collect_snapshots(str(tmp_path))
    assert snaps == jax_aggregate.collect_snapshots(str(tmp_path))
    assert sorted(snaps[1]) == [0, 1, 2, 3]
    report = aggregate.straggler_report(snaps)
    assert report == jax_aggregate.straggler_report(snaps)
    assert aggregate.render_report(report) == jax_aggregate.render_report(report)
    merged = aggregate.merge_traces(traces, str(tmp_path / "m.json"))
    assert merged == jax_aggregate.merge_traces(traces)
    assert json.loads((tmp_path / "m.json").read_text()) == merged


@pytest.mark.parametrize("flags", [[], ["--json"], ["--merge-traces", "trace.host*.json"]])
def test_obs_report_cli_equals_jax(tmp_path, capsys, flags):
    snapshot_dir(tmp_path, 2)
    flags = [str(tmp_path / f) if "*" in f else f for f in flags]
    out = {}
    for name, main in (("port", obs_report.main), ("jax", jax_obs_report.main)):
        main(["--coordinator", str(tmp_path), "--out", str(tmp_path / f"{name}.json")] + flags)
        out[name] = capsys.readouterr().out.replace(name + ".json", "<out>")
    assert out["port"] == out["jax"]
    if flags[:1] == ["--merge-traces"]:
        assert "[obs] merged 2 traces" in out["port"]
        assert (json.loads((tmp_path / "port.json").read_text())
                == json.loads((tmp_path / "jax.json").read_text()))


@pytest.mark.parametrize("seed", range(4))
def test_rebalance_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    times = rng.uniform(0.5, 3.0, n).tolist()
    dead = sorted(rng.choice(n, int(rng.integers(0, n)), replace=False).tolist())
    for kw in ({}, {"threshold": 1.2}, {"dead": dead}, {"dead": dead, "threshold": 2.0}):
        assert straggler.rebalance(times, **kw) == jax_straggler.rebalance(times, **kw)
    with pytest.raises(RuntimeError, match="no healthy hosts"):
        straggler.rebalance(times, dead=range(n))


@pytest.mark.parametrize("seed", range(4))
def test_repack_permutations_equal_jax(seed):
    """``cross_host_rows`` and ``inverse_permutation`` on random permutations
    and on hierarchical repacks of random lengths."""
    rng = np.random.default_rng(seed)
    hosts, group = [(2, 2), (4, 1), (2, 4), (4, 2)][seed]
    n = hosts * group * int(rng.integers(2, 5))
    lengths = rng.integers(1, 64, n)
    perms = [rng.permutation(n),
             straggler.balance_by_length(lengths, 2 * hosts, group_size=group, hosts=hosts)]
    for perm in perms:
        assert straggler.cross_host_rows(perm, hosts) == jax_straggler.cross_host_rows(perm, hosts)
        inv = straggler.inverse_permutation(perm)
        np.testing.assert_array_equal(inv, jax_straggler.inverse_permutation(perm))
        np.testing.assert_array_equal(lengths[perm][inv], lengths)


@pytest.mark.parametrize("seed", range(3))
def test_heartbeat_monitor_equals_jax(seed):
    """One script of beats (out of order, with and without wall clocks) and
    ``dead`` queries on both monitors; the argument checks raise alike."""
    rng = np.random.default_rng(seed)
    n, patience = int(rng.integers(1, 6)), int(rng.integers(1, 4))
    port, jx = straggler.HeartbeatMonitor(n, patience), jax_straggler.HeartbeatMonitor(n, patience)
    for step in range(30):
        if rng.random() < 0.6:
            h, it = int(rng.integers(0, n)), int(rng.integers(0, 20))
            now = float(rng.uniform(0, 50)) if rng.random() < 0.5 else None
            port.beat(h, it, now=now)
            jx.beat(h, it, now=now)
        else:
            it = int(rng.integers(0, 25))
            kw = {"now": float(rng.uniform(0, 60)), "stale_s": 10.0} if rng.random() < 0.5 else {}
            assert port.dead(it, **kw) == jx.dead(it, **kw), step
    for bad in ((0, 1), (n, 0)):
        with pytest.raises(ValueError) as a:
            straggler.HeartbeatMonitor(*bad)
        with pytest.raises(ValueError) as b:
            jax_straggler.HeartbeatMonitor(*bad)
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="out of range"):
        port.beat(n, 0)
