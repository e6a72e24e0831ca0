"""The port's control and data plane against the JAX package on the CPU: the
planner, the registry, the three databuffers, the dataloader, the datasets,
the straggler module's balancer and the worker's load-balance repack.

Both packages get the same numpy inputs. Orders, permutations, rows, integer
arrays and every ``BufferStats`` count must be equal; float values passed
through a buffer must come back bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import DataCoordinatorConfig as JaxCoordinatorConfig
from repro.core import databuffer as jbuf
from repro.core import planner as jplanner
from repro.core import registry as jregistry
from repro.core import worker as jworker
from repro.core.dag import DAG as JaxDAG
from repro.data.dataloader import DistributedDataloader as JaxDataloader
from repro.data import dataset as jdataset
from repro.ft import straggler as jstraggler
from repro.rl import algorithms as jalgos
from repro.rl.trainer import RLConfig as JaxRLConfig
from repro.utils.jax_compat import make_compat_mesh
from repro_torch.configs import DataCoordinatorConfig
from repro_torch.core import (
    DAG,
    CentralizedDatabuffer,
    DAGPlanner,
    DeviceMesh,
    DistributedDatabuffer,
    DoubleBufferedDatabuffer,
    Node,
    NodeType,
    Role,
    default_registry,
    grpo_dag,
    ppo_dag,
    validate_serialization,
)
from repro_torch.core import worker
from repro_torch.data.dataloader import DistributedDataloader
from repro_torch.data.dataset import SyntheticMathDataset, SyntheticTextDataset
from repro_torch.ft import straggler
from repro_torch.rl import algorithms
from repro_torch.rl.trainer import RLConfig

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

# the stages' specs: model-bound stages over the data axes, compute stages
# over all axes
MODEL = (("data",),)
COMPUTE = (("data", "model"),)


def mesh11():
    return make_compat_mesh((1, 1), ("data", "model"))


def cpu_mesh():
    return DeviceMesh("cpu")


# --------------------------------------------------------------------------- #
# planner (paper Fig. 4)
# --------------------------------------------------------------------------- #
def _fork_join():
    return [("gen", "actor", "generate", ()),
            ("inf1", "reference", "model_inference", ("gen",)),
            ("inf2", "critic", "model_inference", ("gen",)),
            ("train", "actor", "model_train", ("inf1", "inf2"))]


def _spec(rows):
    return {"nodes": [{"id": i, "role": r, "type": t, "deps": list(d)} for i, r, t, d in rows]}


@pytest.mark.parametrize("name", ["fork_join", "grpo", "ppo"])
def test_plan_equals_jax(name):
    """The serialized chain and the injected edges are the JAX planner's, and
    the chain is a valid serialization (one node active at a time)."""
    spec = {"fork_join": _spec(_fork_join()), "grpo": grpo_dag().to_spec(),
            "ppo": ppo_dag().to_spec()}[name]
    plan = DAGPlanner().plan(DAG.from_spec(spec))
    jplan = jplanner.DAGPlanner().plan(JaxDAG.from_spec(spec))
    assert plan.order == jplan.order
    assert plan.injected_edges == jplan.injected_edges
    assert [t.after for t in plan.tasks] == [t.after for t in jplan.tasks]
    assert validate_serialization(plan) and len(plan.order) == len(spec["nodes"])
    if name == "fork_join":
        assert plan.order == ["gen", "inf1", "inf2", "train"]
        assert ("inf1", "inf2") in plan.injected_edges
    plans = DAGPlanner().plan_for_workers(DAG.from_spec(spec), 8)
    assert len(plans) == 8 and all(p.order == plan.order for p in plans)


def test_validate_serialization_rejects_a_bad_chain():
    plan = DAGPlanner().plan(DAG.from_spec(_spec(_fork_join())))
    bad = dataclasses.replace(plan, tasks=tuple(reversed(plan.tasks)))
    assert not validate_serialization(bad)
    assert not jplanner.validate_serialization(
        dataclasses.replace(jplanner.DAGPlanner().plan(JaxDAG.from_spec(_spec(_fork_join()))),
                            tasks=tuple(reversed(plan.tasks))))


# --------------------------------------------------------------------------- #
# registry (paper Fig. 5)
# --------------------------------------------------------------------------- #
def test_registry_binds_the_ports_stages_under_jax_keys():
    reg, jreg = default_registry(), jregistry.default_registry()
    assert sorted(f"{r.value}/{t.value}" for r, t in reg.keys()) == \
        sorted(f"{r.value}/{t.value}" for r, t in jreg.keys())
    for r, t in reg.keys():
        fn = reg.resolve(Node("n", r, t))
        jfn = jreg.resolve(jregistry.Node("n", jregistry.Role(r.value),
                                          jregistry.NodeType(t.value)))
        assert fn.__name__ == jfn.__name__
        assert fn.__module__ == "repro_torch.core.stages"
    for node in grpo_dag().nodes.values():
        assert callable(reg.resolve(node))
    calls = []
    reg.register(Role.REWARD, NodeType.MODEL_INFERENCE,
                 lambda ctx, buf, node: calls.append(node.node_id) or {})
    n = Node("rm", Role.REWARD, NodeType.MODEL_INFERENCE)
    reg.resolve(n)(None, None, n)
    assert calls == ["rm"]


@pytest.mark.parametrize("case", ["miss", "duplicate"])
def test_registry_errors_match_jax(case):
    """An unbound lookup names the registered keys and the nearest match; a
    duplicate registration names the bound function and ``override=True``."""
    msgs = []
    for reg, role, ntype, node in ((default_registry(), Role, NodeType, Node),
                                   (jregistry.default_registry(), jregistry.Role,
                                    jregistry.NodeType, jregistry.Node)):
        with pytest.raises(KeyError) as ei:
            if case == "miss":
                reg.resolve(node("dn", role.DATA, ntype.COMPUTE))
            else:
                reg.register(role.ACTOR, ntype.GENERATE, lambda *a: {})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    want = ("dn", "Registered keys", "actor/generate", "Nearest match") if case == "miss" \
        else ("override=True", "actor_generate", "Registered keys")
    assert all(w in msgs[0] for w in want)


# --------------------------------------------------------------------------- #
# databuffers (paper Figs. 7-8): one script of puts, gets and clears run on
# the port's buffer and the JAX buffer of the same class
# --------------------------------------------------------------------------- #
def _x(shape, offset=0.0):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + offset


BUFFER_SCRIPTS = {
    # same spec -> fast path; another spec -> redistribution, value preserved
    "fast_path_and_redistribution": [
        ("put", "x", _x((8, 8)), ("data", None)), ("get", "x", ("data", None)),
        ("get", "x", COMPUTE)],
    # iteration 0 records the consumer spec, iteration 1 is served staged
    "double_buffer_rotation": [
        ("put", "x", _x((8, 8)), ("data", None)), ("get", "x", COMPUTE), ("clear",),
        ("put", "x", _x((8, 8), 1.0), ("data", None)), ("get", "x", COMPUTE)],
    # an overwrite must drop what was staged for the old value
    "overwrite_invalidates_staged": [
        ("put", "x", np.zeros((4, 4), np.float32), ("data", None)), ("get", "x", COMPUTE),
        ("clear",), ("put", "x", np.ones((4, 4), np.float32), ("data", None)),
        ("put", "x", np.full((4, 4), 7.0, np.float32), ("data", None)), ("get", "x", COMPUTE)],
    # single-axis tuples, None padding and specs shorter than ndim compare equal
    "spec_normalization": [
        ("put", "t", _x((4, 3)), (("data",),)), ("get", "t", ("data", None)),
        ("get", "t", ("data",)), ("get", "t", (("data",), None)), ("get", "t", COMPUTE)],
    # a put without a spec is never on the fast path
    "put_without_spec": [("put", "a", np.zeros((2,), np.float32), None), ("get", "a", COMPUTE),
                         ("get", "a", None), ("clear",)],
    # repeat gets of one reshard, and a 1-D key under the sequence spec
    "grpo_like_boundaries": [
        ("put", "tokens", _x((6, 5)), MODEL), ("put", "answers", _x((6,)), MODEL),
        ("get", "tokens", MODEL), ("get", "tokens", COMPUTE), ("get", "answers", COMPUTE),
        ("put", "rewards", _x((6,), 2.0), COMPUTE), ("get", "tokens", COMPUTE),
        ("get", "rewards", COMPUTE), ("pop", "answers"), ("clear",),
        ("put", "tokens", _x((6, 5), 3.0), MODEL), ("get", "tokens", COMPUTE),
        ("get", "tokens", COMPUTE), ("get", "tokens", MODEL)],
}
BUFFERS = {"distributed": (DistributedDatabuffer, jbuf.DistributedDatabuffer),
           "double": (DoubleBufferedDatabuffer, jbuf.DoubleBufferedDatabuffer),
           "centralized": (CentralizedDatabuffer, jbuf.CentralizedDatabuffer)}


def _stat_counts(stats):
    d = dataclasses.asdict(stats)
    d["max_host_inbound_bytes"] = stats.max_host_inbound_bytes
    return d


def _run_script(kind, script):
    cls, jcls = BUFFERS[kind]
    buf, jb = cls(cpu_mesh()), jcls(mesh11())
    for op, *args in script:
        if op == "put":
            key, value, spec = args
            buf.put(key, torch.from_numpy(value.copy()), spec)
            jb.put(key, jnp.asarray(value), None if spec is None else P(*spec))
        elif op in ("get", "pop"):
            key = args[0]
            spec = args[1] if op == "get" else None
            got = buf.get(key, spec) if op == "get" else buf.pop(key)
            want = jb.get(key, None if spec is None else P(*spec)) if op == "get" \
                else jb._host_store.pop(key) if kind == "centralized" else jb.pop(key)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            buf.clear()
            jb.clear()
        assert _stat_counts(buf.stats) == _stat_counts(jb.stats), (op, args)
    return buf, jb


@pytest.mark.parametrize("kind", sorted(BUFFERS))
@pytest.mark.parametrize("script", sorted(BUFFER_SCRIPTS))
def test_databuffer_counts_and_values_match_jax(kind, script):
    buf, jb = _run_script(kind, BUFFER_SCRIPTS[script])
    assert buf.stats.bytes_moved == 0  # one device: every target slice is resident
    if kind == "centralized":
        assert buf.controller_resident_bytes == jb.controller_resident_bytes
    else:
        assert buf.stats.bytes_through_controller == 0
        assert buf.keys() == jb.keys()


def test_databuffer_fast_path_is_zero_copy_and_clear_empties():
    for cls in (DistributedDatabuffer, DoubleBufferedDatabuffer):
        buf = cls(cpu_mesh())
        x = torch.ones(8, 4)
        buf.put("x", x, ("data", None))
        assert buf.get("x", ("data", None)) is x
        assert buf.get("x", COMPUTE) is x  # a reshard on one device moves nothing
        buf.clear()
        assert buf.keys() == []
    assert buf.stats.rotations == 1


def test_centralized_buffer_round_trips_through_host_memory():
    """The controller holds a host copy of every put and hands each get a
    fresh copy: the baseline's all-to-one and one-to-all traffic, 2x the
    array bytes for one put and one get (as JAX counts them). Its ``keys()``
    lists what the controller holds; the JAX baseline's lists its empty
    device store (a caveat of the reference, ROADMAP §3)."""
    buf = CentralizedDatabuffer(cpu_mesh())
    jb = jbuf.CentralizedDatabuffer(mesh11())
    x = torch.ones(16, 4)
    buf.put("x", x, ("data", None))
    jb.put("x", jnp.ones((16, 4), jnp.float32), P("data", None))
    y = buf.get("x", COMPUTE)
    assert y is not x and y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    assert buf.stats.bytes_through_controller == 2 * x.numel() * 4
    assert buf.controller_resident_bytes == x.numel() * 4
    assert buf.keys() == ["x"] and jb.keys() == []
    buf.clear()
    assert buf.keys() == []


def test_double_buffer_prefetch_and_paused_staging():
    """An explicitly declared consumer spec is staged at once; under
    ``staging_paused`` two rewrites are staged once, on exit."""
    def run(buf, x, model, compute):
        buf.put("x", x, model)
        buf.prefetch("x", compute)
        buf.get("x", compute)
        with buf.staging_paused():
            buf.put("x", x * 2, model)
            buf.put("x", x * 3, model)
        return float(buf.get("x", compute).sum()), _stat_counts(buf.stats)

    got = run(DoubleBufferedDatabuffer(cpu_mesh()), torch.ones(4, 4), ("data", None), COMPUTE)
    want = run(jbuf.DoubleBufferedDatabuffer(mesh11()), jnp.ones((4, 4)), P("data", None),
               P(*COMPUTE))
    assert got == want
    assert got[0] == 48.0 and got[1]["overlap_hits"] == 2 and got[1]["sync_waits"] == 0


# --------------------------------------------------------------------------- #
# datasets and the dataloader (paper Fig. 6)
# --------------------------------------------------------------------------- #
def test_dataset_rows_equal_jax():
    idx = np.array([3, 7, 0, 99, 41])
    p, a = SyntheticMathDataset(100, seed=1).get_rows(idx)
    jp, ja = jdataset.SyntheticMathDataset(100, seed=1).get_rows(idx)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(a, ja)
    ds = SyntheticMathDataset(100, seed=1)
    text = ds.tok.decode(p[0])
    x, y = text[:-1].split("+")
    assert int(x) + int(y) == a[0]
    np.testing.assert_array_equal(SyntheticTextDataset(64, 9, 256, seed=3).get_rows(idx),
                                  jdataset.SyntheticTextDataset(64, 9, 256, seed=3).get_rows(idx))


def test_dataloader_indices_equal_jax_and_shuffle_by_epoch():
    ds = SyntheticTextDataset(128, 16, 256, seed=3)
    dl = DistributedDataloader(ds, mesh=cpu_mesh(), global_batch=32, seed=7)
    jdl = JaxDataloader(jdataset.SyntheticTextDataset(128, 16, 256, seed=3), mesh=mesh11(),
                        global_batch=32, seed=7)
    for step in range(10):
        np.testing.assert_array_equal(dl.batch_indices(step), jdl.batch_indices(step))
    np.testing.assert_array_equal(
        DistributedDataloader(ds, mesh=cpu_mesh(), global_batch=32, seed=7).batch_indices(0),
        dl.batch_indices(0))
    assert not np.array_equal(dl.batch_indices(0), dl.batch_indices(len(ds) // 32))
    dl.exclude_ranks([1])
    jdl.exclude_ranks([1])
    assert dl._excluded == jdl._excluded == {1}


@pytest.mark.parametrize("dataset", ["math", "text"])
@pytest.mark.parametrize("seed", [0, 13])
def test_prefetch_batches_equal_jax_at_every_depth(dataset, seed):
    """Batch content is a pure function of the step: every prefetch depth
    serves the JAX loader's rows; the look-ahead counts its hits and the
    rows it loaded ahead."""
    def make(mod):
        return (mod.SyntheticMathDataset(256, seed=seed) if dataset == "math"
                else mod.SyntheticTextDataset(128, 8, 256, seed=seed))

    import repro_torch.data.dataset as tdataset

    jdl = JaxDataloader(make(jdataset), mesh=mesh11(), global_batch=16, seed=seed)
    loaders = [DistributedDataloader(make(tdataset), mesh=cpu_mesh(), global_batch=16,
                                     seed=seed, prefetch=k) for k in (0, 1, 3)]
    for _ in range(6):
        want = jdl.next_batch()
        for dl in loaders:
            got = dl.next_batch()
            assert set(got) == set(want)
            for key in want:
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert [dl.prefetch_hits for dl in loaders] == [0, 5, 5]
    per_batch = 16 * (2 if dataset == "math" else 1)  # prompts and answers
    assert loaders[0].rows_loaded == jdl.rows_loaded == 6 * per_batch
    assert [dl.rows_loaded for dl in loaders[1:]] == [7 * per_batch, 9 * per_batch]
    assert len(loaders[2]._ready) == 3


# --------------------------------------------------------------------------- #
# the straggler copy: the balancer's permutations
# --------------------------------------------------------------------------- #
def _lengths(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return np.sort(rng.exponential(48.0, size=n).astype(np.int64) + 4)
    return rng.integers(1, 100, size=n)


BALANCE_CASES = {
    "skewed_4_buckets": dict(lengths=("skewed", 0, 64), num_buckets=4),
    "uniform_6_buckets": dict(lengths=("uniform", 7, 48), num_buckets=6),
    "grpo_groups": dict(lengths=("uniform", 1, 64), num_buckets=4, group_size=8),
    "hierarchical_2_hosts": dict(lengths=("skewed", 3, 64), num_buckets=4, group_size=4,
                                 hosts=2),
    "rebalance_capacities": dict(lengths=("uniform", 5, 16), num_buckets=4, group_size=4,
                                 capacities=[1, 1, 0, 2]),
}


@pytest.mark.parametrize("case", sorted(BALANCE_CASES))
def test_balancer_equals_jax(case):
    kw = dict(BALANCE_CASES[case])
    kind, seed, n = kw.pop("lengths")
    lengths = _lengths(seed, n, kind)
    perm = straggler.balance_by_length(lengths, **kw)
    np.testing.assert_array_equal(perm, jstraggler.balance_by_length(lengths, **kw))
    assert sorted(perm.tolist()) == list(range(n))
    x = np.random.default_rng(seed).normal(size=(n, 3))
    np.testing.assert_array_equal(x[perm][np.argsort(perm)], x)
    nb = kw["num_buckets"]
    assert straggler.bucket_token_ratio(lengths, nb, perm) == \
        jstraggler.bucket_token_ratio(lengths, nb, perm)
    if case == "skewed_4_buckets":  # within 1.25x of the mean on a skewed batch
        assert straggler.bucket_token_ratio(lengths, nb) > 1.25
        assert straggler.bucket_token_ratio(lengths, nb, perm) <= 1.25
    g = kw.get("group_size", 1)
    rows = perm.reshape(-1, g)
    assert (rows // g == rows[:, :1] // g).all() and (rows % g == np.arange(g)).all()
    if "capacities" in kw:
        assert len(np.split(perm, np.cumsum(np.asarray(kw["capacities"][:-1]) * g))[2]) == 0


@pytest.mark.parametrize("args,kw", [(([1, 2, 3], 2), dict(group_size=2)),
                                     (([1, 2, 3, 4], 2), dict(capacities=[1, 2]))],
                         ids=["rows_not_in_groups", "capacities_short"])
def test_balancer_bad_shapes_raise_as_in_jax(args, kw):
    for mod in (straggler, jstraggler):
        with pytest.raises(ValueError):
            mod.balance_by_length(*args, **kw)


# --------------------------------------------------------------------------- #
# the worker's load-balance repack (paper §6.2), without a model
# --------------------------------------------------------------------------- #
def _rollout_keys(lengths, g):
    """Group-expanded rollout keys of one GENERATE stage: tokens, a response
    mask with the given lengths, logprobs and answers."""
    B, S = len(lengths) * g, 8
    rng = np.random.default_rng(4)
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(np.repeat(lengths, g)):
        mask[b, 2:2 + n] = True
    return {"tokens": rng.integers(3, 259, (B, S)).astype(np.int32), "response_mask": mask,
            "old_logprob": (rng.standard_normal((B, S)) * mask).astype(np.float32),
            "answers": np.repeat(np.arange(len(lengths), dtype=np.int32), g)}


@pytest.mark.parametrize("kind", ["distributed", "double", "centralized"])
@pytest.mark.parametrize("num_buckets,lengths", [(2, [6, 6, 3, 1]), (2, [2, 6, 2, 6]),
                                                 (3, [6, 6, 3, 1])])
def test_balance_repack_equals_jax(kind, num_buckets, lengths):
    """The repack's metrics and the permuted buffer contents are the JAX
    worker's (the JAX baseline buffer lists no keys, so it never repacks:
    the centralized case is held to the distributed JAX buffer's result).
    A bucket count that cannot split the groups reports balance/skipped."""
    g = 2
    keys = _rollout_keys(lengths, g)
    spec, jspec = algorithms.get_algorithm("grpo"), jalgos.get_algorithm("grpo")
    coord = dict(load_balance=True, num_buckets=num_buckets)
    cls, jcls = BUFFERS[kind][0], BUFFERS["distributed" if kind == "centralized" else kind][1]
    buf, jb = cls(cpu_mesh()), jcls(mesh11())
    for k, v in keys.items():
        buf.put(k, torch.from_numpy(v.copy()), MODEL)
        jb.put(k, jnp.asarray(v), P(*(MODEL)))
    ctx = worker.WorkerContext(mesh=cpu_mesh(), rl=RLConfig(group_size=g), engines={},
                               dataloader=None, algorithm=spec)
    jctx = jworker.WorkerContext(mesh=mesh11(), rl=JaxRLConfig(group_size=g), engines={},
                                 dataloader=None, algorithm=jspec)
    w = worker.DAGWorker(ctx, DAGPlanner().plan(grpo_dag()), default_registry(), buf,
                         DataCoordinatorConfig(**coord))
    jw = jworker.DAGWorker(jctx, jplanner.DAGPlanner().plan(jalgos.grpo_dag()),
                           jregistry.default_registry(), jb, JaxCoordinatorConfig(**coord))
    m, jm = w._balance_rollouts(), jw._balance_rollouts()
    assert m == jm
    assert ("balance/skipped" in m) == (num_buckets == 3)
    if num_buckets == 2:
        assert m["balance/repacked"] == (1.0 if lengths == [6, 6, 3, 1] else 0.0)
    for k in keys:
        np.testing.assert_array_equal(buf.get(k).numpy(), np.asarray(jb.get(k)))
    if kind != "centralized":
        assert _stat_counts(buf.stats) == _stat_counts(jb.stats)


def test_execute_node_records_spans_time_and_errors_as_jax():
    """Each node runs inside a ``node/<id>`` span of the process tracer and
    reports ``time/<id>``; a raising stage keeps its time, adds
    ``error/<id>`` and marks its span, in both packages."""
    from repro.core import registry as jreg_mod
    from repro.obs import trace as jtrace
    from repro_torch.core.registry import Registry
    from repro_torch.obs import trace

    def boom(ctx, buf, node):
        raise RuntimeError("stage failed")

    got = []
    for reg_cls, tr, wmod, ctx_mesh, plan, core_node, role, ntype in (
            (Registry, trace, worker, cpu_mesh(), DAGPlanner().plan(grpo_dag()), Node, Role,
             NodeType),
            (jreg_mod.Registry, jtrace, jworker, mesh11(),
             jplanner.DAGPlanner().plan(jalgos.grpo_dag()), jregistry.Node, jregistry.Role,
             jregistry.NodeType)):
        reg = reg_cls()
        for task in plan.tasks:
            reg.register(task.node.role, task.node.type,
                         lambda ctx, buf, node: {f"ran/{node.node_id}": 1.0})
        reg.register(role.REWARD, ntype.COMPUTE, boom, override=True)
        buf_cls = DistributedDatabuffer if wmod is worker else jbuf.DistributedDatabuffer
        ctx = wmod.WorkerContext(mesh=ctx_mesh, rl=None, engines={}, dataloader=None)
        w = wmod.DAGWorker(ctx, plan, reg, buf_cls(ctx_mesh))
        tracer = tr.Tracer(enabled=True)
        old = tr.set_tracer(tracer)
        metrics = {}
        try:
            for node, fn in w.queue:
                try:
                    w.execute_node(node, fn, metrics)
                except RuntimeError:
                    break
        finally:
            tr.set_tracer(old)
        spans = {e["name"]: e for e in tracer.to_events() if e.get("ph") == "X"}
        got.append((sorted(metrics), sorted(spans),
                    spans["node/reward_compute"]["args"].get("error")))
    assert got[0] == got[1]
    keys, span_names, err = got[0]
    assert "error/reward_compute" in keys and "time/reward_compute" in keys
    assert "ran/actor_generation" in keys and "time/advantage_compute" not in keys
    assert "node/actor_generation" in span_names and err == 1
