"""The port's data-parallel fleet (``repro_torch.distributed.fleet``,
``compression`` and ``launch.mesh``) against the JAX package's on the CPU.

Two layers:

1.  **In-process**, held against the JAX modules: the int8 wire form bit
    for bit, every ``FleetContext`` unit of ``tests/test_fleet.py``, the
    ``GradExchange`` slice mixing with JAX's expected values, a mixed
    exchange in which host 0 is JAX's ``FleetContext`` and ``GradExchange``
    and host 1 the port's on one coordinator directory (both return the
    same vector bit for bit), ``fleet_actor_step`` bit for bit the fused
    actor step, and the worker's hierarchical repack on a ``pod`` = 2 mesh.
2.  **Subprocess fleets**, port only: ``tests/torch_fleet_host.py`` hosts
    spawned by a subclass of ``tests/fleet/runner.FleetRunner``, all fleets
    at once, each host on one torch thread, on one experiment file
    (``--smoke`` gemma-2b, ``entropy_coef`` 0.01 and ``lr`` 1e-3, so every
    step has a gradient): 2 exact hosts against a solo run (params and
    every metric but ``fleet/`` and ``time/`` bit for bit, with telemetry
    on), 2 ``int8_ef`` hosts, 2 hosts with ``--load-balance``, and 3 hosts
    of which host 1 kills itself at iteration 1 (the survivors recover and
    end on the solo run's params).
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleet.runner import FleetRunner
from repro.configs.base import DistributedConfig as JaxDistributedConfig
from repro.distributed import compression as jcompression
from repro.distributed import fleet as jfleet
from repro.ft import straggler as jstraggler
from repro_torch import tree
from repro_torch.configs import DataCoordinatorConfig, DistributedConfig, get_config, reduced
from repro_torch.core import DAGPlanner, DeviceMesh, DistributedDatabuffer, default_registry
from repro_torch.core import worker
from repro_torch.distributed import compression, fleet
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.models import get_model
from repro_torch.rl import algorithms, trainer
from repro_torch.rl.trainer import RLConfig

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_PROGRAM = os.path.join(REPO, "tests", "torch_fleet_host.py")
FLEET_TIMEOUT = 300.0


def bits(a) -> np.ndarray:
    """The raw bits of a float array (jax, torch or numpy), for bitwise
    comparisons that also tell -0.0 from 0.0."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    a = np.asarray(a, dtype=np.float32)
    return a.view(np.uint32)


def _clean(history):
    """The view of a metric history that must not depend on the fleet:
    without wall times and the fleet's wire metrics (as tests/test_fleet.py)."""
    return {it: {k: v for k, v in m.items()
                 if "fleet/" not in k and not k.startswith("time/")}
            for it, m in history.items()}


# ================================================================== #
# compression: bit for bit JAX's
# ================================================================== #
@pytest.mark.parametrize("with_error", [False, True], ids=["memoryless", "error_feedback"])
@pytest.mark.parametrize("size", [0, 1, 255, 256, 257, 100_003])
def test_compression_equals_jax_bit_for_bit(size, with_error):
    """encode's q, scale and new error, decode and wire_bytes: torch's round
    (half to even) of an fp32 division gives JAX's bits."""
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) * 3.0).astype(np.float32)
    x[: size // 7] = 0.0  # a zero block quantizes against the 1e-12 floor
    err = (rng.standard_normal(size) * 0.01).astype(np.float32) if with_error else None
    jq, js, je = jcompression.encode(jnp.asarray(x), None if err is None else jnp.asarray(err))
    q, s, e = compression.encode(torch.from_numpy(x),
                                 None if err is None else torch.from_numpy(err))
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(s), bits(js))
    np.testing.assert_array_equal(bits(e), bits(je))
    np.testing.assert_array_equal(bits(compression.decode(q, s, (size,), size)),
                                  bits(jcompression.decode(jq, js, (size,), size)))
    assert compression.wire_bytes(torch.from_numpy(x)) == jcompression.wire_bytes(
        jnp.asarray(x))
    assert compression.num_blocks(size) == jcompression.num_blocks(size)


def test_compression_under_the_scale_floor_equals_jax():
    """A block whose max |x| is under 127 * SCALE_FLOOR divides by the floor,
    not by its scale: JAX's bits, with a decode error up to the block's max
    (a normal block stays within max / 126)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(3 * compression.BLOCK).astype(np.float32)
    x[256:512] *= np.float32(1e-11)
    x[512:] *= np.float32(1e-30)
    jq, js, je = jcompression.encode(jnp.asarray(x))
    q, s, e = compression.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(s), bits(js))
    np.testing.assert_array_equal(bits(e), bits(je))
    d = compression.decode(q, s, x.shape, x.size).numpy()
    err = np.abs(d - x).reshape(3, -1).max(axis=1)
    m = np.abs(x).reshape(3, -1).max(axis=1)
    assert (s.numpy().ravel() < compression.SCALE_FLOOR).tolist() == [False, True, True]
    assert err[0] <= m[0] / 126 and (err[1:] <= m[1:]).all() and (err[1:] > m[1:] / 126).all()


def test_ef_update_equals_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((5, 77)).astype(np.float32)
    err = (rng.standard_normal((5, 77)) * 0.01).astype(np.float32)
    d, e = compression.ef_update(torch.from_numpy(g), torch.from_numpy(err))
    jd, je = jcompression.ef_update(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(bits(d), bits(jd))
    np.testing.assert_array_equal(bits(e), bits(je))


# ================================================================== #
# FleetContext: the units of tests/test_fleet.py on the port
# ================================================================== #
def _mk_ctx(root, pid, hosts=2, **overrides):
    cfg = DistributedConfig(num_hosts=hosts, process_id=pid, coordinator=str(root), **overrides)
    return fleet.FleetContext(cfg)


def _mk_jctx(root, pid, hosts=2, **overrides):
    cfg = JaxDistributedConfig(num_hosts=hosts, process_id=pid, coordinator=str(root),
                               **overrides)
    return jfleet.FleetContext(cfg)


def test_fleet_context_iteration_lag_detection(tmp_path):
    c0, c1 = _mk_ctx(tmp_path, 0), _mk_ctx(tmp_path, 1)
    c0.heartbeat(0)
    c1.heartbeat(0)
    assert c0.poll_peers() == []
    c0.heartbeat(5)  # peer now >= patience iterations behind
    assert c0.poll_peers() == [1]  # never includes self


def test_fleet_context_wallclock_staleness(tmp_path):
    c0 = _mk_ctx(tmp_path, 0, dead_after_s=0.5)
    c1 = _mk_ctx(tmp_path, 1, dead_after_s=0.5)
    c0.heartbeat(0)
    c1.heartbeat(0)
    assert c0.poll_peers() == []
    time.sleep(0.7)
    c0.heartbeat(0)  # refresh self; same iteration, so no lag signal
    assert c0.poll_peers() == [1]


def test_membership_epoch_first_writer_wins(tmp_path):
    c0 = _mk_ctx(tmp_path, 0, hosts=3)
    c1 = _mk_ctx(tmp_path, 1, hosts=3)
    c0.declare_dead([2])
    assert (c0.epoch, c0.members, c0.dead_hosts) == (1, [0, 1], [2])
    c1.declare_dead([2])  # racing survivor adopts, does not re-publish
    assert (c1.epoch, c1.members) == (1, [0, 1])
    # dead host's slice ownership reassigns deterministically and totally
    assert sorted(s for ss in c0.partition().values() for s in ss) == [0, 1, 2]
    assert c0.partition()[2] == []
    assert c0.slice_owner() == c1.slice_owner()


def test_declare_self_dead_raises(tmp_path):
    c0 = _mk_ctx(tmp_path, 0)
    with pytest.raises(RuntimeError):
        c0.declare_dead([0])


def test_wait_files_raises_hosts_lost_on_stale_peer(tmp_path):
    c0 = _mk_ctx(tmp_path, 0, dead_after_s=0.4)
    c1 = _mk_ctx(tmp_path, 1, dead_after_s=0.4)
    c0.heartbeat(0)
    c1.heartbeat(0)
    time.sleep(0.6)
    with pytest.raises(fleet.HostsLost) as exc:
        c0.wait_files([str(tmp_path / "never")], timeout=10.0)
    assert exc.value.hosts == [1]


def test_wait_files_adopts_published_epoch(tmp_path):
    c0 = _mk_ctx(tmp_path, 0, hosts=3)
    c1 = _mk_ctx(tmp_path, 1, hosts=3)
    c0.heartbeat(0)
    c1.heartbeat(0)
    c1.declare_dead([2])  # another survivor publishes the transition
    with pytest.raises(fleet.HostsLost) as exc:
        c0.wait_files([str(tmp_path / "never")], timeout=10.0)
    assert exc.value.hosts == [2]
    assert (c0.epoch, c0.members) == (1, [0, 1])


def test_wait_files_timeout_without_detection(tmp_path):
    c0 = _mk_ctx(tmp_path, 0)
    with pytest.raises(TimeoutError):
        c0.wait_files([str(tmp_path / "never")], timeout=0.2, detect=False)


def _rendezvous(ctxs):
    errs = []

    def arrive(c):
        try:
            c.barrier("startup", timeout=30.0)
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    ts = [threading.Thread(target=arrive, args=(c,)) for c in ctxs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in ts)


def test_barrier_rendezvous(tmp_path):
    _rendezvous([_mk_ctx(tmp_path, 0), _mk_ctx(tmp_path, 1)])


def test_ensure_context_reuse_and_replacement(tmp_path):
    prev = fleet.get_context()
    try:
        cfg = DistributedConfig(num_hosts=2, process_id=0, coordinator=str(tmp_path / "a"))
        a = fleet.ensure_context(cfg)
        assert fleet.ensure_context(cfg) is a  # epoch state survives rebuilds
        other = DistributedConfig(num_hosts=2, process_id=0, coordinator=str(tmp_path / "b"))
        assert fleet.ensure_context(other) is not a
    finally:
        fleet.set_context(prev)


def test_mixed_plane_membership_heartbeats_and_snapshots(tmp_path):
    """A JAX context and a port context on one directory: each sees the
    other's heartbeats, a membership epoch one publishes the other adopts,
    a barrier of the new epoch meets, and both write a metrics snapshot the
    same way."""
    p0, j1 = _mk_ctx(tmp_path, 0, hosts=3), _mk_jctx(tmp_path, 1, hosts=3)
    p0.heartbeat(0)
    j1.heartbeat(0)
    assert p0.poll_peers() == [2] and j1.poll_peers() == [2]  # host 2 never beat
    j1.declare_dead([2])
    assert p0.sync_membership() and (p0.epoch, p0.members) == (j1.epoch, j1.members) == (
        1, [0, 1])
    assert p0.slice_owner() == j1.slice_owner()
    _rendezvous([p0, j1])
    metrics = {"time/generate": 0.25, "actor/loss": -1.5}
    for c in (p0, j1):
        with open(c.publish_metrics(3, metrics)) as f:
            rec = json.load(f)
        assert (rec["host"], rec["iteration"], rec["metrics"]) == (c.process_id, 3, metrics)
    for h in (0, 1):
        assert os.path.exists(tmp_path / "obs" / f"host{h}" / "it000003.json")


def test_fleet_mesh_and_host_groups():
    """make_fleet_mesh: the (pod, data, model) placement JAX's fleet mesh
    reads as, one device a host; host_device_groups over it; more devices a
    host wait for the sharding layer."""
    m = mesh_mod.make_fleet_mesh(3, device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 3, "data": 1, "model": 1}
    assert m.device == torch.device("cpu")
    assert fleet.host_device_groups(m) == [[0], [1], [2]]
    assert fleet.host_device_groups(DeviceMesh("cpu")) == [[0]]
    assert DeviceMesh("cpu").shape == {"data": 1, "model": 1}
    assert mesh_mod.init_distributed("/unused", 1) is None
    with pytest.raises(NotImplementedError, match="item 8: distributed"):
        mesh_mod.make_fleet_mesh(2, devices_per_host=4, device="cpu")


def test_fleet_flags_layer_over_the_experiment_file(tmp_path):
    """An experiment file's ``distributed`` stands as it is, and the four
    fleet flags layer over it field by field, so one file serves every host
    and the solo run; without the flags the file's setting runs."""
    path = tmp_path / "exp.json"
    train.main(["--smoke", "--device", "cpu", "--dump-experiment", str(path)])
    spec = json.loads(path.read_text())
    spec["distributed"] = {"num_hosts": 1, "dead_after_s": 7.0, "exchange_timeout_s": 99.0}
    path.write_text(json.dumps(spec))
    base = ["--experiment", str(path)]
    assert train.build_experiment(train.parse_args(base)).distributed == DistributedConfig(
        dead_after_s=7.0, exchange_timeout_s=99.0)
    flags = ["--num-hosts", "2", "--process-id", "1", "--coordinator", str(tmp_path / "c"),
             "--grad-compression", "int8_ef"]
    dist = train.build_experiment(train.parse_args(base + flags)).distributed
    assert dist == DistributedConfig(num_hosts=2, process_id=1, coordinator=str(tmp_path / "c"),
                                     grad_compression="int8_ef", dead_after_s=7.0,
                                     exchange_timeout_s=99.0)
    # flags alone build the spec's DistributedConfig, as JAX's flags do
    dist = train.build_experiment(train.parse_args(["--smoke"] + flags)).distributed
    assert (dist.num_hosts, dist.process_id, dist.grad_compression) == (2, 1, "int8_ef")
    with pytest.raises(ValueError, match="coordinator"):
        train.build_experiment(train.parse_args(base + ["--num-hosts", "2"]))


# ================================================================== #
# GradExchange
# ================================================================== #
def _run_exchange_pair(tmp_path, mode, grads_by_host, rounds=1, packages=("port", "port")):
    """Drive both hosts' GradExchange concurrently (publish-then-wait makes
    this deadlock-free in one process); ``packages[h]`` picks host h's
    FleetContext and GradExchange (the port's or JAX's). Returns per-host
    results per round."""
    make = {"port": (_mk_ctx, fleet.GradExchange), "jax": (_mk_jctx, jfleet.GradExchange)}
    ctxs = [make[p][0](tmp_path, h) for h, p in enumerate(packages)]
    for c in ctxs:
        c.heartbeat(0)  # bring-up contract: never-beat peers look dead
    exs = [make[p][1](c, mode) for c, p in zip(ctxs, packages)]
    results = {0: [], 1: []}
    errors = []

    def drive(h):
        try:
            for _ in range(rounds):
                results[h].append(exs[h](grads_by_host[h]))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((h, e))

    ts = [threading.Thread(target=drive, args=(h,)) for h in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in ts)
    return exs, results


def test_grad_exchange_exact_slice_mixing(tmp_path):
    """Host h owns slice h of the flat vector: the rebuilt tree every host
    returns is slice 0 from host 0's gradient + slice 1 from host 1's, bit
    for bit, in JAX's leaf order (dict keys sorted: b before w, though the
    port's dicts list w first), with the tree structure and dtypes kept."""
    g0 = {"w": torch.full((30,), 1.0), "b": torch.full((10,), 3.0)}
    g1 = {"w": torch.full((30,), 2.0), "b": torch.full((10,), 4.0)}
    exs, results = _run_exchange_pair(tmp_path, "none", {0: g0, 1: g1})
    # b + first 10 of w from host 0, the last 20 of w from host 1: JAX's
    # expected values (tests/test_fleet.py)
    expect_b = np.full(10, 3.0)
    expect_w = np.concatenate([np.full(10, 1.0), np.full(20, 2.0)])
    for h in range(2):
        out, metrics = results[h][0]
        assert list(out) == ["w", "b"] and out["w"].dtype == torch.float32
        np.testing.assert_array_equal(out["w"].numpy(), expect_w)
        np.testing.assert_array_equal(out["b"].numpy(), expect_b)
        assert metrics["fleet/published_bytes"] == 20 * 4
    for ex in exs:
        assert ex.stats["wire_bytes"] == ex.stats["exact_bytes"] == 40 * 4


def test_grad_exchange_int8_ef_bounded_and_cheaper(tmp_path):
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(600).astype(np.float32))
    exs, results = _run_exchange_pair(tmp_path, "int8_ef", {0: g, 1: g}, rounds=2)
    vec = g.numpy()
    # per-block int8: elementwise error bounded by the block scale (the EF
    # round's scale can grow by half an lsb, hence 126 not 127)
    bound = np.abs(vec).max() / 126.0
    for h in range(2):
        for out, _ in results[h]:
            assert np.abs(out.numpy() - vec).max() <= bound
    # both hosts decode the same bytes -> identical reconstructions
    for r in range(2):
        np.testing.assert_array_equal(bits(results[0][r][0]), bits(results[1][r][0]))
    for ex in exs:
        assert 0 < ex.stats["wire_bytes"] < ex.stats["exact_bytes"]
        assert ex.stats["wire_saved_bytes"] > 0


def test_grad_exchange_rejects_unknown_mode(tmp_path):
    with pytest.raises(ValueError):
        fleet.GradExchange(_mk_ctx(tmp_path, 0), "fp4_magic")


def _mixed_grads(seed):
    """(JAX tree, port tree) of the same values: nested dicts and a list,
    fp32 leaves and one bf16 leaf (its values exact in bf16)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(300).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    ks = [rng.standard_normal((3, 40)).astype(np.float32) for _ in range(2)]
    h = torch.from_numpy(rng.standard_normal(257).astype(np.float32)).to(torch.bfloat16)
    jtree = {"w": jnp.asarray(w), "b": jnp.asarray(b),
             "layers": [{"k": jnp.asarray(k)} for k in ks],
             "h": jnp.asarray(h.float().numpy(), dtype=jnp.bfloat16)}
    ttree = {"w": torch.from_numpy(w), "layers": [{"k": torch.from_numpy(k)} for k in ks],
             "b": torch.from_numpy(b), "h": h}
    return jtree, ttree


def test_jax_order_is_jax_tree_util_leaf_order():
    """tree.jax_order lays the port's leaves out as jax.tree_util does: dict
    keys sorted at every level, sequences and NamedTuple fields by position;
    None, an empty subtree to JAX, keeps its place as a port leaf."""
    from collections import namedtuple

    Pair = namedtuple("Pair", ["second", "first"])
    vals = iter(range(100))

    def make(leaf):
        return {"z": leaf(), "a": [{"y": leaf(), "b": leaf()}, Pair(leaf(), leaf())],
                "m": {"k": (leaf(), None), "c": leaf()}}

    ttree = make(lambda: torch.tensor(float(next(vals))))
    vals = iter(range(100))
    jtree = make(lambda: jnp.asarray(float(next(vals))))
    tl = tree.leaves(ttree)
    got = [float(tl[i]) for i in tree.jax_order(ttree) if tl[i] is not None]
    assert got == [float(x) for x in jax.tree_util.tree_leaves(jtree)]
    assert sorted(tree.jax_order(ttree)) == list(range(len(tl)))


@pytest.mark.parametrize("mode", ["none", "int8_ef"])
def test_mixed_exchange_jax_and_port_hosts(tmp_path, mode):
    """Host 0 is the JAX package's FleetContext and GradExchange, host 1 the
    port's, on one coordinator directory: over 3 rounds (error feedback
    carried) both return the same vector bit for bit, the port keeps each
    leaf's dtype (bf16 round-trips exactly in the exact mode) and both count
    the same wire bytes."""
    rounds = 3
    j0, _ = _mixed_grads(0)
    _, t1 = _mixed_grads(1)
    exs, results = _run_exchange_pair(tmp_path, mode, {0: j0, 1: t1}, rounds=rounds,
                                      packages=("jax", "port"))
    for r in range(rounds):
        jout, jm = results[0][r]
        tout, tm = results[1][r]
        jleaves = jax.tree_util.tree_leaves(jout)
        tleaves = [tree.leaves(tout)[i] for i in tree.jax_order(tout)]
        assert len(jleaves) == len(tleaves) == 5
        for jl, tl in zip(jleaves, tleaves):
            assert str(jl.dtype) == str(tl.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(bits(jl), bits(tl))
        # each host counts the slice it published (slice 0 is never smaller)
        assert jm.pop("fleet/published_bytes") >= tm.pop("fleet/published_bytes") > 0
        assert jm == tm
    if mode == "none":  # host 0's slice comes back as host 0 sent it
        np.testing.assert_array_equal(bits(results[1][0][0]["b"]), bits(j0["b"]))
        assert results[1][0][0]["h"].dtype == torch.bfloat16
    assert exs[0].stats == exs[1].stats


def _actor_batch(B=4, prompt=3, new=5, seed=0):
    rng = np.random.default_rng(seed)
    S = prompt + new
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(rng.integers(2, new + 1, B)):
        mask[b, prompt:prompt + n] = True
    lp = lambda: ((rng.standard_normal((B, S)) * 0.05 - 6.2) * mask).astype(np.float32)  # noqa: E731
    batch = {"tokens": rng.integers(3, 259, (B, S)).astype(np.int32), "response_mask": mask,
             "old_logprob": lp(), "ref_logprob": lp(),
             "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_fleet_actor_step_bitwise_the_fused_step(tmp_path):
    """Two hosts on the same gradient, grad fn + exact exchange + apply fn,
    over two steps: params (bf16 and fp32 leaves), AdamW moments and every
    metric bit for bit the fused ``make_actor_step``."""
    cfg = reduced(get_config("gemma-2b"), vocab_size=260, num_layers=2)
    model = get_model(cfg, device="cpu")
    rl = RLConfig(group_size=2, lr=1e-3, entropy_coef=0.01)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _actor_batch()
    fused = trainer.make_actor_step(model, rl)
    state = trainer.init_state(tree.map(torch.clone, params))
    want = []
    for _ in range(2):
        state, m = fused(state, batch)
        want.append(m)

    ctxs = [_mk_ctx(tmp_path, h) for h in range(2)]
    for c in ctxs:
        c.heartbeat(0)
    steps = [fleet.fleet_actor_step(trainer.make_actor_grad_fn(model, rl),
                                    trainer.make_actor_apply_fn(rl),
                                    fleet.GradExchange(c, "none")) for c in ctxs]
    got, errors = {}, []

    def drive(h):
        try:
            s = trainer.init_state(tree.map(torch.clone, params))
            ms = []
            for _ in range(2):
                s, m = steps[h](s, batch)
                ms.append(m)
            got[h] = (s, ms)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((h, e))

    ts = [threading.Thread(target=drive, args=(h,)) for h in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    for h in range(2):
        s, ms = got[h]
        for a, b in zip(tree.leaves(s), tree.leaves(state)):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        for m, w in zip(ms, want):
            assert {k for k in m if not k.startswith("fleet/")} == set(w)
            for k in w:
                np.testing.assert_array_equal(bits(m[k]), bits(w[k]))
            assert m["fleet/wire_bytes"] > 0
    assert float(want[0]["grad_norm"]) > 0


# ================================================================== #
# the worker's hierarchical repack on a pod = 2 mesh
# ================================================================== #
@pytest.mark.parametrize("num_buckets,lengths", [(2, [6, 6, 1, 1]), (4, [6, 5, 1, 2]),
                                                 (2, [1, 6, 6, 1])])
def test_hierarchical_repack_equals_jax(num_buckets, lengths):
    """A fleet mesh's pod axis bins the rollouts hierarchically: the worker's
    permutation is JAX's ``balance_by_length(..., hosts=2)`` and its
    ``balance/cross_host_row_moves`` JAX's ``cross_host_rows``."""
    g, S = 2, 8
    B = len(lengths) * g
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(np.repeat(lengths, g)):
        mask[b, 1:1 + n] = True
    tokens = np.arange(B * S, dtype=np.int32).reshape(B, S)
    mesh = mesh_mod.make_fleet_mesh(2, device="cpu")
    buf = DistributedDatabuffer(mesh)
    model_spec = (("pod", "data"),)
    buf.put("tokens", torch.from_numpy(tokens), model_spec)
    buf.put("response_mask", torch.from_numpy(mask), model_spec)
    spec = algorithms.get_algorithm("grpo")
    ctx = worker.WorkerContext(mesh=mesh, rl=RLConfig(group_size=g), engines={},
                               dataloader=None, algorithm=spec)
    coord = DataCoordinatorConfig(load_balance=True,
                                  num_buckets=num_buckets if num_buckets != 2 else 0)
    w = worker.DAGWorker(ctx, DAGPlanner().plan(algorithms.grpo_dag()), default_registry(),
                         buf, coord)
    m = w._balance_rollouts()
    lens = mask.sum(1)
    perm = jstraggler.balance_by_length(lens, num_buckets, group_size=g, hosts=2)
    before = jstraggler.bucket_token_ratio(lens, num_buckets)
    after = jstraggler.bucket_token_ratio(lens, num_buckets, perm)
    moved = after < before
    assert m["balance/repacked"] == float(moved)
    assert m["balance/cross_host_row_moves"] == float(
        jstraggler.cross_host_rows(perm, 2) if moved else 0)
    assert m["balance/token_ratio_before"] == before
    np.testing.assert_array_equal(buf.get("tokens").numpy(), tokens[perm] if moved else tokens)
    if lengths == [6, 6, 1, 1]:  # both heavy groups start on host 0
        assert moved and m["balance/cross_host_row_moves"] > 0


# ================================================================== #
# subprocess fleets (port only)
# ================================================================== #
class TorchFleetRunner(FleetRunner):
    """``FleetRunner`` spawning ``tests/torch_fleet_host.py`` hosts."""

    def launch_host(self, host, *, die_at=-1, solo=False):
        log = os.path.join(self.workdir, f"host{host}.log")
        self._logs[host] = log
        with open(log, "wb") as f:
            proc = subprocess.Popen(
                [sys.executable, HOST_PROGRAM], env=self._env(host, solo, die_at),
                stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
        self.procs[host] = proc
        return proc


def _experiment_file(path, dead_after_s: float) -> str:
    """``--smoke`` gemma-2b (2 prompts of 4 rollouts, 8 new tokens) with
    train_host.py's lr and entropy bonus, and the file's ``distributed``
    carrying the failure-detection times (one host: the flags layer the
    fleet over it)."""
    train.main(["--smoke", "--device", "cpu", "--prompts-per-iter", "4", "--group-size", "4",
                "--max-new-tokens", "8", "--lr", "1e-3", "--dump-experiment", str(path)])
    spec = json.loads(path.read_text())
    spec["rl"]["entropy_coef"] = 0.01
    spec["distributed"] = {"num_hosts": 1, "dead_after_s": dead_after_s,
                           "exchange_timeout_s": FLEET_TIMEOUT}
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Every subprocess fleet of this file, started together and joined:
    exact (2 hosts, telemetry on) with its solo reference, int8_ef (2),
    balanced (2), and recovery (3 hosts, host 1 killed at iteration 1)."""
    root = tmp_path_factory.mktemp("torch_fleets")
    exp = _experiment_file(root / "experiment.json", dead_after_s=60.0)
    rexp = _experiment_file(root / "recovery_experiment.json", dead_after_s=6.0)
    runners = {
        "exact": TorchFleetRunner(root / "exact", extra_env={
            "FLEET_EXPERIMENT": exp, "FLEET_OBS": "1"}),
        "comp": TorchFleetRunner(root / "comp", compression="int8_ef",
                                 extra_env={"FLEET_EXPERIMENT": exp}),
        "balance": TorchFleetRunner(root / "balance", extra_env={
            "FLEET_EXPERIMENT": exp, "FLEET_BALANCE": "1"}),
        "recovery": TorchFleetRunner(root / "recovery", num_hosts=3, dead_after_s=6.0,
                                     extra_env={"FLEET_EXPERIMENT": rexp,
                                                "FLEET_RECOVER": "1"}),
    }
    for name, r in runners.items():
        r.launch(die_at={1: 1} if name == "recovery" else None)
    exact = runners["exact"]
    exact.launch_host(exact.num_hosts, solo=True)
    for name, r in runners.items():
        if name == "recovery":
            r.wait(hosts=[0, 2], timeout=FLEET_TIMEOUT)
            r.wait(hosts=[1], timeout=FLEET_TIMEOUT, expect_failure=(1,))
        else:
            r.wait(timeout=FLEET_TIMEOUT)
    return {"exact": exact.artifacts(), "solo": exact.artifact(exact.num_hosts),
            "comp": runners["comp"].artifacts(), "balance": runners["balance"].artifacts(),
            "recovery": runners["recovery"].artifacts([0, 2])}


def test_fleet_parity_bitwise(fleets):
    """`launch.train --num-hosts 2` on one experiment file: both hosts end on
    the params of the `--num-hosts 1` run, bit for bit, with every
    per-iteration metric equal but the fleet's and the wall times."""
    solo = fleets["solo"]
    for h, art in fleets["exact"].items():
        assert art["params_sha256"] == solo["params_sha256"], f"host {h}"
        assert _clean(art["history"]) == _clean(solo["history"]), f"host {h}"
        assert art["steps"] == solo["steps"] == [0, 1, 2]


def test_fleet_every_step_has_a_gradient(fleets):
    for art in list(fleets["exact"].values()) + [fleets["solo"]]:
        assert all(m["actor/grad_norm"] > 0 for m in art["history"].values())


def test_fleet_no_controller_traffic(fleets):
    for art in list(fleets["exact"].values()) + [fleets["solo"]]:
        assert art["buffer"]["bytes_through_controller"] == 0


def test_fleet_clean_run_membership(fleets):
    for art in fleets["exact"].values():
        assert art["members"] == [0, 1]
        assert art["epoch"] == 0
        assert art["recoveries"] == 0
        assert art["dead_hosts"] == []
        assert art["monitor_dead"] == []


def test_fleet_exact_wire_accounting(fleets):
    """grad_compression='none' ships raw fp32: wire bytes == exact bytes,
    nothing saved, one exchange per iteration, each host publishing half."""
    for art in fleets["exact"].values():
        ex = art["exchange"]
        assert ex["exchanges"] == art["iters"] == 3
        assert ex["wire_bytes"] == ex["exact_bytes"] > 0
        assert ex["wire_saved_bytes"] == 0
        for m in art["history"].values():
            assert m["actor/fleet/wire_bytes"] * 3 == ex["wire_bytes"]
            assert abs(m["actor/fleet/published_bytes"] * 2 - m["actor/fleet/wire_bytes"]) <= 4


def test_fleet_obs_trace_schema(fleets):
    """Each host exports a Chrome trace: complete ("X") events with ts/dur,
    its own pid track named by "M" metadata, and both the DAG node spans and
    the GradExchange rounds; the merged fleet trace carries every host."""
    from repro_torch.obs.aggregate import merge_traces

    traces = []
    for h, art in fleets["exact"].items():
        with open(art["obs"]["trace"]) as f:
            tr = json.load(f)
        evs = tr["traceEvents"]
        assert evs, f"host {h}: empty trace"
        for ev in evs:
            assert {"name", "ph", "pid", "tid"} <= set(ev)
            assert ev["ph"] in ("X", "M", "i")
            if ev["ph"] == "X":
                assert ev["ts"] > 0 and ev["dur"] >= 0
        assert {ev["pid"] for ev in evs} == {h}
        meta = {ev["args"]["name"] for ev in evs if ev["ph"] == "M"}
        assert f"host{h}" in meta
        cats = {ev["cat"] for ev in evs if ev["ph"] == "X"}
        assert {"dag", "fleet"} <= cats <= meta
        xchg = [ev for ev in evs if ev["name"] == "fleet/grad_exchange"]
        assert len(xchg) == 3 and all(ev["args"]["wire_bytes"] > 0 for ev in xchg)
        traces.append(tr)
    merged = merge_traces(traces)
    assert {e["pid"] for e in merged["traceEvents"]} == set(fleets["exact"])


def test_fleet_obs_straggler_sum_match(fleets):
    """The straggler report over the hosts' published snapshots: per-host
    per-iteration step times equal the sums of each host's own time/*
    metrics, and the merged histogram counts every (host, iteration)."""
    from repro_torch.obs.aggregate import collect_snapshots, render_report, straggler_report

    arts = fleets["exact"]
    coord = next(iter(arts.values()))["obs"]["snapshots_root"]
    report = straggler_report(collect_snapshots(coord))
    assert report["hosts"] == sorted(arts)
    for h, art in arts.items():
        steps = report["per_host"][h]["step_times"]
        assert sorted(steps) == sorted(int(i) for i in art["history"])
        for it, hist in art["history"].items():
            own = sum(v for k, v in hist.items() if k.startswith("time/"))
            assert steps[int(it)] == pytest.approx(own, rel=1e-12)
    assert report["step_hist"]["count"] == sum(len(a["history"]) for a in arts.values())
    rendered = render_report(report)
    assert "per-host summary" in rendered and "host0" in rendered
    assert "fleet step-time p50" in rendered


def test_compressed_hosts_stay_identical(fleets):
    comp = fleets["comp"]
    assert comp[0]["params_sha256"] == comp[1]["params_sha256"]
    assert _clean(comp[0]["history"]) == _clean(comp[1]["history"])


def test_compressed_converges_within_tolerance(fleets):
    exact, comp = fleets["exact"], fleets["comp"]
    assert comp[0]["params_sha256"] != exact[0]["params_sha256"]
    last = str(max(int(k) for k in exact[0]["history"]))
    exact_loss = exact[0]["history"][last]["actor/loss"]
    comp_loss = comp[0]["history"][last]["actor/loss"]
    assert abs(exact_loss - comp_loss) < 5e-3, (exact_loss, comp_loss)


def test_compressed_strictly_fewer_wire_bytes(fleets):
    exact_ex = fleets["exact"][0]["exchange"]
    comp_ex = fleets["comp"][0]["exchange"]
    assert comp_ex["exact_bytes"] == exact_ex["exact_bytes"]
    assert 0 < comp_ex["wire_bytes"] < comp_ex["exact_bytes"]
    assert comp_ex["wire_bytes"] / comp_ex["exact_bytes"] < 0.3
    assert comp_ex["wire_saved_bytes"] == comp_ex["exact_bytes"] - comp_ex["wire_bytes"]
    hist_wire = sum(m["actor/fleet/wire_bytes"] for m in fleets["comp"][0]["history"].values())
    assert hist_wire == comp_ex["wire_bytes"]
    # the wire is compression.wire_bytes summed over the two slices
    n = exact_ex["exact_bytes"] // 4 // 3
    sizes = [n // 2 + n % 2, n // 2]
    assert comp_ex["wire_bytes"] == 3 * sum(
        compression.wire_bytes(torch.empty(s, device="meta"))[1] for s in sizes)


def test_fleet_hierarchical_balance(fleets):
    """With load balancing on, every iteration reports token-bin balance,
    the repack never worsens the ratio, the hierarchical path ran (the
    cross-host metric), and both hosts computed the same permutation."""
    arts = fleets["balance"]
    assert _clean(arts[0]["history"]) == _clean(arts[1]["history"])
    assert arts[0]["params_sha256"] == arts[1]["params_sha256"]
    for m in arts[0]["history"].values():
        assert "balance/skipped" not in m, m
        assert m["balance/token_ratio_after"] <= m["balance/token_ratio_before"] + 1e-9
        assert m["balance/cross_host_row_moves"] >= 0
        assert m["balance/repacked"] in (0.0, 1.0)


def test_recovery_survivors_agree(fleets):
    """Both survivors adopt the same epoch-1 membership without the killed
    host, recover once, cover every step and land on identical params."""
    arts = fleets["recovery"]
    assert sorted(arts) == [0, 2]
    assert arts[0]["params_sha256"] == arts[2]["params_sha256"]
    for art in arts.values():
        assert art["steps"] == [0, 1, 2]
        assert art["recoveries"] == 1
        assert art["epoch"] == 1
        assert art["members"] == [0, 2]
        assert art["dead_hosts"] == [1]


def test_recovery_monitor_flags_killed_host(fleets):
    for art in fleets["recovery"].values():
        assert 1 in art["monitor_dead"]


def test_recovery_bitwise_continuity(fleets):
    """The trajectory after recovery is the undisturbed solo run's, bit for
    bit: checkpoint restore (actor state and the sampling generator),
    dataloader rewind and the exact exchange leave no trace of the failure."""
    solo = fleets["solo"]
    for h, art in fleets["recovery"].items():
        assert art["params_sha256"] == solo["params_sha256"], f"host {h}"
        assert _clean(art["history"]) == _clean(solo["history"]), f"host {h}"
