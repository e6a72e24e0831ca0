"""The sharding layer of the port (``distributed/sharding.py``,
``collectives.py``, ``launch/mesh.py``, ``launch/workloads.py``'s shapes, the
rank-mesh databuffer, ``compressed_psum``, the elastic restore, the train ->
serve switch and the data-parallel GRPO step) against the JAX package.

The spec rules run in this process on shape-only meshes. Everything with
more than one rank runs in subprocesses, each under a timeout of its own
(``torch_world``): a JAX process with 8 forced host devices computes the
references, while port worlds of gloo ranks on the CPU run the same scripts;
one module fixture starts them all at once and joins them.

Tolerances: the sharded decode's o and lse 2e-5 (fp32 products in a
different order); GRPO metrics and params fp32 2e-5, as
``test_torch_pipeline.py``; values that only move (buffers, the repack,
the switch, the restore) bit for bit; the int8 all-gather sum 1e-6 of its
largest magnitude (a sum of four products in another order).
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES_BY_NAME as JAX_SHAPES
from repro.distributed import sharding as jshr
from repro.distributed import weight_sync as jws
from repro.launch import workloads as jworkloads
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_config, reduced
from repro_torch.distributed import sharding as shr
from repro_torch.distributed import weight_sync
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import workloads
from repro_torch.rl import RLConfig, trainer
from torch_world import start_procs, start_world

torch.set_num_threads(1)

MESH1 = mesh_mod.make_production_mesh()
MESH2 = mesh_mod.make_production_mesh(multi_pod=True)
TOL = 2e-5
ITERS = 2
GRPO = dict(model=dict(vocab_size=260, num_layers=2, pad_heads_to=8),
            rl=dict(temperature=0.0, group_size=4, max_new_tokens=4, lr=1e-3, entropy_coef=0.01),
            prompts_per_iter=4)
EOS_ID, EOS_SCALE = 2, 3.0


# --------------------------------------------------------------------------- #
# the spec rules, shape-only meshes
# --------------------------------------------------------------------------- #
def _dict_path(path) -> tuple:
    return tuple(e.key for e in path if isinstance(e, jax.tree_util.DictKey))


def _port_dict_paths(t, path=()):
    """(dict-key path, leaf) of a port tree (list indices dropped)."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _port_dict_paths(v, path + (k,))
    elif isinstance(t, (list, tuple)) and not shr.is_spec(t):
        for v in t:
            yield from _port_dict_paths(v, path)
    else:
        yield path, t


def assert_specs_equal(jax_shapes, jax_specs, port_shapes, port_specs):
    """Every port leaf's spec equals the JAX spec of the leaf at the same
    dict-key path with JAX's leading stack dims (layer groups) dropped,
    which JAX never splits; every JAX path has port leaves."""
    jax_by_path = {}
    for (path, leaf), spec in zip(jax.tree_util.tree_leaves_with_path(jax_shapes),
                                  jax.tree.leaves(jax_specs, is_leaf=lambda x: isinstance(x, P))):
        assert len(spec) == len(leaf.shape), (path, spec)
        jax_by_path.setdefault(_dict_path(path), []).append((len(leaf.shape), tuple(spec)))
    seen = set()
    for (path, spec), (_, leaf) in zip(_port_dict_paths(port_specs),
                                       _port_dict_paths(port_shapes)):
        assert path in jax_by_path, path
        seen.add(path)
        for ndim, jspec in jax_by_path[path]:
            lead = ndim - leaf.dim()
            assert jspec[:lead] == (None,) * lead and jspec[lead:] == spec, (path, jspec, spec)
    assert seen == set(jax_by_path), set(jax_by_path) - seen


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX's, the port's) param shapes of ``arch``, nothing allocated."""
    return jworkloads.state_shapes(JAX_ARCHS[arch]), workloads.state_shapes(ARCHS[arch])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["pod1", "pod2"])
def test_param_specs_equal_jax(arch, mesh):
    """``param_specs`` in both modes, for every arch at both production
    meshes, leaf for leaf the JAX package's."""
    jstate, state = _shapes(arch)
    for mode in ("train", "serve"):
        assert_specs_equal(jstate.params, jshr.param_specs(JAX_ARCHS[arch], mesh, jstate.params, mode),
                           state.params, shr.param_specs(ARCHS[arch], mesh, state.params, mode))


@pytest.mark.parametrize("arch", ["deepseek-67b", "mixtral-8x7b", "mamba2-2.7b",
                                  "seamless-m4t-medium", "jamba-v0.1-52b"])
@pytest.mark.parametrize("shape", [(128, 32_768), (1, 4096)], ids=["decode_32k", "b1"])
def test_cache_specs_equal_jax(arch, shape):
    B, S = shape
    jc = jworkloads.caches_shapes(JAX_ARCHS[arch], B, S)
    c = workloads.caches_shapes(ARCHS[arch], B, S)
    assert_specs_equal(jc, jshr.cache_specs(JAX_ARCHS[arch], MESH1, B, jc),
                       c, shr.cache_specs(ARCHS[arch], MESH1, B, c))


def test_batch_axes_and_train_batch_specs_equal_jax():
    for mesh in (MESH1, MESH2):
        for b in (1, 2, 16, 32, 256, 512):
            assert shr.batch_axes(mesh, b) == jshr.batch_axes(mesh, b)
        for arch in ARCHS:
            got = shr.train_batch_specs(ARCHS[arch], mesh, 256)
            want = jshr.train_batch_specs(JAX_ARCHS[arch], mesh, 256)
            assert got == {k: tuple(v) for k, v in want.items()}
    assert shr.opt_state_specs(("data",)).m == ("data",)


@pytest.mark.parametrize("arch", ["deepseek-67b", "gemma-2b", "mixtral-8x7b"])
def test_serve_param_mode_and_switch_bytes_equal_jax(arch):
    for mesh in (MESH1, MESH2):
        for name in ("decode_32k", "long_500k"):
            shape = SHAPES_BY_NAME[name]
            assert workloads.serve_param_mode(ARCHS[arch], shape, mesh) == \
                jworkloads.serve_param_mode(JAX_ARCHS[arch], JAX_SHAPES[name], mesh)
        jstate, state = _shapes(arch)
        want = jws.switch_bytes(JAX_ARCHS[arch], mesh, jstate.params)
        got = weight_sync.switch_bytes(ARCHS[arch], mesh, state.params)
        assert got == pytest.approx(want, rel=1e-12)
    assert workloads.num_params(ARCHS[arch]) == JAX_ARCHS[arch].num_params()


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert shr.named(MESH2, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert shr.named(MESH1, (None, "data")) == (Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        shr.named(MESH2, (("data", "pod"),))


def test_fleet_geometry_48_devices():
    """``fleet_mesh_shape`` and ``fleet.host_device_groups`` at JAX's
    48-device fleet (``tests/test_fleet.py``'s geometry), with its
    refusals."""
    assert mesh_mod.fleet_mesh_shape(48, 4) == {"pod": 4, "data": 12, "model": 1}
    shape2 = mesh_mod.fleet_mesh_shape(48, 4, model_parallel=2)
    assert shape2 == {"pod": 4, "data": 6, "model": 2}
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.distributed.fleet import host_device_groups

    assert host_device_groups(DeviceMesh(None, shape2)) == \
        [list(range(h * 12, (h + 1) * 12)) for h in range(4)]
    assert mesh_mod.fleet_mesh_shape(48, 3, devices_per_host=16) == \
        {"pod": 3, "data": 16, "model": 1}
    assert host_device_groups(DeviceMesh(None, {"data": 48, "model": 1})) == \
        [list(range(48))]
    with pytest.raises(ValueError, match="divisible"):
        mesh_mod.fleet_mesh_shape(48, 5)
    with pytest.raises(ValueError, match="needs 49"):
        mesh_mod.fleet_mesh_shape(48, 7, devices_per_host=7)
    with pytest.raises(ValueError, match="world of as many"):
        mesh_mod.make_local_mesh((2, 1), device="cpu")
    assert mesh_mod.backend_for("cpu", 2) == "gloo"


# --------------------------------------------------------------------------- #
# worlds: JAX's references and the port's ranks, all started at once
# --------------------------------------------------------------------------- #
JAX_REF = r'''
import os, sys, json, pickle, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.utils.jax_compat import make_compat_mesh, shard_map
W = sys.argv[1]
G = json.loads(sys.argv[2])
out = {}

def done(name):
    open(os.path.join(W, name + ".done"), "w").close()

# the elastic-restore checkpoint of a (4, 2) mesh
from repro.ft import checkpoint
m42 = make_compat_mesh((4, 2), ('data', 'model'))
ck = {
    'w': jax.device_put(jnp.arange(64.0).reshape(8, 8), NamedSharding(m42, P('data', 'model'))),
    'b': jax.device_put(jnp.arange(8.0), NamedSharding(m42, P('model'))),
    'h': jax.device_put((jnp.arange(32.0).reshape(8, 4) / 7).astype(jnp.bfloat16),
                        NamedSharding(m42, P('data', None))),
    'step_scale': jnp.float32(3.5),
}
checkpoint.save(os.path.join(W, 'ckpt'), ck, step=17)
done('ckpt')

# the GRPO run's initial weights (fp32, the EOS row scaled)
from repro.api import ExperimentSpec
from repro.configs import get_config, reduced
from repro.rl import trainer as jtrainer
jexp = ExperimentSpec(model=reduced(get_config('gemma-2b'), **G['model']),
                      rl=jtrainer.RLConfig(**G['rl']), prompts_per_iter=G['prompts_per_iter'],
                      mesh_shape=(2, 1))
jpipe = jexp.compile()
params = jax.tree.map(lambda a: np.asarray(a, np.float32), jpipe.ctx.actor_state.params)
params['embed'][G['eos_id']] *= G['eos_scale']
with open(os.path.join(W, 'weights.pkl'), 'wb') as f:
    pickle.dump(params, f)
done('weights')

# the databuffers' DP resize on a (2, 2) mesh
from repro.core import DistributedDatabuffer, DoubleBufferedDatabuffer, CentralizedDatabuffer
m22 = make_compat_mesh((2, 2), ('data', 'model'))
x = jnp.arange(16 * 4.0).reshape(16, 4)
bufs = {}
for cls in (DistributedDatabuffer, DoubleBufferedDatabuffer, CentralizedDatabuffer):
    buf = cls(m22)
    vals = []
    for it in range(2):
        buf.put('x', x + it, P('data', None))
        for spec in (P(('data', 'model'), None), P('data'), P('model', None), P(None, 'model')):
            vals.append(np.asarray(buf.get('x', spec)).tolist())
        buf.clear()
    bufs[cls.__name__] = {'values': vals, 'stats': dataclasses.asdict(buf.stats)}
out['buffers'] = bufs

# the length-aware repack keeps the producer's spec
from repro.configs import DataCoordinatorConfig
from repro.core.worker import DAGWorker
buf = DistributedDatabuffer(m22)
lengths = np.array([13, 9, 1, 1, 5, 3, 1, 1])
mask = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int32)
buf.put('response_mask', jnp.asarray(mask), P('data', None))
buf.put('tokens', jnp.arange(8 * 16).reshape(8, 16), P('data', None))
w = DAGWorker.__new__(DAGWorker)
w.buffer = buf
w.coordinator = DataCoordinatorConfig(load_balance=True, num_buckets=4)
class C: pass
class RL: algorithm = 'ppo'; group_size = 1
w.ctx = C(); w.ctx.mesh = m22; w.ctx.rl = RL()
out['repack'] = {'metrics': w._balance_rollouts(),
                 'tokens': np.asarray(buf.get('tokens')).tolist(),
                 'mask': np.asarray(buf.get('response_mask')).tolist(),
                 'spec': [str(e) for e in buf.get('tokens').sharding.spec]}

# compressed_psum over 4 devices
from repro.distributed.compression import compressed_psum
m4 = make_compat_mesh((4,), ('data',))
xs = jnp.asarray(np.random.default_rng(0).standard_normal((4, 64, 32)).astype(np.float32))
def body(xs):
    return compressed_psum(xs[0], 'data')
approx = jax.jit(shard_map(body, mesh=m4, in_specs=(P('data', None, None),), out_specs=P(),
                           check_vma=False))(xs)
out['psum'] = np.asarray(approx).tolist()

# the sequence-sharded decode on a (1, 4) mesh
from repro.distributed.collectives import seq_sharded_decode_attention
m14 = make_compat_mesh((1, 4), ('data', 'model'))
r = np.random.default_rng(1)
q = r.standard_normal((3, 4, 16)).astype(np.float32)
k = r.standard_normal((3, 32, 2, 16)).astype(np.float32)
v = r.standard_normal((3, 32, 2, 16)).astype(np.float32)
cl = np.array([5, 8, 32], np.int32)
o = seq_sharded_decode_attention(m14, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl))
out['decode'] = np.asarray(o).tolist()

# the train -> serve switch of the GRPO weights on the (2, 2) mesh
from repro.distributed import weight_sync, sharding as shr
from repro.models import get_model
cfg = jexp.model
train_specs = shr.param_specs(cfg, m22, params, 'train')
placed = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(m22, s)),
                      params, train_specs, is_leaf=lambda x: isinstance(x, np.ndarray))
switched = weight_sync.switch(m22, placed, shr.param_specs(cfg, m22, params, 'serve'))
with open(os.path.join(W, 'switch.pkl'), 'wb') as f:
    pickle.dump(jax.tree.map(np.asarray, switched), f)

# GRPO on the (2, 1) mesh
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
jpipe.ctx.actor_state = jtrainer.init_state(fp32(params))
jpipe.ctx.ref_params = fp32(params)
hist = jpipe.run(G['iters'])
with open(os.path.join(W, 'jax_grpo.pkl'), 'wb') as f:
    pickle.dump({'history': [{k: float(v) for k, v in m.items()} for m in hist],
                 'params': jax.tree.map(np.asarray, jpipe.ctx.actor_state.params),
                 'stats': dataclasses.asdict(jpipe.buffer.stats)}, f)
with open(os.path.join(W, 'jax_ref.json'), 'w') as f:
    json.dump(out, f)
'''

PORT_WORLD4 = r'''
import os, dataclasses, pickle
import numpy as np
from torch_world import wait_for
from repro_torch import bridge
from repro_torch.core.databuffer import (CentralizedDatabuffer, DistributedDatabuffer,
                                         DoubleBufferedDatabuffer)
from repro_torch.distributed import collectives as C, compression
from repro_torch.launch.mesh import make_local_mesh
W = os.environ['WORK']
res = {}
m22 = make_local_mesh((2, 2), ('data', 'model'), device='cpu')

# the databuffers' DP resize
x = torch.arange(16 * 4.0).reshape(16, 4)
bufs = {}
for cls in (DistributedDatabuffer, DoubleBufferedDatabuffer, CentralizedDatabuffer):
    buf = cls(m22)
    vals = []
    for it in range(2):
        buf.put('x', C.shard(m22, x + it, ('data', None)), ('data', None))
        for spec in ((('data', 'model'), None), ('data',), ('model', None), (None, 'model')):
            vals.append(C.all_gather(m22, buf.get('x', spec), spec).tolist())
        buf.clear()
    bufs[cls.__name__] = {'values': vals, 'stats': dataclasses.asdict(buf.stats)}
res['buffers'] = bufs

# the repack
from repro_torch.configs import DataCoordinatorConfig
from repro_torch.core.worker import DAGWorker
buf = DistributedDatabuffer(m22)
lengths = np.array([13, 9, 1, 1, 5, 3, 1, 1])
mask = torch.from_numpy((np.arange(16)[None, :] < lengths[:, None]).astype(np.int32))
buf.put('response_mask', C.shard(m22, mask, ('data', None)), ('data', None))
buf.put('tokens', C.shard(m22, torch.arange(8 * 16).reshape(8, 16), ('data', None)), ('data', None))
w = DAGWorker.__new__(DAGWorker)
w.buffer = buf
w.coordinator = DataCoordinatorConfig(load_balance=True, num_buckets=4)
class Ctx: pass
class RL: algorithm = 'ppo'; group_size = 1
w.ctx = Ctx(); w.ctx.mesh = m22; w.ctx.rl = RL()
res['repack'] = {'metrics': w._balance_rollouts(),
                 'tokens': buf.global_value('tokens').tolist(),
                 'mask': buf.global_value('response_mask').tolist(),
                 'spec': list(buf.spec_of('tokens'))}

# compressed_psum over the 4 ranks
m4 = make_local_mesh((4,), ('data',), device='cpu')
xs = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64, 32)).astype(np.float32))
res['psum'] = compression.compressed_psum(m4, xs[RANK], 'data').tolist()

# the sequence-sharded decode on (1, 4)
m14 = make_local_mesh((1, 4), ('data', 'model'), device='cpu')
r = np.random.default_rng(1)
q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
           for s in ((3, 4, 16), (3, 32, 2, 16), (3, 32, 2, 16)))
cl = torch.tensor([5, 8, 32], dtype=torch.int32)
ks, vs = (C.shard(m14, t, (None, 'model')) for t in (k, v))
o, lse = C.seq_sharded_decode_attention(m14, q, ks, vs, cl, return_lse=True)
from repro_torch.kernels import ops
o1, lse1 = ops.decode_attention(q, k, v, cl)
res['decode'] = {'o': o.tolist(), 'lse': lse.tolist(), 'o1': o1.tolist(), 'lse1': lse1.tolist()}

# the elastic restore of the (4, 2) checkpoint onto (2, 2) ranks
from repro_torch.ft import checkpoint
wait_for(os.path.join(W, 'ckpt.done'))
specs = {'w': ('data', 'model'), 'b': (None,), 'h': (('data', 'model'), None), 'step_scale': ()}
tmpl = {'w': torch.zeros(4, 4), 'b': torch.zeros(8), 'h': torch.zeros(2, 4, dtype=torch.bfloat16),
        'step_scale': torch.zeros(())}
got, step = checkpoint.restore(os.path.join(W, 'ckpt'), tmpl, mesh=m22, specs=specs)
full = {k: C.all_gather(m22, got[k], specs[k]) for k in got}
res['restore'] = {'step': step, **{k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                                   .tolist() for k, t in full.items()}}
# ... saved again on the ranks, and restored whole on one device below
checkpoint.save(os.path.join(W, 'ckpt_ranks'), got, step=step, mesh=m22, specs=specs)

# the train -> serve switch of the GRPO weights, published
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as shr
from repro_torch.distributed.weight_sync import WeightVersionStore
wait_for(os.path.join(W, 'weights.done'))
with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
    params = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
cfg = reduced(get_config('gemma-2b'), vocab_size=260, num_layers=2, pad_heads_to=8)
train_specs = shr.param_specs(cfg, m22, params, 'train')
serve_specs = shr.param_specs(cfg, m22, params, 'serve')
shards = shr.map_with_specs(lambda p, s: C.shard(m22, p, s).clone(), params, train_specs)
pub = WeightVersionStore().publish(shards, mesh=m22, target_specs=serve_specs, specs=train_specs)
assert pub.version == 0
full = shr.map_with_specs(lambda p, s: C.all_gather(m22, p, s), pub.params, serve_specs)
if RANK == 0:
    with open(os.path.join(W, 'port_switch.pkl'), 'wb') as f:
        pickle.dump(bridge.to_jax(full), f)
RESULT = res
'''

PORT_GRPO = r'''
import os, pickle, dataclasses
from torch_world import wait_for
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, reduced
from repro_torch.rl import RLConfig, trainer
from repro_torch.distributed import sharding as shr
W = os.environ['WORK']
G = json.loads(os.environ['GRPO'])
exp = ExperimentSpec(model=reduced(get_config('gemma-2b'), **G['model']), rl=RLConfig(**G['rl']),
                     prompts_per_iter=G['prompts_per_iter'], mesh_shape=(2, 1))
pipe = exp.compile(device='cpu')
wait_for(os.path.join(W, 'weights.done'))
with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
    params = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
mesh = pipe.ctx.mesh
pipe.ctx.actor_state = trainer.shard_state(mesh, params, pipe.ctx.param_specs)
pipe.ctx.ref_params = params
hist = pipe.run(G['iters'])
final = trainer.gather_params(mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs)
if RANK == 0:
    with open(os.path.join(W, 'port_grpo.pkl'), 'wb') as f:
        pickle.dump({'history': hist, 'params': bridge.to_jax(final)}, f)
RESULT = {'mesh': mesh.shape, 'coords': mesh.coords,
          'stats': dataclasses.asdict(pipe.buffer.stats),
          'rows': int(pipe.ctx.dataloader.rows_loaded)}

# PPO on the same weights: its advantages are whitened over the global batch
ppo = ExperimentSpec(model=exp.model, rl=RLConfig(**dict(G['rl'], algorithm='ppo')),
                     prompts_per_iter=G['prompts_per_iter'], mesh_shape=(2, 1)).compile(device='cpu')
ppo.ctx.actor_state = trainer.shard_state(ppo.ctx.mesh, params, ppo.ctx.param_specs)
ppo.ctx.ref_params = params
phist = ppo.run(G['iters'])
pfinal = trainer.gather_params(ppo.ctx.mesh, ppo.ctx.actor_state.params, ppo.ctx.param_specs)
if RANK == 0:
    with open(os.path.join(W, 'port_ppo.pkl'), 'wb') as f:
        pickle.dump({'history': phist, 'params': bridge.to_jax(pfinal)}, f)
'''

LAUNCH = ["-m", "repro_torch.launch.train", "--device", "cpu", "--iters", "2"]


def launch_experiment(path, **rl) -> ExperimentSpec:
    """The entry-point tests' experiment file: the smoke gemma-2b in fp32,
    2 prompts x 4 rollouts of 6 tokens (sampled unless ``rl`` says
    otherwise), an entropy bonus, and GRPO's DAG with an (ACTOR,
    MODEL_INFERENCE) node that recomputes the behaviour logprobs in the
    training forward. The lockstep engine's KV cache is bf16 in every dtype,
    so the sampler's own logprobs move by a bf16 rounding with the batch's
    composition; recomputed, every metric is fp32's."""
    from repro_torch.core import DAG, Node, NodeType, Role

    dag = DAG.from_nodes([
        Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
        Node("actor_inference", Role.ACTOR, NodeType.MODEL_INFERENCE,
             deps=("actor_generation",)),
        Node("reference_inference", Role.REFERENCE, NodeType.MODEL_INFERENCE,
             deps=("actor_generation",)),
        Node("reward_compute", Role.REWARD, NodeType.COMPUTE, deps=("actor_generation",)),
        Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE, deps=("reward_compute",)),
        Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN,
             deps=("actor_inference", "reference_inference", "advantage_compute"))])
    exp = ExperimentSpec(model=reduced(get_config("gemma-2b"), vocab_size=260, num_layers=2,
                                       dtype="float32"),
                         rl=RLConfig(**dict(dict(group_size=4, max_new_tokens=6, lr=1e-3,
                                                 entropy_coef=0.01), **rl)),
                         prompts_per_iter=2, dag=dag.to_spec())
    with open(path, "w") as f:
        f.write(exp.to_json())
    return exp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: JAX's references (8 forced
    devices), a 4-rank port world, a 2-rank GRPO and PPO world, and
    launch.train as 2 ranks of a host:port world beside a solo run (sampled)
    and beside JAX's launch.train on 2 forced devices (greedy, from one
    checkpoint)."""
    work = str(tmp_path_factory.mktemp("sharding"))
    g = dict(GRPO, iters=ITERS, eos_id=EOS_ID, eos_scale=EOS_SCALE)
    env = {"WORK": work, "GRPO": json.dumps(g)}
    from torch_world import free_port

    from repro_torch.ft import checkpoint

    port, gport = free_port(), free_port()
    exp = os.path.join(work, "launch.json")
    launch_experiment(exp)
    launch = LAUNCH + ["--experiment", exp]
    # greedy, and no KL penalty: a resume restores the actor state only, so
    # each package's reference params are its own seed's. One initial state,
    # saved in each package's layout (JAX stacks the layers)
    import jax.numpy as jnp
    from repro.ft import checkpoint as jax_ckpt
    from repro.rl import trainer as jtrainer

    gexp = os.path.join(work, "greedy.json")
    init = launch_experiment(gexp, temperature=0.0, kl_coef=0.0).compile(
        device="cpu").ctx.actor_state
    checkpoint.save(os.path.join(work, "g_init_port"), init, step=0)
    jax_ckpt.save(os.path.join(work, "g_init_jax"),
                  jtrainer.init_state(jax.tree.map(jnp.asarray, bridge.to_jax(init.params))),
                  step=0)
    greedy = ["--experiment", gexp, "--iters", str(ITERS), "--ckpt-every", str(ITERS)]
    groups = {
        "jax": start_procs([["-c", JAX_REF, work, json.dumps(g)]], logdir=work, name="jax",
                           env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}),
        "world4": start_world(PORT_WORLD4, 4, logdir=work, name="world4", env=env),
        "grpo": start_world(PORT_GRPO, 2, logdir=work, name="grpo", env=env),
        "launch": start_procs(
            [launch + ["--num-hosts", "2", "--process-id", str(r), "--coordinator",
                       f"127.0.0.1:{port}", "--obs-metrics", os.path.join(work, f"rank{r}.jsonl")]
             for r in range(2)]
            + [launch + ["--obs-metrics", os.path.join(work, "solo.jsonl")]],
            logdir=work, name="launch"),
        "greedy": start_procs(
            [LAUNCH + greedy + ["--resume", os.path.join(work, "g_init_port"),
                                "--num-hosts", "2", "--process-id", str(r), "--coordinator",
                                f"127.0.0.1:{gport}", "--ckpt-dir", os.path.join(work, "g_ranks"),
                                "--obs-metrics", os.path.join(work, f"g_rank{r}.jsonl")]
             for r in range(2)]
            + [LAUNCH + greedy + ["--resume", os.path.join(work, "g_init_port"),
                                  "--ckpt-dir", os.path.join(work, "g_solo"),
                                  "--obs-metrics", os.path.join(work, "g_solo.jsonl")]]
            + [["-m", "repro.launch.train"] + greedy
               + ["--resume", os.path.join(work, "g_init_jax"),
                  "--ckpt-dir", os.path.join(work, "g_jax"),
                  "--obs-metrics", os.path.join(work, "g_jax.jsonl")]],
            logdir=work, name="greedy",
            env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}),
    }
    out = {name: grp.join() for name, grp in groups.items()}
    with open(os.path.join(work, "jax_ref.json")) as f:
        out["ref"] = json.load(f)
    out["work"] = work
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("cls", ["DistributedDatabuffer", "DoubleBufferedDatabuffer",
                                 "CentralizedDatabuffer"])
def test_databuffer_dp_resize_equals_jax(worlds, cls):
    """Put under P('data'), get under four specs, two iterations, on a
    (2, 2) mesh: each rank's values and BufferStats equal the JAX buffer's
    on 4 devices; no byte through a controller but the centralized arm's."""
    want = worlds["ref"]["buffers"][cls]
    for rank in worlds["world4"]:
        got = rank["buffers"][cls]
        assert got["values"] == want["values"]
        stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
                 for k, v in got["stats"].items()}
        want_stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
                      for k, v in want["stats"].items()}
        assert stats == want_stats
        assert (stats["bytes_through_controller"] == 0) == (cls != "CentralizedDatabuffer")
        assert stats["redistributions"] > 0


def test_repack_keeps_the_producers_spec_as_jax(worlds):
    want = worlds["ref"]["repack"]
    for rank in worlds["world4"]:
        got = rank["repack"]
        assert got["metrics"] == want["metrics"] and got["metrics"]["balance/repacked"] == 1.0
        assert got["tokens"] == want["tokens"] and got["mask"] == want["mask"]
        assert got["spec"][0] == "data" == want["spec"][0]


def test_compressed_psum_equals_jax(worlds):
    want = np.asarray(worlds["ref"]["psum"], np.float32)
    for rank in worlds["world4"]:
        got = np.asarray(rank["psum"], np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_seq_sharded_decode_equals_jax_and_one_rank(worlds):
    """(1, 4) ranks, 32 slots: row 0 lives in rank 0's slots, row 1 fills
    rank 0's exactly (ranks 1-3 empty), row 2 the whole cache. o equals
    JAX's and the one-rank decode's, lse the one-rank decode's."""
    want = np.asarray(worlds["ref"]["decode"])
    for rank in worlds["world4"]:
        d = rank["decode"]
        np.testing.assert_allclose(d["o"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(d["o"], d["o1"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(d["lse"], d["lse1"], atol=TOL, rtol=TOL)


def test_elastic_restore_of_a_jax_checkpoint(worlds):
    """JAX's (4, 2) checkpoint (4 chunks of ``w``, 2 of ``b``, 4 of a bf16
    ``h``) onto (2, 2) ranks, bit for bit; the ranks' own save (one file a
    rank) restored whole on one device, bit for bit."""
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.ft import checkpoint

    want_w = np.arange(64.0).reshape(8, 4 * 2)
    want_h = (torch.arange(32.0).reshape(8, 4) / 7).to(torch.bfloat16)
    for rank in worlds["world4"]:
        r = rank["restore"]
        assert r["step"] == 17 and r["step_scale"] == 3.5
        assert r["w"] == want_w.tolist() and r["b"] == list(np.arange(8.0))
        assert r["h"] == want_h.view(torch.int16).tolist()
    for src in ("ckpt", "ckpt_ranks"):
        tmpl = {"w": torch.zeros(8, 8), "b": torch.zeros(8),
                "h": torch.zeros(8, 4, dtype=torch.bfloat16), "step_scale": torch.zeros(())}
        got, step = checkpoint.restore(os.path.join(worlds["work"], src), tmpl,
                                       mesh=DeviceMesh("cpu"))
        assert step == 17
        assert torch.equal(got["w"], torch.from_numpy(want_w).float())
        assert torch.equal(got["h"].view(torch.int16), want_h.view(torch.int16))
    manifest = json.load(open(os.path.join(worlds["work"], "ckpt_ranks", "manifest.json")))
    assert len(manifest["leaves"]["['w']"]["chunks"]) == 4


def test_publish_switches_to_the_serve_layout_as_jax(worlds):
    """``publish(mesh=, target_specs=)`` of FSDP x TP shards on (2, 2)
    ranks: the serve layout's values bit for bit JAX's ``switch``."""
    want, got = _load(worlds, "switch.pkl"), _load(worlds, "port_switch.pkl")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(path))


def _solo_run(worlds, algorithm):
    """The port's one-device run of ``algorithm`` on the worlds' weights:
    (history, final params as JAX leaves, rows loaded)."""
    weights = _load(worlds, "weights.pkl")
    solo = ExperimentSpec(model=reduced(get_config("gemma-2b"), **GRPO["model"]),
                          rl=RLConfig(**dict(GRPO["rl"], algorithm=algorithm)),
                          prompts_per_iter=GRPO["prompts_per_iter"]).compile(device="cpu")
    solo.ctx.actor_state = trainer.init_state(bridge.from_jax(weights, device="cpu",
                                                              dtype=torch.float32))
    solo.ctx.ref_params = bridge.from_jax(weights, device="cpu", dtype=torch.float32)
    hist = solo.run(ITERS)
    return hist, bridge.to_jax(solo.ctx.actor_state.params), solo.ctx.dataloader.rows_loaded


def _assert_runs_close(port, refs, weights):
    """Metrics (rollouts and rewards exactly) and final params of ``port``
    within fp32 TOL of each of ``refs``; the params moved."""
    for ref in refs:
        assert len(port["history"]) == len(ref["history"]) == ITERS
        for m, r in zip(port["history"], ref["history"]):
            for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
                assert m[k] == r[k], k
            for k in [k for k in r if k.startswith(("actor/", "critic/"))]:
                np.testing.assert_allclose(m[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref["params"]),
                                jax.tree.leaves(port["params"])):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))
    assert port["history"][-1]["actor/grad_norm"] > 0
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(port["params"]),
                                                          jax.tree.leaves(weights)))
    assert moved > 1e-4


def test_data_parallel_grpo_equals_jax_and_one_rank(worlds):
    """Two greedy GRPO iterations (entropy bonus, so the weights move) of
    the smoke gemma-2b on 2 ranks through ``ExperimentSpec(mesh_shape=(2,
    1)).compile``: metrics and final params within fp32 2e-5 of JAX's
    pipeline on a (2, 1) mesh and of the port's one-device run on the same
    weights; each rank read only its rows; each rank's ``BufferStats``
    equal JAX's (the stages read JAX's specs), nothing through a
    controller."""
    jax_run, port = _load(worlds, "jax_grpo.pkl"), _load(worlds, "port_grpo.pkl")
    solo_hist, solo_final, solo_rows = _solo_run(worlds, "grpo")
    _assert_runs_close(port, [jax_run, {"history": solo_hist, "params": solo_final}],
                       _load(worlds, "weights.pkl"))
    for r, rank in enumerate(worlds["grpo"]):
        assert rank["mesh"] == {"data": 2, "model": 1} and rank["coords"]["data"] == r
        stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
                 for k, v in rank["stats"].items()}
        assert stats == jax_run["stats"]
        assert stats["bytes_through_controller"] == 0 and stats["redistributions"] > 0
        assert 2 * rank["rows"] == solo_rows > 0  # half the rows each


def test_data_parallel_ppo_whitens_over_the_global_batch(worlds):
    """Two greedy PPO iterations on 2 ranks (critic shards too): each rank
    whitens its rows' advantages by the global batch's moments (summed over
    the ranks), so metrics and final params lie within fp32 2e-5 of the
    port's one-device run, itself held against JAX in
    ``test_torch_pipeline.py``."""
    solo_hist, solo_final, _ = _solo_run(worlds, "ppo")
    _assert_runs_close(_load(worlds, "port_ppo.pkl"),
                       [{"history": solo_hist, "params": solo_final}],
                       _load(worlds, "weights.pkl"))


def _records(worlds, name):
    with open(os.path.join(worlds["work"], name)) as f:
        return [json.loads(line)["metrics"] for line in f if '"iteration"' in line]


def test_launch_train_host_port_world_equals_a_solo_run(worlds):
    """``launch.train --num-hosts 2 --process-id r --coordinator
    127.0.0.1:PORT`` on an fp32 experiment file: both ranks record the solo
    run's metrics within fp32 2e-5 (rollouts and rewards exactly), and
    their buffers move nothing through a controller."""
    ranks = [_records(worlds, f"rank{r}.jsonl") for r in range(2)]
    solo = _records(worlds, "solo.jsonl")
    untimed = [[{k: v for k, v in m.items() if not k.startswith("time/")} for m in h]
               for h in ranks]
    assert len(solo) == ITERS and untimed[0] == untimed[1]
    for m, s in zip(ranks[0], solo):
        assert set(m) == set(s)
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert m[k] == s[k], k
        for k in [k for k in s if k.startswith("actor/")]:
            np.testing.assert_allclose(m[k], s[k], atol=TOL, rtol=TOL, err_msg=k)
    assert solo[-1]["actor/grad_norm"] > 0
    for out in worlds["launch"][:2]:
        assert "bytes_through_controller=0" in out
        assert re.search(r"redistributions=[1-9]", out)


def test_launch_train_host_port_world_equals_jax(worlds):
    """``launch.train --num-hosts 2 --process-id r --coordinator
    127.0.0.1:PORT`` against JAX's ``launch.train`` on a (2, 1) mesh (2
    forced devices), greedy on an fp32 file, both resumed from one initial
    state (saved in each package's layout) and checkpointed at their last
    iteration. Every metric of both ranks lies within fp32 2e-5 of JAX's
    (rollouts and rewards exactly; ``actor/kl`` aside, since each package's
    reference params are its own seed's and the file sets no KL penalty).

    The entry point trains the weights in the dtype the model stores them
    in, bf16, and the greedy batch's only gradient is the entropy bonus's:
    Adam scales each element's step to about ``lr`` whatever its size, so a
    bf16 rounding flips single elements by a whole step (the port's own
    one-device run differs from the ranks by up to 9.8e-4 = lr in an
    element). The final params are therefore held as a whole: the ranks'
    displacement from the initial state lies no farther from JAX's than the
    port's one-device run's does (relative distance 0.0672 for both on this
    CPU), within 0.01. Element by element at 2e-5 on fp32 weights:
    ``test_data_parallel_grpo_equals_jax_and_one_rank``."""
    import jax.numpy as jnp
    from repro.ft import checkpoint as jax_ckpt
    from repro.rl import trainer as jtrainer
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.ft import checkpoint

    work = worlds["work"]
    ranks = [_records(worlds, f"g_rank{r}.jsonl") for r in range(2)]
    want = _records(worlds, "g_jax.jsonl")
    untimed = [[{k: v for k, v in m.items() if not k.startswith("time/")} for m in h]
               for h in ranks]
    assert len(want) == ITERS and untimed[0] == untimed[1]
    for m, w in zip(ranks[0], want):
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert m[k] == w[k], k
        keys = [k for k in w if k.startswith("actor/") and k != "actor/kl"]
        assert keys and set(keys) <= set(m)
        for k in keys:
            np.testing.assert_allclose(m[k], w[k], atol=TOL, rtol=TOL, err_msg=k)
    assert want[-1]["actor/grad_norm"] > 0

    def restored(name, mesh=None):
        with open(os.path.join(work, "greedy.json")) as f:
            tmpl = ExperimentSpec.from_json(f.read()).compile(device="cpu").ctx.actor_state
        state, step = checkpoint.restore(os.path.join(work, name), tmpl, mesh=mesh)
        return state, step

    def flat(params):
        return np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(params)])

    init = bridge.to_jax(restored("g_init_port")[0].params)
    assert restored("g_ranks", DeviceMesh("cpu"))[1] == ITERS
    jax_state, step = jax_ckpt.restore(os.path.join(work, "g_jax"),
                                       jtrainer.init_state(jax.tree.map(jnp.asarray, init)))
    assert step == ITERS
    start, target = flat(init), flat(jax_state.params)
    moved = np.linalg.norm(target - start)

    def distance(name, mesh=None):
        return np.linalg.norm(flat(bridge.to_jax(restored(name, mesh)[0].params)) - target) / moved

    assert np.abs(target - start).max() > 1e-4
    assert distance("g_ranks", DeviceMesh("cpu")) <= distance("g_solo") + 0.01
