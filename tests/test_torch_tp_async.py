"""The staleness-bounded async pipeline (``core/async_worker.py``) on a rank
mesh, against the JAX package's ``AsyncDAGWorker`` on the same mesh and the
port's synchronous worker on the same ranks.

The model is a reduced qwen2.5-7b with 4 query heads on 2 KV heads, 2 layers
and biases, in fp32. Every fp32 leaf that JAX initialises to one value
(norm weights, biases) is drawn at random first, and the EOS column of the
untied head is scaled so that some greedy rollouts end early.

The references come from JAX processes of 2 forced host devices, one a
mesh and one of every case on one device: greedy GRPO through ``ExperimentSpec(mesh_shape=M,
async_pipeline=AsyncPipelineConfig(enabled=True, max_staleness=W))`` for M
in (1, 2) and (2, 1) and W in 0 and 1, a truncated-IS variant of GRPO at
W = 1 on (2, 1), PPO at W = 0 on (2, 1) and the continuous engine's
3-turn ``dialog`` episodes at W = 1 on (1, 2) (fp32 cache arenas,
``tests/torch_arena.py``). Port worlds of 2 gloo ranks on the CPU, one a
mesh (``torch_world``), run the same, the synchronous worker beside each
W = 0 case, and the four faults that lifting the rank-mesh refusal alone
would have left (each pinned by a test below), and a ``--resume`` through
``launch.train``. One module fixture starts every process at once.

Tolerances: fp32 2e-5 (the actor's and critic's metrics, the recomputed
logprobs; the final params at 2e-5 or at ``SPREAD_FACTOR`` x JAX's own
one-device-to-mesh spread of the leaf, as in ``test_torch_tp_engine.py``);
greedy tokens, rewards, the scheduler's counts
(staleness, versions, inflight depth, correction flag), the episode and
turn counts and ``BufferStats`` equal; W = 0 bit for bit the synchronous
worker on the same ranks.
"""
from __future__ import annotations

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import AsyncPipelineConfig, get_config, reduced
from torch_world import start_procs, start_world

torch.set_num_threads(1)

TOL = 2e-5
ARCH = "qwen2.5-7b"
MODEL_KW = dict(vocab_size=260, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, use_bias=True)
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
RL = dict(temperature=0.0, group_size=4, max_new_tokens=6, lr=1e-3, critic_lr=1e-3,
          entropy_coef=0.01)
PROMPTS = 4
SLOTS = 4
EOS_ID, EOS_SCALE = 2, 3.0
TIS = "grpo_tis_mesh"  # GRPO with the truncated-IS correction, registered in every process
DIALOG = dict(name="dialog", max_turns=3, turn_budget=3, obs_budget=8)
# case -> (mesh, algorithm, staleness window, iterations, env)
CASES = {
    **{f"{m}_w{w}": (m, "grpo", w, 2 + w, None) for m in MESHES for w in (0, 1)},
    "2x1_tis": ("2x1", TIS, 1, 3, None),
    "2x1_ppo": ("2x1", "ppo", 0, 2, None),
    "1x2_dialog": ("1x2", "grpo", 1, 3, DIALOG),
}
# each case's one-device run, the same for both meshes (JAX's in two
# processes)
SOLO_OF = {c: f"solo_{algo}_w{w}_{iters}" + ("_env" if env else "")
           for c, (_, algo, w, iters, env) in CASES.items()}
SOLO = {SOLO_OF[c]: (f"solo{int(v[1] == 'ppo' or v[4] is not None)}",) + tuple(v[1:])
        for c, v in CASES.items()}
# the final params after the AdamW steps: each leaf within TOL, or within
# SPREAD_FACTOR x the distance the leaf already shows between JAX's
# one-device run and JAX's run on the same mesh, or between the two
# packages' one-device runs, if larger. Adam normalises each element's
# update by its gradient's magnitude, so an element whose gradient nearly
# cancels (the self-attention key bias in RoPE's slowest dimensions, a gate
# column whose inputs cancel) moves with the gradient's rounding: JAX's own
# mesh and one device round alike, and part from the port's one device by up
# to 9e-5 after two PPO steps (tests/test_torch_tp_engine.py holds its
# engine runs to JAX's spread alone)
SPREAD_FACTOR = 2.0
# the scheduler's counts: equal to JAX's and on every rank
ASYNC_COUNTS = ("async/staleness", "async/weight_version", "async/is_corrected",
                "async/inflight", "async/gen_stalled", "pipeline/staleness")
CLOCK_KEYS = {"rollout/wall_s", "rollout/tokens_per_s"}


def _cfg():
    return reduced(get_config(ARCH), **MODEL_KW)


# --------------------------------------------------------------------------- #
# the JAX references, one process a mesh and one of every case on one
# device; 1x2 writes the weights, 2x1 the critic's
# --------------------------------------------------------------------------- #
JAX_REF = r'''
import os, sys, json, pickle, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.api import ExperimentSpec
from repro.configs import AsyncPipelineConfig, EnvConfig, RolloutEngineConfig, get_config, reduced
from repro.rl import algorithms as jalgorithms
from repro.rl import trainer as jtrainer
from repro.utils.jax_compat import use_mesh
from torch_arena import Recorded, jax_fp32_arena
from torch_world import wait_for
W, KEY = sys.argv[1], sys.argv[2]
G = json.loads(sys.argv[3])
jalgorithms.register_algorithm(dataclasses.replace(
    jalgorithms.get_algorithm('grpo'), name=G['tis'], is_correction='truncated'))
cfg = reduced(get_config(G['arch']), **G['model'])
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
np32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
cases = {c: v for c, v in {**G['cases'], **G['solo']}.items() if v[0] == KEY}


def compile(case):
    _, algo, window, _, env = cases[case]
    kw = {} if env is None else dict(
        rollout=RolloutEngineConfig(engine='continuous', num_slots=G['slots']),
        env=EnvConfig(**env))
    return ExperimentSpec(
        model=cfg, rl=jtrainer.RLConfig(**dict(G['rl'], algorithm=algo)),
        prompts_per_iter=G['prompts'],
        mesh_shape=tuple(G['meshes'][KEY]) if KEY in G['meshes'] else None,
        async_pipeline=AsyncPipelineConfig(enabled=True, max_staleness=window), **kw).compile()


pipes = {c: compile(c) for c in cases}
if KEY == '1x2':
    params = np32(next(iter(pipes.values())).ctx.actor_state.params)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
        if jax.tree_util.keystr(p).endswith(("['w']", "['b_q']", "['b_k']", "['b_v']",
                                              "['b_o']")) else a, params)
    params['lm_head'][:, G['eos_id']] *= G['eos_scale']
    with open(os.path.join(W, 'weights.pkl'), 'wb') as f:
        pickle.dump(params, f)
    open(os.path.join(W, 'weights.done'), 'w').close()
else:
    if KEY == '2x1':
        critic = np32(pipes['2x1_ppo'].ctx.critic_state.params)
        with open(os.path.join(W, 'critic.pkl'), 'wb') as f:
            pickle.dump(critic, f)
        open(os.path.join(W, 'critic.done'), 'w').close()
    elif KEY == 'solo1':
        wait_for(os.path.join(W, 'critic.done'))
        with open(os.path.join(W, 'critic.pkl'), 'rb') as f:
            critic = pickle.load(f)
    wait_for(os.path.join(W, 'weights.done'))
    with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
        params = pickle.load(f)
out = {}
for c, pipe in pipes.items():
    pipe.ctx.actor_state = jtrainer.init_state(fp32(params))
    pipe.ctx.ref_params = fp32(params)
    if pipe.ctx.critic_state is not None:
        pipe.ctx.critic_state = jtrainer.init_state(fp32(critic))
    eng = pipe.ctx.engines['generate'] = Recorded(pipe.ctx.engines['generate'], np.asarray)
    if cases[c][4] is not None:
        eng.engine.model = jax_fp32_arena(eng.engine.model)
    with use_mesh(pipe.ctx.mesh):
        hist = pipe.run(cases[c][3])
    out[c] = {'history': [{k: float(v) for k, v in h.items()} for h in hist],
              'tokens': eng.seen, 'params': np32(pipe.ctx.actor_state.params),
              'critic': None if pipe.ctx.critic_state is None else np32(
                  pipe.ctx.critic_state.params),
              'stats': dataclasses.asdict(pipe.buffer.stats)}
with open(os.path.join(W, f'jax_{KEY}.pkl'), 'wb') as f:
    pickle.dump(out, f)
'''

# --------------------------------------------------------------------------- #
# the port's worlds, one a mesh
# --------------------------------------------------------------------------- #
PORT_WORLD = r'''
import dataclasses, gc, os, json, pickle, weakref
import numpy as np
from torch_arena import Recorded, fp32_arena
from torch_world import wait_for
from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import (AsyncPipelineConfig, EnvConfig, RolloutEngineConfig, get_config,
                                 reduced)
from repro_torch.core.async_worker import AsyncDAGWorker
from repro_torch.core.worker import WorkerContext
from repro_torch.distributed import collectives as C, constraint, sharding as shr, weight_sync
from repro_torch.launch import train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model
from repro_torch.rl import RLConfig, algorithms, trainer
W = os.environ['WORK']
G = json.loads(os.environ['TPA'])
KEY = os.environ['MESH']
SHAPE = tuple(G['meshes'][KEY])
mesh = make_local_mesh(SHAPE, ('data', 'model'), device='cpu')
algorithms.register_algorithm(dataclasses.replace(
    algorithms.get_algorithm('grpo'), name=G['tis'], is_correction='truncated'))
cfg = reduced(get_config(G['arch']), **G['model'])
model = get_model(cfg, device='cpu')
wait_for(os.path.join(W, 'weights.done'))
with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
    full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
critic = None
if KEY == '2x1':
    wait_for(os.path.join(W, 'critic.done'))
    with open(os.path.join(W, 'critic.pkl'), 'rb') as f:
        critic = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
cases = {c: v for c, v in G['cases'].items() if v[0] == KEY}
res = {'coords': mesh.coords, 'counts': {}}
out = {}


def leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def compile(algo, window, env=None):
    """A pipeline on this world's mesh with the bridged weights; window None
    is the synchronous worker."""
    kw = {} if env is None else dict(
        rollout=RolloutEngineConfig(engine='continuous', num_slots=G['slots']),
        env=EnvConfig(**env))
    if window is not None:
        kw['async_pipeline'] = AsyncPipelineConfig(enabled=True, max_staleness=window)
    pipe = ExperimentSpec(model=cfg, rl=RLConfig(**dict(G['rl'], algorithm=algo)),
                          prompts_per_iter=G['prompts'], mesh_shape=SHAPE,
                          **kw).compile(device='cpu')
    pipe.ctx.actor_state = trainer.shard_state(mesh, full, pipe.ctx.param_specs)
    pipe.ctx.ref_params = shr.map_with_specs(
        lambda p, s: C.shard(mesh, p, s, axes=('model',)).clone(), full, pipe.ctx.param_specs)
    if pipe.ctx.critic_state is not None:
        pipe.ctx.critic_state = trainer.shard_state(mesh, critic, pipe.ctx.critic_specs)
    rec = pipe.ctx.engines['generate'] = Recorded(pipe.ctx.engines['generate'],
                                                  lambda t: t.numpy().copy())
    if env is not None:
        rec.engine.model = fp32_arena(rec.engine.model)
    return pipe, rec


def summary(pipe, rec, hist):
    ctx = pipe.ctx
    return {'history': hist, 'tokens': rec.seen,
            'params': bridge.to_jax(trainer.gather_params(mesh, ctx.actor_state.params,
                                                          ctx.param_specs)),
            'critic': None if ctx.critic_state is None else bridge.to_jax(
                trainer.gather_params(mesh, ctx.critic_state.params, ctx.critic_specs)),
            'stats': dataclasses.asdict(pipe.buffer.stats)}


def clean(hist):
    return [{k: v for k, v in m.items() if not k.startswith(('time/', 'async/'))
             and k != 'pipeline/staleness'} for m in hist]


# 1. every case of this mesh, and the synchronous worker beside each W = 0
for c, (_, algo, window, iters, env) in cases.items():
    pipe, rec = compile(algo, window, env)
    assert isinstance(pipe.worker, AsyncDAGWorker) and pipe.worker.max_staleness == window
    hist = pipe.run(iters)
    out[c] = summary(pipe, rec, hist)
    res['counts'][c] = [{k: m.get(k) for k in G['counts']} for m in hist]
    if window == 0:
        sync, srec = compile(algo, None)
        shist = sync.run(iters)
        res[c + '_bitwise_sync'] = {
            'history': clean(hist) == clean(shist),
            'tokens': all(np.array_equal(a, b) for a, b in zip(rec.seen, srec.seen)),
            'params': leaves_equal(pipe.ctx.actor_state.params, sync.ctx.actor_state.params),
            'critic': pipe.ctx.critic_state is None or leaves_equal(
                pipe.ctx.critic_state.params, sync.ctx.critic_state.params),
            'moved': not leaves_equal(sync.ctx.actor_state.params, trainer.shard_state(
                mesh, full, sync.ctx.param_specs).params)}
        del sync, srec
    del pipe, rec
    gc.collect()


def recorded_steps(pipe):
    """Wrap the actor step to keep each batch it trains on."""
    batches, step = [], pipe.ctx.engines['actor_step']

    def run(state, batch):
        batches.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)
    pipe.ctx.engines['actor_step'] = run
    return batches


if KEY == '1x2':
    # 2. the halves driven alone, outside any ambient mesh: each enters it
    pipe, rec = compile('grpo', 1)
    w = pipe.worker
    assert constraint.tp() is None
    for _ in range(G['cases']['1x2_w1'][3]):
        w.dispatch_generation({})
        if w.train_ready():
            w.consume_and_train({})
    out['decoupled'] = summary(pipe, rec, [])
    del pipe, rec, w
    gc.collect()

    # 3. the cache of the switched copies at W = 1: generation reads the
    # published version, the step the live params, and no switched copy
    # outlives its half
    pipe, rec = compile('grpo', 1)
    w, ctx = pipe.worker, pipe.ctx
    w.dispatch_generation({})
    behind = w.dispatch_generation({})
    w.consume_and_train({})  # trains the first batch, publishes version 1
    # a step the scheduler has not published: the trainer running ahead
    ahead = {k: w._rows(behind.data, behind.specs, k, w._model_spec())
             for k in ('tokens', 'response_mask', 'old_logprob', 'ref_logprob', 'advantages')}
    with constraint.use_mesh(mesh):
        ctx.actor_state, _ = ctx.engines['actor_step'](ctx.actor_state, ahead)
    del ahead
    ctx.drop_switched()
    seen, loss_fn, generate = {}, trainer.actor_loss_fn, ctx.engines['generate']

    def spy_generate(params, prompts, g):
        seen['gen'] = tree.map(torch.clone, params)
        seen['gen_refs'] = [weakref.ref(t) for t in tree.leaves(params)]
        return generate(params, prompts, g)

    def spy_loss(m, rl, p, b, **kw):
        seen.setdefault('step', tree.map(lambda t: t.detach().clone(), p))
        return loss_fn(m, rl, p, b, **kw)
    ctx.engines['generate'] = spy_generate
    trainer.actor_loss_fn = spy_loss
    version_refs = [weakref.ref(t) for t in tree.leaves(w.weights.current.params)]
    w.dispatch_generation({})
    gc.collect()
    cache = {'gen_copy_freed': all(r() is None for r in seen['gen_refs'])}
    pub = weight_sync.switch(mesh, w.weights.current.params, ctx.serve_specs,
                             specs=ctx.param_specs)
    live = weight_sync.switch(mesh, ctx.actor_state.params, ctx.serve_specs,
                              specs=ctx.param_specs)
    cache['gen_reads_published'] = leaves_equal(seen['gen'], pub)
    cache['gen_not_live'] = not leaves_equal(seen['gen'], live)
    live_model = tree.map(torch.clone, trainer.gather_params(
        mesh, ctx.actor_state.params, ctx.param_specs, axes=trainer.data_axes(mesh)))
    pub_model = tree.map(torch.clone, trainer.gather_params(
        mesh, w.weights.current.params, ctx.param_specs, axes=trainer.data_axes(mesh)))
    del pub, live
    m = {}
    w.consume_and_train(m)
    trainer.actor_loss_fn = loss_fn
    gc.collect()
    cache['old_version_freed'] = all(r() is None for r in version_refs)
    cache['step_reads_live'] = leaves_equal(seen['step'], live_model)
    cache['step_not_published'] = not leaves_equal(seen['step'], pub_model)
    cache['staleness'] = m['async/staleness']
    res['cache'] = cache
    del pipe, rec, w, ctx, seen, live_model, pub_model
    gc.collect()

    # 4. --resume through launch.train under --max-staleness 1: the first
    # dispatch publishes and generates the restored shards
    exp = ExperimentSpec(model=cfg, rl=RLConfig(**G['rl']), prompts_per_iter=G['prompts'],
                         mesh_shape=SHAPE)
    path, ckpt = os.path.join(W, f'resume{RANK}.json'), os.path.join(W, 'ckpt')
    with open(path, 'w') as f:
        f.write(exp.to_json())
    argv = ['--experiment', path, '--device', 'cpu', '--num-hosts', str(WORLD),
            '--process-id', str(RANK), '--coordinator', '127.0.0.1:1']
    a = train.main(argv + ['--iters', '2', '--ckpt-dir', ckpt, '--ckpt-every', '2'])
    saved = tree.map(torch.clone, a['pipeline'].ctx.actor_state.params)
    specs = a['pipeline'].ctx.param_specs
    serve_specs = a['pipeline'].ctx.serve_specs
    del a
    first, serve_params = {}, WorkerContext.serve_params

    def spy_serve(self, state=None):
        out_p = serve_params(self, state)
        first.setdefault('state', tree.map(torch.clone, (state or self.actor_state).params))
        first.setdefault('serve', tree.map(torch.clone, out_p))
        return out_p
    WorkerContext.serve_params = spy_serve
    b = train.main(argv + ['--iters', '4', '--resume', ckpt, '--max-staleness', '1'])
    WorkerContext.serve_params = serve_params
    res['resume'] = {
        'async': isinstance(b['pipeline'].worker, AsyncDAGWorker),
        'first_state_restored': leaves_equal(first['state'], saved),
        'first_serve_restored': leaves_equal(first['serve'], weight_sync.switch(
            mesh, saved, serve_specs, specs=specs)),
        'staleness': [m.get('async/staleness') for m in b['history']],
        'version': b['pipeline'].worker.weights.version}
    del b
else:
    # 5. a key's spec through a dispatch and a consume on a mesh whose data
    # axis splits the rows
    pipe, rec = compile('grpo', 1)
    w, buf = pipe.worker, pipe.buffer
    put_log, put = [], buf.put

    def logged_put(k, v, spec=None):
        put(k, v, spec)
        put_log.append((k, buf.spec_of(k)))
    buf.put = logged_put
    batches = recorded_steps(pipe)
    first = w.dispatch_generation({})
    produced = dict(put_log)
    w.dispatch_generation({})
    del put_log[:]
    w.consume_and_train({})
    reput = {k: s for k, s in put_log if k in first.data}
    res['specs'] = {
        'pending': {k: list(map(str, s)) for k, s in first.specs.items()},
        'pending_equal_produced': first.specs == produced and set(first.data) == set(produced),
        'all_split': all(s is not None and s[0] is not None for s in first.specs.values()),
        'reput_equal': reput == first.specs,
        'step_rows': int(batches[0]['tokens'].shape[0]),
        'generated_rows': int(first.data['tokens'].shape[0]),
        'step_tokens_are_the_batch': torch.equal(batches[0]['tokens'], first.data['tokens'])}
    del pipe, rec, w, buf, first, batches
    gc.collect()

    # 6. the truncated-IS recompute at staleness 1: the live params
    # gathered, on this rank's rows
    pipe, rec = compile(G['tis'], 1)
    w = pipe.worker
    w.dispatch_generation({})
    w.dispatch_generation({})
    w.consume_and_train({})
    batches = recorded_steps(pipe)
    pending = w._inflight[0]
    live = trainer.gather_params(mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs)
    with torch.no_grad():
        want = model.logprobs(live, pending.data['tokens'])[0] * pending.data['response_mask']
    m = {}
    w.consume_and_train(m)
    got = batches[0]
    res['recompute'] = {
        'is_corrected': m['async/is_corrected'], 'staleness': m['async/staleness'],
        'rows': int(got['old_logprob'].shape[0]),
        'max_abs_err': float((got['old_logprob'] - want).abs().max()),
        'behaviour_kept': torch.equal(got['behavior_logprob'], pending.data['old_logprob']),
        'moved': float((got['old_logprob'] - pending.data['old_logprob']).abs().max())}
    del pipe, rec, w, batches, pending, live
with open(os.path.join(W, f'{KEY}_port{RANK}.pkl'), 'wb') as f:
    pickle.dump(out, f)
RESULT = res
'''


def _port_solo(work):
    """The port's one-device run of every case of SOLO, on the bridged
    weights (and critic), the TIS variant registered for the while."""
    import dataclasses

    from torch_arena import Recorded, fp32_arena
    from torch_world import wait_for

    from repro_torch import bridge, tree
    from repro_torch.api import ExperimentSpec
    from repro_torch.configs import EnvConfig, RolloutEngineConfig
    from repro_torch.rl import RLConfig, algorithms, trainer

    def load(name):
        wait_for(os.path.join(work, name + ".done"))
        with open(os.path.join(work, name + ".pkl"), "rb") as f:
            return bridge.from_jax(pickle.load(f), device="cpu", dtype=torch.float32)

    full, critic = load("weights"), load("critic")
    algorithms.register_algorithm(dataclasses.replace(
        algorithms.get_algorithm("grpo"), name=TIS, is_correction="truncated"))
    out = {}
    try:
        for name, (_, algo, window, iters, env) in SOLO.items():
            kw = {} if env is None else dict(
                rollout=RolloutEngineConfig(engine="continuous", num_slots=SLOTS),
                env=EnvConfig(**env))
            pipe = ExperimentSpec(
                model=_cfg(), rl=RLConfig(**dict(RL, algorithm=algo)), prompts_per_iter=PROMPTS,
                async_pipeline=AsyncPipelineConfig(enabled=True, max_staleness=window),
                **kw).compile(device="cpu")
            pipe.ctx.actor_state = trainer.init_state(tree.map(torch.clone, full))
            pipe.ctx.ref_params = tree.map(torch.clone, full)
            if pipe.ctx.critic_state is not None:
                pipe.ctx.critic_state = trainer.init_state(tree.map(torch.clone, critic))
            if env is not None:
                eng = pipe.ctx.engines["generate"] = Recorded(pipe.ctx.engines["generate"],
                                                              lambda t: t)
                eng.engine.model = fp32_arena(eng.engine.model)
            pipe.run(iters)
            out[name] = {"params": bridge.to_jax(pipe.ctx.actor_state.params),
                         "critic": None if pipe.ctx.critic_state is None else bridge.to_jax(
                             pipe.ctx.critic_state.params)}
    finally:
        algorithms._ALGORITHMS.pop(TIS)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: a JAX process a mesh (2
    forced devices), two of the one-device runs, and a port world a mesh;
    the port's one-device runs in this process meanwhile."""
    work = str(tmp_path_factory.mktemp("tp_async"))
    g = dict(arch=ARCH, model=MODEL_KW, meshes=MESHES, rl=RL, prompts=PROMPTS, slots=SLOTS,
             eos_id=EOS_ID, eos_scale=EOS_SCALE, tis=TIS, cases=CASES, solo=SOLO,
             counts=ASYNC_COUNTS)
    args = json.dumps(g)
    jax_env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2",
               "PYTHONPATH": os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                              os.path.dirname(__file__)])}
    groups = {f"jax_{key}": start_procs([["-c", JAX_REF, work, key, args]], logdir=work,
                                        name=f"jax_{key}", env=jax_env)
              for key in (*MESHES, "solo0", "solo1")}
    for key, shape in MESHES.items():
        groups[key] = start_world(PORT_WORLD, shape[0] * shape[1], logdir=work, name=key,
                                  env={"WORK": work, "TPA": args, "MESH": key})
    solo = _port_solo(work)
    out = {name: grp.join() for name, grp in groups.items()}
    out["work"], out["solo"] = work, solo
    with open(os.path.join(work, "weights.pkl"), "rb") as f:
        out["weights"] = pickle.load(f)
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


def _port(worlds, mesh):
    """Each rank's runs: {case: {...}} a rank."""
    return [_load(worlds, f"{mesh}_port{r}.pkl") for r in range(2)]


def _global_tokens(ranks, case, mesh):
    """The tokens of every iteration over the global batch: the ranks of the
    data axis hold consecutive rows, the ranks of ``model`` the same ones."""
    per = [r[case]["tokens"] for r in ranks]
    if MESHES[mesh][0] == 1:
        for p in per[1:]:
            for a, b in zip(p, per[0]):
                np.testing.assert_array_equal(a, b)
        return per[0]
    return [np.concatenate(parts, 0) for parts in zip(*per)]


def _assert_case_matches_jax(worlds, case):
    mesh = CASES[case][0]
    want = _load(worlds, f"jax_{mesh}.pkl")[case]
    ranks = _port(worlds, mesh)
    got = ranks[0][case]
    toks = _global_tokens(ranks, case, mesh)
    assert len(toks) == len(want["tokens"]) == len(got["history"]) == len(want["history"])
    for it, (t, j) in enumerate(zip(toks, want["tokens"])):
        np.testing.assert_array_equal(t, j, err_msg=f"iteration {it}")
    for it, (m, j) in enumerate(zip(got["history"], want["history"])):
        assert set(m) == set(j), it
        for k in m:
            if k in ASYNC_COUNTS or (k.startswith(("rollout/", "reward/", "env/"))
                                     and k not in CLOCK_KEYS):
                assert m[k] == j[k], (it, k)
            elif k.startswith(("actor/", "critic/")):
                np.testing.assert_allclose(m[k], j[k], atol=TOL, rtol=TOL, err_msg=f"{it} {k}")
    solo = _load(worlds, f"jax_{SOLO[SOLO_OF[case]][0]}.pkl")[SOLO_OF[case]]
    port_solo = worlds["solo"][SOLO_OF[case]]
    for key in ("params", "critic"):
        if want[key] is None:
            continue
        for (path, w), g, s, p in zip(jax.tree_util.tree_leaves_with_path(want[key]),
                                      jax.tree.leaves(got[key]), jax.tree.leaves(solo[key]),
                                      jax.tree.leaves(port_solo[key])):
            spread = max(float(np.abs(w - s).max()), float(np.abs(p - s).max()))
            tol = max(TOL, SPREAD_FACTOR * spread)
            np.testing.assert_allclose(g, w, atol=tol, rtol=TOL,
                                       err_msg=f"{key} {jax.tree_util.keystr(path)}")
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(got["params"]),
                                                          jax.tree.leaves(worlds["weights"])))
    assert moved > 1e-4
    if CASES[case][1] != TIS:
        # JAX's recomputed old_logprob leaves GSPMD under another sharding
        # than the model stages', and its train stage counts a
        # redistribution of it; the port's is put under the model spec
        for r in ranks:
            stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
                     for k, v in r[case]["stats"].items()}
            assert stats == want["stats"], case
    return got, want


# --------------------------------------------------------------------------- #
# against the JAX package's AsyncDAGWorker on the same mesh
# --------------------------------------------------------------------------- #
GRPO_CASES = [f"{m}_w{w}" for m in MESHES for w in (0, 1)]


@pytest.mark.parametrize("case", GRPO_CASES)
def test_async_grpo_equals_jax_on_the_same_mesh(worlds, case):
    """Greedy GRPO at W = 0 (2 ticks) and W = 1 (3 ticks: one generation-only
    warm-up, then staleness 0 and 1): every iteration's tokens over the
    global batch bit for bit JAX's, rewards and the scheduler's counts
    equal, the actor's metrics within 2e-5 and the final params within
    2e-5 or ``SPREAD_FACTOR`` x JAX's own spread, every rank's ``BufferStats`` equal JAX's (each popped key put back under its
    spec: the train stage's gets take the fast path, as on JAX's arrays)."""
    got, _ = _assert_case_matches_jax(worlds, case)
    window = CASES[case][2]
    assert [m.get("async/staleness") for m in got["history"]][window:] == \
        [float(min(i, window)) for i in range(len(got["history"]) - window)]
    assert got["history"][-1]["actor/kl"] > 0


def test_truncated_is_equals_jax_on_a_data_split_mesh(worlds):
    """The truncated-IS variant at W = 1 on (2, 1): the batch consumed at
    staleness 1 recomputes ``old_logprob`` under the live params on each
    rank's rows, and the actor's metrics (``rho_mean`` among them) and
    params stay as close to JAX's as GRPO's; the correction flag is exact."""
    got, _ = _assert_case_matches_jax(worlds, "2x1_tis")
    assert [m.get("async/is_corrected") for m in got["history"]] == [None, 0.0, 1.0]
    assert all(0.0 < m["actor/rho_mean"] <= 2.0 for m in got["history"][2:])


def test_ppo_at_staleness0_equals_jax_on_a_data_split_mesh(worlds):
    """PPO at W = 0 on (2, 1): the critic's values and steps on each rank's
    rows; the actor's and critic's metrics and final params within 2e-5 of
    JAX's."""
    got, _ = _assert_case_matches_jax(worlds, "2x1_ppo")
    assert any(k.startswith("critic/") for k in got["history"][0])


def test_multi_turn_dialog_at_staleness1_equals_jax(worlds):
    """3-turn ``dialog`` episodes on the continuous engine at W = 1 on
    (1, 2): tokens, rewards, ``env/turns_mean`` and every count of the
    slot schedule and the episodes equal JAX's, the actor's metrics within
    2e-5."""
    got, _ = _assert_case_matches_jax(worlds, "1x2_dialog")
    for m in got["history"]:
        assert m["rollout/turns"] > 16 and m["rollout/cont_refills"] >= 1
    assert got["history"][2]["async/staleness"] == 1.0


@pytest.mark.parametrize("case", ["1x2_w0", "2x1_w0", "2x1_ppo"])
def test_staleness0_is_bitwise_the_sync_worker_on_the_same_ranks(worlds, case):
    """W = 0 and the synchronous worker, each from the same shards on the
    same world: metrics, rollouts and every rank's final shards (and the
    critic's) bit for bit, and the weights moved."""
    for r in worlds[CASES[case][0]]:
        assert r[case + "_bitwise_sync"] == {"history": True, "tokens": True, "params": True,
                                             "critic": True, "moved": True}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_count_metrics_are_equal_on_every_rank(worlds, mesh):
    """The gate counts, so every rank takes the same dispatch and consume
    decision in every tick: the scheduler's counts of every case equal on
    both ranks."""
    ranks = worlds[mesh]
    assert ranks[0]["counts"] == ranks[1]["counts"]
    assert set(ranks[0]["counts"]) == {c for c, v in CASES.items() if v[0] == mesh}


# --------------------------------------------------------------------------- #
# the faults of an async worker that ran the one-device code on the ranks
# --------------------------------------------------------------------------- #
def test_decoupled_halves_enter_the_mesh(worlds):
    """``dispatch_generation`` and ``consume_and_train`` driven alone on
    (1, 2), outside any ambient mesh, in ``run_iteration``'s order: the
    rollouts and final params bit for bit the ``run_iteration`` run's. A
    half that did not enter the mesh ran the model code without its
    collectives (each rank on its own shards, nothing summed over
    ``model``)."""
    for r in _port(worlds, "1x2"):
        a, b = r["decoupled"], r["1x2_w1"]
        assert len(a["tokens"]) == len(b["tokens"])
        for x, y in zip(a["tokens"], b["tokens"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
            np.testing.assert_array_equal(x, y)


def test_popped_keys_keep_their_specs_through_dispatch_and_consume(worlds):
    """On (2, 1), whose data axis splits the rows: the queued batch keeps
    the spec each stage put its key under, the consume puts every key back
    under it, and the step trains on this rank's 8 generated rows. Put back
    without a spec, a key reads as held whole, and the step's get cut this
    rank's half of its half (4 rows)."""
    for r in worlds["2x1"]:
        s = r["specs"]
        assert s["pending_equal_produced"] and s["all_split"] and s["reput_equal"], s
        assert s["step_rows"] == s["generated_rows"] == PROMPTS * RL["group_size"] // 2
        assert s["step_tokens_are_the_batch"]


def test_is_recompute_reads_model_params_on_the_rank_rows(worlds):
    """The truncated-IS recompute on (2, 1) at staleness 1: ``old_logprob``
    on each rank's 8 rows equals the one-device model on the live params
    gathered (``WorkerContext.model_params``) within 2e-5, and the behaviour
    logprobs ride along unchanged. The rank's FSDP shards of the train
    layout are not a model's params."""
    for r in worlds["2x1"]:
        rc = r["recompute"]
        assert rc["is_corrected"] == 1.0 and rc["staleness"] == 1.0
        assert rc["rows"] == PROMPTS * RL["group_size"] // 2
        assert rc["max_abs_err"] <= TOL and rc["behaviour_kept"] and rc["moved"] > 0


def test_generation_reads_the_published_copy_and_the_step_the_live_params(worlds):
    """At W = 1 on (1, 2), with a step the scheduler has not published
    (the trainer running ahead): the next dispatch generates on the
    published version switched to the serve layout, not on the live
    params; the consume's step reads the live params, not the published
    ones; the dispatch's switched copy is freed when its half ends, and the
    previous version when the next is published (one switched copy, one
    version a rank)."""
    for r in worlds["1x2"]:
        assert r["cache"] == {"gen_copy_freed": True, "gen_reads_published": True,
                              "gen_not_live": True, "old_version_freed": True,
                              "step_reads_live": True, "step_not_published": True,
                              "staleness": 1.0}


def test_resume_under_async_generates_with_the_restored_shards(worlds):
    """``launch.train --coordinator HOST:PORT --num-hosts 2 --resume D
    --max-staleness 1`` on an experiment with ``mesh_shape`` (1, 2): the
    first dispatch generates on the restored shards (the state it switches
    and its serve params bit for bit those saved), and the resumed
    iterations run the scheduler from version 0."""
    for r in worlds["1x2"]:
        assert r["resume"] == {"async": True, "first_state_restored": True,
                               "first_serve_restored": True, "staleness": [None, 0.0],
                               "version": 1}


def test_one_device_pending_batches_keep_their_specs():
    """On one device, too, a queued batch carries each key's spec and is put
    back under it: the train stage's gets are fast-path hits, as JAX's."""
    from repro_torch.core import build_pipeline
    from repro_torch.rl import RLConfig

    pipe = build_pipeline(_cfg(), RLConfig(group_size=2, max_new_tokens=4), device="cpu",
                          prompts_per_iter=2,
                          async_pipeline=AsyncPipelineConfig(enabled=True, max_staleness=1))
    w = pipe.worker
    first = w.dispatch_generation({})
    assert set(first.specs) == set(first.data) and all(s is not None for s in first.specs.values())
    w.dispatch_generation({})
    before = pipe.buffer.stats.redistributions
    w.consume_and_train({})
    # the step's keys put under another spec than its own (the advantages,
    # a compute stage's) redistribute, as in the synchronous worker; every
    # other get is a fast-path hit
    moved = [k for k in ("tokens", "response_mask", "old_logprob", "ref_logprob", "advantages")
             if first.specs[k] != first.specs["tokens"]]
    assert moved == ["advantages"]
    assert pipe.buffer.stats.redistributions == before + len(moved)
