"""The continuous rollout engine on tensor-parallel ranks (``model`` > 1),
and the attention gradient where 1 < ``num_kv_heads`` < ``model``, against
the JAX package and the port's one device.

The model is a reduced qwen2.5-7b with 4 query heads on 2 KV heads, 2
layers and biases, in fp32. Every fp32 leaf that JAX initialises to one
value (norm weights, biases) is drawn at random first, and the EOS column of
the untied head is scaled so that some greedy rollouts end early. At
``model`` = 2 each rank holds one whole KV head; at ``model`` = 4 the K/V
projections are replicated, and the ranks of the two GQA groups cut
different heads of the K/V that every rank computed.

The references come from two JAX processes of 4 forced host devices: the
weights, the GRPO actor loss's ``jax.grad`` under ``use_mesh`` on a (1, 4)
mesh, and two greedy GRPO iterations through ``ExperimentSpec(mesh_shape=
(1, M), rollout=RolloutEngineConfig(engine="continuous", num_slots=4,
prefill_chunk=C))`` for M in (2, 4) and C in (0, 4), and on one device (the math prompts have 6
tokens: chunks of 4 run two chunks, the second across a slot shard's edge).
Port worlds of (1, 2) and (1, 4) gloo ranks on the CPU (``torch_world``) run
the same, and besides: the engine under a fixed schedule against lockstep
``generate`` on the same ranks, a chunked refill under ``kv_quant`` (1, 2),
multi-turn episodes (``dialog`` on (1, 2), ``calculator`` on (1, 4)) and a
reduced seamless-m4t (4 heads on 2 KV heads) whose self- and
cross-attention take the same cut at ``model`` = 4. The port's one-device
runs happen in this process meanwhile. One module fixture starts every
process at once. Both engines run on fp32 cache arenas
(``tests/torch_arena.py``).

Tolerances: fp32 2e-5 (metrics, params, logprobs, each leaf's gradient at
2e-5 of its largest magnitude; seamless's leaves by ``assert_grads_match``;
the params after the AdamW steps at 2e-5 or at ``SPREAD_FACTOR`` x JAX's
own one-device-to-mesh spread, below);
greedy and fixed-schedule tokens, masks, lengths and every count of the
slot schedule and of the episodes equal.
"""
from __future__ import annotations

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge, tree
from repro_torch.configs import get_config, reduced
from torch_grads import assert_grads_match
from torch_world import start_procs, start_world, wait_for

torch.set_num_threads(1)

TOL = 2e-5
ITERS = 2
ARCH = "qwen2.5-7b"
MODEL_KW = dict(vocab_size=260, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, use_bias=True)
SEAMLESS_KW = dict(vocab_size=260, num_layers=2)  # 4 heads on 2 KV heads
MESHES = {"1x2": (1, 2), "1x4": (1, 4)}
CHUNKS = (0, 4)
RL = dict(temperature=0.0, group_size=4, max_new_tokens=8, lr=1e-3, entropy_coef=0.01)
PROMPTS = 4
SLOTS = 4
EOS_ID, EOS_SCALE = 2, 3.0
# the episodes: dialog runs every turn, calculator ends some early
EPISODES = {"1x2": dict(env="dialog", B=6, slots=3, max_new=8, turns=3, turn_budget=4,
                        obs_budget=8),
            "1x4": dict(env="calculator", B=8, slots=4, max_new=6, turns=3, turn_budget=4,
                        obs_budget=8)}
# the chunked refill under kv_quant: 2 prompts of 10 tokens in chunks of 4
QUANT_B, QUANT_L, QUANT_CHUNK, QUANT_SMAX = 2, 10, 4, 16
CLOCK_KEYS = {"rollout/wall_s", "rollout/tokens_per_s"}
# the final params after the AdamW steps: each leaf within TOL, or within
# SPREAD_FACTOR x the largest distance between JAX's one-device run and
# JAX's run on the same mesh in that leaf, if larger. Adam normalises each
# element's update by its gradient's magnitude, so an element whose gradient
# nearly cancels (the self-attention key bias in RoPE's slowest dimensions,
# a gate column whose inputs cancel) moves with the gradient's rounding: on
# these two iterations JAX's own (1, 4) mesh parts from its one device by
# 5.1e-5 in ``w_gate`` and its (1, 2) mesh by 2.6e-5 in ``b_k``
SPREAD_FACTOR = 2.0


def _cfg():
    return reduced(get_config(ARCH), **MODEL_KW)


# --------------------------------------------------------------------------- #
# the JAX references: A writes the weights, the (1, 4) gradient and the (1, 2)
# pipelines; B the one-device pipeline and the (1, 4) pipelines
# --------------------------------------------------------------------------- #
JAX_REF = r'''
import os, sys, json, pickle
import numpy as np
import jax, jax.numpy as jnp
from repro.api import ExperimentSpec
from repro.configs import RolloutEngineConfig, get_config, reduced
from repro.models import get_model
from repro.rl import trainer as jtrainer
from repro.utils.jax_compat import make_compat_mesh, use_mesh
from torch_arena import Recorded, jax_fp32_arena
from torch_world import wait_for
W, PART = sys.argv[1], sys.argv[2]
G = json.loads(sys.argv[3])
cfg = reduced(get_config(G['arch']), **G['model'])
rl = jtrainer.RLConfig(**G['rl'])
cases = ([('1x2', c) for c in G['chunks']] if PART == 'a'
         else [('solo', 0)] + [('1x4', c) for c in G['chunks']])
pipes = {(m, c): ExperimentSpec(
    model=cfg, rl=rl, prompts_per_iter=G['prompts'],
    mesh_shape=tuple(G['meshes'][m]) if m in G['meshes'] else None,
    rollout=RolloutEngineConfig(engine='continuous', num_slots=G['slots'], prefill_chunk=c),
    ).compile() for m, c in cases}
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
out = {}
if PART == 'a':
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          next(iter(pipes.values())).ctx.actor_state.params)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
        if jax.tree_util.keystr(p).endswith(("['w']", "['b_q']", "['b_k']", "['b_v']",
                                              "['b_o']")) else a, params)
    params['lm_head'][:, G['eos_id']] *= G['eos_scale']
    with open(os.path.join(W, 'weights.pkl'), 'wb') as f:
        pickle.dump(params, f)
    open(os.path.join(W, 'weights.done'), 'w').close()
    # the GRPO actor loss's gradient on a (1, 4) mesh
    model = get_model(cfg)
    batch = {k: jnp.asarray(np.asarray(v)) for k, v in G['batch'].items()}
    with use_mesh(make_compat_mesh((1, 4), ('data', 'model'))):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtrainer.actor_loss_fn(model, rl, p, batch), has_aux=True))(fp32(params))
    out['loss'], out['grads'] = float(loss), jax.tree.map(np.asarray, grads)
else:
    wait_for(os.path.join(W, 'weights.done'))
    with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
        params = pickle.load(f)
for (m, c), pipe in pipes.items():
    pipe.ctx.actor_state = jtrainer.init_state(fp32(params))
    pipe.ctx.ref_params = fp32(params)
    eng = pipe.ctx.engines['generate'] = Recorded(pipe.ctx.engines['generate'], np.asarray)
    eng.engine.model = jax_fp32_arena(eng.engine.model)
    with use_mesh(pipe.ctx.mesh):
        hist = pipe.run(G['iters'])
    out['solo' if m == 'solo' else f'{m}_c{c}'] = {
                        'history': [{k: float(v) for k, v in h.items()} for h in hist],
                        'tokens': eng.seen,
                        'params': jax.tree.map(np.asarray, pipe.ctx.actor_state.params)}
with open(os.path.join(W, f'jax_{PART}.pkl'), 'wb') as f:
    pickle.dump(out, f)
'''

# --------------------------------------------------------------------------- #
# the port's worlds, one a mesh
# --------------------------------------------------------------------------- #
PORT_WORLD = r'''
import dataclasses, os, json, pickle
import numpy as np
from torch_arena import Recorded, fp32_arena
from torch_world import wait_for
from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import EnvConfig, RolloutEngineConfig, get_config, reduced
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.distributed import collectives as C, constraint, sharding as shr
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model
from repro_torch.rl import RLConfig, envs, rollout, trainer
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
W = os.environ['WORK']
G = json.loads(os.environ['TPE'])
KEY = os.environ['MESH']
SHAPE = tuple(G['meshes'][KEY])
MODEL = ('model',)
mesh = make_local_mesh(SHAPE, ('data', 'model'), device='cpu')
cfg = reduced(get_config(G['arch']), **G['model'])
model = get_model(cfg, device='cpu')
rl = RLConfig(**G['rl'])
wait_for(os.path.join(W, 'weights.done'))
with open(os.path.join(W, 'weights.pkl'), 'rb') as f:
    full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)


def shards(params, specs):
    return shr.map_with_specs(lambda p, s: C.shard(mesh, p, s, axes=MODEL).clone(), params,
                              specs)


def gathered(params, specs):
    return shr.map_with_specs(lambda p, s: C.all_gather(mesh, p, s, axes=MODEL), params, specs)


out, res = {}, {'coords': mesh.coords}
train_specs = shr.param_specs(cfg, mesh, full, 'train')
serve = shards(full, shr.param_specs(cfg, mesh, full, 'serve'))

# 1. the GRPO actor loss's gradient on the train shards, gathered over model
batch = {k: torch.tensor(v) for k, v in G['batch'].items()}
with constraint.use_mesh(mesh):
    (loss, _), grads = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(model, rl, p, batch), shards(full, train_specs))
out['loss'], out['grads'] = float(loss), bridge.to_jax(gathered(grads, train_specs))

# 2. greedy GRPO on the continuous engine through ExperimentSpec(mesh_shape=...)
for c in G['chunks']:
    pipe = ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'], mesh_shape=SHAPE,
                          rollout=RolloutEngineConfig(engine='continuous', num_slots=G['slots'],
                                                      prefill_chunk=c)).compile(device='cpu')
    pipe.ctx.actor_state = trainer.shard_state(mesh, full, pipe.ctx.param_specs)
    pipe.ctx.ref_params = shards(full, pipe.ctx.param_specs)
    eng = pipe.ctx.engines['generate'] = Recorded(pipe.ctx.engines['generate'], np.asarray)
    assert isinstance(eng.engine, ContinuousRolloutEngine) and eng.prefill_chunk == c
    eng.engine.model = fp32_arena(eng.engine.model)
    hist = pipe.run(G['iters'])
    out[f'c{c}'] = {'history': hist, 'tokens': eng.seen, 'params': bridge.to_jax(
        trainer.gather_params(mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs))}
    res[f'c{c}_tokens'] = [t.tolist() for t in eng.seen]

# 3. a fixed schedule (one slot a prompt, one bucket) against lockstep generate
prompt = torch.tensor(G['fixed_prompts'])
B = prompt.shape[0]
for temp in (0.0, 2.0):
    kw = dict(max_new=G['fixed_new'], temperature=temp, eos_id=G['eos_id'], pad_id=0)
    with torch.inference_mode(), constraint.use_mesh(mesh):
        want = rollout.generate(fp32_arena(model), serve, prompt, torch.Generator().manual_seed(6),
                                **kw)
        eng = ContinuousRolloutEngine(fp32_arena(model), num_slots=B + 3, **kw)
        got = eng(serve, prompt, torch.Generator().manual_seed(6))
    out[f'fixed_{temp}'] = {k: (getattr(want, k).numpy(), getattr(got, k).numpy())
                            for k in ('tokens', 'response_mask', 'lengths', 'old_logprob')}
    out[f'fixed_{temp}']['stats'] = eng.last_stats

# 4. a chunked refill under kv_quant, the slot shards gathered
if KEY == '1x2':
    qmodel = get_model(dataclasses.replace(cfg, kv_quant=True), device='cpu')
    qp = torch.tensor(G['quant_prompts'])
    with torch.inference_mode(), constraint.use_mesh(mesh):
        caches = qmodel.init_caches(qp.shape[0], G['quant_smax'])
        logits = []
        for off in range(0, qp.shape[1], G['quant_chunk']):
            lg, caches = qmodel.prefill_chunk(serve, qp[:, off:off + G['quant_chunk']], caches,
                                              offset=off)
            logits.append(lg.numpy())
        cache = [{k: C.all_gather(mesh, v, (None, 'model'), axes=MODEL).numpy()
                  for k, v in c.items()} for c in caches]
        try:
            qmodel.prefill_chunk(serve, qp[:, :4], caches, offset=G['quant_smax'] - 2)
            out['past_width'] = None
        except ValueError as e:
            out['past_width'] = str(e)
    out['quant'] = {'logits': logits, 'caches': cache}

# 5. multi-turn episodes on the engine over the sharded arena
c = G['episodes'][KEY]
env = envs.EnvRuntime(envs.get_env(c['env']), EnvConfig(
    name=c['env'], max_turns=c['turns'], obs_budget=c['obs_budget']), ByteTokenizer())
eng = ContinuousRolloutEngine(fp32_arena(model), max_new=c['max_new'], temperature=0.0,
                              eos_id=G['eos_id'], pad_id=0, num_slots=c['slots'],
                              max_turns=c['turns'], turn_budget=c['turn_budget'],
                              obs_budget=c['obs_budget'], env=env)
with constraint.use_mesh(mesh):
    r = eng(serve, torch.tensor(G['episode_prompts'][KEY]), torch.Generator().manual_seed(0))
out['episodes'] = {'tokens': r.tokens.numpy(), 'role_mask': r.role_mask.numpy(),
                   'response_mask': r.response_mask.numpy(), 'lengths': r.lengths.numpy(),
                   'old_logprob': r.old_logprob.numpy(), 'env': eng.last_env,
                   'stats': eng.last_stats}
res['episode_tokens'] = r.tokens.tolist()

# 6. seamless: self- and cross-attention over 2 KV heads, the LM loss's gradient
if KEY == '1x4':
    scfg = reduced(get_config('seamless-m4t-medium'), **G['seamless'])
    smodel = get_model(scfg, device='cpu')
    sfull = tree.map(lambda t: t.float(), smodel.init(torch.Generator().manual_seed(3)))
    sfull = tree.map(lambda t: t + 0.1 * torch.randn(t.shape, generator=torch.Generator()
                                                     .manual_seed(t.numel())), sfull)
    sspecs = shr.param_specs(scfg, mesh, sfull, 'train')
    sbatch = {k: torch.tensor(v) for k, v in G['seamless_batch'].items()}
    with constraint.use_mesh(mesh):
        (sloss, _), sg = trainer.value_and_grad(lambda p: smodel.loss(p, sbatch),
                                                shards(sfull, sspecs))
    out['seamless'] = {'loss': float(sloss), 'grads': bridge.to_jax(gathered(sg, sspecs))}
if RANK == 0:
    with open(os.path.join(W, f'{KEY}_port.pkl'), 'wb') as f:
        pickle.dump(out, f)
RESULT = res
'''


def _batch(rng, V, B=4, prompt=6, new=6):
    """A GRPO actor batch with ragged response masks (as
    ``test_torch_tensor_parallel._batch``)."""
    S = prompt + new
    tokens = rng.integers(3, V, (B, S)).astype(np.int32)
    lens = rng.integers(2, new + 1, B)
    lens[0] = new
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        mask[b, prompt:prompt + n] = True
    old = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    ref_lp = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    rewards = rng.random(B).astype(np.float32)
    adv = ((rewards - rewards.mean()) / (rewards.std() + 1e-6))[:, None] * mask
    return {"tokens": tokens.tolist(), "response_mask": mask.tolist(), "old_logprob": old.tolist(),
            "ref_logprob": ref_lp.tolist(), "advantages": adv.astype(np.float32).tolist()}


def _math_prompts(n, seed):
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.rl.reward import make_math_prompts

    return make_math_prompts(np.random.default_rng(seed), n, ByteTokenizer())[0].tolist()


def _solo(g, weights):
    """The port's one-device runs of what the worlds run besides the JAX
    comparisons: the actor gradient, the kv_quant chunked refill, both
    episode cases and seamless's gradient."""
    import dataclasses

    from torch_arena import fp32_arena

    from repro_torch.configs import EnvConfig
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import get_model
    from repro_torch.rl import RLConfig, envs, trainer
    from repro_torch.rl.rollout_engine import ContinuousRolloutEngine

    cfg = _cfg()
    model = get_model(cfg, device="cpu")
    full = bridge.from_jax(weights, device="cpu", dtype=torch.float32)
    batch = {k: torch.tensor(v) for k, v in g["batch"].items()}
    (loss, _), grads = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(model, RLConfig(**RL), p, batch), full)
    out = {"loss": float(loss), "grads": bridge.to_jax(grads)}
    qmodel = get_model(dataclasses.replace(cfg, kv_quant=True), device="cpu")
    qp = torch.tensor(g["quant_prompts"])
    with torch.inference_mode():
        caches = qmodel.init_caches(QUANT_B, QUANT_SMAX)
        logits = []
        for off in range(0, QUANT_L, QUANT_CHUNK):
            lg, caches = qmodel.prefill_chunk(full, qp[:, off:off + QUANT_CHUNK], caches,
                                              offset=off)
            logits.append(lg.numpy())
        try:
            qmodel.prefill_chunk(full, qp[:, :4], caches, offset=QUANT_SMAX - 2)
        except ValueError as e:
            out["past_width"] = str(e)
    out["quant"] = {"logits": logits, "caches": [{k: v.numpy() for k, v in c.items()}
                                                 for c in caches]}
    out["episodes"] = {}
    for key, c in EPISODES.items():
        env = envs.EnvRuntime(envs.get_env(c["env"]), EnvConfig(
            name=c["env"], max_turns=c["turns"], obs_budget=c["obs_budget"]), ByteTokenizer())
        eng = ContinuousRolloutEngine(fp32_arena(model), max_new=c["max_new"], temperature=0.0,
                                      eos_id=EOS_ID, pad_id=0, num_slots=c["slots"],
                                      max_turns=c["turns"], turn_budget=c["turn_budget"],
                                      obs_budget=c["obs_budget"], env=env)
        r = eng(full, torch.tensor(g["episode_prompts"][key]), torch.Generator().manual_seed(0))
        out["episodes"][key] = {"tokens": r.tokens.numpy(), "role_mask": r.role_mask.numpy(),
                                "response_mask": r.response_mask.numpy(),
                                "lengths": r.lengths.numpy(), "old_logprob": r.old_logprob.numpy(),
                                "env": eng.last_env, "stats": eng.last_stats}
    scfg = reduced(get_config("seamless-m4t-medium"), **SEAMLESS_KW)
    smodel = get_model(scfg, device="cpu")
    sfull = tree.map(lambda t: t.float(), smodel.init(torch.Generator().manual_seed(3)))
    sfull = tree.map(lambda t: t + 0.1 * torch.randn(t.shape, generator=torch.Generator()
                                                     .manual_seed(t.numel())), sfull)
    sbatch = {k: torch.tensor(v) for k, v in g["seamless_batch"].items()}
    (sloss, _), sg = trainer.value_and_grad(lambda p: smodel.loss(p, sbatch), sfull)
    out["seamless"] = {"loss": float(sloss), "grads": bridge.to_jax(sg)}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: two JAX processes (4 forced
    devices each) and a port world a mesh; the port's one-device runs in
    this process meanwhile."""
    work = str(tmp_path_factory.mktemp("tp_engine"))
    rng = np.random.default_rng(31)
    scfg = reduced(get_config("seamless-m4t-medium"), **SEAMLESS_KW)
    stok = rng.integers(3, 260, (2, 8)).astype(np.int32)
    g = dict(arch=ARCH, model=MODEL_KW, seamless=SEAMLESS_KW, meshes=MESHES, chunks=CHUNKS,
             rl=RL, prompts=PROMPTS, slots=SLOTS, iters=ITERS, eos_id=EOS_ID, eos_scale=EOS_SCALE,
             batch=_batch(rng, 260), episodes=EPISODES,
             fixed_prompts=_math_prompts(8, 5), fixed_new=12,
             quant_prompts=rng.integers(4, 200, (QUANT_B, QUANT_L)).tolist(),
             quant_chunk=QUANT_CHUNK, quant_smax=QUANT_SMAX,
             episode_prompts={k: _math_prompts(c["B"], 7) for k, c in EPISODES.items()},
             seamless_batch={
                 "tokens": stok.tolist(),
                 "labels": np.concatenate([stok[:, 1:], np.full((2, 1), -1, np.int32)],
                                          1).tolist(),
                 "frames": rng.standard_normal((2, scfg.encoder_len, scfg.d_model))
                 .astype(np.float32).tolist()})
    args = json.dumps(g)
    jax_env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
               "PYTHONPATH": os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                              os.path.dirname(__file__)])}
    groups = {f"jax_{part}": start_procs([["-c", JAX_REF, work, part, args]], logdir=work,
                                         name=f"jax_{part}", env=jax_env) for part in "ab"}
    for key, shape in MESHES.items():
        groups[key] = start_world(PORT_WORLD, shape[0] * shape[1], logdir=work, name=key,
                                  env={"WORK": work, "TPE": args, "MESH": key})
    wait_for(os.path.join(work, "weights.done"))
    with open(os.path.join(work, "weights.pkl"), "rb") as f:
        weights = pickle.load(f)
    solo = _solo(g, weights)
    out = {name: grp.join() for name, grp in groups.items()}
    out["solo"], out["work"], out["weights"] = solo, work, weights
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


def _port(worlds, mesh):
    return _load(worlds, f"{mesh}_port.pkl")


def _jax(worlds, mesh):
    return _load(worlds, "jax_a.pkl" if mesh == "1x2" else "jax_b.pkl")


def _assert_grads_within(got, want):
    """Every leaf of ``got`` within TOL of its largest magnitude of
    ``want``'s, and ``want``'s nonzero."""
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for (path, b), a in zip(flat_w, flat_g):
        scale = float(np.abs(b).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------- #
# the attention gradient where 1 < KV heads < model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_actor_gradient_of_every_leaf_equals_jax_on_a_1x4_mesh(worlds, mesh):
    """The GRPO actor loss's gradient on the ranks' train shards, gathered
    over ``model``: every leaf within 2e-5 of its largest magnitude of
    ``jax.grad``'s on a (1, 4) mesh, and of the port's one device. At
    ``model`` = 4 the 2 KV heads are replicated and each rank's one query
    head attends one of them; ``layers.local_kv`` copies the whole K and V
    to ``model`` before it cuts, so the backward all-reduce sums each KV
    head's cotangent into that head. Cut before the copy (the order before
    the repair), it summed the two GQA groups' cotangents of different
    heads into one another, and the worst leaf was off by 1.0-1.5 of its
    largest magnitude: this test fails there."""
    want = _load(worlds, "jax_a.pkl")
    got = _port(worlds, mesh)
    for ref_run in (want, worlds["solo"]):
        np.testing.assert_allclose(got["loss"], ref_run["loss"], atol=TOL, rtol=TOL)
        _assert_grads_within(got["grads"], ref_run["grads"])


def test_cross_attention_gradient_where_kv_heads_are_fewer_than_ranks(worlds):
    """Reduced seamless-m4t (4 heads on 2 KV heads, random fp32 leaves) on
    (1, 4): the LM loss over its frames and every leaf's gradient, gathered,
    against the port's one device (``assert_grads_match``: the
    cross-attention's key bias as noise, the encoder's first norm at bf16).
    Its decoder's cross-attention cuts the memory's K/V through the same
    ``local_kv``."""
    got, want = _port(worlds, "1x4")["seamless"], worlds["solo"]["seamless"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    assert_grads_match(bridge.from_jax(got["grads"], device="cpu"), want["grads"],
                       bf16_first_layer=("['encoder']['norm1']['w']",
                                         "['encoder']['norm1']['b']"))


# --------------------------------------------------------------------------- #
# the continuous engine through ExperimentSpec on a rank mesh
# --------------------------------------------------------------------------- #
CASES = [(m, c) for m in sorted(MESHES) for c in CHUNKS]
IDS = [f"{m}-chunk{c}" for m, c in CASES]


@pytest.mark.parametrize("mesh,chunk", CASES, ids=IDS)
def test_continuous_engine_grpo_equals_jax_on_the_same_mesh(worlds, mesh, chunk):
    """Two greedy GRPO iterations of 16 rollouts over 4 slots on the
    continuous engine, whole-prompt or chunked refills: the tokens of every
    iteration bit for bit JAX's on the same mesh, every ``rollout/*`` count
    (counted once, not once a rank) and ``reward/*`` equal, the actor's
    metrics within 2e-5 and the final params within 2e-5, or within
    SPREAD_FACTOR x JAX's own spread between its one device and this mesh;
    every rank drew the same tokens. Some rollouts end early (EOS)."""
    want = _jax(worlds, mesh)[f"{mesh}_c{chunk}"]
    got = _port(worlds, mesh)[f"c{chunk}"]
    assert len(got["tokens"]) == len(want["tokens"]) == ITERS
    for t, w in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(t, w)
    for r in worlds[mesh]:
        assert r[f"c{chunk}_tokens"] == worlds[mesh][0][f"c{chunk}_tokens"]
    for it, (m, j) in enumerate(zip(got["history"], want["history"])):
        assert set(m) == set(j), it
        for k in m:
            if k.startswith(("rollout/", "reward/")) and k not in CLOCK_KEYS:
                assert m[k] == j[k], (it, k)
            elif k.startswith("actor/"):
                np.testing.assert_allclose(m[k], j[k], atol=TOL, rtol=TOL, err_msg=f"{it} {k}")
        assert m["rollout/refills"] > 1 and m["rollout/num_slots"] == SLOTS
    assert min(m["rollout/mean_len"] for m in got["history"]) < RL["max_new_tokens"]
    solo = _load(worlds, "jax_b.pkl")["solo"]["params"]
    for (path, w), g, s in zip(jax.tree_util.tree_leaves_with_path(want["params"]),
                               jax.tree.leaves(got["params"]), jax.tree.leaves(solo)):
        tol = max(TOL, SPREAD_FACTOR * float(np.abs(w - s).max()))
        np.testing.assert_allclose(g, w, atol=tol, rtol=TOL, err_msg=jax.tree_util.keystr(path))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(got["params"]),
                                                          jax.tree.leaves(worlds["weights"])))
    assert moved > 1e-4


@pytest.mark.parametrize("temperature", [0.0, 2.0], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fixed_schedule_equals_lockstep_on_the_ranks(worlds, mesh, temperature):
    """The engine with one slot a prompt and one bucket on the ranks' serve
    shards consumes lockstep ``generate``'s seed stream on the same ranks:
    tokens, masks, lengths and logprobs bit for bit, with EOS made certain
    (the scaled EOS column: some rows end early), and only as many decode
    steps as the slowest row needs."""
    got = _port(worlds, mesh)[f"fixed_{temperature}"]
    for k in ("tokens", "response_mask", "lengths", "old_logprob"):
        want, eng = got[k]
        np.testing.assert_array_equal(eng, want, err_msg=k)
    lens = got["lengths"][0]
    assert lens.min() < 12, "want some early EOS"
    assert got["stats"]["decode_steps"] == lens.max() - 1 and got["stats"]["refills"] == 1


def test_chunked_refill_under_kv_quant_equals_one_device(worlds):
    """Three chunks of a kv_quant prefill on (1, 2): each chunk's rows
    quantized once and written on the rank that owns their slots, the
    prefix gathered and dequantized: each chunk's logits within 2e-5 of one
    device's, every rank's int8 slots and scales gathered equal to one
    device's cache (the slots past the prompt untouched), and a chunk past
    the cache's width raises one device's ValueError."""
    got, want = _port(worlds, "1x2"), worlds["solo"]
    for a, b in zip(got["quant"]["logits"], want["quant"]["logits"]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    for gc, wc in zip(got["quant"]["caches"], want["quant"]["caches"]):
        for k, w in wc.items():
            g = gc[k][:, :w.shape[1]]
            if k.endswith("_scale"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
            else:
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, k
                assert (g[:, QUANT_L:] == 0).all() and (w[:, QUANT_L:] == 0).all(), k
    assert got["past_width"] == want["past_width"] and "past the cache width" in want[
        "past_width"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_multi_turn_episodes_on_the_ranks_equal_one_device(worlds, mesh):
    """``dialog`` (1, 2) and ``calculator`` (1, 4) episodes on the engine
    over the slot-sharded arena: continuations gather each rank's slot
    shard of their rows and teacher-force the feed through ``decode_step``
    at each lane's own offset. Tokens, roles, masks, lengths, rewards,
    turns, tool calls and every slot count equal one device's, logprobs
    within 2e-5; every rank stepped the same episodes."""
    got, want = _port(worlds, mesh)["episodes"], worlds["solo"]["episodes"][mesh]
    for k in ("tokens", "role_mask", "response_mask", "lengths"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["old_logprob"], want["old_logprob"], atol=TOL, rtol=TOL)
    for k in ("rewards", "turns"):
        np.testing.assert_array_equal(got["env"][k], want["env"][k])
    assert got["env"]["tool_calls"] == want["env"]["tool_calls"]
    for k, v in want["stats"].items():
        if f"rollout/{k}" not in CLOCK_KEYS:
            assert got["stats"][k] == v, k
    assert got["stats"]["cont_refills"] >= 1 and (got["role_mask"] == 2).any()
    for r in worlds[mesh]:
        assert r["episode_tokens"] == worlds[mesh][0]["episode_tokens"]
