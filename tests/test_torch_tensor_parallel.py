"""Tensor-parallel model stages of the port (``distributed/constraint.py``
and its call sites in ``models/layers.py`` and ``models/lm.py``, the
per-axis collectives, the vocab-sharded sampler, the tensor-parallel step
and pipeline) against the JAX package.

Two fp32 models: the smoke gemma-2b (MQA, 4 heads padded to 8, a tied head,
K/V replicated over ``model`` in the train layout and split within the head
in the serve layout) and the reduced qwen2.5-7b of
``tests/test_multidevice.py`` (4 KV heads, whole heads a rank) with biases.
Every fp32 leaf that JAX initialises to zero or one value (norm weights,
biases) is drawn at random first, and the EOS row is scaled so that some
rollouts end early.

The references come from JAX processes (one a model, 4 forced host devices):
the weights, a fixed batch's logprobs, prefill then 8 greedy decode steps,
the GRPO actor loss's ``jax.grad``, and two greedy GRPO iterations with an
entropy bonus through ``ExperimentSpec(mesh_shape=...)`` on a (1, 2) and a
(2, 2) ``(data, model)`` mesh under ``use_mesh``. Port worlds of 2 and 4
gloo ranks on the CPU (``torch_world``) run the same on (1, 2) and (2, 2);
the port's one-device runs happen in this process meanwhile. One module
fixture starts every process at once.

Tolerances: fp32 2e-5 (logprobs, metrics, params, each leaf's gradient at
2e-5 of its largest magnitude); greedy tokens and the sampler's tokens bit
for bit; ``BufferStats`` equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.rl import RLConfig, trainer
from torch_world import start_procs, start_world

torch.set_num_threads(1)

TOL = 2e-5
ITERS = 2
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODELS = {
    "gemma": ("gemma-2b", dict(vocab_size=260, num_layers=2, pad_heads_to=8)),
    "qwen": ("qwen2.5-7b", dict(vocab_size=260, num_layers=2, d_model=64, num_heads=4,
                                num_kv_heads=4, head_dim=16, use_bias=True)),
}
RL = dict(temperature=0.0, group_size=4, max_new_tokens=4, lr=1e-3, entropy_coef=0.01)
PROMPTS = 4
EOS_ID, EOS_SCALE = 2, 3.0
DECODE_STEPS = 8


def _cfg(name):
    arch, kw = MODELS[name]
    return reduced(get_config(arch), **kw)


# --------------------------------------------------------------------------- #
# the JAX references, one process a model
# --------------------------------------------------------------------------- #
JAX_REF = r'''
import os, sys, json, pickle, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.api import ExperimentSpec
from repro.configs import get_config, reduced
from repro.models import get_model
from repro.rl import trainer as jtrainer
from repro.utils.jax_compat import use_mesh
W, NAME = sys.argv[1], sys.argv[2]
G = json.loads(sys.argv[3])
cfg = reduced(get_config(G['arch']), **G['model'])
rl = jtrainer.RLConfig(**G['rl'])

def compile(shape):
    return ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'],
                          mesh_shape=tuple(shape)).compile()

pipes = {k: compile(s) for k, s in G['meshes'].items()}
params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      pipes['1x2'].ctx.actor_state.params)
rng = np.random.default_rng(7)
params = jax.tree_util.tree_map_with_path(
    lambda p, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
    if jax.tree_util.keystr(p).endswith(("['w']", "['b_q']", "['b_k']", "['b_v']",
                                          "['b_o']", "['b_in']", "['b_out']")) else a, params)
params['embed'][G['eos_id']] *= G['eos_scale']
with open(os.path.join(W, NAME + '_weights.pkl'), 'wb') as f:
    pickle.dump(params, f)
open(os.path.join(W, NAME + '_weights.done'), 'w').close()
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
out = {}

# a fixed batch's logprobs and the GRPO actor loss's gradient, one device
model = get_model(cfg)
batch = {k: jnp.asarray(np.asarray(v)) for k, v in G['batch'].items()}
lp, ent = model.logprobs(fp32(params), batch['tokens'])
out['logprobs'], out['entropy'] = np.asarray(lp), np.asarray(ent)
(loss, _), grads = jax.value_and_grad(
    lambda p: jtrainer.actor_loss_fn(model, rl, p, batch), has_aux=True)(fp32(params))
out['loss'], out['grads'] = float(loss), jax.tree.map(np.asarray, grads)

# prefill, then greedy decode steps
prompt = batch['tokens'][:, :G['prompt_len']]
logits, caches, cl = model.prefill(fp32(params), prompt, smax=G['prompt_len'] + G['steps'] + 1)
toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
lps = [jax.nn.log_softmax(logits, -1)[jnp.arange(prompt.shape[0]), toks[-1]]]
for _ in range(G['steps']):
    logits, caches, cl = model.decode_step(fp32(params), toks[-1], caches, cl)
    toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    lps.append(jax.nn.log_softmax(logits, -1)[jnp.arange(prompt.shape[0]), toks[-1]])
out['decode_tokens'] = np.stack([np.asarray(t) for t in toks], 1)
out['decode_logprobs'] = np.stack([np.asarray(t) for t in lps], 1)

# two greedy GRPO iterations on each mesh
for key, pipe in pipes.items():
    pipe.ctx.actor_state = jtrainer.init_state(fp32(params))
    pipe.ctx.ref_params = fp32(params)
    with use_mesh(pipe.ctx.mesh):
        hist = pipe.run(G['iters'])
    out['grpo_' + key] = {'history': [{k: float(v) for k, v in m.items()} for m in hist],
                          'params': jax.tree.map(np.asarray, pipe.ctx.actor_state.params),
                          'stats': dataclasses.asdict(pipe.buffer.stats)}
with open(os.path.join(W, NAME + '_jax.pkl'), 'wb') as f:
    pickle.dump(out, f)
'''

# --------------------------------------------------------------------------- #
# the port's worlds, one a mesh
# --------------------------------------------------------------------------- #
PORT_WORLD = r'''
import os, json, pickle, dataclasses
import numpy as np
from torch_world import wait_for
from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as C, constraint, sharding as shr
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model
from repro_torch.rl import RLConfig, critic as critic_mod, rollout, trainer
W = os.environ['WORK']
G = json.loads(os.environ['TP'])
KEY = os.environ['MESH']
SHAPE = tuple(G['meshes'][KEY])
mesh = make_local_mesh(SHAPE, ('data', 'model'), device='cpu')
data = C.region(mesh, (SHAPE[0],), ('data',))[0]
res = {'coords': mesh.coords}


def model_shards(full, specs):
    return shr.map_with_specs(lambda p, s: C.shard(mesh, p, s, axes=('model',)).clone(),
                              full, specs)


def gathered(shards, specs):
    return shr.map_with_specs(lambda p, s: C.all_gather(mesh, p, s, axes=('model',)),
                              shards, specs)


for name, (arch, kw) in G['models'].items():
    cfg = reduced(get_config(arch), **kw)
    model = get_model(cfg, device='cpu')
    wait_for(os.path.join(W, name + '_weights.done'))
    with open(os.path.join(W, name + '_weights.pkl'), 'rb') as f:
        full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
    train_specs = shr.param_specs(cfg, mesh, full, 'train')
    serve_specs = shr.param_specs(cfg, mesh, full, 'serve')
    train, serve = model_shards(full, train_specs), model_shards(full, serve_specs)
    batch = {k: torch.tensor(v) for k, v in G['batch'].items()}
    out = {}
    with constraint.use_mesh(mesh):
        with torch.no_grad():
            lp, ent = model.logprobs(train, batch['tokens'])
        out['logprobs'], out['entropy'] = lp.tolist(), ent.tolist()
        prompt = batch['tokens'][:, :G['prompt_len']]
        res_g = rollout.generate(model, serve, prompt, torch.Generator().manual_seed(0),
                                 max_new=G['steps'] + 1, temperature=0.0)
        out['decode_tokens'] = res_g.tokens[:, G['prompt_len']:].tolist()
        out['decode_logprobs'] = res_g.old_logprob[:, G['prompt_len']:].tolist()
        # the actor loss's gradient on this data row's rows, weighted as the
        # data-parallel step weighs them, summed over data, gathered over model
        rows = {k: v[C.region(mesh, v.shape, ('data',))[0]] for k, v in batch.items()}
        count = rows['response_mask'].float().sum()
        weight = count / C.all_reduce(mesh, count, axes=('data',))
        rl = RLConfig(**G['rl'])
        (loss, _), grads = trainer.value_and_grad(
            lambda p: tuple(x * weight if i == 0 else x for i, x in enumerate(
                trainer.actor_loss_fn(model, rl, p, rows))), train)
    grads = tree.map(lambda g: C.all_reduce(mesh, g, axes=('data',)), grads)
    out['loss'] = float(C.all_reduce(mesh, loss, axes=('data',)))
    out['grads'] = bridge.to_jax(gathered(grads, train_specs))

    # two greedy GRPO iterations through ExperimentSpec(mesh_shape=...)
    pipe = ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'],
                          mesh_shape=SHAPE).compile(device='cpu')
    pipe.ctx.actor_state = trainer.shard_state(mesh, full, pipe.ctx.param_specs)
    pipe.ctx.ref_params = model_shards(full, pipe.ctx.param_specs)
    hist = pipe.run(G['iters'])
    out['grpo'] = {'history': hist, 'stats': dataclasses.asdict(pipe.buffer.stats),
                   'params': bridge.to_jax(trainer.gather_params(
                       mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs))}
    if name == 'gemma' and KEY == '1x2':
        # PPO: the critic's shards through the same tensor-parallel step
        ppo = ExperimentSpec(model=cfg, rl=RLConfig(**dict(G['rl'], algorithm='ppo')),
                             prompts_per_iter=G['prompts'], mesh_shape=SHAPE).compile(device='cpu')
        ppo.ctx.actor_state = trainer.shard_state(mesh, full, ppo.ctx.param_specs)
        ppo.ctx.ref_params = model_shards(full, ppo.ctx.param_specs)
        critic = tree.map(lambda t: t.float(),
                          critic_mod.init(cfg, torch.Generator().manual_seed(5), device='cpu'))
        ppo.ctx.critic_state = trainer.shard_state(mesh, critic, ppo.ctx.critic_specs)
        phist = ppo.run(G['iters'])
        out['ppo'] = {'history': phist, 'critic': bridge.to_jax(trainer.gather_params(
            mesh, ppo.ctx.critic_state.params, ppo.ctx.critic_specs))}
    if RANK == 0:
        with open(os.path.join(W, f'{name}_{KEY}_port.pkl'), 'wb') as f:
            pickle.dump(out, f)
RESULT = res
'''


def _batch(cfg, rng, B=4, prompt=6, new=6):
    """A GRPO actor batch over ``cfg``'s vocabulary, with ragged response
    masks (as ``test_torch_train.grpo_batch``)."""
    S = prompt + new
    tokens = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
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


def _solo(name, weights, algorithm="grpo"):
    """The port's one-device run of ``algorithm`` on a model's weights."""
    full = bridge.from_jax(weights, device="cpu", dtype=torch.float32)
    pipe = ExperimentSpec(model=_cfg(name), rl=RLConfig(**dict(RL, algorithm=algorithm)),
                          prompts_per_iter=PROMPTS).compile(device="cpu")
    pipe.ctx.actor_state = trainer.init_state(full)
    pipe.ctx.ref_params = tree.map(torch.clone, full)
    out = {}
    if algorithm == "ppo":
        from repro_torch.rl import critic as critic_mod

        critic = tree.map(lambda t: t.float(), critic_mod.init(
            _cfg(name), torch.Generator().manual_seed(5), device="cpu"))
        pipe.ctx.critic_state = trainer.init_state(critic)
    out["history"] = pipe.run(ITERS)
    out["params"] = bridge.to_jax(pipe.ctx.actor_state.params)
    if algorithm == "ppo":
        out["critic"] = bridge.to_jax(pipe.ctx.critic_state.params)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: a JAX process a model (4
    forced devices) and a port world a mesh; the port's one-device runs in
    this process meanwhile."""
    from torch_world import wait_for

    work = str(tmp_path_factory.mktemp("tp"))
    g = dict(models=MODELS, meshes=MESHES, rl=RL, prompts=PROMPTS, iters=ITERS,
             eos_id=EOS_ID, eos_scale=EOS_SCALE, prompt_len=6, steps=DECODE_STEPS)
    g["batch"] = _batch(_cfg("gemma"), np.random.default_rng(12))  # both models' vocab
    groups = {
        f"jax_{name}": start_procs(
            [["-c", JAX_REF, work, name, json.dumps(dict(g, arch=arch, model=kw))]],
            logdir=work, name=f"jax_{name}",
            env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
        for name, (arch, kw) in MODELS.items()}
    for key, shape in MESHES.items():
        groups[key] = start_world(PORT_WORLD, shape[0] * shape[1], logdir=work, name=key,
                                  env={"WORK": work, "TP": json.dumps(g), "MESH": key})
    solo = {}
    for name in MODELS:
        wait_for(os.path.join(work, name + "_weights.done"))
        with open(os.path.join(work, name + "_weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        solo[name] = {"weights": weights, "grpo": _solo(name, weights)}
    solo["gemma"]["ppo"] = _solo("gemma", solo["gemma"]["weights"], "ppo")
    out = {name: grp.join() for name, grp in groups.items()}
    out["solo"], out["work"] = solo, work
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


CASES = [(m, k) for m in MODELS for k in MESHES]
IDS = [f"{m}-{k}" for m, k in CASES]


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_logprobs_of_a_fixed_batch_equal_jax(worlds, name, mesh):
    """``Model.logprobs`` on this rank's ``model`` shards of the train
    layout: logprob and entropy within fp32 2e-5 of JAX's."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["entropy"], want["entropy"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_prefill_and_greedy_decode_equal_jax(worlds, name, mesh):
    """Prefill then 8 greedy decode steps on the serve layout (a cache
    sharded by slot, the vocab-sharded sampler): the tokens bit for bit
    JAX's prefill + ``decode_step`` argmax, their logprobs within 2e-5."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_array_equal(np.asarray(got["decode_tokens"]), want["decode_tokens"])
    np.testing.assert_allclose(got["decode_logprobs"], want["decode_logprobs"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_actor_gradient_of_every_leaf_equals_jax(worlds, name, mesh):
    """The GRPO actor loss's gradient on the ranks' shards, summed over data
    and gathered over ``model``: every leaf within 2e-5 of its largest
    magnitude of ``jax.grad``'s, and nonzero. K/V replicated over ``model``
    (gemma) take every rank's query heads' share through ``copy_to_model``."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(want["grads"])
    flat_t, tree_t = jax.tree.flatten(got["grads"])
    assert tree_j == tree_t
    for (path, b), a in zip(flat_j, flat_t):
        scale = float(np.abs(b).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_runs_close(port, ref_run, weights, key="params"):
    assert len(port["history"]) == len(ref_run["history"]) == ITERS
    for m, r in zip(port["history"], ref_run["history"]):
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert m[k] == r[k], k
        keys = [k for k in r if k.startswith(("actor/", "critic/"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(m[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(ref_run[key]),
                            jax.tree.leaves(port[key])):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))
    assert port["history"][-1]["actor/grad_norm"] > 0
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(port["params"]),
                                                          jax.tree.leaves(weights)))
    assert moved > 1e-4


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_tensor_parallel_grpo_equals_jax_and_one_device(worlds, name, mesh):
    """Two greedy GRPO iterations with an entropy bonus through
    ``ExperimentSpec(mesh_shape=...).compile``: metrics and final params
    within fp32 2e-5 of JAX's pipeline on the same mesh and of the port's
    one-device run; every rank's ``BufferStats`` equal JAX's, with
    redistributions (model stages at dp = D, compute stages at D x M) and
    nothing through a controller; the ranks of a data row agree."""
    jax_run = _load(worlds, f"{name}_jax.pkl")["grpo_" + mesh]
    port = _load(worlds, f"{name}_{mesh}_port.pkl")["grpo"]
    solo = worlds["solo"][name]
    for ref_run in (jax_run, solo["grpo"]):
        _assert_runs_close(port, ref_run, solo["weights"])
    stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
             for k, v in port["stats"].items()}
    assert stats == jax_run["stats"]
    assert stats["bytes_through_controller"] == 0 and stats["redistributions"] > 0
    coords = [r["coords"] for r in worlds[mesh]]
    assert sorted((c["data"], c["model"]) for c in coords) == sorted(
        (d, m) for d in range(MESHES[mesh][0]) for m in range(MESHES[mesh][1]))


def test_tensor_parallel_ppo_critic_equals_one_device(worlds):
    """PPO on (1, 2): the critic's shards go through the tensor-parallel
    step (its ``v_head`` replicated over ``model``); metrics, the actor's
    and the critic's final params within fp32 2e-5 of the port's one-device
    run, itself held against JAX in ``test_torch_pipeline.py``."""
    port = _load(worlds, "gemma_1x2_port.pkl")["ppo"]
    solo = worlds["solo"]["gemma"]["ppo"]
    assert any(k.startswith("critic/") for k in port["history"][0])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(solo["critic"]),
                            jax.tree.leaves(port["critic"])):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))
    for m, r in zip(port["history"], solo["history"]):
        for k in [k for k in r if k.startswith(("actor/", "critic/"))]:
            np.testing.assert_allclose(m[k], r[k], atol=TOL, rtol=TOL, err_msg=k)


# --------------------------------------------------------------------------- #
# the vocab-sharded sampler, plain, in this process
# --------------------------------------------------------------------------- #
def _sampler_case(layout, vocab=1000, Vp=1024, d=64, B=8):
    """h, a head (d, Vp) in the tied (a transposed (Vp, d)) or untied
    layout, seeds and inverse temperatures (greedy and sampled rows); row 0
    greedy with a tie of its two best logits across the middle column (the
    boundary of two shards), row 1 greedy with its best logits in the
    padded tail."""
    g = torch.Generator().manual_seed(3)
    h = torch.randn(B, d, generator=g)
    w = torch.randn(Vp, d, generator=g) * 0.1
    mid = Vp // 2
    h[0] = 0.0
    h[0, 0] = 1.0
    w[:, 0] = 0.0
    w[mid - 1, 0] = w[mid, 0] = 5.0  # row 0's two best logits tie at Vp/2 - 1 and Vp/2
    h[1] = 0.0
    h[1, 1] = 1.0
    w[vocab:, 1] = 9.0  # row 1's best logits lie in the padded tail, never sampled
    w[vocab - 3, 1] = 4.0
    head = w.t() if layout == "tied" else w.t().contiguous()
    seeds = torch.randint(-2**31, 2**31, (B,), generator=g, dtype=torch.int64).to(torch.int32)
    inv_temp = torch.tensor([0.0, 0.0, 1.0, 0.5, 2.0, 0.0, 1.0, 1.0])
    return h, head, seeds, inv_temp, vocab


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("layout", ["tied", "untied"])
def test_vocab_sharded_sampler_equals_one_device(layout, shards):
    """Each shard's online state (``ref.sample_state``, and the kernel's
    decomposition ``ref.fused_sample_partials`` with ``col_offset``) merged
    in shard order: the tokens bit for bit one-device ``ref.fused_sample``'s
    (the boundary tie to its lower index, the padded tail, which lies in
    the last shard, never taken), the logprobs within 2e-5; a shard of
    padded columns only gives the empty state."""
    h, head, seeds, it, vocab = _sampler_case(layout)
    want_tok, want_lp = ref.fused_sample(h, head, seeds, it, vocab_size=vocab)
    n = head.shape[1] // shards
    assert want_tok[0] == head.shape[1] // 2 - 1 and want_tok[1] == vocab - 3
    for state_fn in (ref.sample_state, lambda *a, **k: ref.fused_sample_partials(
            *a, **k, return_state=True)):
        states = [state_fn(h, head[:, r * n:(r + 1) * n], seeds, it, vocab_size=vocab,
                           col_offset=r * n) for r in range(shards)]
        tok, lp = ref.merge_sample_states(states)
        assert torch.equal(tok, want_tok)
        np.testing.assert_allclose(lp, want_lp, atol=TOL, rtol=TOL)
    if shards == 4:  # the last shard holds only padded columns: the empty state
        m, l, y, z, i = ref.sample_state(h, head[:, 3 * n:], seeds, it, vocab_size=3 * n,
                                         col_offset=3 * n)
        assert torch.all(l == 0) and torch.all(i == 2**31 - 1) and torch.all(m == ref.NEG_INF)


def test_sampler_state_dispatch_on_the_cpu():
    """``sampling.fused_sample(state=True)`` on a CPU tensor is the plain
    state, and ``ops.fused_sample_shard`` on a mesh without a world merges
    the one shard it holds: the one-device sampler's tokens."""
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.kernels import sampling

    h, head, seeds, it, vocab = _sampler_case("untied")
    floats, idx = sampling.fused_sample(h, head, seeds, it, vocab_size=vocab, state=True)
    m, l, y, z, i = ref.sample_state(h, head, seeds, it, vocab_size=vocab)
    assert torch.equal(floats, torch.stack([m, l, y, z], 1)) and torch.equal(idx, i.int())
    tok, lp = ops.fused_sample_shard(DeviceMesh("cpu"), h, head, seeds, it, vocab_size=vocab)
    want_tok, want_lp = ref.fused_sample(h, head, seeds, it, vocab_size=vocab)
    assert torch.equal(tok, want_tok)
    np.testing.assert_allclose(lp, want_lp, atol=TOL, rtol=TOL)


def test_one_device_paths_ignore_an_ambient_mesh_without_model_ranks():
    """The model code's helpers are no-ops without a world or at ``model`` =
    1: the forward is bit for bit the one without a mesh."""
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.distributed import constraint
    from repro_torch.models import get_model

    cfg = _cfg("gemma")
    model = get_model(cfg, device="cpu")
    params = tree.map(lambda t: t.float(), model.init(torch.Generator().manual_seed(0)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    want = model.logprobs(params, tokens)
    with constraint.use_mesh(DeviceMesh("cpu", {"data": 1, "model": 2})):
        assert constraint.tp() is None
        got = model.logprobs(params, tokens)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_specs_pair_with_leaves_by_key_whatever_their_order():
    """A params tree whose dict keys lie in another order than the spec
    tree's (params bridged from JAX walk their keys sorted) gets each
    leaf's own spec: ``map_with_specs`` and ``spec_leaves(like=)`` pair by
    key, not by walk order."""
    from repro_torch.core.databuffer import DeviceMesh
    from repro_torch.distributed import sharding as shr
    from repro_torch.models import get_model

    cfg = _cfg("qwen")
    params = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    specs = shr.param_specs(cfg, DeviceMesh(None, {"data": 2, "model": 2}), params, "train")
    bridged = bridge.from_jax(bridge.to_jax(params), device="cpu")
    assert list(bridged) != list(specs)  # the orders differ
    got = shr.map_with_specs(lambda p, s: s, bridged, specs)
    assert got["blocks"][0]["attn"] == specs["blocks"][0]["attn"]
    assert got["embed"] == specs["embed"] and got["lm_head"] == specs["lm_head"]

    def by_key(t, spec_list):
        return dict(zip((k for k, _ in tree.leaves_with_keys(t)), spec_list))

    assert by_key(bridged, shr.spec_leaves(specs, bridged)) == by_key(params,
                                                                      shr.spec_leaves(specs))
