"""Tensor-parallel MoE and SSD layers of the port (expert TP in
``models/moe.py``, head TP in ``models/ssm.py``, the sharded gated norm
``ops.rmsnorm(width=)`` with its two kernel entries, the SSD decode state per
rank) against the JAX package.

Three fp32 models, every fp32 leaf that JAX initialises to zero or one value
(norm weights, ``norm_w``, ``D``) drawn at random first, ``w_x``'s second
half of columns (the second rank's heads) scaled up so that the two halves
of the gated norm's width differ in mean square, and the EOS row scaled so
that some rollouts end early: reduced granite-moe-3b (2 layers, 4 experts
top-2, padded heads), reduced mamba2-2.7b (2 layers, 8 SSD heads) and a
reduced jamba with experts (one period: an SSD layer with a dense MLP, an
attention layer with an MoE MLP). The MoE output is not rounded to bf16 in
either package (``moe.OUT_DTYPE = None``; JAX's einsum without
``preferred_element_type``), as ``test_torch_moe.py`` does.

The references come from JAX processes (one a model, 4 forced host devices,
one XLA thread each):
the weights, a fixed batch's logprobs, prefill then greedy decode steps, the
GRPO actor loss's ``jax.grad``, ``lm.loss_fn``'s loss, ``moe_aux`` and
gradients, two greedy GRPO iterations through ``ExperimentSpec(mesh_shape=)``
on each mesh under ``use_mesh``, and (mamba2's process) ``ops.rmsnorm`` in
ref mode on a (1, 2) mesh with its input split over ``model``. Port worlds of
2 and 4 gloo ranks on the CPU (``torch_world``) run the same on (1, 2) and
(2, 2); jamba on (1, 2) only. The (1, 2) world also plants the two faults
that ``chip_smoke.py``'s phase 19 plants, in the same way, ``moe_gate_copy``
(``moe.combine_to_model`` made the identity: the combine weights'
``copy_to_model`` dropped) and ``ssd_norm_local`` (the gated norm over the
rank's own width), and takes the actor gradient again under each. A (2, 1)
world runs granite's GRPO on the continuous engine, held against the
port's one-device run. One module fixture starts every process at once.

Tolerances: fp32 2e-5 (logprobs, metrics, params, each leaf's gradient at
2e-5 of its largest magnitude); greedy tokens bit for bit; ``BufferStats``
equal.
"""
from __future__ import annotations

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from torch_world import start_procs, start_world

torch.set_num_threads(1)

TOL = 2e-5
ITERS = 2
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODELS = {
    "granite": ("granite-moe-3b-a800m", dict(vocab_size=260, num_layers=2, pad_heads_to=8,
                                             num_experts=4, num_experts_per_tok=2)),
    "mamba2": ("mamba2-2.7b", dict(vocab_size=260, num_layers=2)),
    "jamba": ("jamba-v0.1-52b", dict(vocab_size=260, num_layers=2, attn_layer_period=2,
                                     attn_layer_offset=1, moe_layer_period=2,
                                     moe_layer_offset=1)),
}
MODEL_MESHES = {"granite": ("1x2", "2x2"), "mamba2": ("1x2", "2x2"), "jamba": ("1x2",)}
RL = dict(temperature=0.0, group_size=4, max_new_tokens=4, lr=1e-3, entropy_coef=0.01)
PROMPTS = 4
EOS_ID, EOS_SCALE = 2, 3.0
W_X_SCALE = 3.0  # the second half of w_x's columns: the second rank's heads
DECODE_STEPS = 6
ENGINE = dict(engine="continuous", num_slots=4)
FAULTS = {"moe_gate_copy": "granite", "ssd_norm_local": "mamba2"}
NORM_ROWS, NORM_WIDTH = 6, 32

_UNROUNDED = r'''
import jax.numpy as jnp
from repro.models import moe as jmoe


class _UnroundedJnp:
    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


jmoe.jnp = _UnroundedJnp()
'''

# --------------------------------------------------------------------------- #
# the JAX references, one process a model
# --------------------------------------------------------------------------- #
JAX_REF = _UNROUNDED + r'''
import os, sys, json, pickle, dataclasses
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.api import ExperimentSpec
from repro.configs import get_config, reduced
from repro.kernels import ops as jops
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

pipes = {k: compile(G['meshes'][k]) for k in G['model_meshes']}
params = jax.tree.map(lambda a: np.array(a, np.float32),
                      pipes['1x2'].ctx.actor_state.params)
rng = np.random.default_rng(7)
params = jax.tree_util.tree_map_with_path(
    lambda p, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
    if jax.tree_util.keystr(p).endswith(("['w']", "['norm_w']", "['D']")) else a, params)
for stack in params['blocks']:
    if 'ssm' in stack:
        w_x = stack['ssm']['w_x']
        w_x[..., w_x.shape[-1] // 2:] *= G['w_x_scale']
params['embed'][G['eos_id']] *= G['eos_scale']
with open(os.path.join(W, NAME + '_weights.pkl'), 'wb') as f:
    pickle.dump(params, f)
open(os.path.join(W, NAME + '_weights.done'), 'w').close()
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
out = {}

# a fixed batch's logprobs and the GRPO actor loss's gradient, one device
model = get_model(cfg)
batch = {k: jnp.asarray(np.asarray(v)) for k, v in G['batch'].items()}
lp, ent = jax.jit(model.logprobs)(fp32(params), batch['tokens'])
out['logprobs'], out['entropy'] = np.asarray(lp), np.asarray(ent)
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p: jtrainer.actor_loss_fn(model, rl, p, batch), has_aux=True))(fp32(params))
out['loss'], out['grads'] = float(loss), jax.tree.map(np.asarray, grads)
if cfg.num_experts:
    lm_batch = {'tokens': batch['tokens'], 'labels': jnp.asarray(np.asarray(G['labels']))}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, lm_batch), has_aux=True))(fp32(params))
    out['lm'] = {'loss': float(loss), 'moe_aux': float(metrics['moe_aux']),
                 'grads': jax.tree.map(np.asarray, grads)}

# prefill, then greedy decode steps
prompt = batch['tokens'][:, :G['prompt_len']]
logits, caches, cl = jax.jit(model.prefill, static_argnames='smax')(
    fp32(params), prompt, smax=G['prompt_len'] + G['steps'] + 1)
toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
lps = [jax.nn.log_softmax(logits, -1)[jnp.arange(prompt.shape[0]), toks[-1]]]
decode_step = jax.jit(model.decode_step)
for _ in range(G['steps']):
    logits, caches, cl = decode_step(fp32(params), toks[-1], caches, cl)
    toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    lps.append(jax.nn.log_softmax(logits, -1)[jnp.arange(prompt.shape[0]), toks[-1]])
out['decode_tokens'] = np.stack([np.asarray(t) for t in toks], 1)
out['decode_logprobs'] = np.stack([np.asarray(t) for t in lps], 1)

if NAME == 'mamba2':
    # the gated norm's RMSNorm with its input split over `model` (GSPMD sums
    # the mean square over the split), ref mode, and its gradient
    N = G['norm']
    mesh = pipes['1x2'].ctx.mesh
    x = jax.device_put(jnp.asarray(np.asarray(N['x'], np.float32)),
                       NamedSharding(mesh, PS(None, 'model')))
    w = jax.device_put(jnp.asarray(np.asarray(N['w'], np.float32)),
                       NamedSharding(mesh, PS('model')))
    ct = jnp.asarray(np.asarray(N['ct'], np.float32))
    jops.set_mode('ref')
    with use_mesh(mesh):
        y = jax.jit(jops.rmsnorm)(x, w)
        dx, dw = jax.jit(jax.grad(lambda x, w: jnp.sum(jops.rmsnorm(x, w) * ct),
                                  argnums=(0, 1)))(x, w)
    jops.set_mode(None)
    out['norm'] = {'y': np.asarray(y), 'dx': np.asarray(dx), 'dw': np.asarray(dw),
                   'sharding': str(x.sharding.spec)}

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
import torch.nn.functional as F
from torch_world import wait_for
from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as C, constraint, sharding as shr
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model, lm, moe, ssm
from repro_torch.rl import RLConfig, rollout, trainer
moe.OUT_DTYPE = None
W = os.environ['WORK']
G = json.loads(os.environ['TP'])
KEY = os.environ['MESH']
SHAPE = tuple(G['meshes'][KEY])
mesh = make_local_mesh(SHAPE, ('data', 'model'), device='cpu')
res = {'coords': mesh.coords}
MODEL = ('model',)


def model_shards(full, specs):
    return shr.map_with_specs(lambda p, s: C.shard(mesh, p, s, axes=MODEL).clone(), full, specs)


def gathered(shards, specs):
    return shr.map_with_specs(lambda p, s: C.all_gather(mesh, p, s, axes=MODEL), shards, specs)


def rows_of(batch):
    return {k: v[C.region(mesh, v.shape, ('data',))[0]] for k, v in batch.items()}


def weighted_grads(loss_fn, params, specs, count):
    """The loss on this data row's rows weighted by their share of ``count``
    (as the data-parallel step weighs them), its metrics, and the gradient
    summed over data and gathered over model."""
    weight = count / C.all_reduce(mesh, count, axes=('data',))
    with constraint.use_mesh(mesh):
        (loss, metrics), grads = trainer.value_and_grad(
            lambda p: (lambda l, m: (l * weight, m))(*loss_fn(p)), params)
    grads = tree.map(lambda g: C.all_reduce(mesh, g, axes=('data',)), grads)
    return (float(C.all_reduce(mesh, loss, axes=('data',))), metrics,
            bridge.to_jax(gathered(grads, specs)))


def local_gated_out(cfg, p, y, z):
    """``ssm._gated_out`` normalised over the rank's own width (the
    ``ssd_norm_local`` fault)."""
    yz = y * F.silu(z)
    yn = ops.rmsnorm(yz.reshape(-1, yz.shape[-1]), p['norm_w']).reshape(yz.shape)
    return constraint.reduce_from_model(yn @ p['w_out'])


FAULTS = {'moe_gate_copy': lambda cfg: (moe, 'combine_to_model', lambda combine: combine),
          'ssd_norm_local': lambda cfg: (ssm, '_gated_out', local_gated_out)}

if KEY == '1x2':
    # the sharded gated norm alone: this rank's columns, the whole width
    N = G['norm']
    x = torch.tensor(N['x'])
    D = x.shape[-1]
    cols = C.region(mesh, (D,), ('model',))[0]
    xl = x[:, cols].clone().requires_grad_(True)
    wl = torch.tensor(N['w'])[cols].clone().requires_grad_(True)
    with constraint.use_mesh(mesh):
        y = ops.rmsnorm(xl, wl, width=D)
        dx, dw = torch.autograd.grad(torch.sum(y * torch.tensor(N['ct'])[:, cols]), [xl, wl])
        res['norm'] = {'y': C.all_gather(mesh, y.detach(), (None, 'model'), axes=MODEL).tolist(),
                       'dx': C.all_gather(mesh, dx, (None, 'model'), axes=MODEL).tolist(),
                       'dw': C.all_gather(mesh, dw, ('model',), axes=MODEL).tolist()}

for name in G['mesh_models'][KEY]:
    arch, kw = G['models'][name]
    cfg = reduced(get_config(arch), **kw)
    model = get_model(cfg, device='cpu')
    wait_for(os.path.join(W, name + '_weights.done'))
    with open(os.path.join(W, name + '_weights.pkl'), 'rb') as f:
        full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
    train_specs = shr.param_specs(cfg, mesh, full, 'train')
    serve_specs = shr.param_specs(cfg, mesh, full, 'serve')
    train, serve = model_shards(full, train_specs), model_shards(full, serve_specs)
    batch = {k: torch.tensor(v) for k, v in G['batch'].items()}
    rl = RLConfig(**G['rl'])
    out = {}
    with constraint.use_mesh(mesh):
        with torch.no_grad():
            lp, ent = model.logprobs(train, batch['tokens'])
        out['logprobs'], out['entropy'] = lp.tolist(), ent.tolist()
        prompt = batch['tokens'][:, :G['prompt_len']]
        out['cache_shapes'] = [{k: list(v.shape) for k, v in c.items()}
                               for c in lm.init_caches(cfg, prompt.shape[0], 16)]
        res_g = rollout.generate(model, serve, prompt, torch.Generator().manual_seed(0),
                                 max_new=G['steps'] + 1, temperature=0.0)
        out['decode_tokens'] = res_g.tokens[:, G['prompt_len']:].tolist()
        out['decode_logprobs'] = res_g.old_logprob[:, G['prompt_len']:].tolist()
    rows = rows_of(batch)
    actor = lambda p: trainer.actor_loss_fn(model, rl, p, rows)
    out['loss'], _, out['grads'] = weighted_grads(actor, train, train_specs,
                                                  rows['response_mask'].float().sum())
    if cfg.num_experts:
        lm_rows = rows_of({'tokens': batch['tokens'], 'labels': torch.tensor(G['labels'])})
        loss, metrics, grads = weighted_grads(
            lambda p: model.loss(p, lm_rows), train, train_specs,
            (lm_rows['labels'] != lm.IGNORE).float().sum())
        out['lm'] = {'loss': loss, 'moe_aux': float(metrics['moe_aux']), 'grads': grads}
    if KEY == '1x2':
        for fault, victim in G['faults'].items():
            if victim == name:
                obj, attr, value = FAULTS[fault](cfg)
                kept = getattr(obj, attr)
                setattr(obj, attr, value)
                try:
                    out['fault_' + fault] = weighted_grads(
                        actor, train, train_specs, rows['response_mask'].float().sum())[2]
                finally:
                    setattr(obj, attr, kept)

    # two greedy GRPO iterations through ExperimentSpec(mesh_shape=...)
    pipe = ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'],
                          mesh_shape=SHAPE).compile(device='cpu')
    pipe.ctx.actor_state = trainer.shard_state(mesh, full, pipe.ctx.param_specs)
    pipe.ctx.ref_params = model_shards(full, pipe.ctx.param_specs)
    hist = pipe.run(G['iters'])
    out['grpo'] = {'history': hist, 'stats': dataclasses.asdict(pipe.buffer.stats),
                   'params': bridge.to_jax(trainer.gather_params(
                       mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs))}
    if RANK == 0:
        with open(os.path.join(W, f'{name}_{KEY}_port.pkl'), 'wb') as f:
            pickle.dump(out, f)
RESULT = res
'''

# granite on a (2, 1) world with the continuous engine: each data rank's
# engine runs its own rows and stops on its own rows' EOS
ENGINE_WORLD = r'''
import os, json, pickle
from torch_world import wait_for
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.configs import RolloutEngineConfig, get_config, reduced
from repro_torch.models import moe
from repro_torch.rl import RLConfig, trainer
moe.OUT_DTYPE = None
W = os.environ['WORK']
G = json.loads(os.environ['TP'])
arch, kw = G['models']['granite']
wait_for(os.path.join(W, 'granite_weights.done'))
with open(os.path.join(W, 'granite_weights.pkl'), 'rb') as f:
    full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
pipe = ExperimentSpec(model=reduced(get_config(arch), **kw), rl=RLConfig(**G['rl']),
                      prompts_per_iter=G['prompts'], mesh_shape=(2, 1),
                      rollout=RolloutEngineConfig(**G['engine'])).compile(device='cpu')
pipe.ctx.actor_state = trainer.shard_state(pipe.ctx.mesh, full, pipe.ctx.param_specs)
pipe.ctx.ref_params = full
hist = pipe.run(G['iters'])
final = trainer.gather_params(pipe.ctx.mesh, pipe.ctx.actor_state.params, pipe.ctx.param_specs)
if RANK == 0:
    with open(os.path.join(W, 'granite_engine_2x1_port.pkl'), 'wb') as f:
        pickle.dump({'history': hist, 'params': bridge.to_jax(final)}, f)
RESULT = {'mesh': pipe.ctx.mesh.shape,
          'decode_steps': [m['rollout/decode_steps'] for m in hist]}
'''


def _batch(rng, vocab, B=4, prompt=6, new=6):
    """A GRPO actor batch with ragged response masks, and next-token labels
    of its tokens (the last position ignored) for ``lm.loss_fn``."""
    S = prompt + new
    tokens = rng.integers(3, vocab, (B, S)).astype(np.int32)
    lens = rng.integers(2, new + 1, B)
    lens[0] = new
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        mask[b, prompt:prompt + n] = True
    old = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    ref_lp = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    rewards = rng.random(B).astype(np.float32)
    adv = ((rewards - rewards.mean()) / (rewards.std() + 1e-6))[:, None] * mask
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[1, :3] = -1  # rows of different label counts
    batch = {"tokens": tokens.tolist(), "response_mask": mask.tolist(),
             "old_logprob": old.tolist(), "ref_logprob": ref_lp.tolist(),
             "advantages": adv.astype(np.float32).tolist()}
    return batch, labels.tolist()


def _norm_case(rng, rows=NORM_ROWS, width=NORM_WIDTH):
    """x (rows, width) whose two halves differ in mean square, w and a
    cotangent."""
    x = rng.standard_normal((rows, width)).astype(np.float32)
    x[:, width // 2:] *= 3.0
    return {"x": x.tolist(), "w": (rng.standard_normal(width) * 0.3).astype(np.float32).tolist(),
            "ct": rng.standard_normal((rows, width)).astype(np.float32).tolist()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: a JAX process a model (4
    forced devices) and a port world a mesh."""
    work = str(tmp_path_factory.mktemp("tp_moe_ssd"))
    rng = np.random.default_rng(19)
    batch, labels = _batch(rng, 260)
    mesh_models = {k: [m for m, ks in MODEL_MESHES.items() if k in ks] for k in MESHES}
    g = dict(models=MODELS, meshes=MESHES, mesh_models=mesh_models, rl=RL, prompts=PROMPTS,
             iters=ITERS, eos_id=EOS_ID, eos_scale=EOS_SCALE, w_x_scale=W_X_SCALE,
             prompt_len=6, steps=DECODE_STEPS, batch=batch, labels=labels, faults=FAULTS,
             norm=_norm_case(rng), engine=ENGINE)
    groups = {
        f"jax_{name}": start_procs(
            [["-c", JAX_REF, work, name, json.dumps(dict(g, arch=arch, model=kw,
                                                         model_meshes=MODEL_MESHES[name]))]],
            logdir=work, name=f"jax_{name}",
            # one XLA thread a process: the suite's other workers share the cores
            env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                              "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"})
        for name, (arch, kw) in MODELS.items()}
    for key, shape in MESHES.items():
        groups[key] = start_world(PORT_WORLD, shape[0] * shape[1], logdir=work, name=key,
                                  env={"WORK": work, "TP": json.dumps(g), "MESH": key})
    groups["engine_2x1"] = start_world(ENGINE_WORLD, 2, logdir=work, name="engine_2x1",
                                       env={"WORK": work, "TP": json.dumps(g)})
    out = {name: grp.join() for name, grp in groups.items()}
    out["work"], out["g"] = work, g
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


CASES = [(m, k) for m, ks in MODEL_MESHES.items() for k in ks]
IDS = [f"{m}-{k}" for m, k in CASES]


def _grad_errors(got, want):
    """Each leaf's largest gradient error over its largest magnitude, by
    path; the trees must match."""
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(want)
    flat_t, tree_t = jax.tree.flatten(got)
    assert tree_j == tree_t
    errs = {}
    for (path, b), a in zip(flat_j, flat_t):
        scale = float(np.abs(b).max())
        assert scale > 0, jax.tree_util.keystr(path)
        errs[jax.tree_util.keystr(path)] = float(np.abs(np.asarray(a) - b).max()) / scale
    return errs


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_logprobs_of_a_fixed_batch_equal_jax(worlds, name, mesh):
    """``Model.logprobs`` on this rank's ``model`` shards of the train
    layout: logprob and entropy within fp32 2e-5 of JAX's."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["entropy"], want["entropy"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_prefill_and_greedy_decode_equal_jax(worlds, name, mesh):
    """Prefill then greedy decode steps on the serve layout (an SSD layer's
    state per rank, the vocab-sharded sampler): the tokens bit for bit
    JAX's prefill + ``decode_step`` argmax, their logprobs within 2e-5."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_array_equal(np.asarray(got["decode_tokens"]), want["decode_tokens"])
    np.testing.assert_allclose(got["decode_logprobs"], want["decode_logprobs"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_actor_gradient_of_every_leaf_equals_jax(worlds, name, mesh):
    """The GRPO actor loss's gradient on the ranks' shards, summed over data
    and gathered over ``model``: every leaf within 2e-5 of its largest
    magnitude of ``jax.grad``'s, and nonzero. The replicated router, B/C
    stream and norms take every rank's share through ``copy_to_model``."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_{mesh}_port.pkl")
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    errs = _grad_errors(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_gradient_check_rejects_each_planted_fault(worlds, fault):
    """The gradient check above rejects each fault that ``chip_smoke.py``
    plants: ``moe_gate_copy`` leaves the router each rank's partial gradient
    through the gates, ``ssd_norm_local`` normalises each half of the width
    by its own mean square. Either moves some leaf's gradient by more than
    a hundred times the tolerance."""
    name = FAULTS[fault]
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_1x2_port.pkl")
    errs = _grad_errors(got["fault_" + fault], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] > 100 * TOL, (worst, errs[worst])
    if fault == "moe_gate_copy":  # only the router's gradient moves
        assert "router" in worst, worst


@pytest.mark.parametrize("name,mesh", [c for c in CASES if c[0] != "mamba2"],
                         ids=[i for i in IDS if not i.startswith("mamba2")])
def test_lm_loss_with_its_moe_aux_equals_jax(worlds, name, mesh):
    """``lm.loss_fn`` on the ranks' rows and shards: the loss (with 0.01 x
    the aux loss) and every leaf's gradient within 2e-5 of JAX's, and
    ``moe_aux`` on every rank JAX's global value: its token means are taken
    over the whole batch, which the data axis splits on (2, 2)."""
    want = _load(worlds, f"{name}_jax.pkl")["lm"]
    got = _load(worlds, f"{name}_{mesh}_port.pkl")["lm"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], atol=TOL, rtol=TOL)
    assert want["moe_aux"] > 0
    errs = _grad_errors(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name,mesh", CASES, ids=IDS)
def test_tensor_parallel_grpo_equals_jax(worlds, name, mesh):
    """Two greedy GRPO iterations with an entropy bonus through
    ``ExperimentSpec(mesh_shape=...).compile``: metrics and final params
    within fp32 2e-5 of JAX's pipeline on the same mesh (on (2, 2) the
    experts' FSDP over ``data`` at dim -3); every rank's ``BufferStats``
    equal JAX's, with redistributions and nothing through a controller;
    the weights moved."""
    jax_run = _load(worlds, f"{name}_jax.pkl")["grpo_" + mesh]
    port = _load(worlds, f"{name}_{mesh}_port.pkl")["grpo"]
    assert len(port["history"]) == len(jax_run["history"]) == ITERS
    for m, r in zip(port["history"], jax_run["history"]):
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert m[k] == r[k], k
        keys = [k for k in r if k.startswith("actor/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(m[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jax_run["params"]),
                            jax.tree.leaves(port["params"])):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))
    assert port["history"][-1]["actor/grad_norm"] > 0
    weights = _load(worlds, f"{name}_weights.pkl")
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(port["params"]),
                                                          jax.tree.leaves(weights)))
    assert moved > 1e-4
    stats = {k: ({int(h): b for h, b in v.items()} if k == "host_inbound_bytes" else v)
             for k, v in port["stats"].items()}
    assert stats == jax_run["stats"]
    assert stats["bytes_through_controller"] == 0 and stats["redistributions"] > 0


@pytest.mark.parametrize("name,mesh", [c for c in CASES if c[0] != "granite"],
                         ids=[i for i in IDS if not i.startswith("granite")])
def test_ssd_decode_state_holds_this_ranks_heads(worlds, name, mesh):
    """``lm.init_caches`` on a tensor-parallel mesh: an SSD layer's ``ssm``
    state holds ``nh / model`` heads and ``conv_x`` ``d_inner / model``
    channels, ``conv_bc`` all ``2 g n``; an attention layer keeps its
    slot-sharded cache."""
    from repro_torch.configs import get_config, reduced

    arch, kw = MODELS[name]
    cfg = reduced(get_config(arch), **kw)
    M = MESHES[mesh][1]
    got = _load(worlds, f"{name}_{mesh}_port.pkl")["cache_shapes"]
    assert len(got) == cfg.num_layers
    for shapes, (mixer, _) in zip(got, cfg.layer_kinds()):
        if mixer == "attn":
            assert shapes["k"] == [4, 16 // M, cfg.num_kv_heads, cfg.head_dim]
            continue
        assert shapes == {
            "ssm": [4, cfg.ssm_nheads // M, cfg.ssm_headdim, cfg.ssm_state],
            "conv_x": [4, cfg.ssm_conv - 1, cfg.ssm_d_inner // M],
            "conv_bc": [4, cfg.ssm_conv - 1, 2 * cfg.ssm_ngroups * cfg.ssm_state]}


def test_sharded_norm_over_a_world_equals_jax_on_a_mesh(worlds):
    """``ops.rmsnorm(width=)`` on each rank's half of the columns (the sum
    of squares, summed over ``model`` both ways, then the scaled forward;
    both autograd Functions) against JAX's ``ops.rmsnorm`` in ref mode on
    a (1, 2) mesh with its input split over ``model``: the output and the
    gradients of x and w within fp32 2e-5."""
    want = _load(worlds, "mamba2_jax.pkl")["norm"]
    assert "model" in want["sharding"]
    for r in worlds["1x2"]:
        got = r["norm"]
        for k in ("y", "dx", "dw"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("splits", [2, 4])
def test_sharded_norm_plain_versions_equal_jax_ref(splits):
    """``ref.rmsnorm_sumsq`` of each column block, summed, then
    ``ref.rmsnorm_scaled`` of each block at the whole width: concatenated,
    JAX's ``ref.rmsnorm`` of the whole row within fp32 2e-5; the sum of
    squares of the whole row equals the blocks' sum."""
    from repro.kernels import ref as jref

    case = _norm_case(np.random.default_rng(splits), width=NORM_WIDTH * splits)
    x, w = np.asarray(case["x"], np.float32), np.asarray(case["w"], np.float32)
    xt, wt = torch.tensor(x), torch.tensor(w)
    blocks = torch.chunk(xt, splits, dim=-1)
    ss = sum(ref.rmsnorm_sumsq(b) for b in blocks)
    np.testing.assert_allclose(ss, ref.rmsnorm_sumsq(xt), atol=TOL, rtol=TOL)
    got = torch.cat([ref.rmsnorm_scaled(b, ss, wb, width=x.shape[-1])
                     for b, wb in zip(blocks, torch.chunk(wt, splits))], dim=-1)
    want = np.asarray(jref.rmsnorm(jax.numpy.asarray(x), jax.numpy.asarray(w)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_moe_continuous_engine_on_a_data_split_world_equals_one_device(worlds):
    """granite with the continuous engine on a (2, 1) world: each data
    rank's engine runs its own rows and stops on its own rows' EOS, so the
    ranks run different numbers of decode steps, and the MoE layers pair
    no collective there (the aux loss's sums are taken over the data axis
    only in ``lm.loss_fn``). Two greedy GRPO iterations: metrics (rollouts
    and rewards exactly) and final params within fp32 2e-5 of the port's
    one-device run of the same engine on the same weights."""
    from repro_torch import bridge
    from repro_torch.api import ExperimentSpec
    from repro_torch.configs import RolloutEngineConfig, get_config, reduced
    from repro_torch.models import moe
    from repro_torch.rl import RLConfig, trainer

    ranks = worlds["engine_2x1"]
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 1}] * 2
    assert any(a != b for a, b in zip(*(r["decode_steps"] for r in ranks)))
    arch, kw = MODELS["granite"]
    weights = _load(worlds, "granite_weights.pkl")
    kept, moe.OUT_DTYPE = moe.OUT_DTYPE, None
    try:
        solo = ExperimentSpec(model=reduced(get_config(arch), **kw), rl=RLConfig(**RL),
                              prompts_per_iter=PROMPTS,
                              rollout=RolloutEngineConfig(**ENGINE)).compile(device="cpu")
        solo.ctx.actor_state = trainer.init_state(
            bridge.from_jax(weights, device="cpu", dtype=torch.float32))
        solo.ctx.ref_params = bridge.from_jax(weights, device="cpu", dtype=torch.float32)
        want = solo.run(ITERS)
    finally:
        moe.OUT_DTYPE = kept
    port = _load(worlds, "granite_engine_2x1_port.pkl")
    assert len(port["history"]) == len(want) == ITERS
    for m, r in zip(port["history"], want):
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert m[k] == r[k], k
        keys = [k for k in r if k.startswith("actor/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(m[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(
            bridge.to_jax(solo.ctx.actor_state.params)), jax.tree.leaves(port["params"])):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=str(path))
    assert port["history"][-1]["actor/grad_norm"] > 0
