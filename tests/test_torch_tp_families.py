"""Tensor-parallel model stages of the port for the remaining families
against the JAX package: the int8 KV cache, sliding-window rings, prefix
embeddings, the encoder-decoder and ``top_p < 1`` on a rank mesh with
``model`` > 1 (``models/lm.py``, ``models/layers.py``, ``models/encdec.py``,
``collectives.seq_sharded_decode_attention_quant``).

Fp32 models, every fp32 leaf that JAX initialises to zero or one value
(norm weights and shifts, biases) drawn at random first, the EOS row scaled
so that some rollouts end early: the smoke gemma-2b with ``kv_quant`` (one
KV head, split within the head in the serve layout), reduced mixtral-8x7b
with a window of 7 (not a multiple of M = 2: the ring's eighth slot is
padding) and 4 experts top-2, reduced llava-next-34b with 8 prefix rows,
and reduced seamless-m4t-medium (2 + 2 layers, 4 MHA heads: K/V
column-parallel, biases). A 10-token prompt runs past the window and 8
decode steps wrap the ring. The MoE output is not rounded to bf16 in either
package (``moe.OUT_DTYPE = None``; JAX's einsum without
``preferred_element_type``). Two models run in the port only: mixtral with
the int8 cache as well as its window, and reduced nemotron-4-15b for
``top_p`` (its draws are held to the port's one-device run with the same
hash seeds: JAX's plain sampler draws with threefry, so it matches only in
distribution).

The references come from JAX processes (one a model, 4 forced host devices,
one XLA thread each): the weights, a fixed batch's logprobs, a loss's
``jax.grad`` (the GRPO actor loss; llava's and seamless's LM loss with their
prefix or frames), prefill then greedy decode steps, and two greedy GRPO
iterations through ``ExperimentSpec(mesh_shape=)`` on (1, 2) (and (2, 2) for
``kv_quant``) under ``use_mesh``. seamless runs JAX unrolled (its encoder
scan cannot carry bf16 frames into fp32 weights). llava's prefill is sized
``P + Lp + steps`` in both packages, as the port's ``generate`` sizes it.
Port worlds of 2 and 4 gloo ranks on the CPU (``torch_world``) run the same
on their meshes; the (1, 2) world also runs the port's one-device
references on its rank 0 and plants the two faults that ``chip_smoke.py``'s
phase 20 plants, ``ring_rank_residue`` (the ring's residue taken modulo the
rank's width) and ``quant_before_gather`` (each rank quantizes the K/V row
by the scale of its own half of the head). One module fixture starts every
process at once.

Tolerances: fp32 2e-5 (logprobs, metrics, params, each leaf's gradient at
2e-5 of its largest magnitude; seamless's leaves by
``torch_grads.assert_grads_match``); greedy tokens and the int8 cache bit for
bit; ``BufferStats`` equal. An int8 decode step attends a bf16 cache (the
dequantized values), and the decode kernel and its plain version round the
probabilities to bf16 against the running max of the keys they hold: a
rank's shard rounds against its own max, one device against the whole
cache's, so the two part at the bf16 rounding of the probabilities. The
references with the int8 cache (JAX's process, and the port's one device
in ``test_decode_steps_equal_one_device_on_the_ranks_slot_shards``) split
their int8 decode attention into the ranks' M = 2 slot shards of ceil(W /
M) slots, each attended by the package's own plain version and merged by
its own ``combine_decode_shards``: then every int8 decode step and GRPO on
(1, 2) and (2, 2) are held at fp32 2e-5.
"""
from __future__ import annotations

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from torch_grads import assert_grads_match
from torch_world import start_procs, start_world

torch.set_num_threads(1)

TOL = 2e-5
ITERS = 2
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODELS = {
    "gemma_kvq": ("gemma-2b", dict(vocab_size=260, num_layers=2, pad_heads_to=8,
                                   kv_quant=True)),
    "mixtral": ("mixtral-8x7b", dict(vocab_size=260, num_layers=2, sliding_window=7,
                                     num_experts=4, num_experts_per_tok=2)),
    "llava": ("llava-next-34b", dict(vocab_size=260, num_layers=2, num_prefix_embeds=8)),
    "seamless": ("seamless-m4t-medium", dict(vocab_size=260, num_layers=2, num_kv_heads=4)),
}
PORT_ONLY = {
    "mixtral_kvq": ("mixtral-8x7b", dict(MODELS["mixtral"][1], kv_quant=True)),
    "nemotron": ("nemotron-4-15b", dict(vocab_size=260, num_layers=2)),
}
GRPO_MESHES = {"gemma_kvq": ("1x2", "2x2"), "mixtral": ("1x2",), "llava": ("1x2",)}
RL = dict(temperature=0.0, group_size=4, max_new_tokens=4, lr=1e-3, entropy_coef=0.01)
PROMPTS = 4
EOS_ID, EOS_SCALE = 2, 3.0
PROMPT_LEN, DECODE_STEPS = 10, 8
TOP_P, TOP_P_TEMPERATURE = 0.9, 0.8
FAULTS = {"ring_rank_residue": "mixtral", "quant_before_gather": "gemma_kvq"}
# the leaves whose first layer sees bf16 cotangents in both packages (the
# encoder's frames arrive in bf16; test_torch_encdec.py)
BF16_FIRST = ("['encoder']['norm1']['w']", "['encoder']['norm1']['b']")

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
from repro.api import ExperimentSpec
from repro.configs import get_config, reduced
from repro.models import encdec as jencdec, get_model, lm as jlm
from repro.rl import trainer as jtrainer
from repro.utils.jax_compat import use_mesh
W, NAME = sys.argv[1], sys.argv[2]
G = json.load(open(sys.argv[3]))
cfg = reduced(get_config(G['arch']), **G['model'])
rl = jtrainer.RLConfig(**G['rl'])
model = get_model(cfg)
pipes = {k: ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'],
                           mesh_shape=tuple(G['meshes'][k])).compile()
         for k in G['grpo_meshes']}
params = jax.tree.map(lambda a: np.array(a, np.float32),
                      jax.jit(model.init)(jax.random.PRNGKey(0)))
rng = np.random.default_rng(7)
params = jax.tree_util.tree_map_with_path(
    lambda p, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
    if jax.tree_util.keystr(p).endswith(("['w']", "['b']", "['b_q']", "['b_k']", "['b_v']",
                                          "['b_o']", "['b_in']", "['b_out']")) else a, params)
params['embed'][G['eos_id']] *= G['eos_scale']
with open(os.path.join(W, NAME + '_weights.pkl'), 'wb') as f:
    pickle.dump(params, f)
open(os.path.join(W, NAME + '_weights.done'), 'w').close()
if cfg.kv_quant:
    # the int8 decode attention split into the ranks' M slot shards of
    # ceil(W / M) slots, each attended alone (its softmax rounded against
    # its own max) and merged by JAX's combine_decode_shards: what the
    # port's ranks compute
    from repro.kernels import ops as jops
    whole = jops.decode_attention_quant

    def split_quant(q, k, v, ks, vs, cache_len, **kw):
        w = -(-k.shape[1] // G['split'])
        parts = [whole(q, k[:, r * w:(r + 1) * w], v[:, r * w:(r + 1) * w],
                       ks[:, r * w:(r + 1) * w], vs[:, r * w:(r + 1) * w],
                       jnp.clip(cache_len - r * w, 0, w), **kw) for r in range(G['split'])]
        lse = jnp.stack([p[1] for p in parts])
        m = jnp.max(lse, axis=0)
        den = jnp.maximum(jnp.sum(jnp.exp(lse - m), axis=0), 1e-20)
        return jops.combine_decode_shards(jnp.stack([p[0] for p in parts]), lse), m + jnp.log(den)
    jops.decode_attention_quant = split_quant
fp32 = lambda t: jax.tree.map(jnp.asarray, t)
P32 = fp32(params)
out = {}
batch = {k: jnp.asarray(np.asarray(v)) for k, v in G['batch'].items()}
extra = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in G['extra'].items()}
labels = jnp.asarray(np.asarray(G['labels']))

# a fixed batch's logprobs and a loss's gradient, one device
if cfg.is_encoder_decoder:
    memory = jencdec.encode(cfg, P32, extra['frames'], unroll=True)
    h = jencdec.decode_full(cfg, P32, batch['tokens'], memory, unroll=True)
    lp, ent, _ = jlm.token_stats(cfg, P32, h[:, :-1], batch['tokens'][:, 1:])
    z = jnp.zeros((lp.shape[0], 1), lp.dtype)
    lp, ent = jnp.concatenate([z, lp], 1), jnp.concatenate([z, ent], 1)
    lm_batch = {'tokens': batch['tokens'], 'labels': labels, 'frames': extra['frames']}
    loss_fn = lambda p: jencdec.loss_fn(cfg, p, lm_batch, unroll=True)
else:
    lp, ent = jax.jit(model.logprobs)(P32, batch['tokens'], **extra)
    if cfg.num_prefix_embeds:
        P = cfg.num_prefix_embeds
        pre = jnp.full((labels.shape[0], P), -1, labels.dtype)
        lm_batch = {'tokens': batch['tokens'], 'labels': jnp.concatenate([pre, labels], 1),
                    'prefix_embeds': extra['prefix_embeds']}
        loss_fn = lambda p: model.loss(p, lm_batch)
    else:
        loss_fn = lambda p: jtrainer.actor_loss_fn(model, rl, p, batch)
out['logprobs'], out['entropy'] = np.asarray(lp), np.asarray(ent)
(loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(P32)
out['loss'], out['grads'] = float(loss), jax.tree.map(np.asarray, grads)

# prefill, then greedy decode steps
prompt = batch['tokens'][:, :G['prompt_len']]
P = cfg.num_prefix_embeds if 'prefix_embeds' in extra else 0
smax = P + G['prompt_len'] + G['steps'] + 1
if cfg.is_encoder_decoder:
    logits, caches, cl = jax.jit(lambda p, t, f: jencdec.prefill(cfg, p, t, f, smax=smax,
                                                                  unroll=True))(
        P32, prompt, extra['frames'])
    decode_step = jax.jit(lambda p, t, c, n: jencdec.decode_step(cfg, p, t, c, n, unroll=True))
else:
    logits, caches, cl = jax.jit(lambda p, t, e: model.prefill(p, t, smax=smax, **e))(
        P32, prompt, extra)
    decode_step = jax.jit(model.decode_step)
toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
lps = [jax.nn.log_softmax(logits, -1)[jnp.arange(prompt.shape[0]), toks[-1]]]
for _ in range(G['steps']):
    logits, caches, cl = decode_step(P32, toks[-1], caches, cl)
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
from torch_world import wait_for
from repro_torch import bridge, tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives as C, constraint, sharding as shr
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model, lm, moe
from repro_torch.rl import RLConfig, rollout, trainer
moe.OUT_DTYPE = None
W = os.environ['WORK']
G = json.load(open(os.environ['TP']))
KEY = os.environ['MESH']
SHAPE = tuple(G['meshes'][KEY])
mesh = make_local_mesh(SHAPE, ('data', 'model'), device='cpu')
MODEL = ('model',)
M = SHAPE[1]
TOLV = 2e-5
res = {'coords': mesh.coords}


def model_shards(full, specs):
    return shr.map_with_specs(lambda p, s: C.shard(mesh, p, s, axes=MODEL).clone(), full, specs)


def gathered(shards, specs):
    return shr.map_with_specs(lambda p, s: C.all_gather(mesh, p, s, axes=MODEL), shards, specs)


def slots(caches):
    """Every rank's slots of each cache leaf, concatenated in rank order."""
    return [{k: C.all_gather(mesh, v, (None, 'model'), axes=MODEL) for k, v in c.items()
             if k in ('k', 'v', 'k_scale', 'v_scale')} for c in caches]


def load(name):
    arch, kw = {**G['models'], **G['port_only']}[name]
    cfg = reduced(get_config(arch), **kw)
    src = name.replace('_kvq', '') if name == 'mixtral_kvq' else name
    if name == 'nemotron':  # the port's own weights, every 1-D leaf drawn at random
        full = tree.map(lambda t: t.float(),
                        get_model(cfg, device='cpu').init(torch.Generator().manual_seed(0)))
        g = torch.Generator().manual_seed(1)
        full = tree.map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g)
                        if t.dim() == 1 else t, full)
    else:
        wait_for(os.path.join(W, src + '_weights.done'))
        with open(os.path.join(W, src + '_weights.pkl'), 'rb') as f:
            full = bridge.from_jax(pickle.load(f), device='cpu', dtype=torch.float32)
    return cfg, get_model(cfg, device='cpu'), full


def greedy(model, params, prompt, extra, steps):
    """Prefill then ``steps`` greedy decode steps (the caller's argmax):
    the tokens, their logprobs, each step's logits and the caches."""
    P = extra['prefix_embeds'].shape[1] if 'prefix_embeds' in extra else 0
    with torch.no_grad():
        logits, caches, cl = model.prefill(params, prompt, smax=P + prompt.shape[1] + steps + 1,
                                           **extra)
        toks, lps, every = [], [], []
        for j in range(steps + 1):
            if j:
                logits, caches, cl = model.decode_step(params, toks[-1], caches, cl)
            toks.append(logits.argmax(-1).to(torch.int32))
            lps.append(torch.log_softmax(logits, -1).gather(1, toks[-1][:, None].long())[:, 0])
            every.append(logits[:, :model.cfg.vocab_size])
    return torch.stack(toks, 1), torch.stack(lps, 1), torch.stack(every, 1), caches


def split_quant_decode(w):
    """``ops.decode_attention_quant`` on one device split into M shards of
    ``w`` slots, each attended alone and merged as the ranks merge them."""
    whole = ops.decode_attention_quant

    def run(q, k, v, ks, vs, cache_len, **kw):
        parts = [whole(q, k[:, r * w:(r + 1) * w], v[:, r * w:(r + 1) * w],
                       ks[:, r * w:(r + 1) * w], vs[:, r * w:(r + 1) * w],
                       torch.clamp(cache_len - r * w, 0, w).to(torch.int32), **kw)
                 for r in range(M)]
        return ops.combine_decode_shards(torch.stack([p[0] for p in parts]),
                                         torch.stack([p[1] for p in parts]), return_lse=True)
    return run


def quant_half(x):
    """``lm.quant_kv`` with the scale of this rank's half of the head (the
    ``quant_before_gather`` fault)."""
    hd, r = x.shape[-1], constraint.tp_rank()
    part = x[..., r * hd // M:(r + 1) * hd // M].float()
    scale = torch.clamp(part.abs().amax(dim=-1), min=1e-8) / 127.0
    return torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127).to(torch.int8), scale


def rank_residue(cfg, cache_len, w):
    """``lm._tp_ring_slot`` with the residue modulo the rank's width (the
    ``ring_rank_residue`` fault)."""
    return cache_len % w, torch.clamp(cache_len + 1, max=w)


QUANT_KV = lm.quant_kv


def int8_cache(cfg, model, serve, prompt, extra, steps):
    """The rank mesh's prefill cache, gathered over model, against
    ``quant_kv`` of the same rank mesh's cache with kv_quant off (what the
    int8 cache must hold bit for bit): the count of unequal entries of
    each leaf a layer, the gathered cache and the width W."""
    smax = prompt.shape[1] + steps + 1
    plain = get_model(dataclasses.replace(cfg, kv_quant=False), device='cpu')
    with torch.no_grad(), constraint.use_mesh(mesh):
        got = slots(model.prefill(serve, prompt, smax=smax, **extra)[1])
        kv = slots(plain.prefill(serve, prompt, smax=smax, **extra)[1])
    diff = []
    for g, f in zip(got, kv):
        (kq, ks), (vq, vs) = QUANT_KV(f['k']), QUANT_KV(f['v'])
        want = {'k': kq, 'v': vq, 'k_scale': ks, 'v_scale': vs}
        diff.append({k: int((g[k] != want[k]).sum()) for k in want})
    return diff, got, lm.ring_width(cfg, smax)


if KEY == '1x2':
    todo = list(G['models']) + list(G['port_only'])
else:
    todo = [n for n, ks in G['grpo_meshes'].items() if KEY in ks]
for name in todo:
    cfg, model, full = load(name)
    train_specs = shr.param_specs(cfg, mesh, full, 'train')
    serve_specs = shr.param_specs(cfg, mesh, full, 'serve')
    train, serve = model_shards(full, train_specs), model_shards(full, serve_specs)
    batch = {k: torch.tensor(v) for k, v in G['batch'].items()}
    extra = {k: torch.tensor(v) for k, v in G['extra'].items()
             if (k == 'frames') == cfg.is_encoder_decoder
             and (k != 'prefix_embeds' or cfg.num_prefix_embeds)}
    prompt = batch['tokens'][:, :G['prompt_len']]
    rl = RLConfig(**G['rl'])
    out = {}
    if KEY == '1x2' and name in G['models']:
        labels = torch.tensor(G['labels'])
        with constraint.use_mesh(mesh):
            with torch.no_grad():
                lp, ent = model.logprobs(train, batch['tokens'], **extra)
            out['logprobs'], out['entropy'] = lp.tolist(), ent.tolist()
            if cfg.is_encoder_decoder:
                lm_batch = {'tokens': batch['tokens'], 'labels': labels, **extra}
                loss_fn = lambda p: model.loss(p, lm_batch)
            elif cfg.num_prefix_embeds:
                pre = torch.full((labels.shape[0], cfg.num_prefix_embeds), -1, dtype=labels.dtype)
                lm_batch = {'tokens': batch['tokens'], 'labels': torch.cat([pre, labels], 1),
                            **extra}
                loss_fn = lambda p: model.loss(p, lm_batch)
            else:
                loss_fn = lambda p: trainer.actor_loss_fn(model, rl, p, batch)
            (loss, _), grads = trainer.value_and_grad(loss_fn, train)
        out['loss'], out['grads'] = float(loss), bridge.to_jax(gathered(grads, train_specs))
        with constraint.use_mesh(mesh):
            toks, lps, _, caches = greedy(model, serve, prompt, extra, G['steps'])
        out['decode_tokens'], out['decode_logprobs'] = toks.tolist(), lps.tolist()
        out['cache_shapes'] = [{k: list(v.shape) for k, v in c.items()} for c in caches]
        with constraint.use_mesh(mesh):
            zeros = model.init_caches(prompt.shape[0], prompt.shape[1] + G['steps'] + 1)
        out['init_cache_shapes'] = [{k: list(v.shape) for k, v in c.items()} for c in zeros]
    if KEY == '1x2' and name in ('mixtral', 'mixtral_kvq', 'gemma_kvq'):
        # the rank mesh's greedy steps and ring against one device's, whose
        # int8 attention is split into the ranks' slot shards
        with constraint.use_mesh(mesh):
            t_tp, _, l_tp, c_tp = greedy(model, serve, prompt, extra, G['steps'])
            c_tp = slots(c_tp)
        w = c_tp[0]['k'].shape[1] // M
        kept = ops.decode_attention_quant
        ops.decode_attention_quant = split_quant_decode(w)
        try:
            t_one, _, l_one, c_one = greedy(model, full, prompt, extra, G['steps'])
        finally:
            ops.decode_attention_quant = kept
        Wr = c_one[0]['k'].shape[1]
        out['vs_one_device'] = {
            'tokens_equal': bool(torch.equal(t_tp, t_one)),
            'logits_max_abs_err': float((l_tp - l_one).abs().max()),
            'logits_max_abs': float(l_one.abs().max()),
            # after the ring wrapped: every slot of the cache in place (an
            # int8 value may round one step apart where its K differs by fp32
            # noise, as test_int8_cache_is_quantized_after_the_gather holds)
            'cache_max_abs_err': max(float((a[k][:, :Wr].float() - b[k].float()).abs().max()
                                           / (1.0 if a[k].dtype == torch.int8 else TOLV))
                                     for a, b in zip(c_tp, c_one) for k in b),
            'padding_slots': [int(a['k'].shape[1] - Wr) for a in c_tp]}
    if KEY == '1x2' and cfg.kv_quant:
        diff, got, Wq = int8_cache(cfg, model, serve, prompt, extra, G['steps'])
        with torch.no_grad():
            one = model.prefill(full, prompt, smax=prompt.shape[1] + G['steps'] + 1, **extra)[1]
        out['int8'] = {
            'against_gathered_kv': diff, 'width': Wq, 'slots': got[0]['k'].shape[1],
            # layer 0 sees the same input on both: its int8 cache is one
            # device's bit for bit; later layers' scales within fp32
            'layer0_equal_one_device': all(bool(torch.equal(got[0][k][:, :Wq], one[0][k]))
                                           for k in one[0]),
            'scales_max_rel_err': max(float(((got[i][k][:, :Wq] - one[i][k]).abs()
                                             / one[i][k]).max())
                                      for i in range(len(one)) for k in ('k_scale', 'v_scale')),
            'values_max_abs_diff': max(int((got[i][k][:, :Wq].int() - one[i][k].int()).abs().max())
                                       for i in range(len(one)) for k in ('k', 'v')),
            'padding': {k: sorted(set(got[0][k][:, Wq:].flatten().tolist()))
                        for k in ('k', 'k_scale')},
            'past_prompt': {k: sorted(set(got[0][k][:, prompt.shape[1]:Wq].flatten().tolist()))
                            for k in ('v', 'v_scale')}}
    if KEY == '1x2' and name == 'gemma_kvq':
        kept = lm.quant_kv
        lm.quant_kv = quant_half
        try:
            out['fault_quant_before_gather'] = int8_cache(cfg, model, serve, prompt, extra,
                                                          G['steps'])[0]
        finally:
            lm.quant_kv = kept
    if KEY == '1x2' and name == 'mixtral':
        kept = lm._tp_ring_slot
        lm._tp_ring_slot = rank_residue
        try:
            with constraint.use_mesh(mesh):
                toks, lps, _, _ = greedy(model, serve, prompt, extra, G['steps'])
        finally:
            lm._tp_ring_slot = kept
        out['fault_ring_rank_residue'] = {'decode_tokens': toks.tolist(),
                                          'decode_logprobs': lps.tolist()}
    if KEY == '1x2' and name == 'llava':
        # generate with the prefix, held to the port's one device
        runs = {}
        for where, p, ctx in (('tp', serve, constraint.use_mesh(mesh)),
                              ('one', full, constraint.use_mesh(None))):
            with ctx:
                r = rollout.generate(model, p, prompt, torch.Generator().manual_seed(3),
                                     max_new=G['steps'], temperature=0.0, **extra)
            runs[where] = r
        out['generate'] = {'tokens_equal': bool(torch.equal(runs['tp'].tokens,
                                                            runs['one'].tokens)),
                           'logprob_max_abs_err': float((runs['tp'].old_logprob
                                                         - runs['one'].old_logprob).abs().max()),
                           'response_tokens': int(runs['tp'].response_mask.sum())}
    if KEY == '1x2' and name == 'nemotron':
        drawn, sample = [], ops.sample_logits

        def recording(z, seeds, inv_temp, **kw):
            tok, lp = sample(z, seeds, inv_temp, **kw)
            drawn.append((z.clone(), inv_temp.clone(), tok.clone()))
            return tok, lp
        ops.sample_logits = recording
        try:
            with constraint.use_mesh(mesh):
                r_tp = rollout.generate(model, serve, prompt, torch.Generator().manual_seed(5),
                                        max_new=G['steps'], temperature=G['temperature'],
                                        top_p=G['top_p'])
        finally:
            ops.sample_logits = sample
        r_one = rollout.generate(model, full, prompt, torch.Generator().manual_seed(5),
                                 max_new=G['steps'], temperature=G['temperature'],
                                 top_p=G['top_p'])
        inside = sum(int(ref.nucleus(lm.mask_padded_vocab(cfg, z) * it[:, None], G['top_p'])
                         .gather(1, tok[:, None].long()).sum()) for z, it, tok in drawn)
        out['top_p'] = {'tokens_equal': bool(torch.equal(r_tp.tokens, r_one.tokens)),
                        'logprob_max_abs_err': float((r_tp.old_logprob
                                                      - r_one.old_logprob).abs().max()),
                        'draws': sum(int(t.numel()) for _, _, t in drawn), 'inside': inside,
                        'plain_sampler_steps': len(drawn), 'vocab_size': cfg.vocab_size,
                        'gathered_width': int(drawn[0][0].shape[1])}
    if name == 'seamless':
        err = {}
        for where, shape in (('tp', SHAPE), ('one', None)):
            try:
                pipe = ExperimentSpec(model=cfg, rl=rl, prompts_per_iter=G['prompts'],
                                      mesh_shape=shape).compile(device='cpu')
                pipe.run(1)
            except NotImplementedError as e:
                err[where] = str(e)
        out['pipeline_errors'] = err
    elif name in G['grpo_meshes'] and KEY in G['grpo_meshes'][name]:
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


def _batch(rng, vocab, B=4, prompt=PROMPT_LEN, new=6):
    """A GRPO actor batch with ragged response masks, and next-token labels
    of its tokens (the last position ignored) for an LM loss."""
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every subprocess of the module at once: a JAX process a model (4
    forced devices) and a port world a mesh."""
    from repro_torch.configs import get_config, reduced

    work = str(tmp_path_factory.mktemp("tp_families"))
    rng = np.random.default_rng(20)
    batch, labels = _batch(rng, 260)
    B = len(batch["tokens"])
    llava = reduced(get_config("llava-next-34b"), **MODELS["llava"][1])
    seamless = reduced(get_config("seamless-m4t-medium"), **MODELS["seamless"][1])
    extra = {"prefix_embeds": (rng.standard_normal((B, llava.num_prefix_embeds, llava.d_model))
                               * 0.5).astype(np.float32).tolist(),
             "frames": rng.standard_normal((B, seamless.encoder_len, seamless.d_model))
             .astype(np.float32).tolist()}
    g = dict(models=MODELS, port_only=PORT_ONLY, meshes=MESHES, grpo_meshes=GRPO_MESHES, rl=RL,
             prompts=PROMPTS, iters=ITERS, eos_id=EOS_ID, eos_scale=EOS_SCALE,
             prompt_len=PROMPT_LEN, steps=DECODE_STEPS, batch=batch, labels=labels, extra=extra,
             top_p=TOP_P, temperature=TOP_P_TEMPERATURE, split=2)
    groups = {}
    for name, (arch, kw) in MODELS.items():
        mine = {k: v for k, v in extra.items()
                if (k == "frames") == (name == "seamless") and (k != "prefix_embeds"
                                                                 or name == "llava")}
        args = os.path.join(work, f"jax_{name}.json")
        with open(args, "w") as f:
            json.dump(dict(g, arch=arch, model=kw, extra=mine,
                           grpo_meshes=GRPO_MESHES.get(name, ())), f)
        groups[f"jax_{name}"] = start_procs(
            [["-c", JAX_REF, work, name, args]],
            logdir=work, name=f"jax_{name}",
            # one XLA thread a process: the suite's other workers share the cores
            env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                              "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"})
    args = os.path.join(work, "port.json")
    with open(args, "w") as f:
        json.dump(g, f)
    for key, shape in MESHES.items():
        groups[key] = start_world(PORT_WORLD, shape[0] * shape[1], logdir=work, name=key,
                                  env={"WORK": work, "TP": args, "MESH": key})
    out = {name: grp.join() for name, grp in groups.items()}
    out["work"] = work
    return out


def _load(worlds, name):
    with open(os.path.join(worlds["work"], name), "rb") as f:
        return pickle.load(f)


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


NAMES = sorted(MODELS)


@pytest.mark.parametrize("name", NAMES)
def test_logprobs_of_a_fixed_batch_equal_jax(worlds, name):
    """``Model.logprobs`` on this rank's ``model`` shards of the train
    layout (llava with its prefix, seamless with its frames): logprob and
    entropy within fp32 2e-5 of JAX's."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_1x2_port.pkl")
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["entropy"], want["entropy"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_of_every_leaf_equals_jax(worlds, name):
    """The loss (GRPO's actor loss; llava's LM loss over its prefix and
    tokens; seamless's over its frames) and every leaf's gradient on the
    ranks' shards, gathered over ``model``, within 2e-5 of ``jax.grad``'s
    (seamless: ``assert_grads_match``, its cross-attention key bias held as
    noise and its encoder's first norm at bf16)."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_1x2_port.pkl")
    np.testing.assert_allclose(got["loss"], want["loss"], atol=TOL, rtol=TOL)
    if name == "seamless":
        from repro_torch import bridge

        assert_grads_match(bridge.from_jax(got["grads"], device="cpu"), want["grads"],
                           bf16_first_layer=BF16_FIRST)
        return
    errs = _grad_errors(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_greedy_decode_equal_jax(worlds, name):
    """Prefill then greedy decode steps on the serve layout: mixtral's
    prompt runs past its window and the steps wrap its ring (7 slots, the
    ranks' 8th empty), llava's 8 prefix rows run ahead of the prompt,
    seamless's decoder attends its memory on each rank's heads. Tokens bit
    for bit JAX's, logprobs within fp32 2e-5 (gemma's int8 steps against
    JAX's attention split into the ranks' slot shards)."""
    want, got = _load(worlds, f"{name}_jax.pkl"), _load(worlds, f"{name}_1x2_port.pkl")
    np.testing.assert_array_equal(np.asarray(got["decode_tokens"]), want["decode_tokens"])
    np.testing.assert_allclose(got["decode_logprobs"], want["decode_logprobs"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["gemma_kvq", "mixtral", "mixtral_kvq"])
def test_decode_steps_equal_one_device_on_the_ranks_slot_shards(worlds, name):
    """The rank mesh's greedy steps against the port's one-device run whose
    int8 attention is split into the ranks' slot shards (each shard's
    softmax rounded against its own max, as on the ranks): tokens bit for
    bit, every step's logits within fp32 2e-5, and after the ring wrapped
    every slot of every layer's cache (int8 values and scales, or fp32 K/V)
    in place; the ranks' slots past W (7 of 8 for mixtral's window, 19 of
    20 for gemma's cache) are padding."""
    got = _load(worlds, f"{name}_1x2_port.pkl")["vs_one_device"]
    assert got["tokens_equal"]
    assert got["logits_max_abs_err"] <= TOL * max(got["logits_max_abs"], 1.0), got
    # in units of the tolerance: fp32 K/V within 2e-5, int8 values within
    # one step and their scales within 2e-5
    assert got["cache_max_abs_err"] <= 1.0, got
    assert set(got["padding_slots"]) == {1}, got


@pytest.mark.parametrize("name", ["gemma_kvq", "mixtral_kvq"])
def test_int8_cache_is_quantized_after_the_gather(worlds, name):
    """The rank mesh's int8 prefill cache, every rank's slots gathered:
    values and scales bit for bit ``quant_kv`` of the same mesh's cache
    with kv_quant off (each scale over every KV head of its token), slot
    for slot, including the zero rows past the prompt (value 0, scale
    1e-8/127) and the slot that rounding W up to a multiple of M adds;
    layer 0's cache bit for bit the one-device port's, every later layer's
    scales within fp32 2e-5 and its values within one quantization step."""
    got = _load(worlds, f"{name}_1x2_port.pkl")["int8"]
    assert all(v == 0 for layer in got["against_gathered_kv"] for v in layer.values()), got
    assert got["slots"] == got["width"] + 1
    assert got["layer0_equal_one_device"]
    assert got["scales_max_rel_err"] <= TOL and got["values_max_abs_diff"] <= 1, got
    tiny = float(np.float32(1e-8) / np.float32(127.0))
    assert got["padding"] == {"k": [0], "k_scale": [pytest.approx(tiny, rel=1e-6)]}
    if name == "gemma_kvq":  # a cache wider than the prompt
        assert got["past_prompt"] == {"v": [0], "v_scale": [pytest.approx(tiny, rel=1e-6)]}


@pytest.mark.parametrize("name,mesh", [(n, k) for n, ks in GRPO_MESHES.items() for k in ks],
                         ids=[f"{n}-{k}" for n, ks in GRPO_MESHES.items() for k in ks])
def test_tensor_parallel_grpo_equals_jax(worlds, name, mesh):
    """Two greedy GRPO iterations with an entropy bonus through
    ``ExperimentSpec(mesh_shape=...).compile``: metrics and final params
    within fp32 2e-5 of JAX's pipeline on the same mesh (mixtral's
    rollouts wrap its ring; gemma's run on the int8 cache, whose decode
    steps attend each rank's slots through the int8 kernel's plain
    version); every rank's ``BufferStats`` equal JAX's, with
    redistributions and nothing through a controller; the weights moved."""
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


def test_encoder_decoder_pipeline_fails_as_on_one_device(worlds):
    """seamless's GRPO pipeline on (1, 2) compiles and then fails exactly as
    on one device: ``rollout.generate`` raises "fused sampling is
    decoder-only" before its prefill, so before any collective."""
    got = _load(worlds, "seamless_1x2_port.pkl")["pipeline_errors"]
    assert got["tp"] == got["one"] == "fused sampling is decoder-only"


def test_encoder_decoder_caches_hold_the_ranks_slots_and_kv_heads(worlds):
    """seamless's decode caches on (1, 2), from prefill and from
    ``init_caches`` alike: the self-attention cache this rank's half of the
    slots of all 4 KV heads, the memory ``mk``/``mv`` this rank's 2 KV heads
    over every frame."""
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("seamless-m4t-medium"), **MODELS["seamless"][1])
    got = _load(worlds, "seamless_1x2_port.pkl")
    assert got["init_cache_shapes"] == got["cache_shapes"]
    smax = PROMPT_LEN + DECODE_STEPS + 1
    for c in got["cache_shapes"]:
        assert c["k"] == c["v"] == [4, -(-smax // 2), 4, cfg.head_dim]
        assert c["mk"] == c["mv"] == [4, cfg.encoder_len, 2, cfg.head_dim]


def test_llava_generate_with_its_prefix_equals_one_device(worlds):
    """``generate`` with 8 prefix rows on (1, 2), its cache sized ``P + Lp +
    max_new`` and split by slot: tokens bit for bit the port's one-device
    run, logprobs within fp32 2e-5 (JAX's ``generate`` sizes the cache
    without the prefix and loses positions; its prefill and decode steps
    are held above)."""
    got = _load(worlds, "llava_1x2_port.pkl")["generate"]
    assert got["tokens_equal"] and got["response_tokens"] > 0
    assert got["logprob_max_abs_err"] <= TOL


def test_top_p_draws_equal_one_device_inside_their_nucleus(worlds):
    """nemotron at ``top_p`` 0.9 and temperature 0.8 on (1, 2): every decode
    step gathers the ranks' fp32 logits of the whole vocab and samples them
    with the plain sampler (``ops.sample_logits``), each draw inside its
    nucleus; the tokens bit for bit the port's one-device run with the same
    hash seeds, the logprobs within fp32 2e-5."""
    got = _load(worlds, "nemotron_1x2_port.pkl")["top_p"]
    assert got["plain_sampler_steps"] == DECODE_STEPS - 1
    assert got["inside"] == got["draws"] == 4 * (DECODE_STEPS - 1)
    assert got["gathered_width"] >= got["vocab_size"]
    assert got["tokens_equal"] and got["logprob_max_abs_err"] <= TOL


def test_the_checks_reject_each_planted_fault(worlds):
    """The checks above reject each fault that ``chip_smoke.py``'s phase
    20 plants: ``quant_before_gather`` leaves int8 values or scales unequal
    to the quantization of the gathered K/V, and ``ring_rank_residue``
    writes the ring's tokens into the wrong slots once the steps pass the
    rank's width, so the greedy stream parts from JAX's or its logprobs
    move by more than a hundred times the tolerance."""
    gemma = _load(worlds, "gemma_kvq_1x2_port.pkl")["fault_quant_before_gather"]
    assert sum(v for layer in gemma for v in layer.values()) > 0
    want = _load(worlds, "mixtral_jax.pkl")
    got = _load(worlds, "mixtral_1x2_port.pkl")["fault_ring_rank_residue"]
    parted = not np.array_equal(np.asarray(got["decode_tokens"]), want["decode_tokens"])
    err = np.abs(np.asarray(got["decode_logprobs"]) - want["decode_logprobs"]).max()
    assert parted or err > 100 * TOL, err
