"""The PyTorch port's serving slice on the CPU: lockstep ``generate`` against
the JAX package's on the same bridged weights, the ``serve`` entry point,
and the port's isolation from JAX and from the JAX package.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.rl.rollout import generate

REPO = pathlib.Path(__file__).resolve().parent.parent
SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def pair():
    """(JAX model, fp32 JAX params, port model, the same params bridged)."""
    jmodel = jax_get_model(jax_reduced(jax_get_config("gemma-2b"), **SMOKE))
    params = jmodel.init(jax.random.PRNGKey(3))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if jnp.issubdtype(a.dtype, jnp.floating) else a, params)
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), dtype=torch.float32)
    return jmodel, jp, get_model(reduced(get_config("gemma-2b"), **SMOKE)), tp


def prompt():
    return np.random.default_rng(4).integers(3, 259, (4, 6)).astype(np.int32)


def run_both(pair, **kw):
    jmodel, jp, model, tp = pair
    budgets = kw.pop("budgets", None)
    want = jax_generate(jmodel, jp, jnp.asarray(prompt()), jax.random.PRNGKey(0),
                        max_new=MAX_NEW, temperature=0.0,
                        budgets=None if budgets is None else jnp.asarray(budgets), **kw)
    got = generate(model, tp, torch.from_numpy(prompt()), torch.Generator().manual_seed(0),
                   max_new=MAX_NEW, temperature=0.0,
                   budgets=None if budgets is None else torch.from_numpy(budgets), **kw)
    return got, want


def assert_same_rollout(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob),
                               atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def free(pair):
    """Greedy rollouts of both packages without EOS or budgets."""
    return run_both(pair)


def test_greedy_generate_matches_jax(free):
    got, want = free
    assert got.tokens.shape == (4, 6 + MAX_NEW)
    assert_same_rollout(got, want)


@pytest.mark.parametrize("case", ["eos", "budgets", "eos_and_budgets"])
def test_generate_eos_and_budgets_match_jax(pair, free, case):
    # an EOS id the greedy rollout emits mid-response, so rows finish early
    eos = int(free[0].tokens[0, 6 + 2])
    kw = {"eos": dict(eos_id=eos), "budgets": dict(budgets=np.array([1, 3, 6, 9], np.int32)),
          "eos_and_budgets": dict(eos_id=eos, budgets=np.array([2, 6, 4, 1], np.int32))}[case]
    got, want = run_both(pair, pad_id=0, **kw)
    assert int(got.lengths.min()) < MAX_NEW
    assert_same_rollout(got, want)


def test_sampled_generate_is_seeded(pair):
    _, _, model, tp = pair
    p = torch.from_numpy(prompt())
    run = lambda seed: generate(model, tp, p, torch.Generator().manual_seed(seed),  # noqa: E731
                                max_new=MAX_NEW, temperature=0.8)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.tokens, b.tokens) and not torch.equal(a.tokens, c.tokens)
    assert bool((a.tokens[:, 6:] < 260).all())  # never the padded vocab
    assert bool((a.old_logprob[:, 6:] < 0).all())


def test_serve_main_runs_on_cpu(capsys):
    stats = serve.main(["--smoke", "--lockstep", "--device", "cpu", "--batch", "2",
                        "--max-new", "4", "--requests", "2", "--prompt-len", "9"])
    assert len(stats["results"]) == 3  # warm-up + two timed batches
    assert stats["results"][0].tokens.shape == (2, 9 + 4)
    assert stats["tokens"] > 0 and stats["p99_s"] >= stats["p50_s"] > 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_serve_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--lockstep"])
    with pytest.raises(NotImplementedError, match="streaming engine not yet ported"):
        serve.main(["--smoke", "--device", "cpu"])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path[:0] = [{str(REPO / "src")!r}, {str(REPO)!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert not [m for m in sys.modules if m.startswith(("jax.", "repro.", "jaxlib"))]
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25
