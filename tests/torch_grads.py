"""Shared by the tests that hold the port's gradients against ``jax.grad``."""
import jax
import numpy as np

from repro_torch import bridge


def assert_grads_match(g_t, g_j, bf16_first_layer=()):
    """The port's grad tree (bridged to the JAX layout) against JAX's, each
    leaf nonzero and at 1e-4 of its largest |grad|; except the key bias of
    a cross-attention (no RoPE), whose gradient is zero: q . b_k adds the
    same to every score of a query, which the softmax cancels. There both
    packages' gradients must be rounding noise, at most 1e-6 of the largest
    |grad| of any leaf. (RoPE rotates a self-attention's key bias by each
    key's position, so that gradient is not zero.)

    The leaves named in ``bf16_first_layer`` are stacked over layers, and
    their layer 0 sees cotangents that pass through bf16 in both packages
    (a norm whose output keeps its bf16 input's dtype, read by three
    projections whose bf16 gradients each package sums in its own order):
    that layer is held at the bf16 tolerance, 2e-2 of its largest |grad|."""
    flat_j, tree_j = jax.tree_util.tree_flatten_with_path(g_j)
    flat_t, tree_t = jax.tree.flatten(bridge.to_jax(g_t))
    assert tree_j == tree_t
    top = max(float(np.abs(np.asarray(b)).max()) for _, b in flat_j)
    for (path, b), a in zip(flat_j, flat_t):
        name, b = jax.tree_util.keystr(path), np.asarray(b)
        scale = float(np.abs(b).max())
        if name.endswith("['cross_attn']['b_k']"):
            assert max(scale, float(np.abs(a).max())) <= 1e-6 * top, name
            continue
        assert scale > 0, name
        if name in bf16_first_layer:
            np.testing.assert_allclose(a[0], b[0], atol=2e-2 * float(np.abs(b[0]).max()),
                                       rtol=0, err_msg=name)
            a, b = a[1:], b[1:]
            scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=0, err_msg=name)
