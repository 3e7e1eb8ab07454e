"""The port's CNN against the reference CNN: forward, loss and gradients
on the same parameters (numpy, converted with ``params_from_jax``) and
the same batch of 4 images.

Tolerance atol 1e-4: both run f32 on the CPU, but the convolutions sum
in another order in XLA and in PyTorch, and the differences grow through
20 conv/GroupNorm layers and the backward pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import colrel_paper as jcolrel_paper
from repro.models import build as jbuild
from repro.models import cnn as jcnn
from repro_torch import tree
from repro_torch.configs import colrel_paper
from repro_torch.convert import params_from_jax
from repro_torch.models import cnn

ATOL = 1e-4


def _numpy_params(jcfg, seed):
    """Random parameters of the reference's structure, at init-like scales
    (He-scaled conv weights, GroupNorm scales near 1)."""
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name in ("bias", "b"):
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_cnn_forward_loss_and_grads_match_reference(which):
    jcfg = getattr(jcolrel_paper, which)().cnn
    cfg = getattr(colrel_paper, which)().cnn
    np_params = _numpy_params(jcfg, seed=0)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=4).astype(np.int32)

    jparams = jax.tree.map(jnp.asarray, np_params)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcnn.loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
    jlogits = jax.jit(lambda p: jcnn.forward(jcfg, p, jbatch["images"]))(jparams)

    model = cnn.CNN(cfg)
    params = tree.map(lambda x: x.requires_grad_(), params_from_jax(np_params, "cpu"))
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    loss, aux = cnn.loss_fn(model, params, batch)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    named = dict(zip(tree.paths(params), tree.leaves(params)))
    logits = torch.func.functional_call(model, named, (batch["images"],))

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=0)
    assert aux["acc"].item() == float(jaux["acc"])
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves) == (61 if which == "full" else 25)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL, rtol=0)


def test_same_padding_of_strided_conv_is_asymmetric():
    """XLA "SAME" pads a stride-2 3x3 conv on an even input by (0, 1)."""
    assert cnn._same_pad(32, 3, 2) == (0, 1)
    assert cnn._same_pad(32, 3, 1) == (1, 1)
    assert cnn._same_pad(32, 1, 2) == (0, 0)
