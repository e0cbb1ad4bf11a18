"""Helpers shared by the port's runtime tests (test_torch_port_runtime.py,
test_torch_port_mesh.py): a small model of a preset built in both
packages from one set of seeded weights, the port's loaded from the JAX
parameters through ``convert.from_jax_params``.  The one test here holds
the two builds to each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu_torch.convert import from_jax_params
from virnet_tpu_torch.models import build_model

SMALL = {"denoising-syn": dict(n_feat=(8, 16, 24), dep_S=3, n_resblocks=1),
         "sisr": dict(n_feat=(8, 16, 24), dep_S=3, dep_K=2, n_resblocks=1)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tier-1 run has six workers at
    once, and PyTorch's default of a thread per core oversubscribes the
    CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_kwargs(task, **overrides) -> dict:
    return {**SMALL["sisr" if task == "sisr" else "denoising-syn"],
            **overrides}


def small_pair(task, seed=0, **overrides):
    """(JAX model, its params, the port's model on the CPU in eval mode,
    the port's state dict) of a small ``task`` preset, ``overrides`` going
    to both packages' build_model."""
    kw = small_kwargs(task, **overrides)
    jm = jax_build_model(task, **kw)
    x = jnp.zeros((1, 16, 16, 3))
    key = jax.random.PRNGKey(seed)
    params = (jm.init(key, x, 2) if task == "sisr"
              else jm.init(key, x))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    tm = build_model(task, **kw)
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval(), sd


def test_small_pair_builds_one_model_in_both_packages():
    """The two builds of one preset restore alike: mu atol 1e-5."""
    x = np.random.default_rng(0).random((1, 24, 20, 3), dtype=np.float32)
    for task, args in (("denoising-syn", ()), ("sisr", (2,))):
        jm, params, tm, _ = small_pair(task, seed=1)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                   *args)[0])
        with torch.inference_mode():
            got = tm(torch.from_numpy(x), *args)[0].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
