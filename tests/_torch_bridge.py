"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: carry states, configs and manifolds across as numpy arrays."""

import dataclasses

import numpy as np
import torch

import nudge_tpu.config as jconfig
import nudge_tpu_torch.config as pconfig
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.state import state_from_numpy

# fields of the JAX SimConfig that the port drops (TPU-only knobs)
DROPPED = {"xla_solver_max_bodies", "aligned_fast_path"}


def tree(obj):
    """Nested dict of numpy arrays from a flax struct / dataclass tree."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if getattr(obj, f.name) is not None}
    return np.asarray(obj)


def to_port_state(jstate, device="cpu"):
    return state_from_numpy(tree(jstate), device)


def jax_cfg(pcfg, **kw):
    """The JAX config equal to a port config, on the plain XLA path."""
    fields = {f.name: getattr(pcfg, f.name)
              for f in dataclasses.fields(pconfig.SimConfig)}
    fields.update(solver="xla", aligned_fast_path=False)
    fields.update(kw)
    return jconfig.SimConfig(**fields)


def port_manifolds(jman):
    """Port Manifolds with the same contents as a JAX Manifolds."""
    kw = {}
    for f in dataclasses.fields(pcontacts.Manifolds):
        v = getattr(jman, f.name)
        kw[f.name] = None if v is None else torch.from_numpy(
            np.array(v))
    return pcontacts.Manifolds(**kw)


def jax_manifolds(pman):
    import jax.numpy as jnp

    kw = {}
    for f in dataclasses.fields(jcontacts.Manifolds):
        v = getattr(pman, f.name)
        kw[f.name] = None if v is None else jnp.asarray(v.cpu().numpy())
    return jcontacts.Manifolds(**kw)


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(a, b, name=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=name)


def assert_close(a, b, atol, name=""):
    np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=atol,
                               err_msg=name)


__all__ = ["tree", "to_port_state", "jax_cfg", "port_manifolds",
           "jax_manifolds", "assert_equal", "assert_close", "np_"]
