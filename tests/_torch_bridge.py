"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: carry states, configs and manifolds across as numpy arrays, and
build the same test scene in both packages."""

import dataclasses

import numpy as np
import torch

import nudge_tpu.config as jconfig
import nudge_tpu_torch.config as pconfig
from nudge_tpu import scenes as jscenes
from nudge_tpu.ops import contacts as jcontacts
from nudge_tpu_torch import scenes as pscenes
from nudge_tpu_torch.ops import contacts as pcontacts
from nudge_tpu_torch.state import state_from_numpy, state_to_numpy

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
    """The port state holding a JAX SimState, a batch of them (a leading
    scene or chunk axis on every leaf) or an EnvState (of either package)
    as a port `envs.EnvState`."""
    from nudge_tpu_torch.envs import EnvState

    d = tree(jstate)
    if "sim" not in d:
        return state_from_numpy(d, device)
    return EnvState(sim=state_from_numpy(d["sim"], device),
                    goal=torch.from_numpy(np.array(d["goal"])).to(device),
                    t=torch.from_numpy(np.array(d["t"])).to(device))


def to_jax_state(pstate, jcfg):
    """The JAX SimState holding a port state. The port does not model the
    persistent broadphase's tight-list memo: those fields come from the JAX
    `empty_bp_cache`, with memo_ok False (the reference then recomputes
    the tight list)."""
    import jax.numpy as jnp
    from nudge_tpu import state as jstate
    from nudge_tpu.ops import persistent_bp as jpbp

    d = state_to_numpy(pstate)
    classes = dict(bodies=jstate.Bodies, boxes=jstate.Boxes,
                   spheres=jstate.Spheres, cache=jstate.ContactCache,
                   sleep=jstate.SleepState, colors=jstate.ColorCache)
    kw = {g: cls(**{k: jnp.asarray(v) for k, v in d[g].items()})
          for g, cls in classes.items()}
    memo = jpbp.empty_bp_cache(jcfg, d["bodies"]["pos"].shape[0])
    bp = {f.name: getattr(memo, f.name) for f in dataclasses.fields(memo)}
    bp.update({k: jnp.asarray(v) for k, v in d["bp"].items()})
    kw["bp"] = jpbp.BPCache(**bp)
    return jstate.SimState(connections=jnp.asarray(d["connections"]),
                           step_count=jnp.asarray(d["step_count"]), **kw)


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


def pressed_mixed_pile(n=120, **over):
    """A mixed pile (walls, grid broadphase) pressed into resting columns:
    each body sits on the one below it (or on the ground) 5 mm deep, so
    that box-box, box-sphere and sphere-sphere contacts exist from step 0,
    in both packages. Returns (port cfg, JAX cfg, JAX state, port state)."""
    import jax.numpy as jnp

    pb = pscenes.scene_pile(n, sphere_frac=0.3, seed=5, walls=True)
    pcfg = pb.auto_config(broadphase="grid", **over)
    jcfg = jax_cfg(pcfg)
    jst = jscenes.scene_pile(n, sphere_frac=0.3, seed=5,
                             walls=True).finalize(jcfg)
    pos = np.array(jst.bodies.pos)
    half_y = np.full(pos.shape[0], 0.5)
    sph = np.asarray(jst.spheres.body)
    half_y[sph[sph >= 0]] = np.asarray(jst.spheres.radius)[sph >= 0]
    cols = int(np.ceil(n ** (1 / 3))) ** 2        # scene_pile's grid columns
    top = np.zeros(cols)
    for k in range(n):                            # body 0 is the ground
        c, body = k % cols, k + 1
        pos[body, 1] = top[c] + half_y[body] - 0.005
        top[c] = pos[body, 1] + half_y[body]
    jst = jst.replace(bodies=jst.bodies.replace(pos=jnp.asarray(pos)))
    return pcfg, jcfg, jst, to_port_state(jst)


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(a, b, name=""):
    np.testing.assert_array_equal(np_(a), np_(b), err_msg=name)


def assert_close(a, b, atol, name=""):
    np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=atol,
                               err_msg=name)


# positions after a few steps: every stage agrees to float32 rounding (the
# reference contracts multiply-adds into FMAs), the solve's 20 sweeps grow
# that to ~1e-6, and a step integrates it once
POS_ATOL = 1e-4


def _by_feature(man):
    """Each manifold's points in feature-id order (invalid points last)."""
    pv = np_(man.point_valid)
    key = np.where(pv, np_(man.feat), np.iinfo(np.int32).max)
    order = np.argsort(key, axis=1, kind="stable")

    def take(x):
        x = np_(x)
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return np.take_along_axis(x, idx, axis=1)

    return {f: take(getattr(man, f))
            for f in ("point_valid", "feat", "depth", "pos")}


def assert_manifolds_match(pman, jman, where, atol=1e-5):
    """Manifold slots equal slot for slot. Inside a manifold the points are
    matched by feature id: the reference's XLA program contracts
    multiply-adds into FMAs, so where the 4-point box-box reduction meets
    an exact tie the two may store the tied points in swapped slots
    (ROADMAP Queue 3); floats within `atol`."""
    for f in ("body_a", "body_b", "ga", "gb", "valid", "count", "overflow",
              "overflow_bits", "pair_demand"):
        assert_equal(getattr(pman, f), getattr(jman, f), f"{where} man.{f}")
    p, j = _by_feature(pman), _by_feature(jman)
    pv = j["point_valid"]
    assert_equal(p["point_valid"], pv, f"{where} man.point_valid")
    assert_equal(p["feat"][pv], j["feat"][pv], f"{where} man.feat")
    for f in ("depth", "pos"):
        assert_close(p[f][pv], j[f][pv], atol, f"{where} man.{f}")


def metrics_np(m):
    """{field: numpy array} of stacked StepMetrics of either package."""
    return {f.name: np_(getattr(m, f.name)) for f in dataclasses.fields(m)}


def rollout_both(scene, steps, **over):
    """`scene(scenes_module)` built by both packages and stepped `steps`
    times from the port's auto_config(**over) (the JAX package on the
    same config, XLA path). Returns (port cfg, port state, port metrics,
    JAX state, JAX metrics), the metrics as numpy."""
    from nudge_tpu import engine as jengine
    from nudge_tpu_torch import engine as pengine

    pb = scene(pscenes)
    pcfg = pb.auto_config(**over)
    pst, pm = pengine.simulate(pb.finalize(pcfg, device="cpu"), pcfg, steps)
    jcfg = jax_cfg(pcfg)
    jst, jm = jengine.simulate(scene(jscenes).finalize(jcfg), jcfg, steps)
    return pcfg, pst, metrics_np(pm), jst, metrics_np(jm)


def assert_same_trajectory(pst, pm, jst, jm):
    """A few-body rollout of the port held to the JAX package's: the
    integer metrics of every step exactly, the final bodies within
    POS_ATOL."""
    for f in ("contact_count", "overflow", "manifold_demand", "pair_demand"):
        assert_equal(pm[f], jm[f], f)
    for f in ("pos", "quat", "vel", "angvel"):
        assert_close(getattr(pst.bodies, f), getattr(jst.bodies, f),
                     POS_ATOL, f)


__all__ = ["tree", "to_port_state", "to_jax_state", "jax_cfg", "port_manifolds",
           "jax_manifolds", "pressed_mixed_pile", "assert_equal",
           "assert_close", "np_", "POS_ATOL", "metrics_np", "rollout_both",
           "assert_same_trajectory", "assert_manifolds_match"]
