"""Analytic policy gradients through the simulator (PyTorch port of
examples/policy_grad.py).

Trains a linear policy for BoxPushEnv by differentiating the mean rollout
return with respect to the policy parameters: the gradient flows through
every contact, friction cone and impulse clamp of the engine
(`differentiable=True`). A batch of 4 rollouts a update runs through
`envs.vec_reset` / `vec_step`; Adam at the reference's rate. Where the
reference splits jax.random keys, each rollout's goal comes from a
torch.Generator seeded from one generator.

    python -m nudge_tpu_torch.examples.policy_grad [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from nudge_tpu_torch.envs import BoxPushEnv, vec_reset, vec_step

HORIZON = 12      # env steps per rollout (x frame_skip physics steps)
BATCH = 4         # rollouts per update
UPDATES = 20
LR = 3e-2


def policy(params, obs):
    """Linear policy on a batch of observations [B, 9] -> actions [B, 2]."""
    return obs @ params["w"].T + params["b"]


def mean_return(env, params, seeds):
    """The mean over the batch of each rollout's summed reward; rollout k's
    goal is drawn from a generator seeded with seeds[k]."""
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    s, obs = vec_reset(env, gens)
    ret = torch.zeros(len(gens), device=obs.device)
    for _ in range(HORIZON):
        s, obs, rew, _done, _ = vec_step(env, s, policy(params, obs))
        ret = ret + rew
    return ret.mean()


def main(argv=None):
    """Train; returns {"return": [mean return per update], "seconds": [per
    update], "w": the final weights}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = BoxPushEnv(horizon=HORIZON, frame_skip=3, differentiable=True,
                     sleeping=False, device=args.device)
    params = {"w": torch.zeros((env.act_size, env.obs_size),
                               device=env.device, requires_grad=True),
              "b": torch.zeros(env.act_size, device=env.device,
                               requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=LR)
    gen = torch.Generator().manual_seed(0)
    hist = {"return": [], "seconds": []}
    for i in range(UPDATES):
        t0 = time.perf_counter()
        seeds = torch.randint(0, 2 ** 62, (BATCH,), generator=gen)
        loss = -mean_return(env, params, seeds)
        opt.zero_grad()
        loss.backward()
        opt.step()
        ret = -float(loss.detach())
        hist["seconds"].append(time.perf_counter() - t0)
        hist["return"].append(ret)
        if i % 4 == 0:
            print(f"update {i:>3}  mean return {ret:8.3f}")
    print(f"final mean return {hist['return'][-1]:.3f} "
          f"(untrained zero policy: ~{-HORIZON * 4.0:.0f})")
    print("w[:, 6:9] (action from goal-bearing features):")
    print(params["w"][:, 6:9].detach().cpu().numpy().round(3))
    hist["w"] = params["w"].detach().cpu().tolist()
    return hist


if __name__ == "__main__":
    main()
