"""Built-in vectorized environments of the RL plane (the port of
``tpucfn/rl/env.py``).

Each env is a handful of tensor ops on its device, so a rollout steps
every env copy at once on the card and never waits on the host: a
K-armed contextual bandit (the observation is the arm-mean vector, so
the best policy is learnable in a handful of updates: the smoke
workload) and a small gridworld (multi-step credit assignment for the
A2C path).

Contract (both envs, and anything user-supplied to the actor):

* ``reset(generator) -> (state, obs)``: ``state`` is a dict of tensors
  with leading dim ``num_envs``; ``obs`` is ``[num_envs, obs_dim]``
  float32.
* ``step(state, action, generator) -> (state, obs, reward, done)``:
  shape-static and **auto-resetting**: a done env is respawned from
  ``generator`` inside the same call (the rollout never branches on
  done).  Every tensor stays on the env's ``device``.
* Everything is a deterministic function of ``(state, action, generator
  state)``: the draws come from the generator the caller passes, in a
  fixed order, never from a global stream.  The draws differ from JAX's
  threefry ones; the dynamics given the draws are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from tpucfn_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BanditEnv:
    """Vectorized K-armed bandit with observable arm means.

    Every episode is one step: the observation is the per-arm mean
    vector (drawn uniform [0,1) at reset), reward is the chosen arm's
    mean, and the episode ends immediately; auto-reset redraws the
    means.  The optimal policy ("pick the argmax of the obs") is
    learnable by a linear layer, so return curves move within tens of
    updates.
    """

    num_envs: int = 8
    num_arms: int = 4
    device: str | torch.device = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def obs_dim(self) -> int:
        return self.num_arms

    @property
    def num_actions(self) -> int:
        return self.num_arms

    def _draw(self, generator: torch.Generator) -> torch.Tensor:
        return torch.rand((self.num_envs, self.num_arms), generator=generator,
                          device=self.device, dtype=torch.float32)

    def reset(self, generator: torch.Generator):
        means = self._draw(generator)
        return {"means": means}, means

    def step(self, state, action: torch.Tensor, generator: torch.Generator):
        means = state["means"]
        reward = means.gather(1, action[:, None].long())[:, 0]
        done = torch.ones((self.num_envs,), dtype=torch.bool,
                          device=self.device)
        # one-step episodes: auto-reset IS the transition
        new_means = self._draw(generator)
        return {"means": new_means}, new_means, reward, done


@dataclasses.dataclass(frozen=True)
class GridWorldEnv:
    """Vectorized ``size``×``size`` gridworld: reach the goal cell.

    Observation is ``[row, col, goal_row, goal_col] / (size-1)`` (4
    floats); actions are up/down/left/right with wall clamping; reward
    is +1 on reaching the goal (episode done) and a -0.05 living cost
    otherwise; episodes also time out at ``horizon`` steps.  Done envs
    auto-reset to a fresh random start/goal drawn from the generator.
    """

    num_envs: int = 8
    size: int = 5
    horizon: int = 20
    device: str | torch.device = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def obs_dim(self) -> int:
        return 4

    @property
    def num_actions(self) -> int:
        return 4

    def _spawn(self, generator: torch.Generator):
        # start first, then goal: the JAX package's order of draws
        kw = dict(generator=generator, device=self.device, dtype=torch.int32)
        pos = torch.randint(0, self.size, (self.num_envs, 2), **kw)
        goal = torch.randint(0, self.size, (self.num_envs, 2), **kw)
        # a spawn on the goal would be a zero-length episode; shift one
        # column (wrapping) so start != goal always holds
        clash = (pos == goal).all(dim=1, keepdim=True)
        shifted = torch.stack([pos[:, 0], (pos[:, 1] + 1) % self.size], 1)
        return torch.where(clash, shifted, pos), goal

    def _obs(self, state):
        denom = float(max(self.size - 1, 1))
        return torch.cat([state["pos"].to(torch.float32) / denom,
                          state["goal"].to(torch.float32) / denom], dim=1)

    def reset(self, generator: torch.Generator):
        pos, goal = self._spawn(generator)
        state = {"pos": pos, "goal": goal,
                 "t": torch.zeros((self.num_envs,), dtype=torch.int32,
                                  device=self.device)}
        return state, self._obs(state)

    def step(self, state, action: torch.Tensor, generator: torch.Generator):
        # up, down, left, right: (-1, 0), (1, 0), (0, -1), (0, 1)
        drow = (action == 1).to(torch.int32) - (action == 0).to(torch.int32)
        dcol = (action == 3).to(torch.int32) - (action == 2).to(torch.int32)
        pos = (state["pos"] + torch.stack([drow, dcol], 1)).clamp(
            0, self.size - 1)
        at_goal = (pos == state["goal"]).all(dim=1)
        t = state["t"] + 1
        done = at_goal | (t >= self.horizon)
        reward = torch.where(at_goal, 1.0, -0.05).to(torch.float32)
        # auto-reset: done lanes get a fresh spawn and a zeroed clock
        new_pos, new_goal = self._spawn(generator)
        d2 = done[:, None]
        state = {
            "pos": torch.where(d2, new_pos, pos),
            "goal": torch.where(d2, new_goal, state["goal"]),
            "t": torch.where(done, 0, t),
        }
        return state, self._obs(state), reward, done


ENVS = {"bandit": BanditEnv, "gridworld": GridWorldEnv}


def make_env(name: str, num_envs: int, *,
             device: str | torch.device = "cuda"):
    """Build one of the built-in envs by registry name, on ``device``."""
    try:
        cls = ENVS[name]
    except KeyError:
        raise ValueError(
            f"unknown rl env {name!r}; built-ins: {sorted(ENVS)}") from None
    return cls(num_envs=num_envs, device=device)
