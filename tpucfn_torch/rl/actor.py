"""Actor: the env-step + policy-decode rollout on the card (the port of
``Actor`` in ``tpucfn/rl/actor.py``).

The JAX rollout is one XLA program (``lax.scan`` over ``unroll`` steps).
This one is an eager loop of ``unroll`` iterations of (policy forward →
categorical sample → env step) that only queues work on the device: no
value is read back to the host anywhere in it (no ``.item()``, no
Python branch on a device tensor, no host-to-device copy), so the host
runs ahead of the card through the whole slab.  Sampling is Gumbel-max
(``argmax(logits + Gumbel noise)``, what ``jax.random.categorical``
computes) with the noise drawn from the generator the caller passes.

Determinism contract: the rollout is a function of ``(params,
env_state, obs, generator state)``.  The loop seeds a fresh generator
from ``(seed, iteration)`` for each rollout, so a resumed run replays
the uninterrupted one bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits [..., A]``: the argmax of the logits
    plus standard Gumbel noise (int64)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class Actor:
    """Co-located actor: an ``unroll``-step rollout over a vectorized env.

    ``apply_fn(params, obs) -> (logits, value)`` is the policy/value
    forward; ``env`` follows the contract in :mod:`tpucfn_torch.rl.env`.
    :meth:`rollout` returns trajectories shaped ``[num_envs, unroll,
    ...]`` (batch-major: the leading axis is the one the learner splits
    across data-parallel ranks).
    """

    def __init__(self, env: Any, apply_fn: Callable, *, unroll: int = 16):
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        self.env = env
        self.apply_fn = apply_fn
        self.unroll = unroll

    def reset(self, generator: torch.Generator):
        """Initial ``(env_state, obs)``."""
        return self.env.reset(generator)

    @torch.no_grad()
    def rollout(self, params, env_state, obs, generator: torch.Generator):
        """One acting slab, queued on the device without a host sync.

        Returns ``(env_state, obs, traj)`` where ``traj`` carries
        ``obs/action/reward/done/value`` as ``[num_envs, unroll, ...]``
        plus ``bootstrap`` ``[num_envs]``: the learner batch.
        """
        steps = {k: [] for k in ("obs", "action", "reward", "done", "value")}
        for _ in range(self.unroll):
            logits, value = self.apply_fn(params, obs)
            action = sample_categorical(logits, generator)
            env_state, next_obs, reward, done = self.env.step(
                env_state, action, generator)
            for k, v in (("obs", obs), ("action", action), ("reward", reward),
                         ("done", done), ("value", value)):
                steps[k].append(v)
            obs = next_obs
        traj = {k: torch.stack(v, dim=1) for k, v in steps.items()}
        # bootstrap value for the truncated tail of each env's episode
        _, traj["bootstrap"] = self.apply_fn(params, obs)
        return env_state, obs, traj

    @property
    def steps_per_rollout(self) -> int:
        """Env steps advanced by one rollout call (all envs)."""
        return self.unroll * self.env.num_envs
