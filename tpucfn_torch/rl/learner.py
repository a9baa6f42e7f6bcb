"""Learner: a ``Trainer``-backed A2C policy-gradient update (the port of
``tpucfn/rl/learner.py``).

The learner is a :class:`tpucfn_torch.train.Trainer`, with the same
checkpoint layout and data-parallel mean as a supervised run, bound to
an actor-critic loss over the trajectory slabs the replay queue hands
over, and to :func:`tpucfn_torch.train.adam` (optax's ``adam``).

Parameter refresh to the actors is a copy on the device, never a trip
through the host or a checkpoint.  The copy is needed for correctness:
``Trainer.step`` updates the parameters in place (what donation buys
in JAX), so actors holding ``state.params`` themselves would act with
weights that change under them one update later.

The policy/value network is a two-layer MLP as plain functions on a
flat dict of tensors (``torso.kernel``, ``torso.bias``, ``pi.*``,
``v.*``), each kernel ``[in, out]`` as in the JAX package, so
:func:`params_from_jax` carries its weights across unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpucfn_torch.train.optim import adam
from tpucfn_torch.train.trainer import Trainer, TrainerConfig

_LAYERS = ("torso", "pi", "v")


# -- policy/value network ---------------------------------------------------

def mlp_init(generator: torch.Generator, obs_dim: int, num_actions: int,
             hidden: int = 64) -> dict[str, torch.Tensor]:
    """Two-layer torso with separate policy and value heads, He-normal
    kernels and zero biases, on the generator's device."""
    dev = generator.device

    def dense(n_in, n_out):
        kernel = torch.randn((n_in, n_out), generator=generator, device=dev,
                             dtype=torch.float32) * math.sqrt(2.0 / n_in)
        return kernel, torch.zeros((n_out,), dtype=torch.float32, device=dev)

    params = {}
    for name, (n_in, n_out) in zip(_LAYERS, ((obs_dim, hidden),
                                             (hidden, num_actions),
                                             (hidden, 1))):
        params[f"{name}.kernel"], params[f"{name}.bias"] = dense(n_in, n_out)
    return params


def mlp_apply(params, obs):
    """``obs [..., obs_dim] -> (logits [..., A], value [...])``."""
    h = torch.tanh(obs @ params["torso.kernel"] + params["torso.bias"])
    logits = h @ params["pi.kernel"] + params["pi.bias"]
    value = (h @ params["v.kernel"] + params["v.bias"])[..., 0]
    return logits, value


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's ``{torso, pi, v}{kernel, bias}`` tree (numpy or
    jax arrays) as the port's flat params, fp32 on the CPU."""
    return {f"{name}.{leaf}": torch.from_numpy(
                np.array(tree[name][leaf], dtype=np.float32))
            for name in _LAYERS for leaf in ("kernel", "bias")}


# -- A2C loss over [B, T] trajectory slabs ---------------------------------

def make_a2c_loss(gamma: float = 0.99, value_coef: float = 0.5,
                  entropy_coef: float = 0.01):
    """Loss in the Trainer's ``(params, model_state, batch, generator)``
    signature.  ``batch`` is one replay slab: ``obs [B,T,obs_dim]``,
    ``action/reward/done [B,T]``, ``bootstrap [B]``.  Returns are n-step
    discounted-to-go with the bootstrap value closing the truncated
    tail; ``done`` cuts the discount chain at episode ends.
    """

    def loss_fn(params, model_state, batch, generator):
        del generator  # the update is deterministic given the slab
        obs, action = batch["obs"], batch["action"]
        reward, done = batch["reward"], batch["done"]
        logits, values = mlp_apply(params, obs)  # [B,T,A], [B,T]

        # the reverse-time scan per env, over T
        ret = batch["bootstrap"]
        rets = []
        for t in range(reward.shape[1] - 1, -1, -1):
            ret = reward[:, t] + gamma * torch.where(done[:, t], 0.0, ret)
            rets.append(ret)
        returns = torch.stack(rets[::-1], dim=1)  # [B,T]

        logp = torch.log_softmax(logits, dim=-1)
        logp_a = logp.gather(-1, action[..., None].long())[..., 0]
        adv = (returns - values).detach()
        pg_loss = -torch.mean(logp_a * adv)
        v_loss = torch.mean((returns - values) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
        loss = pg_loss + value_coef * v_loss - entropy_coef * entropy
        aux = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
               "reward_mean": torch.mean(reward)}
        return loss, (aux, model_state)

    return loss_fn


class RLLearner:
    """Binds env shape + A2C loss into a Trainer, plus the refresh copy.

    The learner runs on the env's device.  ``mesh`` None: one device.
    With a mesh the Trainer runs data parallel over its ranks (every
    parameter replicated: the catch-all rule places nothing), each rank's
    slab rows its share of the batch, and the update is the mean over the
    ranks.
    """

    def __init__(self, mesh, env, *, hidden: int = 64, lr: float = 1e-2,
                 gamma: float = 0.99, value_coef: float = 0.5,
                 entropy_coef: float = 0.01, seed_split: int = 0):
        from tpucfn_torch.parallel.sharding import ShardingRules

        del seed_split  # reserved for multi-learner variants
        self.mesh = mesh
        self.env = env
        self.apply_fn = mlp_apply

        def init_fn(generator):
            return mlp_init(generator, env.obs_dim, env.num_actions,
                            hidden), {}

        rules = None if mesh is None else ShardingRules(((r".*", ()),))
        self.trainer = Trainer(
            mesh, rules, make_a2c_loss(gamma, value_coef, entropy_coef),
            adam(lr), init_fn, TrainerConfig(donate_state=True),
            device=env.device)

    # -- Trainer pass-throughs --------------------------------------------

    def init(self, seed: int):
        """Fresh state: params from a generator seeded ``seed``."""
        return self.trainer.init(seed)

    def step(self, state, slab):
        """One A2C update on a replay slab (already on the device); the
        state's tensors are updated in place."""
        return self.trainer.step(state, slab)

    # -- actor param refresh ----------------------------------------------

    def refresh(self, state) -> dict[str, torch.Tensor]:
        """The actors' own copy of the current policy params: a clone on
        the device, detached, so the next in-place update cannot change
        what the actors hold."""
        with torch.no_grad():
            return {k: p.detach().clone() for k, p in state.params.items()}
