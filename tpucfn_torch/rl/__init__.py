"""The RL plane (the port of ``tpucfn/rl/``): actors and an A2C learner on
one card, the Anakin layout of Podracer (arXiv:2104.06272).

The actors step a vectorized env (bandit or gridworld) and decode the
policy on the same device as the ``Trainer``-backed learner;
trajectory slabs pass through a replay queue on the device; the actors
take new params as a copy on the device after every update.  The loop
is wired into the port's planes: goodput buckets ``act``/``learn``/
``refresh``, ``rl_*`` metrics and trace spans, heartbeats and
whole-stack checkpoint resume, and ``python -m tpucfn_torch.cli rl
train`` runs it, under ``launch`` as well.  It runs on the card unless
the caller asks for the CPU, and launches none of the port's kernels:
the policy is a two-layer MLP.
"""

from tpucfn_torch.rl.actor import Actor
from tpucfn_torch.rl.env import ENVS, BanditEnv, GridWorldEnv, make_env
from tpucfn_torch.rl.learner import (RLLearner, make_a2c_loss, mlp_apply,
                                     mlp_init, params_from_jax)
from tpucfn_torch.rl.loop import RLConfig, RLObs, run_rl_loop
from tpucfn_torch.rl.replay import ReplayQueue

__all__ = [
    "Actor",
    "BanditEnv",
    "ENVS",
    "GridWorldEnv",
    "RLConfig",
    "RLLearner",
    "RLObs",
    "ReplayQueue",
    "make_a2c_loss",
    "make_env",
    "mlp_apply",
    "mlp_init",
    "params_from_jax",
    "run_rl_loop",
]
