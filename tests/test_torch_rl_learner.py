"""The port's learner (``tpucfn_torch/rl/learner.py``) against the JAX
package's (``tpucfn/rl/learner.py``): the MLP forward, the A2C loss with
its aux values and every gradient, three ``RLLearner`` steps from the same
params on the same slabs, ``adam`` against ``optax.adam``, the refresh
copy across an in-place step, and the bandit learning gate.

Weights carry across through ``params_from_jax``; slabs are numpy from a
seed, with episode cuts and a bootstrap.  Tolerances: the forward within
1e-6, the loss, aux and gradients within 1e-5 relative, three learner
steps' losses and params within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tpucfn.mesh import MeshSpec, build_mesh
from tpucfn.rl import RLLearner as JaxRLLearner
from tpucfn.rl import make_a2c_loss as jax_make_a2c_loss
from tpucfn.rl import make_env as jax_make_env
from tpucfn.rl import mlp_apply as jax_mlp_apply
from tpucfn.rl import mlp_init as jax_mlp_init
from tpucfn_torch.rl import (Actor, RLLearner, make_a2c_loss, make_env,
                             mlp_apply, mlp_init, params_from_jax)
from tpucfn_torch.rl.loop import fold_in
from tpucfn_torch.train import adam

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_params(seed=0, obs_dim=4, actions=4, hidden=16):
    tree = jax_mlp_init(jax.random.key(seed), obs_dim, actions, hidden)
    return tree, params_from_jax(jax.tree.map(np.asarray, tree))


def _slab(seed, b=8, t=6, obs_dim=4, actions=4):
    rs = np.random.RandomState(seed)
    done = rs.rand(b, t) < 0.25
    done[0, 2] = done[1, -1] = True  # a cut mid-slab and at the tail
    return {"obs": rs.randn(b, t, obs_dim).astype(np.float32),
            "action": rs.randint(0, actions, (b, t)).astype(np.int32),
            "reward": rs.randn(b, t).astype(np.float32),
            "done": done,
            "value": rs.randn(b, t).astype(np.float32),
            "bootstrap": rs.randn(b).astype(np.float32)}


def _torch(slab):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in slab.items()}


def test_mlp_init_layout():
    g = torch.Generator().manual_seed(0)
    p = mlp_init(g, 4, 3, hidden=16)
    tree, ours = _jax_params(obs_dim=4, actions=3)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    assert all(float(p[f"{n}.bias"].abs().max()) == 0 for n in
               ("torso", "pi", "v"))


def test_mlp_apply_matches_jax():
    tree, params = _jax_params()
    obs = np.random.RandomState(1).randn(8, 6, 4).astype(np.float32)
    jl, jv = jax_mlp_apply(tree, jnp.asarray(obs))
    tl, tv = mlp_apply(params, torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def test_a2c_loss_and_grads_match_jax():
    tree, params = _jax_params()
    slab = _slab(2)
    jloss = jax_make_a2c_loss(gamma=0.9, value_coef=0.5, entropy_coef=0.01)
    (jl, (jaux, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        tree, {}, {k: jnp.asarray(v) for k, v in slab.items()}, None)
    tparams = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    tl, (taux, _) = make_a2c_loss(gamma=0.9, value_coef=0.5,
                                  entropy_coef=0.01)(
        tparams, {}, _torch(slab), None)
    names = list(tparams)
    tgrads = torch.autograd.grad(tl, [tparams[k] for k in names])
    assert _rel(tl.item(), float(jl)) <= REL
    assert set(taux) == set(jaux)
    for k in jaux:
        assert _rel(taux[k].item(), float(jaux[k])) <= REL, k
    jflat = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for k, g in zip(names, tgrads):
        assert _rel(g.numpy(), jflat[k]) <= REL, k


def test_three_learner_steps_match_jax():
    mesh = build_mesh(MeshSpec.for_devices(jax.device_count()))
    jlearner = JaxRLLearner(mesh, jax_make_env("gridworld", 8), hidden=16,
                            lr=3e-2)
    jstate = jlearner.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    learner = RLLearner(None, make_env("gridworld", 8, device="cpu"),
                        hidden=16, lr=3e-2)
    state = learner.init(0)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(params[k])
    for i in range(3):
        slab = _slab(10 + i)
        jstate, jm = jlearner.step(jstate, {k: jnp.asarray(v)
                                            for k, v in slab.items()})
        state, m = learner.step(state, _torch(slab))
        assert _rel(m["loss"].item(), float(jm["loss"])) <= REL, i
        jp = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for k, p in state.params.items():
            assert _rel(p.detach().numpy(), jp[k]) <= REL, (i, k)
    assert state.step == 3


@pytest.mark.parametrize("lr", [1e-2, 5e-2])  # rl train's, the gate's
def test_adam_matches_optax(lr):
    """Four updates of params and grads from a seed (grad scales 1e-4-3).
    Optax takes the bias corrections 1 - b^t in float32 (1 - 0.999 is
    1.3e-5 off there), ``torch.optim.AdamW`` in double: each update
    differs by up to ~1e-5 of itself, under 1e-6 absolute at these
    rates."""
    rs = np.random.RandomState(4)
    params = {"w": rs.randn(6, 5).astype(np.float32),
              "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.01, 3.0, 0.2, 1e-4)]
    tx = optax.adam(lr)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
    ours = adam(lr)
    tp = {k: nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    ost = ours.init(tp)
    for g in grads:
        assert ours.update({k: torch.from_numpy(v.copy())
                            for k, v in g.items()}, ost, tp) is None
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
    group = ost["optimizer"].param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 0.0)


def test_refresh_survives_in_place_step():
    """The refresh copy keeps the actors' params unchanged across a learner
    step that updates the state's tensors in place."""
    env = make_env("bandit", num_envs=8, device="cpu")
    learner = RLLearner(None, env)
    actor = Actor(env, learner.apply_fn, unroll=4)
    state = learner.init(0)
    params = learner.refresh(state)
    before = {k: v.clone() for k, v in params.items()}
    es, obs = actor.reset(torch.Generator().manual_seed(1))
    _, _, traj = actor.rollout(params, es, obs,
                               torch.Generator().manual_seed(2))
    state, _ = learner.step(state, traj)
    assert all(torch.equal(before[k], params[k]) for k in before)
    assert any(not torch.equal(before[k], state.params[k]) for k in before)
    assert all(params[k].data_ptr() != state.params[k].data_ptr()
               for k in params)


def test_learner_improves_bandit():
    """A2C on the bandit: the reward's edge over the uniform policy (the
    slab's mean of all arm means) grows and ends above 0.1 (the JAX
    package's gate, ``tests/test_rl.py``)."""
    env = make_env("bandit", num_envs=8, device="cpu")
    learner = RLLearner(None, env, lr=5e-2)
    actor = Actor(env, learner.apply_fn, unroll=16)
    state = learner.init(0)
    es, obs = actor.reset(torch.Generator().manual_seed(1))
    edge = []
    for it in range(40):
        params = learner.refresh(state)
        es, obs, traj = actor.rollout(
            params, es, obs, torch.Generator().manual_seed(fold_in(7, it)))
        baseline = float(traj["obs"].mean())
        state, metrics = learner.step(state, traj)
        edge.append(float(metrics["reward_mean"]) - baseline)
    assert np.mean(edge[-10:]) > np.mean(edge[:10]) + 0.05
    assert np.mean(edge[-10:]) > 0.1
