"""The port's RL envs (``tpucfn_torch/rl/env.py``) against the JAX
package's (``tpucfn/rl/env.py``): the env contract, the bandit's reward,
and a gridworld step from the same state and actions.

The random draws cannot match (a torch generator against JAX's
threefry), so the comparison is of everything the draws do not decide:
the bandit's reward from given means is the chosen arm's mean exactly,
and a gridworld step from a given state gives bit-equal positions,
goals, clocks, observations, rewards and done flags on every lane that
is not done; a done lane gets a fresh spawn (start != goal, clock 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.rl.env import make_env as jax_make_env
from tpucfn_torch.rl.env import ENVS, BanditEnv, GridWorldEnv, make_env


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("name", ["bandit", "gridworld"])
def test_env_contract(name):
    env = make_env(name, num_envs=8, device="cpu")
    state, obs = env.reset(_gen(0))
    assert obs.shape == (8, env.obs_dim) and obs.dtype == torch.float32
    action = torch.zeros((8,), dtype=torch.int64)
    state2, obs2, reward, done = env.step(state, action, _gen(1))
    assert obs2.shape == (8, env.obs_dim)
    assert reward.shape == done.shape == (8,)
    assert reward.dtype == torch.float32 and done.dtype == torch.bool
    assert all(v.shape[0] == 8 for v in state2.values())
    # a function of (state, action, generator state): same in, same bits out
    _, obs3, reward3, done3 = env.step(state, action, _gen(1))
    assert torch.equal(obs2, obs3) and torch.equal(reward, reward3)
    assert torch.equal(done, done3)
    # the same as the JAX package's env: sizes and the registry
    ref = jax_make_env(name, num_envs=8)
    assert (env.obs_dim, env.num_actions) == (ref.obs_dim, ref.num_actions)


def test_envs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    for cls in ENVS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(num_envs=2)


def test_bandit_reward_is_chosen_arm_mean():
    rs = np.random.RandomState(0)
    means = rs.uniform(size=(6, 4)).astype(np.float32)
    action = rs.randint(0, 4, size=6)
    want = means[np.arange(6), action]
    env = BanditEnv(num_envs=6, device="cpu")
    _, _, reward, done = env.step({"means": torch.from_numpy(means)},
                                  torch.from_numpy(action), _gen(1))
    assert np.array_equal(reward.numpy(), want)
    assert bool(done.all())  # 1-step episodes, auto-reset
    ref = jax_make_env("bandit", num_envs=6)
    _, _, jreward, jdone = ref.step({"means": jnp.asarray(means)},
                                    jnp.asarray(action, jnp.int32),
                                    jax.random.key(1))
    assert np.array_equal(reward.numpy(), np.asarray(jreward))
    assert np.array_equal(done.numpy(), np.asarray(jdone))


def _grid_case(n=64, seed=0):
    """States whose steps end some episodes at the goal, some at the
    horizon, and leave the rest running."""
    rs = np.random.RandomState(seed)
    pos = rs.randint(0, 5, size=(n, 2)).astype(np.int32)
    goal = rs.randint(0, 5, size=(n, 2)).astype(np.int32)
    goal[np.all(pos == goal, axis=1), 1] ^= 1
    # a quarter: goal one step below (action 1 reaches it)
    q = n // 4
    pos[:q, 0] = np.minimum(pos[:q, 0], 3)
    goal[:q] = pos[:q] + [1, 0]
    t = rs.randint(0, 20, size=n).astype(np.int32)
    t[q:2 * q] = 19  # these time out
    action = rs.randint(0, 4, size=n).astype(np.int32)
    action[:q] = 1
    return pos, goal, t, action


def test_gridworld_step_matches_jax():
    pos, goal, t, action = _grid_case()
    n = len(pos)
    ref = jax_make_env("gridworld", num_envs=n)
    js, jobs, jrew, jdone = ref.step(
        {"pos": jnp.asarray(pos), "goal": jnp.asarray(goal),
         "t": jnp.asarray(t)}, jnp.asarray(action), jax.random.key(3))
    env = GridWorldEnv(num_envs=n, device="cpu")
    ts, tobs, trew, tdone = env.step(
        {"pos": torch.from_numpy(pos), "goal": torch.from_numpy(goal),
         "t": torch.from_numpy(t)}, torch.from_numpy(action).long(), _gen(3))
    done = np.asarray(jdone)
    # reward and done are decided before the reset: equal on every lane
    assert np.array_equal(tdone.numpy(), done)
    assert np.array_equal(trew.numpy(), np.asarray(jrew))
    assert 0 < done.sum() < n and (np.asarray(jrew) == 1.0).any()
    live = ~done
    for k in ("pos", "goal", "t"):
        assert np.array_equal(ts[k].numpy()[live], np.asarray(js[k])[live]), k
    assert np.array_equal(tobs.numpy()[live], np.asarray(jobs)[live])
    # done lanes: a fresh spawn, start != goal, clock 0, obs from it
    assert (ts["t"].numpy()[done] == 0).all()
    assert not np.all(ts["pos"].numpy()[done] == ts["goal"].numpy()[done],
                      axis=1).any()
    assert torch.equal(tobs, env._obs(ts))


def test_gridworld_spawn_never_on_the_goal():
    env = GridWorldEnv(num_envs=4096, size=2, device="cpu")
    state, obs = env.reset(_gen(0))
    assert not bool((state["pos"] == state["goal"]).all(dim=1).any())
    assert obs.min() >= 0 and obs.max() <= 1


def test_gridworld_reaches_goal():
    env = make_env("gridworld", num_envs=1, device="cpu")
    state, obs = env.reset(_gen(3))
    total = 0.0
    for _ in range(2 * env.size):
        row, col, gr, gc = [float(v) * (env.size - 1) for v in obs[0]]
        if row < gr:
            a = 1  # down
        elif row > gr:
            a = 0  # up
        elif col < gc:
            a = 3  # right
        else:
            a = 2  # left
        state, obs, reward, done = env.step(
            state, torch.tensor([a]), _gen(7))
        total += float(reward[0])
        if bool(done[0]):
            break
    assert bool(done[0])
    assert total > 0  # goal bonus beats living cost on the direct path


def test_make_env_error_matches_the_reference():
    with pytest.raises(ValueError) as ours:
        make_env("cartpole", 4, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_make_env("cartpole", 4)
    assert str(ours.value) == str(theirs.value)
