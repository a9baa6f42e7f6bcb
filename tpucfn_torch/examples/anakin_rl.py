"""Anakin-style RL on one card (the Podracer layout, arXiv:2104.06272;
the port of ``examples/anakin_rl.py``).

The port's RL plane end to end in one script: actors roll out a
vectorized env (bandit or gridworld) on the same device as the
``Trainer``-backed A2C learner, trajectory slabs pass through the replay
queue on the device, and the actors take the new params as a copy on
the device every iteration.  Checkpoints hold the whole stack (learner
state + env state + queue ring + iteration), so an interrupted run
(``--stop-after``, a preemption drain, or a chaos kill under ``python
-m tpucfn_torch.cli launch``) resumes bit-identically.

    python -m tpucfn_torch.examples.anakin_rl --steps 100        # the card
    python -m tpucfn_torch.examples.anakin_rl --device cpu --steps 20

Flags mirror the training examples (``--steps`` is the iteration
budget); the same loop also ships as ``python -m tpucfn_torch.cli rl
train``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run-dir", default="/tmp/tpucfn-rl",
                   help="checkpoints and per-iteration rows land here")
    p.add_argument("--steps", type=int, default=100,
                   help="act→learn→refresh iterations to run")
    p.add_argument("--env", choices=["bandit", "gridworld"],
                   default="bandit")
    p.add_argument("--num-envs", type=int, default=8,
                   help="vectorized env copies = learner batch size")
    p.add_argument("--unroll", type=int, default=16,
                   help="env steps per rollout slab")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--stop-after", type=int, default=0,
                   help="simulated interruption: halt at iteration N "
                        "without changing the budget; rerunning resumes")
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing checkpoints in --run-dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the CPU")
    args = p.parse_args(argv)

    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.launch import initialize_runtime
    from tpucfn_torch.rl.loop import RLConfig, run_rl_loop

    initialize_runtime(device=resolve_device(args.device))
    run_rl_loop(RLConfig(
        run_dir=args.run_dir, env=args.env, num_envs=args.num_envs,
        unroll=args.unroll, iters=args.steps, hidden=args.hidden,
        lr=args.lr, seed=args.seed, ckpt_every=args.ckpt_every,
        log_every=args.log_every, stop_after=args.stop_after,
        fresh=args.fresh, device=args.device))
    return 0


if __name__ == "__main__":
    from tpucfn_torch.examples.common import exit_process

    exit_process(main())
