"""Command line of the port: ``python -m tpucfn_torch.cli serve``.

``serve`` is the single-replica path of ``tpucfn serve``
(``tpucfn/cli/main.py:cmd_serve``): continuous-batching inference over a
workload of token-id prompts (``--prompts`` JSONL with {"tokens": [...]}
rows, or ``--synthetic N`` random prompts) on a random-init Llama
preset, printing the serving metrics snapshot as one JSON line.  It runs
on the card unless ``--device cpu`` is given.  Replicas, speculative
decoding, fault tolerance, the obs server and the compile cache are not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpucfn_torch.serve.engine import LLAMA_PRESETS


def cmd_serve(args) -> int:
    from tpucfn_torch.serve import AdmissionError, Server
    from tpucfn_torch.serve.engine import demo_llama_engine

    cfg, engine = demo_llama_engine(args.preset, seed=args.seed,
                                    max_batch=args.max_batch,
                                    cache_len=args.cache_len,
                                    prefill_width=args.max_prefill_batch,
                                    device=args.device)
    rs = np.random.RandomState(args.seed)
    if args.prompts:
        prompts = []
        with open(args.prompts) as f:
            for line in f:
                if line.strip():
                    prompts.append([int(t) for t in json.loads(line)["tokens"]])
    else:
        lo, _, hi = (args.prompt_len or "4:32").partition(":")
        prompts = [
            rs.randint(0, cfg.vocab_size,
                       rs.randint(int(lo), int(hi or lo) + 1)).tolist()
            for _ in range(args.synthetic)]
    if not prompts:
        print("error: no prompts (use --prompts file or --synthetic N)",
              file=sys.stderr)
        return 2
    server = Server(engine, num_blocks=args.num_blocks,
                    block_size=args.block_size,
                    prefix_cache=args.prefix_cache,
                    max_prefill_batch=args.max_prefill_batch)
    reqs = []
    for p in prompts:
        try:
            reqs.append(server.submit(p, max_new_tokens=args.max_new,
                                      temperature=args.temperature))
        except AdmissionError as e:
            print(f"rejected ({e.status}): {e}", file=sys.stderr)
    server.run_until_idle()
    ok = sum(1 for r in reqs if r.error is None)
    print(f"served {ok}/{len(prompts)} requests "
          f"({len(prompts) - len(reqs)} rejected at submit)", file=sys.stderr)
    print(json.dumps({**server.metrics.snapshot(),
                      "slo": server.slo.snapshot()}))
    return 0 if ok == len(prompts) else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpucfn_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser(
        "serve", help="continuous-batching inference over a prompt workload "
                      "(paged KV cache, bucketed prefills, admission control)")
    sv.add_argument("--preset", choices=LLAMA_PRESETS, default="tiny")
    sv.add_argument("--prompts",
                    help='JSONL file of {"tokens": [ids...]} prompts')
    sv.add_argument("--synthetic", type=int, default=8,
                    help="generate N random prompts instead of --prompts")
    sv.add_argument("--prompt-len", metavar="LO:HI",
                    help="synthetic prompt length range (default 4:32)")
    sv.add_argument("--max-new", type=int, default=16)
    sv.add_argument("--temperature", type=float, default=0.0)
    sv.add_argument("--max-batch", type=int, default=8,
                    help="decode slots (the fixed decode batch shape)")
    sv.add_argument("--cache-len", type=int, default=None,
                    help="per-slot KV capacity in tokens (default: model "
                         "max_seq)")
    sv.add_argument("--num-blocks", type=int, default=256)
    sv.add_argument("--block-size", type=int, default=16)
    sv.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="block-level prompt-prefix caching (--no-prefix-cache "
                         "disables)")
    sv.add_argument("--max-prefill-batch", type=int, default=4,
                    help="same-bucket prefills fused into one call (the "
                         "engine's fixed lane count; 1 disables)")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "attention path)")
    sv.set_defaults(fn=cmd_serve)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
