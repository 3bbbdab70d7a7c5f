"""Behaviour-cloning CLI: train the 2 x 128 MLP policy on trajectories.

    python -m ahrag_tpu_torch.cli.train_bc [--traj FILE.jsonl] [--out FILE]
        [--epochs 5] [--lr 1e-3] [--device cpu]

The port's copy of ``ahrag_tpu/cli/train_bc.py``, over the port's
``agent/bc.train_bc`` on ``--device`` (``cuda`` unless told otherwise); the
checkpoint is the port's own (``torch.save``).
"""
from __future__ import annotations

import argparse
import json

from ahrag_tpu_torch.agent.bc import train_bc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train a BC policy from trajectories")
    ap.add_argument("--traj", default="artifacts/rl/trajectories.jsonl")
    ap.add_argument("--out", default="artifacts/rl/bc_policy.msgpack")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    report = train_bc(args.traj, args.out, epochs=args.epochs, lr=args.lr,
                      device=args.device)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
