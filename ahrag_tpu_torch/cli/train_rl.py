"""Action-frequency policy trainer: the minimal baseline policy, a
probability distribution over actions counted from trajectories.

    python -m ahrag_tpu_torch.cli.train_rl [--traj FILE.jsonl] [--out FILE.json]

The port's copy of ``ahrag_tpu/cli/train_rl.py`` (host Python, no device).
A trajectory line that does not parse is skipped (``utils/parse.json_or_none``).
"""
from __future__ import annotations

import argparse
import json
import os
from collections import Counter

from ahrag_tpu_torch.utils.parse import json_or_none


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train the action-frequency policy")
    ap.add_argument("--traj", default="artifacts/rl/trajectories.jsonl")
    ap.add_argument("--out", default="artifacts/rl/policy.json")
    args = ap.parse_args(argv)
    if not os.path.exists(args.traj):
        raise SystemExit(f"Trajectory file not found: {args.traj}")
    counts: Counter = Counter()
    total = 0
    with open(args.traj, "r", encoding="utf-8") as f:
        for line in f:
            obj = json_or_none(line)
            if obj is None:
                continue
            for s in obj.get("steps", []):
                a = s.get("action")
                if isinstance(a, int):
                    counts[a] += 1
                    total += 1
    if total == 0:
        raise SystemExit("No steps found in trajectories")
    policy = {str(a): c / total for a, c in counts.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump({"action_probs": policy}, f, indent=2)
    print(f"Saved naive policy to {args.out}")


if __name__ == "__main__":
    main()
