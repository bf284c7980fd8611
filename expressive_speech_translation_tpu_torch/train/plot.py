"""Training-curve extraction/plotting from executor logs.

Parity with plot_training.py (79 LoC): regex-parse ``TRAIN Batch E/S loss …
acc …`` and ``CV info`` lines from one or more logs (:5-24), aggregate per
epoch, and render ``training_curves.png`` (:58-79) — or emit a CSV when
matplotlib is unavailable.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

TRAIN_RE = re.compile(
    r"TRAIN Batch (\d+)/(\d+) loss ([\d.eE+-]+) acc ([\d.eE+-]+)"
)
CV_RE = re.compile(
    r"Epoch (\d+) Step (\d+) CV info loss ([\d.eE+-]+) acc ([\d.eE+-]+)"
)


def parse_logs(paths: List[str | Path]):
    train: List[Tuple[int, int, float, float]] = []
    cv: List[Tuple[int, int, float, float]] = []
    for path in paths:
        for line in Path(path).read_text(errors="replace").splitlines():
            m = TRAIN_RE.search(line)
            if m:
                train.append((int(m[1]), int(m[2]), float(m[3]), float(m[4])))
                continue
            m = CV_RE.search(line)
            if m:
                cv.append((int(m[1]), int(m[2]), float(m[3]), float(m[4])))
    return train, cv


def per_epoch(train) -> Dict[int, Dict[str, float]]:
    acc: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for epoch, _step, loss, a in train:
        acc[epoch].append((loss, a))
    return {
        e: {"loss": sum(x[0] for x in v) / len(v), "acc": sum(x[1] for x in v) / len(v)}
        for e, v in sorted(acc.items())
    }


def write_outputs(train, cv, out_path: str | Path) -> str:
    epochs = per_epoch(train)
    out = Path(out_path)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        if epochs:
            xs = list(epochs)
            ax1.plot(xs, [epochs[e]["loss"] for e in xs], "o-", label="train")
            ax2.plot(xs, [epochs[e]["acc"] for e in xs], "o-", label="train")
        if cv:
            ax1.plot([c[0] for c in cv], [c[2] for c in cv], "s--", label="cv")
            ax2.plot([c[0] for c in cv], [c[3] for c in cv], "s--", label="cv")
        for ax, title in ((ax1, "loss"), (ax2, "accuracy")):
            ax.set_xlabel("epoch"); ax.set_title(title); ax.legend(); ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(out)
        return str(out)
    except Exception:
        csv_path = out.with_suffix(".csv")
        with csv_path.open("w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["epoch", "train_loss", "train_acc", "cv_loss", "cv_acc"])
            cv_by_epoch = {c[0]: c for c in cv}
            for e, stats in per_epoch(train).items():
                c = cv_by_epoch.get(e, (e, 0, "", ""))
                writer.writerow([e, round(stats["loss"], 6), round(stats["acc"], 6), c[2], c[3]])
        return str(csv_path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("logs", nargs="+")
    parser.add_argument("--out", default="training_curves.png")
    args = parser.parse_args(argv)
    train, cv = parse_logs(args.logs)
    written = write_outputs(train, cv, args.out)
    print(f"parsed {len(train)} train lines, {len(cv)} cv lines -> {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
