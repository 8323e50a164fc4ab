"""Convergence-speed addendum to the 3D SSL transfer study.

The main grid (`tools/ssl3d_transfer_study.py`) fine-tunes for 100 epochs —
long enough that the synthetic lesion task SATURATES (scratch reaches ~0.98
dice from 6 labeled volumes), so final-dice deltas cannot resolve an SSL
benefit. This addendum measures the quantity that still discriminates at the
task ceiling: how FAST each init converges. Same data, same splits, same
final SSL checkpoint, same CLI — only `--max_epochs` shrinks.

Runs {scratch, ssl-final} x --epochs x --seeds on the --fraction% split and
appends an `addendum` section to ssl3d_study.json:

    python tools/ssl3d_convergence_addendum.py --workdir .study_ssl3d
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True, help="the study workdir")
    ap.add_argument("--epochs", default="5,20")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--fraction", type=int, default=10)
    ap.add_argument("--warmup_epochs", type=int, default=2,
                    help="short runs need a short warmup (study default is 10)")
    ap.add_argument("--timeout", type=int, default=1800)
    return ap.parse_args(argv)


def _final_metric(log_dir: str, names: Sequence[str]) -> Dict[str, float]:
    csvs = sorted(glob.glob(os.path.join(log_dir, "lightning_logs",
                                         "version_*", "metrics.csv")))
    if not csvs:
        return {}
    import csv as _csv

    out: Dict[str, float] = {}
    with open(csvs[-1]) as f:
        for row in _csv.DictReader(f):
            for n in names:
                v = row.get(n)
                if v not in (None, ""):
                    out[n] = float(v)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    ws = os.path.abspath(args.workdir)
    py = sys.executable
    report_path = os.path.join(ws, "ssl3d_study.json")
    report = json.load(open(report_path)) if os.path.exists(report_path) else {}

    final_cks = sorted(glob.glob(os.path.join(ws, "ckpt_ssl_final_*")))
    if not final_cks:
        raise SystemExit(f"no final SSL checkpoint under {ws}")
    steps = [d for d in os.listdir(final_cks[-1]) if d.isdigit()]
    ssl_ck = os.path.join(final_cks[-1], max(steps, key=int))
    split = os.path.join(ws, "splits",
                         f"split_{args.fraction}_percent_train.json")
    n_train = len(json.load(open(split))["train"])
    batch = max(1, min(8, n_train))

    pp = os.environ.get("PYTHONPATH", "")
    env = {**os.environ, "PYTHONPATH": REPO + (os.pathsep + pp if pp else "")}
    # the trainers keep their compile cache in <repo>/build/jax_cache, or
    # where JAX_COMPILATION_CACHE_DIR says (core/runtime.py)

    rows = []
    for epochs in (int(e) for e in args.epochs.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            for init, ck in (("scratch", None), ("ssl", ssl_ck)):
                tag = f"add_{init}_{epochs}ep_s{seed}"
                log_dir = os.path.join(ws, f"logs_{tag}")
                cmd = [py, "-m",
                       "medical_image_segmentation_tpu.train.train_segmentation3d",
                       "--images_dir", os.path.join(ws, "data", "imagesTr"),
                       "--masks_dir", os.path.join(ws, "data", "labelsTr"),
                       "--split_file", split,
                       "--volume_size", "64", "96", "96",
                       "--crop_size", "32", "64", "64",
                       "--batch_size", str(batch),
                       "--max_epochs", str(epochs),
                       "--warmup_epochs", str(args.warmup_epochs),
                       "--seed", str(seed),
                       "--features", "32", "64", "128", "256",
                       "--cache_volumes", "--device_cache",
                       "--eval_every_epochs", "0",
                       "--checkpoint_every_epochs", "0",
                       "--checkpoint_dir", os.path.join(ws, f"ckpt_{tag}"),
                       "--log_dir", log_dir]
                if ck:
                    cmd += ["--ssl_checkpoint", ck]
                log = os.path.join(ws, f"{tag}.log")
                print(f"[addendum] $ {' '.join(cmd)}", file=sys.stderr)
                with open(log, "w") as f:
                    rc = subprocess.call(cmd, stdout=f, stderr=subprocess.STDOUT,
                                         cwd=REPO, env=env, timeout=args.timeout)
                if rc != 0:
                    raise SystemExit(f"[addendum] FAILED rc={rc}: see {log}")
                m = _final_metric(log_dir, ["test/dice", "test/iou"])
                rows.append({"init": init, "epochs": epochs, "seed": seed, **m})
                print(f"[addendum] {tag}: {m}", file=sys.stderr)
                report["addendum"] = rows
                json.dump(report, open(report_path, "w"), indent=2)

    lines = ["| fine-tune epochs | scratch dice | SSL dice | Δ |",
             "|---|---|---|---|"]
    for epochs in sorted({r["epochs"] for r in rows}):
        s = [r["test/dice"] for r in rows
             if r["epochs"] == epochs and r["init"] == "scratch" and "test/dice" in r]
        e = [r["test/dice"] for r in rows
             if r["epochs"] == epochs and r["init"] == "ssl" and "test/dice" in r]
        sm, em = sum(s) / len(s), sum(e) / len(e)
        lines.append(f"| {epochs} | {sm:.4f} | {em:.4f} | {em - sm:+.4f} |")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
