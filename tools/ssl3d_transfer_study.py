"""3D SSL transfer study at sandbox-max scale (VERDICT r3 item #3).

Round 3 reported an honest negative: BYOL3D pretraining did NOT beat scratch
on the volumetric fine-tune (dice 0.797 vs 0.824 at 100% labels) — with the
analysis blaming (a) a 32-dim pooled embedding (features 8/16/32), (b) a
96-volume unlabeled corpus, (c) batch 8 for 1.4k steps. None of those causes
were tested. This driver tests them: features 32-256 (256-d embedding),
512 unlabeled volumes, batch >= 32, thousands of steps on the real chip, an
LR x tau sweep, and a {scratch, ssl} x label-fraction x seed fine-tune grid.

Stages (idempotent — done-markers in WORKDIR/.stages; delete to redo):
  data      synthesize 96 labeled + 512 unlabeled 3D-lesion volumes + splits
  sweep     short BYOL3D pretrains over (lr, tau); each scored by a short
            10%-label fine-tune (the quantity we actually care about)
  final     long pretrain at the winning (lr, tau)
  grid      {scratch, ssl-final} x fractions x seeds full fine-tunes
  report    JSON + markdown table (ssl3d_study.json)

Every training run is a subprocess of the real CLIs (`mis-train-ssl3d`,
`mis-train-segmentation3d`) — the study exercises exactly what a user runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--labeled", type=int, default=96)
    ap.add_argument("--unlabeled", type=int, default=512)
    ap.add_argument("--hw", type=int, default=96)
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--crop", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="train crop passed to both trainers (must fit inside the volume)")
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256),
                    help="3D encoder widths; last = pooled embedding dim "
                         "(round-3 negative used 8/16/32 -> 32-d)")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--sweep", default="1.0:0.99,0.3:0.99,0.3:0.996",
                    help="comma list of lr:tau pretrain configs")
    ap.add_argument("--sweep_epochs", type=int, default=100)
    ap.add_argument("--final_epochs", type=int, default=400)
    ap.add_argument("--select_epochs", type=int, default=60,
                    help="fine-tune length used to score sweep checkpoints")
    ap.add_argument("--finetune_epochs", type=int, default=100)
    ap.add_argument("--finetune_batch", type=int, default=8)
    ap.add_argument("--fractions", default="10,25,100")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--select_fraction", type=int, default=10)
    ap.add_argument("--timeout", type=int, default=5400, help="per-run kill timer (s)")
    return ap.parse_args(argv)




_STALL_S = 600       # no-log-growth kill threshold (epochs log every ~5-60 s;
                     # must also cover a cold first compile of the 3D program)
_RETRY_BACKOFF = (180, 900)  # seconds to wait before each retry


def _run(cmd: List[str], log: str, timeout: int) -> None:
    """Run one trainer subprocess with a hard timeout, a LOG-STALL watchdog,
    and resume-aware retries.

    The watchdog exists because a trainer on a hung device never exits on
    its own — it keeps enqueueing host batches until the OOM-killer takes
    the whole machine. Killing on "log hasn't grown for _STALL_S" bounds the
    damage to minutes,
    and because pretrains pass --resume (and fine-tunes are short), a retry
    after a cool-down loses at most the epochs since the last checkpoint.
    """
    # Prepend (not replace) so entries already on PYTHONPATH survive into
    # the trainer subprocesses. The trainers share one persistent compile
    # cache (core/runtime.py), so only shape-distinct runs pay a compile.
    pp = os.environ.get("PYTHONPATH", "")
    env = {**os.environ, "PYTHONPATH": REPO + (os.pathsep + pp if pp else "")}

    for attempt in range(len(_RETRY_BACKOFF) + 1):
        print(f"[study] $ {' '.join(cmd)} > {log}"
              + (f" (attempt {attempt + 1})" if attempt else ""), file=sys.stderr)
        with open(log, "w" if attempt == 0 else "a") as f:
            p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                 cwd=REPO, env=env)
            t0 = last_change = time.time()
            last_sz = -1
            while True:
                try:
                    rc = p.wait(timeout=15)
                    break
                except subprocess.TimeoutExpired:
                    pass
                now = time.time()
                try:
                    sz = os.path.getsize(log)
                except OSError:
                    sz = 0
                if sz != last_sz:
                    last_sz, last_change = sz, now
                if now - t0 > timeout or now - last_change > _STALL_S:
                    why = ("timeout" if now - t0 > timeout else
                           f"no log growth for {int(now - last_change)}s "
                           "(hung device?)")
                    print(f"[study] KILLING run: {why}", file=sys.stderr)
                    p.kill()
                    p.wait()
                    rc = -9
                    break
        if rc == 0:
            return
        if attempt < len(_RETRY_BACKOFF):
            wait = _RETRY_BACKOFF[attempt]
            print(f"[study] rc={rc}; waiting {wait}s for the device to clear, "
                  f"then retrying", file=sys.stderr)
            time.sleep(wait)
    tail = open(log).read()[-2000:]
    raise SystemExit(f"[study] FAILED rc={rc}: {' '.join(cmd)}\n{tail}")


def _final_metric(log_dir: str, names: Sequence[str]) -> Dict[str, float]:
    csvs = sorted(glob.glob(os.path.join(log_dir, "lightning_logs", "version_*", "metrics.csv")))
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


def _latest_ckpt(ckpt_dir: str) -> str:
    steps = [d for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not steps:
        raise SystemExit(f"[study] no checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, max(steps, key=int))


class Stages:
    def __init__(self, ws: str):
        self.dir = os.path.join(ws, ".stages")
        os.makedirs(self.dir, exist_ok=True)

    def done(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.dir, name + ".done"))

    def mark(self, name: str) -> None:
        open(os.path.join(self.dir, name + ".done"), "w").write(str(time.time()))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    ws = os.path.abspath(args.workdir)
    os.makedirs(ws, exist_ok=True)
    st = Stages(ws)
    py = sys.executable
    vol = ["--volume_size", str(args.depth), str(args.hw), str(args.hw),
           "--crop_size", *(str(c) for c in args.crop)]
    data_dir = os.path.join(ws, "data")
    img_dir, lbl_dir = os.path.join(data_dir, "imagesTr"), os.path.join(data_dir, "labelsTr")
    unl_dir = os.path.join(data_dir, "unlabeledTr")
    splits = os.path.join(ws, "splits")

    # --- data ---
    if not st.done("data"):
        _run([py, os.path.join(REPO, "tools", "make_synthetic_dataset.py"),
              "--output_dir", data_dir, "--n_volumes", str(args.labeled),
              "--unlabeled_volumes", str(args.unlabeled), "--lesion3d",
              "--hw", str(args.hw), "--depth", str(args.depth)],
             os.path.join(ws, "data.log"), args.timeout)
        _run([py, "-m", "medical_image_segmentation_tpu.data.ingest.create_splits",
              "--images_dir", img_dir, "--output_dir", splits],
             os.path.join(ws, "splits.log"), args.timeout)
        st.mark("data")

    feats = [str(f) for f in args.features]

    def pretrain(tag: str, lr: float, tau: float, epochs: int) -> str:
        ck = os.path.join(ws, f"ckpt_ssl_{tag}")
        if not st.done(f"pretrain_{tag}"):
            # --resume: a VM restart mid-pretrain must not discard epochs
            # already paid for — the trainer no-ops it when the checkpoint
            # dir is empty, so fresh runs are unaffected.
            # --device_cache: the corpus lives in device memory and batches
            # gather on-device, so no host upload sits in the step
            _run([py, "-m", "medical_image_segmentation_tpu.train.train_ssl3d",
                  "--images_dir", unl_dir, *vol, "--resume",
                  "--batch_size", str(args.batch_size),
                  "--max_epochs", str(epochs),
                  "--learning_rate", str(lr), "--ema_momentum", str(tau),
                  "--features", *feats, "--cache_volumes", "--device_cache",
                  "--checkpoint_every_epochs", "50",
                  "--checkpoint_dir", ck,
                  "--log_dir", os.path.join(ws, f"logs_ssl_{tag}")],
                 os.path.join(ws, f"pretrain_{tag}.log"), args.timeout)
            st.mark(f"pretrain_{tag}")
        return _latest_ckpt(ck)

    def finetune(tag: str, split_file: str, epochs: int, seed: int,
                 ssl_ckpt: Optional[str]) -> Dict[str, float]:
        log_dir = os.path.join(ws, f"logs_seg_{tag}")
        # Clamp the batch to the split's train-set size: drop-last batching
        # at batch > n_train runs ZERO steps/epoch — the trainer now refuses
        # that outright, and an early version of this study silently scored
        # untrained models on the 10% split (6 volumes < batch 8) because of
        # it. The clamp keeps small-fraction runs meaningful.
        n_train = len(json.load(open(split_file))["train"])
        batch = max(1, min(args.finetune_batch, n_train))
        if not st.done(f"seg_{tag}"):
            cmd = [py, "-m", "medical_image_segmentation_tpu.train.train_segmentation3d",
                   "--images_dir", img_dir, "--masks_dir", lbl_dir,
                   "--split_file", split_file, *vol,
                   "--batch_size", str(batch),
                   "--max_epochs", str(epochs), "--seed", str(seed),
                   "--features", *feats, "--cache_volumes", "--device_cache",
                   # per-epoch val passes dominate short epochs; the
                   # final-epoch eval + test still produce every metric the
                   # report reads
                   "--eval_every_epochs", "10",
                   "--checkpoint_every_epochs", "0",
                   "--checkpoint_dir", os.path.join(ws, f"ckpt_seg_{tag}"),
                   "--log_dir", log_dir]
            if ssl_ckpt:
                cmd += ["--ssl_checkpoint", ssl_ckpt]
            _run(cmd, os.path.join(ws, f"seg_{tag}.log"), args.timeout)
            st.mark(f"seg_{tag}")
        return _final_metric(log_dir, ["test/dice", "test/iou", "val/dice"])

    report: Dict[str, object] = {"config": vars(args).copy()}
    out = os.path.join(ws, "ssl3d_study.json")

    def dump() -> None:
        json.dump(report, open(out, "w"), indent=2)

    # --- sweep: score each (lr, tau) by a short low-label fine-tune ---
    sel_split = os.path.join(splits, f"split_{args.select_fraction}_percent_train.json")
    sweep_rows = []
    for spec in args.sweep.split(","):
        lr, tau = (float(x) for x in spec.split(":"))
        tag = f"lr{lr}_tau{tau}".replace(".", "p")
        ck = pretrain(tag, lr, tau, args.sweep_epochs)
        m = finetune(f"sel_{tag}", sel_split, args.select_epochs, 0, ck)
        loss = _final_metric(os.path.join(ws, f"logs_ssl_{tag}"), ["loss"])
        sweep_rows.append({"lr": lr, "tau": tau, "ckpt": ck,
                           "byol_loss": loss.get("loss"), **m})
        report["sweep"] = sweep_rows
        dump()
        print(f"[study] sweep {tag}: {m}", file=sys.stderr)
    best = max(sweep_rows, key=lambda r: r.get("test/dice", -1.0))
    report["best"] = {"lr": best["lr"], "tau": best["tau"]}
    dump()
    print(f"[study] sweep winner: lr={best['lr']} tau={best['tau']} "
          f"(10%-label dice {best.get('test/dice')})", file=sys.stderr)

    # --- final long pretrain at the winner; the checkpoint dir carries the
    # winner's tag so a re-scored sweep that changes the winner can never
    # silently resume another config's weights ---
    best_tag = f"lr{best['lr']}_tau{best['tau']}".replace(".", "p")
    final_ck = pretrain(f"final_{best_tag}", best["lr"], best["tau"], args.final_epochs)

    # --- grid: {scratch, ssl} x fractions x seeds ---
    rows = []
    for frac in (int(f) for f in args.fractions.split(",")):
        split_file = os.path.join(splits, f"split_{frac}_percent_train.json")
        for seed in (int(s) for s in args.seeds.split(",")):
            for init, ck in (("scratch", None), ("ssl", final_ck)):
                tag = f"{init}_{frac}pct_s{seed}"
                m = finetune(tag, split_file, args.finetune_epochs, seed, ck)
                rows.append({"init": init, "label_fraction": frac, "seed": seed, **m})
                report["grid"] = rows
                dump()
                print(f"[study] grid {tag}: {m}", file=sys.stderr)

    # markdown summary: mean over seeds per (init, fraction)
    agg: Dict[tuple, List[float]] = {}
    for r in rows:
        if "test/dice" in r:
            agg.setdefault((r["label_fraction"], r["init"]), []).append(r["test/dice"])
    lines = ["| Labels | scratch dice | SSL dice | Δ |", "|---|---|---|---|"]
    for frac in sorted({k[0] for k in agg}):
        s = agg.get((frac, "scratch"), [float("nan")])
        e = agg.get((frac, "ssl"), [float("nan")])
        sm, em = sum(s) / len(s), sum(e) / len(e)
        lines.append(f"| {frac}% | {sm:.4f} | {em:.4f} | {em - sm:+.4f} |")
    print("\n".join(lines))
    print(f"full report: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
