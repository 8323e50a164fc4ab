"""One-command real-data parity harness vs. the reference framework.

The reference's headline result — BYOL pretraining on a curated 1M-image TCIA
corpus improving Medical-Decathlon fine-tune Dice — was produced on data this
sandbox cannot hold (PHI-adjacent, ~100 GB). This harness converts that
unprovable north star into a ready-to-fire check: point it at mounted
TCIA DICOM trees and a Decathlon task directory and it runs the CANONICAL
sequence end-to-end

    scan -> curate subset -> dataset stats -> store build -> BYOL pretrain
    -> slice Decathlon -> splits -> fine-tune (scratch AND SSL-init, per
    label fraction) -> Dice comparison table

at the reference's CANONICAL pretrain config — batch 2048, 200 epochs,
resnet18 at 112² crops, its own launch script
(``scripts/train/train_ssl_pl_test:5-8``), not its argparse defaults —
and emits ``parity_report.json`` + a markdown table comparing

* measured dataset statistics vs. the reference's published constants
  (its ``lightning_module.py:212-213`` train mean/std 57.9764/60.4759 and
  ``:239-240`` val 126.57/63.46 — config data, cited in
  ``data/datamodules.py``), and
* fine-tuned test Dice, SSL-init vs. scratch, at each label fraction —
  the experiment the reference pipeline exists to run (its
  ``train_segmentation.py:64-68`` hard-codes the Task03_Liver paths;
  here they are flags).

Stages are idempotent: each one is skipped when its output already exists
(delete the workdir or pass ``--fresh`` to redo). ``--smoke`` shrinks every
knob so the whole sequence runs in minutes on synthetic data — that mode is
exercised by ``tests/test_parity.py`` so the harness itself is proven before
real data ever shows up.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

# Reference constants the report compares against (see module docstring).
REFERENCE = {
    "train_mean": 57.9764,
    "train_std": 60.4759,
    # The reference's "val" loader reads the NIH chest-x-ray TEST beton
    # (lightning_module.py:199-200) — a DIFFERENT corpus from the 1M train
    # subset, used by its KNN callback; 126.57/63.46 (:239-240) are that
    # corpus's stats. Measured here when --val_png_dir points at it.
    "val_mean": 126.57,
    "val_std": 63.46,
    # Canonical pretrain = the reference's own launch script
    # (scripts/train/train_ssl_pl_test:5-8: batch 2048, 200 epochs,
    # resnet18) at the datamodule's fixed 112² crop
    # (lightning_module.py:203) — NOT train_ssl.py's argparse defaults.
    "ssl_config": {"batch_size": 2048, "base_lr": 1.0, "warmup_epochs": 10,
                   "max_epochs": 200, "arch": "resnet18", "crop_size": 112},
    # Fine-tune = train_segmentation.py defaults (:17-35); the reference
    # ships no launch script for it.
    "seg_config": {"batch_size": 512, "base_lr": 1.0, "warmup_epochs": 10,
                   "max_epochs": 50, "arch": "resnet18"},
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="run the canonical ingest->pretrain->fine-tune->Dice "
                    "sequence and emit a parity report vs the reference")
    ap.add_argument("--workdir", required=True, help="all intermediate + final outputs")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dicom_dirs", nargs="+", default=None,
                     help="TCIA-style DICOM trees (the reference's "
                          "/scratch/.../med_datasets layout)")
    src.add_argument("--png_dir", default=None,
                     help="already-curated PNG tree (skips scan+curate)")
    ap.add_argument("--decathlon_images", required=True, help="Decathlon imagesTr dir")
    ap.add_argument("--decathlon_labels", required=True, help="Decathlon labelsTr dir")
    ap.add_argument("--subset_size", type=int, default=1_000_000,
                    help="curated-subset target (reference: 1M, "
                         "scripts/create_image_subset:18-19)")
    ap.add_argument("--val_png_dir", default=None,
                    help="curated PNG tree of the reference's KNN-val corpus "
                         "(NIH chest-x-ray test set, lightning_module.py:200); "
                         "builds a val store, measures its stats vs the "
                         "126.57/63.46 constants, and feeds the pretrain's "
                         "KNN callback")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--ssl_epochs", type=int, default=200,
                    help="canonical: 200 (scripts/train/train_ssl_pl_test:7)")
    ap.add_argument("--ssl_batch_size", type=int, default=2048,
                    help="canonical: 2048 (scripts/train/train_ssl_pl_test:6)")
    ap.add_argument("--seg_epochs", type=int, default=50)
    ap.add_argument("--seg_batch_size", type=int, default=512)
    ap.add_argument("--fractions", default="10,25,50,100",
                    help="label fractions to fine-tune at (reference splits: "
                         "10/25/50/100)")
    ap.add_argument("--num_workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--num_processes", type=int, default=None,
                    help="ingest parallelism (default: --num_workers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fresh", action="store_true",
                    help="redo every stage even when outputs exist")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink all knobs for a minutes-long synthetic-data "
                         "run (what tests/test_parity.py executes)")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 end-to-end (CPU smoke runs; default bf16)")
    return ap.parse_args(argv)


def _apply_smoke(args: argparse.Namespace) -> None:
    args.subset_size = min(args.subset_size, 8)
    args.image_size = min(args.image_size, 64)
    args.ssl_epochs = 1
    args.ssl_batch_size = min(args.ssl_batch_size, 8)
    args.seg_epochs = 1
    args.seg_batch_size = min(args.seg_batch_size, 8)
    args.fractions = "100"
    args.fp32 = True


class _Stage:
    """Idempotent stage runner: skip when the done-marker exists."""

    def __init__(self, workdir: str, fresh: bool):
        self.dir = os.path.join(workdir, ".parity_stages")
        os.makedirs(self.dir, exist_ok=True)
        self.fresh = fresh
        self.timings: Dict[str, float] = {}

    def run(self, name: str, fn) -> None:
        marker = os.path.join(self.dir, f"{name}.done")
        if os.path.exists(marker) and not self.fresh:
            print(f"[parity] {name}: done (cached) — delete {marker} to redo",
                  file=sys.stderr)
            return
        print(f"[parity] {name}: running…", file=sys.stderr)
        t0 = time.perf_counter()
        fn()
        self.timings[name] = round(time.perf_counter() - t0, 1)
        with open(marker, "w") as f:
            f.write(f"{self.timings[name]}\n")
        print(f"[parity] {name}: ok ({self.timings[name]} s)", file=sys.stderr)


def _check(rc: Optional[int], what: str) -> None:
    if rc not in (0, None):
        raise SystemExit(f"parity: stage '{what}' failed (rc={rc})")


def _final_metric(log_dir: str, names: Sequence[str]) -> Dict[str, float]:
    """Last logged value of each metric from the newest PL-layout CSV."""
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.smoke:
        _apply_smoke(args)
    nproc = args.num_processes or args.num_workers
    ws = os.path.abspath(args.workdir)
    os.makedirs(ws, exist_ok=True)
    stages = _Stage(ws, args.fresh)
    report: Dict[str, object] = {"reference": REFERENCE, "config": vars(args).copy()}

    from medical_image_segmentation_tpu.data.ingest import (
        compute_stats, create_splits, create_store, create_subset, slice_decathlon)

    # --- 1-2. scan + curate (unless a curated PNG tree was provided) ---
    png_dir = args.png_dir
    if png_dir is None:
        dims, hashes = os.path.join(ws, "dims.json"), os.path.join(ws, "hashes.json")
        subset_dir = os.path.join(ws, "subset")
        stages.run("scan", lambda: (
            _check(create_subset.main(["dicom_sizes", *args.dicom_dirs, "--output", dims,
                                       "--num_processes", str(nproc)]), "dicom_sizes"),
            _check(create_subset.main(["dicom_hashes", *args.dicom_dirs, "--output", hashes,
                                       "--num_processes", str(nproc)]), "dicom_hashes")))
        stages.run("curate", lambda: _check(create_subset.main([
            "write_subset", "--dimensions_map", dims, "--hashes_map", hashes,
            "--output_dir", subset_dir, "--size", str(args.subset_size),
            "--num_processes", str(nproc),
            "--mapping_output", os.path.join(ws, "subset_map.json")]), "write_subset"))
        png_dir = subset_dir

    # --- 3. store build ---
    store = os.path.join(ws, "radiology_train.mis")
    stages.run("store", lambda: _check(create_store.main(
        ["--png_dir", png_dir, "--output", store,
         "--max_resolution", str(args.image_size),
         "--num_workers", str(nproc)]), "create_store"))

    # --- 4. dataset statistics vs the reference constants (0-255 scale, on
    # the built store with the reference's CenterCrop — the same measurement
    # its stale compute_dataset_metrics.py script makes on the .beton) ---
    stats_json = os.path.join(ws, "stats.json")
    stages.run("stats", lambda: _check(compute_stats.main(
        ["--store", store, "--center_crop", str(args.image_size),
         "--output", stats_json]), "compute_stats"))
    stats = json.load(open(stats_json))

    def _scalar(v):
        return v[0] if isinstance(v, list) and len(v) == 1 else v

    report["dataset_stats"] = {
        "measured_mean": _scalar(stats.get("mean")),
        "measured_std": _scalar(stats.get("std")),
        "reference_mean": REFERENCE["train_mean"], "reference_std": REFERENCE["train_std"],
    }

    # --- 4b. val corpus: build + measure vs the 126.57/63.46 constants.
    # The reference's val loader is the NIH chest-x-ray TEST set
    # (lightning_module.py:199-200) — a separate corpus, so it can only be
    # measured when the user mounts it; without it the report says
    # "not measured" instead of silently citing the constants as if checked.
    val_store = None
    if args.val_png_dir:
        val_store = os.path.join(ws, "nih_chest_xray_test.mis")
        val_stats_json = os.path.join(ws, "val_stats.json")
        stages.run("val_store", lambda: _check(create_store.main(
            ["--png_dir", args.val_png_dir, "--output", val_store,
             "--max_resolution", str(args.image_size),
             "--num_workers", str(nproc)]), "create_store (val)"))
        stages.run("val_stats", lambda: _check(compute_stats.main(
            ["--store", val_store, "--center_crop", str(args.image_size),
             "--output", val_stats_json]), "compute_stats (val)"))
        vstats = json.load(open(val_stats_json))
        report["dataset_stats"].update({
            "val_measured_mean": _scalar(vstats.get("mean")),
            "val_measured_std": _scalar(vstats.get("std")),
        })
    report["dataset_stats"].update({
        "val_reference_mean": REFERENCE["val_mean"],
        "val_reference_std": REFERENCE["val_std"],
        "val_measured": bool(val_store),
    })

    # --- 5. BYOL pretrain (canonical SSL config, scaled by flags) ---
    from medical_image_segmentation_tpu.train import train_segmentation, train_ssl

    os.environ["RADIOLOGY_1M_TRAIN_STORE"] = store
    if val_store:
        os.environ["RADIOLOGY_1M_VAL_STORE"] = val_store
    else:
        os.environ.setdefault("RADIOLOGY_1M_VAL_STORE", os.path.join(ws, "no_val.mis"))
    ssl_ckpt_dir = os.path.join(ws, "ckpt_ssl")
    ssl_cmd = ["--dataset", "RADIOLOGY_1M", "--arch", args.arch,
               "--batch_size", str(args.ssl_batch_size),
               "--max_epochs", str(args.ssl_epochs),
               "--warmup_epochs", str(min(10, max(0, args.ssl_epochs - 1))),
               "--num_workers", str(args.num_workers), "--seed", str(args.seed),
               "--checkpoint_dir", ssl_ckpt_dir,
               "--log_dir", os.path.join(ws, "logs_ssl")]
    if args.smoke:
        ssl_cmd += ["--hidden_dim", "64", "--projection_dim", "16",
                    "--limit_steps_per_epoch", "2"]
    if args.fp32:
        ssl_cmd.append("--fp32")
    stages.run("pretrain", lambda: _check(train_ssl.main(ssl_cmd), "train_ssl"))
    from medical_image_segmentation_tpu.core.checkpoint import latest_step

    step = latest_step(ssl_ckpt_dir)
    if step is None:
        raise SystemExit("parity: SSL pretrain produced no checkpoint")
    ssl_ckpt = os.path.join(ssl_ckpt_dir, str(step))
    report["ssl"] = {"checkpoint": ssl_ckpt,
                     **_final_metric(os.path.join(ws, "logs_ssl"), ["train/loss"])}

    # --- 6-7. slice Decathlon + splits ---
    img_out = os.path.join(ws, "slices", "images")
    msk_out = os.path.join(ws, "slices", "masks")
    splits_dir = os.path.join(ws, "splits")
    stages.run("slice", lambda: _check(slice_decathlon.main(
        ["--images_dir", args.decathlon_images, "--labels_dir", args.decathlon_labels,
         "--images_out", img_out, "--masks_out", msk_out,
         "--num_processes", str(nproc)]), "slice_decathlon"))
    stages.run("splits", lambda: _check(create_splits.main(
        ["--images_dir", img_out, "--output_dir", splits_dir,
         "--seed", str(args.seed)]), "create_splits"))

    # --- 8. fine-tune grid: {scratch, ssl} x label fractions ---
    fractions = [int(f) for f in args.fractions.split(",")]
    runs: List[Dict[str, object]] = []
    for frac in fractions:
        split_file = os.path.join(splits_dir, f"split_{frac}_percent_train.json")
        if not os.path.exists(split_file):
            raise SystemExit(f"parity: split file missing: {split_file}")
        for init in ("scratch", "ssl"):
            tag = f"seg_{init}_{frac}pct"
            log_dir = os.path.join(ws, f"logs_{tag}")
            cmd = ["--dataset", "DECATHLON_LIVER", "--arch", args.arch,
                   "--images_dir", img_out, "--masks_dir", msk_out,
                   "--split_file", split_file,
                   "--batch_size", str(args.seg_batch_size),
                   "--max_epochs", str(args.seg_epochs),
                   "--warmup_epochs", str(min(10, max(0, args.seg_epochs - 1))),
                   "--image_size", str(args.image_size),
                   "--num_workers", str(args.num_workers), "--seed", str(args.seed),
                   "--checkpoint_dir", os.path.join(ws, f"ckpt_{tag}"),
                   "--log_dir", log_dir]
            if init == "ssl":
                cmd += ["--ssl_checkpoint", ssl_ckpt]
            if args.smoke:
                cmd += ["--limit_steps_per_epoch", "2"]
            if args.fp32:
                cmd.append("--fp32")
            stages.run(tag, lambda cmd=cmd: _check(train_segmentation.main(cmd), tag))
            m = _final_metric(log_dir, ["test/dice", "test/iou", "val/dice"])
            runs.append({"init": init, "label_fraction": frac, **m})
    report["finetune"] = runs
    report["stage_seconds"] = stages.timings

    # --- 9. report ---
    out_path = os.path.join(ws, "parity_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)

    ds = report["dataset_stats"]
    lines = [
        "# Parity report",
        "",
        "| Quantity | Measured | Reference |",
        "|---|---|---|",
        f"| dataset mean | {ds['measured_mean']} | {ds['reference_mean']} (lightning_module.py:212) |",
        f"| dataset std | {ds['measured_std']} | {ds['reference_std']} (lightning_module.py:213) |",
        f"| val (NIH test) mean | {ds.get('val_measured_mean', 'not measured — pass --val_png_dir')} "
        f"| {ds['val_reference_mean']} (lightning_module.py:239) |",
        f"| val (NIH test) std | {ds.get('val_measured_std', 'not measured — pass --val_png_dir')} "
        f"| {ds['val_reference_std']} (lightning_module.py:240) |",
        "",
        "| Init | Labels | test Dice | test IoU |",
        "|---|---|---|---|",
    ]
    for r in runs:
        lines.append(f"| {r['init']} | {r['label_fraction']}% "
                     f"| {r.get('test/dice', float('nan')):.4f} "
                     f"| {r.get('test/iou', float('nan')):.4f} |")
    by_frac: Dict[int, Dict[str, float]] = {}
    for r in runs:
        if "test/dice" in r:
            by_frac.setdefault(int(r["label_fraction"]), {})[str(r["init"])] = float(r["test/dice"])
    wins = [f for f, d in sorted(by_frac.items())
            if "ssl" in d and "scratch" in d and d["ssl"] >= d["scratch"]]
    lines += ["", f"SSL-init ≥ scratch at label fractions: {wins or 'none'}",
              f"Full report: {out_path}"]
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
