"""medical_image_segmentation_tpu — a JAX/XLA framework for NVIDIA GPUs
with the capabilities of the PyTorch/FFCV reference `EthanHaque/medical_image_segmentation`.

Layers (bottom-up):
  data/     — DICOM/NIfTI parsing, sharded ingest CLI tools, mmap sample store,
              C++ decode loader, host/device augmentation pipelines.
  ops/      — losses, metrics, LARS optimizer, LR/momentum schedules,
              on-device augmentation as batched matmuls.
  models/   — ResNet encoder family (stem surgery), U-Net, MLP heads, on a
              small flax.linen-style module system in plain JAX (nn.py).
  parallel/ — mesh construction, sharding helpers, distributed init.
  train/    — BYOL pretrain task, segmentation task, CLI entry points.
  eval/     — KNN probe, linear probe, dice/iou evaluation.
  core/     — registry, config, RNG discipline, npz checkpointing, metrics CSV,
              compile cache and device check (runtime.py).
"""

__version__ = "0.1.0"
