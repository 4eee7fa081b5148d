"""Peak rates of the card the port runs on: one NVIDIA H100 SXM.

Twin of ``repro/launch/mesh.py``, whose constants are a TPU v5e's (per
chip) for its XLA roofline. The port's roofline (``launch/roofline.py``),
its dry run (``launch/dryrun.py``) and ``chip_smoke.py``'s kernel bounds
read these, so one module holds the peaks. Each is NVIDIA's data sheet
figure for the SXM part, dense (no sparsity), at the full 700 W power
limit; a card set below it runs slower (``nvidia-smi``'s ``power.limit``).

Not ported, and why:

* ``make_production_mesh`` (a 16×16 or 2×16×16 TPU mesh) and
  ``mesh_axis_sizes`` / ``data_axes``: in the reference only the XLA dry
  run lowers a model across devices, over GSPMD partition rules
  (``launch/sharding.py``, ``utils/shard.py``, also not ported); its
  train and serve launchers run on one device, as the port's do. The
  port's dry run costs one step on one H100, with no mesh.
* ``make_test_mesh``: the vocab-sharded heads take ``n_shards`` or
  ``devices`` instead (``heads/sharded.py::shard_devices``), one process
  driving every shard.
"""
from __future__ import annotations

# bf16 and fp16 on the tensor cores, dense
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
# float32 outside the tensor cores: the port's float32 products through
# PyTorch run here, TF32 being off for cuBLAS and cuDNN
# (``repro_torch.device.resolve_device``)
PEAK_FLOPS_F32 = 67e12            # FLOP/s
# TF32 on the tensor cores, dense. Only the SSD backward kernel
# (``csrc/ssd_bwd.cu``) runs here, in split TF32: three TF32 products for
# each float32 one, so its float32 work is bounded by 3 x flops / this
PEAK_FLOPS_TF32 = 495e12          # FLOP/s
# HBM3, 80 GB
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80e9                  # bytes of device memory
# NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way
NVLINK_BW = 450e9                 # bytes/s, one direction
