"""Multi-pod dry-run example: count one (arch × shape) combination on the
2×16×16 production mesh (512 devices), one device's share, and print the
roofline terms at the H100's peaks and NVLink rate. No GPU needed: the mesh
is a counting mesh of torch's ``fake`` process group and the tensors live
on the ``meta`` device (``repro_torch.launch.mesh``).

Run: PYTHONPATH=src python examples/dryrun_multipod_torch.py [arch] [shape]
(defaults: mixtral-8x7b decode_32k — MoE + sliding-window decode)
"""
import json
import sys

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.dryrun import lower_combo
from repro_torch.launch.mesh import make_production_mesh

arch = sys.argv[1] if len(sys.argv) > 1 else "mixtral-8x7b"
shape = sys.argv[2] if len(sys.argv) > 2 else "decode_32k"

cfg = get_config(arch)
print(f"{arch} × {shape} on the 2×16×16 multi-pod mesh (512 devices) ...")
with make_production_mesh(multi_pod=True) as mesh:
    rec = lower_combo(cfg, INPUT_SHAPES[shape], mesh)
print(json.dumps(rec, indent=2))
rl = rec["roofline"]
print(f"\ndominant term: {rl['dominant']} "
      f"(compute {rl['compute_s']:.3e}s | memory {rl['memory_s']:.3e}s | "
      f"collective {rl['collective_s']:.3e}s per step per device)")
