"""Tree helpers (``pytree.py``, the reference's ``utils/pytree.py``),
wall-clock timing (``timing.py``), and the activation pins and per-device
kernel calls of a step on a mesh (``shard.py``, the reference's
``utils/shard.py``)."""
from repro_torch.utils.pytree import cast_tree, tree_bytes, tree_norm, tree_size
from repro_torch.utils.timing import Timer, bench_wall
