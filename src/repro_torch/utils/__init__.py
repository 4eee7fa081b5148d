"""Tree helpers (``pytree.py``, the reference's ``utils/pytree.py``) and
wall-clock timing (``timing.py``). The reference's ``utils/shard.py``
(GSPMD partition helpers) is not ported: see ``launch/mesh.py``."""
from repro_torch.utils.pytree import cast_tree, tree_bytes, tree_norm, tree_size
from repro_torch.utils.timing import Timer, bench_wall
