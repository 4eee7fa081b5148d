"""Launchers and their cost tooling: the step functions (``steps.py``),
the training and serving CLIs (``python -m repro_torch.launch.train`` /
``.serve``), the op-level cost counter (``op_cost.py``), the H100's peaks
and the counting meshes (``mesh.py``), the partition rules
(``sharding.py``), the roofline (``roofline.py``) and the dry run over
every (arch × input shape) on the meta device, one device of a mesh or one
card (``python -m repro_torch.launch.dryrun``)."""
