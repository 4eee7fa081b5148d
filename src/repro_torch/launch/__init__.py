"""Launchers: the LM train step (``steps.py``) and the training CLI
(``python -m repro_torch.launch.train``)."""
