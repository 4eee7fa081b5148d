"""Optimiser pieces of the LM trainer, as functions over params trees (not
``torch.optim``), so the port follows the reference's arithmetic step for
step."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
