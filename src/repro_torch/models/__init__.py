"""Model interface (lstm, ssm and hybrid families):
``Model(cfg).init(generator, device=...)``."""
from repro_torch.models.model import Model
