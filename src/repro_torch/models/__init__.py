"""Model interface (LSTM family): ``Model(cfg).init(generator, device=...)``."""
from repro_torch.models.model import Model
