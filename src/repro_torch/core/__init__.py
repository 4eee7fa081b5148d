"""L2S inference side: screens, routing and the screened softmax."""
from repro_torch.core.screening import (ScreenParams, assign_clusters,
                                        candidates_to_padded, screened_logits,
                                        screened_topk)
