"""L2S — Learning to Screen (the paper's contribution). Twin of
``repro/core``:

  1. collect context vectors H and exact-softmax top-k label sets y
  2. init cluster weights v by spherical k-means on H
  3. alternate:  c-step — greedy knapsack candidate selection under budget B
                 v-step — SGD on Eq.(8) through the Gumbel-ST relaxation
  4. inference: z(h) = argmax_t v_t·h;  exact softmax over candidate set c_z

The reference's ``make_screen_fn`` (a jitted closure) has no eager twin.
"""
from repro_torch.core.gumbel import gumbel_softmax_st
from repro_torch.core.kmeans import kmeans_assign, spherical_kmeans
from repro_torch.core.knapsack import candidate_stats, greedy_knapsack
from repro_torch.core.screening import (ScreenParams, assign_clusters,
                                        candidates_to_padded, screened_logits,
                                        screened_topk)
from repro_torch.core.train_l2s import L2SState, collect_contexts, fit_l2s
from repro_torch.core.evaluate import (avg_candidate_size, precision_at_k,
                                       speedup_model)
