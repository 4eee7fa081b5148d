"""The synthetic corpus, the batch loader of the LM trainer and the dry run's
step inputs (``input_specs`` / ``random_inputs``)."""
from repro_torch.data.loader import BatchLoader, input_specs, random_inputs
from repro_torch.data.synthetic import ZipfMarkovCorpus, make_lm_batches
