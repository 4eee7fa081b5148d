"""The synthetic corpus and the batch loader of the LM trainer."""
from repro_torch.data.loader import BatchLoader
from repro_torch.data.synthetic import ZipfMarkovCorpus, make_lm_batches
