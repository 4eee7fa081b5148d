"""A tiny configuration and mix, for the CPU tests of the harness: the
same files' shapes at sizes a test run holds."""

LSTM = {"name": "tiny-lstm", "port_config": "nmt-deen-lstm", "family": "lstm",
        "num_layers": 2, "d_model": 32, "num_heads": 0, "num_kv_heads": 0,
        "head_dim": 1, "d_ff": 0, "vocab_size": 500, "positional": "none",
        "tie_embeddings": False, "norm": "layernorm", "dtype": "float32",
        "screen": {"clusters": 4, "blocks_per_cluster": 2, "block": 128}}

CLOSED = {"jobs": {"requests": 4,
                   "source_length": {"median": 5, "sigma": 0.5, "min": 2,
                                     "max": 8},
                   "prompt_buckets": [4, 8], "block": 4,
                   "output_ratio": [0.8, 1.2]},
          "accuracy_floor": 0.9, "heads": ["exact", "screened-cuda"],
          "judge_requests": 3, "trace_at_s": 0.0, "trace_seconds": 0.0}

LIMITS = {"logit_gap": 1e-4, "route_gap": 1e-3, "outside": 0}

BENCH = {"end_to_end": [
    {"name": "tokens_per_s", "unit": "tokens/s"},
    {"name": "setup_s", "unit": "s"}], "per_layer": []}
