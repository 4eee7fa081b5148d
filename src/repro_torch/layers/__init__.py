"""Layers of the paper's LSTM language model."""
