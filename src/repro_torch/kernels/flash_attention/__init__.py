"""Causal GQA online-softmax attention for long-context prefill."""
