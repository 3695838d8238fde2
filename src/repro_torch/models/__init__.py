"""The port's language models (decoder-only; serving first)."""
