"""Batched serving of the port's language models."""
