"""Synthetic LM data of the port (``pipeline.SyntheticLM``)."""
