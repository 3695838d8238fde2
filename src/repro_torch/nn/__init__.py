"""Layers of the port's model stack (``nn.Module``s whose parameter names
follow the JAX package's parameter paths)."""
