"""Training of the port: losses, AdamW and GaLore, the step and loop,
checkpoints, and the offloaded linear probe."""
