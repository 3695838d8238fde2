"""Configuration and device resolution shared by the port's model stack."""
