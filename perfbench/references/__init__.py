"""Plain references of the conversions, one module per configuration."""
