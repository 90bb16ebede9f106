"""Time-stepping drivers."""
