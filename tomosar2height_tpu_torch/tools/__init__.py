"""Measurement tools run on the card (not imported by the package)."""
