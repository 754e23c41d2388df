"""Measurement scripts for the card (run with ``python3 -m``)."""
