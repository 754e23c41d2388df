"""Fixtures and layout helpers (numpy)."""
