"""Codecs built from the ops."""
