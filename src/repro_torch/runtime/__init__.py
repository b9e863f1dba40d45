"""Serving loops."""
