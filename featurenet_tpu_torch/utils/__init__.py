"""Utilities: metric logging."""
