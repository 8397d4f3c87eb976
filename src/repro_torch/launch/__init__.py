"""Serving: streaming sessions, the serve loop and its CLI."""
