"""Launchers of the port: `serve` (LM mode)."""
