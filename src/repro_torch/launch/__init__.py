"""Serving entry points: steps, the serve driver and its CLI."""
