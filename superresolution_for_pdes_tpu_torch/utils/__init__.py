"""Run-directory helpers."""
