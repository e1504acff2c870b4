"""Terminal helpers."""
