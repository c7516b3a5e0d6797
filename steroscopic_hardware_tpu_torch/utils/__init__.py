"""Utilities: parameter validation."""
