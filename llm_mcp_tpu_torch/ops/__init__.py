"""Norms, rope and sampling."""
