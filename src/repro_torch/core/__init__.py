"""Submodel specs and the elastic family decode surface."""
