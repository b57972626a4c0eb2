"""Flat-vector AdamW."""
