"""Sample-id-addressed data pipeline."""
