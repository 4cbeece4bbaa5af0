"""The port's data pipeline (numpy and PIL only)."""
