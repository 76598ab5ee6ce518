"""Dense decoder model."""
