"""Dense GQA transformer layers, attention and decode."""
