"""Training driver of the port."""
