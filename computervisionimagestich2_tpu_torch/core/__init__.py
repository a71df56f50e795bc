"""Core data types of the port."""
