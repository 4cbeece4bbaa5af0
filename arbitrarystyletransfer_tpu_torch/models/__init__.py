"""Model-level functions of the port."""
