"""HTTP serving surface of the port."""
