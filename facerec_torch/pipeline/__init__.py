"""Pipeline stages of the port (this slice: extract)."""
