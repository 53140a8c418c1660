"""Tools of the port (``selfcheck``'s detection scoring so far)."""
