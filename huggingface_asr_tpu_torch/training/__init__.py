"""training subpackage."""
