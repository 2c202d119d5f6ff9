"""cli subpackage."""
