"""serving subpackage."""
