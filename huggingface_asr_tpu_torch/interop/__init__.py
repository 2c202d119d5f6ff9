"""interop subpackage."""
