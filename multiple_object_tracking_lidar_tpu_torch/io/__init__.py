"""See the package docstring: this subpackage mirrors its JAX counterpart."""
