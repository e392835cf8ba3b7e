"""Subpackage of betapose_tpu_torch; see the package docstring."""
